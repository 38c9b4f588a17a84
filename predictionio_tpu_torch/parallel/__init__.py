"""Ranks, meshes, collectives and host ingest on ``torch.distributed``
(port of ``predictionio_tpu/parallel/``).

The JAX package lays a named ``jax.sharding.Mesh`` over devices and lets
XLA insert the collectives. Here one process is one rank on one device:
:mod:`distributed` joins the ranks (NCCL between cards, gloo on the CPU
or when ranks share a card), :mod:`mesh` names their axes with one
process group per axis, :mod:`collectives` moves tensors along an axis
(with the gradients JAX's transposes give), :mod:`ingest` pads and keeps
each rank's rows, and :mod:`launcher` starts one worker per rank.
"""

from predictionio_tpu_torch.parallel.ingest import pad_to_multiple, shard_columns
from predictionio_tpu_torch.parallel.mesh import MeshSpec, local_mesh, make_mesh

__all__ = ["MeshSpec", "make_mesh", "local_mesh", "shard_columns", "pad_to_multiple"]
