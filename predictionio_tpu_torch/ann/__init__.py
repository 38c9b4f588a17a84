"""ANN retrieval on the card: a clustered (IVF) MIPS index as a registry
artifact, so candidate generation stops being O(corpus) per query (port
of ``predictionio_tpu/ann``).

- :mod:`.index`: k-means build and incremental refresh, the padded-bucket
  layout, the int8 option, the PIOANN01 wire format (shared with the JAX
  package);
- :mod:`.search`: the two-stage search (centroid probe, gathered-bucket
  scoring, top-k in the ``ops.topk`` pack format), plain torch ops;
- :mod:`.lifecycle`: registry integration (build at train, stream refresh,
  serving attach) and the :class:`~.lifecycle.AnnServing` wrapper the
  engines consult;
- :mod:`.metrics`: the ``pio_ann_*`` family.
"""

from predictionio_tpu_torch.ann.index import (
    AnnConfig,
    AnnIndex,
    build_index,
    default_clusters,
    default_nprobe,
    deserialize_index,
    refresh_index,
    serialize_index,
)

__all__ = [
    "AnnConfig",
    "AnnIndex",
    "build_index",
    "default_clusters",
    "default_nprobe",
    "deserialize_index",
    "refresh_index",
    "serialize_index",
]
