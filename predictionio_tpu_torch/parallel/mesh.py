"""Named rank meshes (port of ``predictionio_tpu/parallel/mesh.py``).

The standard axes, by the JAX package's convention:

  - ``data``  — batch/data parallelism
  - ``model`` — the model axis (two-tower's sequence parallelism rides it)

A mesh lays the job's ranks out row-major over its axes (the last axis
varies fastest, as ``np.reshape`` lays devices out in JAX) and, in a
joined job, gives each axis one ``torch.distributed`` process group: the
ranks that agree on every other axis (a job of one rank keeps its
collectives, so they run on its backend). Without a job the mesh has one
rank and no group, and every collective is the identity, as the JAX mesh
of one device degrades gracefully.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Sequence

import torch

from predictionio_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named axis sizes; -1 means 'all remaining ranks'."""

    axes: tuple[tuple[str, int], ...] = (("data", -1),)

    @staticmethod
    def parse(spec: str | None) -> "MeshSpec":
        """Parse "data=8,model=2" (engine.json / CLI surface)."""
        if not spec:
            return MeshSpec()
        axes = []
        for part in spec.split(","):
            name, _, size = part.partition("=")
            axes.append((name.strip(), int(size) if size else -1))
        return MeshSpec(tuple(axes))


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Where a sharded tensor lies: split along ``dim`` over mesh axis
    ``axis``, each rank of that axis holding an equal block that starts at
    ``start`` of the whole ``global_shape``."""

    axis: str
    dim: int
    global_shape: tuple[int, ...]
    start: int

    def partition_spec(self) -> str:
        """The JAX spelling of the placement (``str(PartitionSpec(...))``)."""
        names = ", ".join(repr(self.axis) if d == self.dim else "None" for d in range(len(self.global_shape)))
        return f"PartitionSpec({names})"


def _resolve_sizes(axis_sizes: Sequence[int], n_devices: int) -> list[int]:
    sizes = list(axis_sizes)
    fixed = 1
    free = -1
    for i, s in enumerate(sizes):
        if s == -1:
            if free != -1:
                raise ValueError("at most one mesh axis may be -1")
            free = i
        else:
            fixed *= s
    if free != -1:
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes {fixed}"
            )
        sizes[free] = n_devices // fixed
    else:
        if fixed != n_devices:
            raise ValueError(
                f"mesh axes {sizes} require {fixed} devices, have {n_devices}"
            )
    return sizes


class Mesh:
    """This rank's place in a named layout of the job's ranks."""

    def __init__(self, names: tuple[str, ...], sizes: list[int], rank: int,
                 device: torch.device, groups: dict[str, Any]):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.rank = rank
        self.device = device
        self._groups = groups
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        self.coords = {n: (rank // st) % sz for n, st, sz in zip(names, strides, sizes)}
        self._strides = dict(zip(names, strides))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The axis's process group; None outside a joined job."""
        return self._groups.get(axis)

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks of this rank's group on ``axis``, in axis order."""
        base = self.rank - self.axis_index(axis) * self._strides.get(axis, 1)
        return [base + i * self._strides.get(axis, 1) for i in range(self.axis_size(axis))]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _axis_groups(names: tuple[str, ...], sizes: list[int], rank: int) -> dict[str, Any]:
    """One process group per axis. Every rank creates every group, in one
    order, as ``dist.new_group`` requires; each keeps its own."""
    import torch.distributed as dist

    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    groups: dict[str, Any] = {}
    for a, name in enumerate(names):
        others = [range(s) if i != a else range(1) for i, s in enumerate(sizes)]
        for coord in itertools.product(*others):
            base = sum(c * st for c, st in zip(coord, strides))
            ranks = [base + i * strides[a] for i in range(sizes[a])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = group
    return groups


def make_mesh(spec: MeshSpec | str | None = None, device: str | torch.device = "cuda") -> Mesh:
    """Build a named mesh over the job's ranks (one rank without a joined
    job). ``spec=None`` falls back to ``$PIO_MESH`` (e.g.
    ``data=-1,model=2``), then to all ranks on one ``data`` axis.
    ``device`` names the device of a rank outside a joined job."""
    if spec is None:
        spec = os.environ.get("PIO_MESH") or None
    if isinstance(spec, str) or spec is None:
        spec = MeshSpec.parse(spec)
    rt = distributed.runtime()
    world, rank = (rt.world_size, rt.rank) if rt is not None else (1, 0)
    names = tuple(name for name, _ in spec.axes)
    sizes = _resolve_sizes([s for _, s in spec.axes], world)
    groups = _axis_groups(names, sizes, rank) if rt is not None else {}
    return Mesh(names, sizes, rank, distributed.rank_device(device), groups)


def local_mesh(device: str | torch.device = "cuda") -> Mesh:
    """All ranks on one ``data`` axis — the dev/serving default."""
    return make_mesh(MeshSpec(), device)
