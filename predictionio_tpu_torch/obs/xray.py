"""The step profiler, the card's memory readings, the capacity planner and
the sharding inspector (port of ``predictionio_tpu/obs/xray.py``).

A :class:`TrainProfile` records a run's phases with exclusive-time nesting
and monotonic wall time; the phases tile the measured wall clock, which the
offline pipeline's and the grid's contract tests hold. Profiles flow through
a contextvar (:func:`use_profile` / :func:`current_profile`), and the
module-level :func:`phase` no-ops when nothing is recording. Where the JAX
package fetches a derived scalar as its device barrier,
:meth:`TrainProfile.device_barrier` synchronises the card.

The device half reads the card's caching allocator: live tensor bytes are
``torch.cuda.memory_allocated`` per card, and :func:`device_memory_stats`
keeps the JAX package's keys (``bytes_in_use``, ``peak_bytes_in_use``,
``bytes_limit``) over ``memory_allocated``, ``max_memory_allocated`` and
``mem_get_info``. Nothing here initialises CUDA: without a card, or before
anything touched one, the readings are empty. :func:`estimate_factors` and
:func:`estimate_ann` are the JAX package's arithmetic, unchanged.

The sharding inspector is a redesign: there is no compiled HLO to read, so
:func:`count_collectives` reads the counters every collective of
``parallel.collectives`` bumps, :func:`describe_shardings` reads a
tensor's placement from the ``shard_spec`` a sharded parameter carries
(``parallel.mesh.ShardSpec``), and :func:`inspect_train_step` runs the
step once and puts the model and the optimizer back as they were.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import math
import time
from typing import Any, Callable, Iterator

import torch

from predictionio_tpu_torch.obs.metrics import MetricsRegistry

PHASE_HOST_ETL = "host_etl"  # event-store reads, preparation
PHASE_SWEEP = "sweep"  # fold-in absorbs of the stream pipeline
PHASE_SOLVE = "solve"  # whole-algorithm train
PHASE_EVAL = "eval"  # held-out scoring


@dataclasses.dataclass
class _PhaseAgg:
    wall_s: float = 0.0
    device_s: float = 0.0
    count: int = 0


def register_train_metrics(registry: MetricsRegistry) -> dict[str, Any]:
    """Get-or-create the ``pio_train_*`` family (idempotent)."""
    return {
        "phase": registry.histogram(
            "pio_train_phase_seconds",
            "per-occurrence phase wall time (exclusive/self time)",
            labelnames=("trainer", "phase"),
        ),
        "device": registry.counter(
            "pio_train_device_seconds_total",
            "device waits accounted inside phases",
            labelnames=("trainer", "phase"),
        ),
        "rows": registry.counter(
            "pio_train_rows_total", "rows processed", labelnames=("trainer",)
        ),
        "active": registry.gauge(
            "pio_train_active", "1 while the profile is measuring", labelnames=("trainer",)
        ),
    }


class TrainProfile:
    """One run's recorder. Wall clock accumulates only inside
    :meth:`measure`; phases nest with self-time semantics, so a nested
    phase is never counted twice. Not thread-safe: one profile per loop."""

    def __init__(
        self,
        trainer: str,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.trainer = trainer
        self.registry = registry
        self._clock = clock
        self.phases: dict[str, _PhaseAgg] = {}
        self.rows_total = 0
        self.device_s = 0.0
        self.peak_device_bytes = 0
        self.finished = False
        self._wall_s = 0.0
        self._measure_t0: float | None = None
        self._phase_stack: list[list[Any]] = []  # [name, t0, child_elapsed]
        self._m = register_train_metrics(registry) if registry is not None else None

    # -- measuring -------------------------------------------------------------
    def resume(self) -> None:
        if self.finished or self._measure_t0 is not None:
            return
        self._measure_t0 = self._clock()
        if self._m is not None:
            self._m["active"].set(1.0, trainer=self.trainer)

    def pause(self) -> None:
        if self._measure_t0 is None:
            return
        self._wall_s += self._clock() - self._measure_t0
        self._measure_t0 = None
        if self._m is not None:
            self._m["active"].set(0.0, trainer=self.trainer)

    @contextlib.contextmanager
    def measure(self) -> Iterator["TrainProfile"]:
        self.resume()
        try:
            yield self
        finally:
            self.pause()

    @property
    def wall_s(self) -> float:
        if self._measure_t0 is not None:
            return self._wall_s + (self._clock() - self._measure_t0)
        return self._wall_s

    @property
    def attributed_s(self) -> float:
        """Wall time covered by phases: the tiling contract's numerator."""
        return sum(p.wall_s for p in self.phases.values())

    # -- phases ----------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        frame: list[Any] = [name, self._clock(), 0.0]
        self._phase_stack.append(frame)
        try:
            yield
        finally:
            self._phase_stack.pop()
            elapsed = self._clock() - frame[1]
            self_s = max(0.0, elapsed - frame[2])
            if self._phase_stack:
                self._phase_stack[-1][2] += elapsed
            agg = self.phases.setdefault(name, _PhaseAgg())
            agg.wall_s += self_s
            agg.count += 1
            if self._m is not None:
                self._m["phase"].observe(self_s, trainer=self.trainer, phase=name)

    def add_rows(self, n: int) -> None:
        self.rows_total += int(n)
        if self._m is not None:
            self._m["rows"].inc(int(n), trainer=self.trainer)

    # -- device time -----------------------------------------------------------
    def note_device_time(self, seconds: float) -> None:
        seconds = max(0.0, seconds)
        self.device_s += seconds
        phase = self._phase_stack[-1][0] if self._phase_stack else "unattributed"
        self.phases.setdefault(phase, _PhaseAgg()).device_s += seconds
        if self._m is not None:
            self._m["device"].inc(seconds, trainer=self.trainer, phase=phase)

    def device_barrier(self, device: str | torch.device) -> None:
        """Wait for every kernel queued on ``device`` and account the wait
        to the current phase (a no-op wait on the CPU)."""
        t0 = self._clock()
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            self.peak_device_bytes = max(
                self.peak_device_bytes, torch.cuda.max_memory_allocated(dev)
            )
        self.note_device_time(self._clock() - t0)

    # -- finish ----------------------------------------------------------------
    def finish(self) -> "TrainProfile":
        """Stop the clock; idempotent."""
        if not self.finished:
            self.pause()
            self.finished = True
        return self

    def to_json_dict(self) -> dict[str, Any]:
        wall = self.wall_s
        attributed = self.attributed_s
        return {
            "trainer": self.trainer,
            "wallClockS": round(wall, 6),
            "attributedS": round(attributed, 6),
            "deviceS": round(self.device_s, 6),
            "rowsTotal": self.rows_total,
            "rowsPerS": round(self.rows_total / wall, 2) if wall > 0 else 0.0,
            "phases": {
                name: {
                    "count": agg.count,
                    "wallS": round(agg.wall_s, 6),
                    "deviceS": round(agg.device_s, 6),
                    "meanS": round(agg.wall_s / agg.count, 6) if agg.count else 0.0,
                }
                for name, agg in sorted(self.phases.items())
            },
            "peakDeviceBytes": self.peak_device_bytes,
        }


_CURRENT: contextvars.ContextVar[TrainProfile | None] = contextvars.ContextVar(
    "pio_train_profile", default=None
)


def current_profile() -> TrainProfile | None:
    prof = _CURRENT.get()
    return None if prof is not None and prof.finished else prof


@contextlib.contextmanager
def use_profile(profile: TrainProfile) -> Iterator[TrainProfile]:
    token = _CURRENT.set(profile)
    try:
        yield profile
    finally:
        _CURRENT.reset(token)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Record into the current profile; a no-op when nothing records."""
    prof = current_profile()
    if prof is None:
        yield
        return
    with prof.phase(name):
        yield


def device_fetch(x: Any, where: str = "train") -> Any:
    """Profiled host copy of a tensor (plain ``.cpu()`` when nothing is
    recording): the wait lands in the current profile's phase."""
    prof = current_profile()
    if prof is None or not isinstance(x, torch.Tensor):
        # pio-lint: disable=train-unaccounted-sync -- device_fetch IS the accounted fetch; unprofiled runs have no profile to account into
        return x.cpu() if isinstance(x, torch.Tensor) else x
    t0 = prof._clock()
    out = x.cpu()  # pio-lint: disable=train-unaccounted-sync -- device_fetch IS the accounted fetch: the wait lands in the profile below
    prof.note_device_time(prof._clock() - t0)
    return out


# ---------------------------------------------------------------------------
# live-memory accounting
# ---------------------------------------------------------------------------


def _cuda_live() -> bool:
    """True only when CUDA is already initialised in this process: reading
    a memory gauge must not be what creates a context on the card."""
    try:
        return torch.cuda.is_initialized()
    except Exception:  # a torch built without CUDA
        return False


def live_bytes_per_device() -> dict[str, int]:
    """Bytes of live tensors per card (``torch.cuda.memory_allocated``);
    empty before CUDA is initialised."""
    if not _cuda_live():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_allocated(i)) for i in range(torch.cuda.device_count())}


def live_array_bytes() -> int:
    """Total bytes of live tensors over every card; 0 before CUDA is
    initialised. The runtime cross-check for :func:`estimate_factors`."""
    return sum(live_bytes_per_device().values())


def device_memory_stats() -> dict[str, Any] | None:
    """Allocator stats of the busiest card, under the JAX package's keys:
    ``bytes_in_use`` (``memory_allocated``), ``peak_bytes_in_use``
    (``max_memory_allocated``) and ``bytes_limit`` (the card's total from
    ``mem_get_info``). None before CUDA is initialised."""
    if not _cuda_live():
        return None
    best: dict[str, Any] | None = None
    for i in range(torch.cuda.device_count()):
        in_use = int(torch.cuda.memory_allocated(i))
        if best is None or in_use > best["bytes_in_use"]:
            _free, total = torch.cuda.mem_get_info(i)
            best = {
                "device": f"cuda:{i}",
                "bytes_in_use": in_use,
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                "bytes_limit": int(total),
            }
    return best


# ---------------------------------------------------------------------------
# capacity planner (the JAX package's arithmetic)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CapacityEstimate:
    """Predicted ALS training footprint: what the formulation requires.

    - ``factor_bytes``: both factor tables incl. the +1 padding row, and a
      half-size copy of each for a bf16 ``gather_dtype``;
    - ``workspace_bytes``: the larger half-solve's normal equations
      ``A [E,k,k] + b [E,k] + counts [E]`` at f32, plus 4 CG vectors per
      system;
    - ``wire_bytes``: the rating tables for ``nnz`` ratings (9 B a slot,
      both sides), 0 when ``nnz`` is unknown;
    - ``per_device_bytes``: everything row-sharded over ``n_devices``, plus
      one gathered opposite table when sharded.
    """

    users: int
    items: int
    rank: int
    dtype: str
    gather_dtype: str
    n_devices: int
    nnz: int | None
    factor_bytes: int
    workspace_bytes: int
    wire_bytes: int
    total_bytes: int
    per_device_bytes: int

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def fits(self, hbm_bytes_per_device: int | float) -> bool:
        return self.per_device_bytes <= hbm_bytes_per_device


def _mesh_devices(mesh: Any) -> int:
    """Device count from a mesh spec: an int, a ``"data=8,model=2"``
    string, a ``{"data": 8}`` dict, a ``parallel.mesh.Mesh``, or None
    (=1). An axis without an explicit positive size is refused: it must
    not silently mean one device."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return max(1, mesh)
    if isinstance(mesh, str):
        s = mesh.strip()
        if s.isdigit():  # bare device count: "--mesh 8"
            return max(1, int(s))
        n = 1
        for part in mesh.split(","):
            if not part.strip():
                continue
            _, sep, size = part.partition("=")
            if not sep or not size.strip():
                raise ValueError(
                    f"mesh axis {part!r} needs an explicit size for the "
                    f"capacity planner (e.g. 'data=8,model=2')"
                )
            v = int(size)
            if v <= 0:
                raise ValueError(
                    f"mesh axis sizes must be explicit positives for the "
                    f"capacity planner, got {part!r}"
                )
            n *= v
        return max(1, n)
    if isinstance(mesh, dict):
        n = 1
        for axis, v in mesh.items():
            v = int(v)
            if v <= 0:
                raise ValueError(f"mesh axis {axis!r} size must be positive, got {v}")
            n *= v
        return max(1, n)
    shape = getattr(mesh, "shape", None)  # a Mesh: {axis: size}
    if shape is not None:
        return max(1, math.prod(int(v) for v in dict(shape).values()))
    raise TypeError(f"cannot derive a device count from mesh {mesh!r}")


def estimate_factors(
    users: int,
    items: int,
    k: int,
    dtype: str = "f32",
    mesh: Any = None,
    *,
    nnz: int | None = None,
    gather_dtype: str = "f32",
) -> CapacityEstimate:
    """Predict the per-card footprint of an ALS train (see
    :class:`CapacityEstimate`) over ``mesh``'s devices
    (:func:`_mesh_devices`). Pure arithmetic: ``pio doctor`` calls it
    without a card."""
    if users < 0 or items < 0 or k <= 0:
        raise ValueError(f"need users/items >= 0 and k > 0, got {users}/{items}/{k}")
    bpe = 2 if dtype == "bf16" else 4
    n_dev = _mesh_devices(mesh)
    user_table = (users + 1) * k * bpe
    item_table = (items + 1) * k * bpe
    factor = user_table + item_table
    if gather_dtype == "bf16":
        factor += (user_table + item_table) // 2
    e = max(users, items) + 1
    workspace = e * (k * k + k + 1) * 4 + 4 * e * k * 4
    wire = 2 * int(nnz) * 9 if nnz else 0
    total = factor + workspace + wire
    per_device = -(-total // n_dev)
    if n_dev > 1:
        per_device += max(user_table, item_table)
    return CapacityEstimate(
        users=users,
        items=items,
        rank=k,
        dtype=dtype,
        gather_dtype=gather_dtype,
        n_devices=n_dev,
        nnz=nnz,
        factor_bytes=factor,
        workspace_bytes=workspace,
        wire_bytes=wire,
        total_bytes=total,
        per_device_bytes=int(per_device),
    )


def estimate_ann(
    items: int,
    dim: int,
    clusters: int = 0,
    nprobe: int = 0,
    *,
    quantize_int8: bool = False,
    batch: int = 64,
) -> dict[str, Any]:
    """Price a pinned ANN index's card memory next to the factor tables
    (``pio doctor --capacity ... --ann clusters,nprobe``), with the
    build's own sizing rules (``ann/index.py``): centroids ``[C, dim]``
    f32, bucket ids ``[C, cap]`` int32 and vectors ``[C, cap, dim]`` (f32,
    or int8 plus an f32 scale an item), and the search's per-batch
    transient ``[batch, nprobe, cap, dim]`` with its scores."""
    if items <= 0 or dim <= 0:
        raise ValueError(f"need items > 0 and dim > 0, got {items}/{dim}")
    from predictionio_tpu_torch.ann.index import bucket_capacity, default_clusters, default_nprobe

    clusters = clusters or default_clusters(items)
    clusters = max(1, min(clusters, items))
    nprobe = min(nprobe or default_nprobe(clusters), clusters)
    cap = bucket_capacity(items, clusters)
    vec_elem = 1 if quantize_int8 else 4
    centroid_bytes = clusters * dim * 4
    bucket_bytes = clusters * cap * (dim * vec_elem + 4)
    if quantize_int8:
        bucket_bytes += clusters * cap * 4
    search_transient = batch * nprobe * cap * (dim * 4 + 8)
    total = centroid_bytes + bucket_bytes
    return {
        "items": items,
        "dim": dim,
        "clusters": clusters,
        "nprobe": nprobe,
        "bucketCap": cap,
        "quantized": quantize_int8,
        "centroidBytes": centroid_bytes,
        "bucketBytes": bucket_bytes,
        "searchTransientBytes": search_transient,
        "perDeviceBytes": total,
        "candidatesPerQuery": nprobe * cap,
        "candidateFrac": round(min(1.0, nprobe * cap / max(1, items)), 4),
    }


# ---------------------------------------------------------------------------
# sharding inspector
# ---------------------------------------------------------------------------


def count_collectives(since: dict[str, int] | None = None) -> dict[str, int]:
    """The collectives this process issued (``parallel.collectives``'
    counters, under the JAX inspector's names), since the snapshot
    ``since`` of :func:`~predictionio_tpu_torch.parallel.collectives.collective_counts`
    when given; kinds with none are left out, as the JAX function leaves
    out ops its HLO lacks."""
    from predictionio_tpu_torch.parallel.collectives import collective_counts

    now = collective_counts()
    base = since or {}
    return {k: n - base.get(k, 0) for k, n in now.items() if n - base.get(k, 0)}


def _leaves(tree: Any, prefix: str) -> list[tuple[str, torch.Tensor, Any]]:
    """(name, tensor, shard spec or None) for every tensor of ``tree``: a
    module's parameters, an optimizer's state (named after the parameters
    of the modules in the same tree, else by index), a tensor, or dicts,
    lists and tuples of them."""
    modules: list[torch.nn.Module] = []

    def find(node):
        if isinstance(node, torch.nn.Module):
            modules.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                find(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                find(v)

    find(tree)
    names = {id(p): n for m in modules for n, p in m.named_parameters()}
    out: list[tuple[str, torch.Tensor, Any]] = []

    def join(a: str, b: str) -> str:
        return f"{a}.{b}" if a else b

    def walk(node, name: str):
        if isinstance(node, torch.nn.Module):
            for n, p in node.named_parameters():
                out.append((join(name, n), p, getattr(p, "shard_spec", None)))
        elif isinstance(node, torch.optim.Optimizer):
            params = [p for g in node.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                spec = getattr(p, "shard_spec", None)
                for key, v in node.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        sharded = spec if v.shape == p.shape else None
                        out.append((join(name, f"{names.get(id(p), i)}.{key}"), v, sharded))
        elif torch.is_tensor(node):
            out.append((name, node, None))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, join(name, str(k)))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, join(name, str(i)))

    walk(tree, prefix)
    return out


def describe_shardings(tree: Any, mesh: Any = None, prefix: str = "") -> list[dict[str, Any]]:
    """Placement records of every tensor of ``tree`` (see :func:`_leaves`)
    on ``mesh``'s ranks: ``{"name", "shape", "dtype", "bytes", "sharding",
    "devices", "replicated", "per_device_bytes"}``, the JAX function's
    keys. ``shape`` and ``bytes`` are the whole tensor's; a sharded tensor
    (a ``shard_spec``) is split over its axis, anything else is whole on
    every rank. ``replicated`` is flagged only when the mesh has more than
    one rank. ``per_device_bytes`` is what a rank holds, the shard's own
    bytes (where the JAX function divides by the whole mesh, which
    undercounts a tensor sharded on one axis and replicated on another)."""
    devices = _mesh_devices(mesh)
    out: list[dict[str, Any]] = []
    for name, t, spec in _leaves(tree, prefix):
        shape = list(spec.global_shape) if spec is not None else list(t.shape)
        itemsize = t.element_size()
        out.append({
            "name": name or "<root>",
            "shape": shape,
            "dtype": str(t.dtype).removeprefix("torch."),
            "bytes": math.prod(shape) * itemsize,
            "sharding": spec.partition_spec() if spec is not None else "PartitionSpec()",
            "devices": devices,
            "replicated": bool(devices > 1 and spec is None),
            "per_device_bytes": t.numel() * itemsize,
        })
    return out


def find_replicated(entries: list[dict[str, Any]], min_bytes: int = 1 << 20) -> list[dict[str, Any]]:
    """The flag list: the replicated tensors of at least ``min_bytes``: on
    every rank, card memory spent on what could be sharded."""
    return [e for e in entries if e.get("replicated") and e.get("bytes", 0) >= min_bytes]


def inspect_train_step(
    step: Any,
    *args: Any,
    replicated_min_bytes: int = 1 << 20,
    arg_names: tuple[str, ...] | None = None,
) -> dict[str, Any]:
    """The JAX inspector's report of one train step: ``collectives`` (by
    kind), ``arrays`` (the placements of the parameters, the optimizer's
    state and each argument) and ``flags`` (the replicated ones of at
    least ``replicated_min_bytes``). ``step`` is a ``make_train_step``
    closure carrying ``model``, ``optimizer`` and ``mesh``.

    The JAX function compiles the step without running it and reads the
    partitioned HLO. Torch has no such program, so the collectives are
    counted by running the step once: on every rank of the mesh (its
    collectives need them all), after which the parameters, their
    gradients and the optimizer's state are put back as they were, bit
    for bit. So it costs one step."""
    from predictionio_tpu_torch.parallel.collectives import collective_counts

    model, optimizer, mesh = step.model, step.optimizer, step.mesh
    saved = {n: (p.detach().clone(), None if p.grad is None else p.grad.detach().clone())
             for n, p in model.named_parameters()}
    saved_opt = copy.deepcopy(optimizer.state_dict())
    before = collective_counts()
    try:
        step(*args)
        collectives = count_collectives(before)
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                value, grad = saved[n]
                p.copy_(value)
                p.grad = grad
        optimizer.load_state_dict(saved_opt)
    arrays = describe_shardings({"params": model, "opt_state": optimizer}, mesh)
    for i, a in enumerate(args):
        name = arg_names[i] if arg_names and i < len(arg_names) else f"arg{i}"
        arrays.extend(describe_shardings(a, mesh, prefix=name))
    flags = [f"fully-replicated {e['bytes']} B array {e['name']} on {e['devices']} devices "
             f"— shard it or accept the per-chip cost" for e in find_replicated(arrays, replicated_min_bytes)]
    return {"collectives": collectives, "arrays": arrays, "flags": flags}
