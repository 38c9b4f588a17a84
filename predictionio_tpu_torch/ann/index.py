"""Clustered MIPS index: build, refresh, and a pickle-free wire format
(port of ``predictionio_tpu/ann/index.py``).

The IVF layout, every table a dense batched product over device-resident
tensors:

  - ``centroids``    [C, f] float32: k-means cluster centres over the
    item-vector table;
  - ``bucket_ids``   [C, cap] int32: the item indices of each cluster,
    padded to one shared power-of-two capacity with ``-1`` (pad slots are
    masked to ``-inf`` by the search and never surface);
  - ``bucket_vecs``  [C, cap, f]: each cluster's item vectors in the padded
    layout, float32, or int8 with a per-item ``bucket_scale`` [C, cap]
    when ``quantize_int8`` is on (the exact f32 rescore of the survivors
    restores the ranking).

Build is batched Lloyd iterations. The O(n·C) assignment is a chunked
distance product on the index's device (``torch.matmul`` and ``argmin``,
as the JAX package leaves it to XLA); the centroid update is the
reference's own deterministic host numpy (``np.add.at``, a seeded init,
the empty-cluster re-seed), so equal vectors build byte-identical indexes
on one device, and the registry's content addressing dedupes rebuilds.
A build on another device may flip a near-tie of the argmin and then
differs in a few assignments and in its sha256.

Serialization (PIOANN01) is the JAX package's framing, byte for byte:
magic, a json header and the raw array bytes. An index written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from predictionio_tpu_torch.ops.als import next_pow2
from predictionio_tpu_torch.utils.device import resolve_device

_MAGIC = b"PIOANN01"

# capacity-planner padding model: buckets are padded to a shared pow2
# capacity of twice the balanced mean
PAD_SKEW_MODEL = 2


def default_clusters(n_items: int) -> int:
    """About 4·sqrt(n) rounded to a power of two, clamped so the balanced
    mean bucket keeps at least about 8 items (the reference's rule)."""
    if n_items <= 0:
        return 1
    c = next_pow2(int(round(4.0 * float(n_items) ** 0.5)))
    return max(1, min(c, 8192, next_pow2(n_items) // 8 or 1))


def default_nprobe(clusters: int) -> int:
    """Probe width: clusters/128 with a floor of 16 (the reference's rule)."""
    return min(clusters, max(16, clusters // 128))


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """Build and refresh knobs, with the reference's defaults. The field
    names and order are part of PIOANN01's header."""

    clusters: int = 0  # 0 = default_clusters(corpus)
    nprobe: int = 0  # 0 = default_nprobe(clusters); serve-time default
    build_iters: int = 10  # Lloyd iterations
    seed: int = 0
    quantize_int8: bool = False
    rescore: int = 4  # int8 path: exact-rescore pool = rescore * k
    # below this corpus size no index is built and exact serving stays
    min_items: int = 50_000
    # stream refresh: share of items whose nearest centroid moved before
    # the incremental rebucket is distrusted and k-means runs again
    refresh_drift: float = 0.25
    assign_chunk: int = 16_384  # items per assignment product

    def resolved(self, n_items: int) -> "AnnConfig":
        """Fill the auto (0) fields from the corpus size."""
        clusters = self.clusters or default_clusters(n_items)
        clusters = max(1, min(clusters, max(1, n_items)))
        nprobe = self.nprobe or default_nprobe(clusters)
        return dataclasses.replace(self, clusters=clusters, nprobe=min(nprobe, clusters))


@dataclasses.dataclass
class AnnIndex:
    """One built index and the metadata its manifest entry records. Host
    numpy arrays: :class:`~predictionio_tpu_torch.ann.search.AnnSearcher`
    copies them onto its device."""

    centroids: np.ndarray  # [C, f] f32
    bucket_ids: np.ndarray  # [C, cap] int32, -1 padded
    bucket_vecs: np.ndarray  # [C, cap, f] f32 (int8 when quantized)
    bucket_scale: np.ndarray | None  # [C, cap] f32, int8 mode only
    # nearest-centroid assignment [n] int32 before the balanced spill: the
    # refresh drift guard compares against it
    nearest_assign: np.ndarray | None
    n_items: int
    nprobe: int
    model_version: str = ""  # registry version whose vectors built this
    built_from: str = ""  # "train" | "refresh" | "rebuild"
    config: AnnConfig = dataclasses.field(default_factory=AnnConfig)

    @property
    def clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def bucket_cap(self) -> int:
        return int(self.bucket_ids.shape[1])

    @property
    def quantized(self) -> bool:
        return self.bucket_scale is not None

    def assignments(self) -> np.ndarray:
        """[n_items] nearest-centroid id per item, the drift baseline;
        bucket membership for artifacts without ``nearest_assign``."""
        if self.nearest_assign is not None:
            return np.asarray(self.nearest_assign, np.int32)
        out = np.full(self.n_items, -1, np.int32)
        for c in range(self.clusters):
            ids = self.bucket_ids[c]
            out[ids[ids >= 0]] = c
        return out

    def hbm_bytes(self) -> int:
        """Resident device footprint of the searcher's tables."""
        total = self.centroids.nbytes + self.bucket_ids.nbytes + self.bucket_vecs.nbytes
        if self.bucket_scale is not None:
            total += self.bucket_scale.nbytes
        return int(total)

    def manifest_meta(self) -> dict[str, Any]:
        """The ``ann_index`` manifest entry (less the store-owned sha256 and
        bytes fields)."""
        return {
            "items": self.n_items,
            "dim": self.dim,
            "clusters": self.clusters,
            "bucketCap": self.bucket_cap,
            "nprobe": self.nprobe,
            "quantized": self.quantized,
            "hbmBytes": self.hbm_bytes(),
            "modelVersion": self.model_version,
            "builtFrom": self.built_from,
        }


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _assign(vecs: np.ndarray, centroids: np.ndarray, chunk: int,
            device: str | torch.device = "cuda") -> np.ndarray:
    """Nearest-centroid assignment of every row of ``vecs``: the O(n·C)
    half of Lloyd, one distance product per ``chunk`` rows on ``device``
    so the [chunk, C] score matrix stays bounded. argmin ‖x − c‖² is
    argmin (‖c‖² − 2·x·c), ‖x‖² being constant per row; the first index
    wins a tie, as ``jnp.argmin``'s does."""
    dev = resolve_device(device)
    c = torch.tensor(np.ascontiguousarray(centroids, np.float32), device=dev)
    c_sq = (c * c).sum(dim=1)[None, :]
    out = np.empty(len(vecs), np.int32)
    for start in range(0, len(vecs), chunk):
        x = torch.tensor(np.ascontiguousarray(vecs[start : start + chunk], np.float32), device=dev)
        nearest = torch.argmin(c_sq - 2.0 * (x @ c.T), dim=1)
        # pio-lint: disable=train-unaccounted-sync -- the host index build's input: one [chunk] int32 fetch per chunk, timed as the build
        out[start : start + len(x)] = nearest.to(torch.int32).cpu().numpy()
    return out


def kmeans(vecs: np.ndarray, clusters: int, iters: int, seed: int, chunk: int,
           device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Batched Lloyd: chunked assignment on ``device``, deterministic host
    update. Returns (centroids [C, f] f32, assignment [n] int32). An empty
    cluster is re-seeded from the member of the fattest cluster farthest
    from its centroid."""
    vecs = np.ascontiguousarray(vecs, np.float32)
    n = len(vecs)
    clusters = max(1, min(clusters, n))
    rng = np.random.default_rng(seed)
    centroids = vecs[rng.choice(n, size=clusters, replace=False)].copy()
    assign = np.zeros(n, np.int32)
    for _ in range(max(1, iters)):
        assign = _assign(vecs, centroids, chunk, device)
        sums = np.zeros_like(centroids, dtype=np.float64)
        np.add.at(sums, assign, vecs)
        counts = np.bincount(assign, minlength=clusters)
        empty = np.flatnonzero(counts == 0)
        nonempty = counts > 0
        centroids[nonempty] = (sums[nonempty] / counts[nonempty, None]).astype(np.float32)
        for e in empty:
            fat = int(np.argmax(counts))
            members = np.flatnonzero(assign == fat)
            d = ((vecs[members] - centroids[fat]) ** 2).sum(axis=1)
            far = members[int(np.argmax(d))]
            centroids[e] = vecs[far]
            # hand the stolen point over so the same donor isn't re-picked
            assign[far] = e
            counts[fat] -= 1
            counts[e] += 1
    assign = _assign(vecs, centroids, chunk, device)
    return centroids, assign


def bucket_capacity(n_items: int, clusters: int) -> int:
    """The shared padded bucket capacity: pow2 of twice the balanced mean.
    A skew-free build half-fills it; skew spills instead of inflating every
    bucket."""
    mean = -(-n_items // max(1, clusters))
    return next_pow2(max(1, PAD_SKEW_MODEL * mean))


def _bucketize(vecs: np.ndarray, assign: np.ndarray, clusters: int,
               centroids: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Capacity-bounded scatter into the padded [C, cap] layout. An
    overflowing cluster keeps its ``cap`` members closest to the centroid
    and spills the rest, nearest-first, to their nearest cluster with
    space. Returns (bucket_ids, bucket_vecs, balanced_assign)."""
    n = len(assign)
    cap = bucket_capacity(n, clusters)
    balanced = assign.astype(np.int32).copy()
    counts = np.bincount(balanced, minlength=clusters)
    if int(counts.max(initial=0)) > cap:
        d_own = ((vecs - centroids[balanced]) ** 2).sum(axis=1)
        spilled: list[int] = []
        for c in np.flatnonzero(counts > cap):
            members = np.flatnonzero(balanced == c)
            order = members[np.argsort(d_own[members], kind="stable")]
            spilled.extend(order[cap:])
        counts = np.minimum(counts, cap)
        sp = np.asarray(spilled, np.int64)
        d_all = (centroids * centroids).sum(axis=1)[None, :] - 2.0 * (vecs[sp] @ centroids.T)
        pref = np.argsort(d_all, axis=1, kind="stable")
        best = d_all[np.arange(len(sp)), pref[:, 0]]
        for row in np.argsort(best, kind="stable"):
            item = int(sp[row])
            for c in pref[row]:
                if counts[c] < cap:
                    balanced[item] = c
                    counts[c] += 1
                    break
    bucket_ids = np.full((clusters, cap), -1, np.int32)
    order = np.argsort(balanced, kind="stable")
    sorted_assign = balanced[order]
    starts = np.searchsorted(sorted_assign, np.arange(clusters))
    pos = np.arange(n) - starts[sorted_assign]
    bucket_ids[sorted_assign, pos] = order
    bucket_vecs = vecs[np.maximum(bucket_ids, 0)].astype(np.float32)
    bucket_vecs[bucket_ids < 0] = 0.0
    return bucket_ids, bucket_vecs, balanced


def _quantize_int8(bucket_vecs: np.ndarray, bucket_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-item symmetric int8: scale = max|x| / 127 per row; pad rows get
    scale 0 (their dequantized vector is exactly zero)."""
    amax = np.abs(bucket_vecs).max(axis=2)
    scale = (amax / 127.0).astype(np.float32)
    scale[bucket_ids < 0] = 0.0
    safe = np.where(scale > 0, scale, 1.0)[..., None]
    q = np.clip(np.rint(bucket_vecs / safe), -127, 127).astype(np.int8)
    q[bucket_ids < 0] = 0
    return q, scale


def build_index(vectors: np.ndarray, config: AnnConfig | None = None, *, model_version: str = "",
                built_from: str = "train", device: str | torch.device = "cuda") -> AnnIndex:
    """Full build: k-means (assignments on ``device``), bucketize, and the
    int8 quantization when configured. Deterministic for (vectors, config)
    on one device."""
    config = (config or AnnConfig()).resolved(len(vectors))
    vecs = np.ascontiguousarray(vectors, np.float32)
    if vecs.ndim != 2 or len(vecs) == 0:
        raise ValueError(f"need a [n, f] vector table, got shape {vecs.shape}")
    centroids, assign = kmeans(vecs, config.clusters, config.build_iters, config.seed,
                               config.assign_chunk, device)
    return _finish(vecs, centroids, assign, config, model_version, built_from)


def _finish(vecs: np.ndarray, centroids: np.ndarray, assign: np.ndarray, config: AnnConfig,
            model_version: str, built_from: str) -> AnnIndex:
    clusters = len(centroids)
    bucket_ids, bucket_vecs, _balanced = _bucketize(vecs, assign, clusters, centroids)
    bucket_scale = None
    if config.quantize_int8:
        bucket_vecs, bucket_scale = _quantize_int8(bucket_vecs, bucket_ids)
    return AnnIndex(
        centroids=centroids.astype(np.float32),
        bucket_ids=bucket_ids,
        bucket_vecs=bucket_vecs,
        bucket_scale=bucket_scale,
        nearest_assign=assign.astype(np.int32),
        n_items=len(vecs),
        nprobe=min(config.nprobe, clusters),
        model_version=model_version,
        built_from=built_from,
        config=config,
    )


def refresh_index(index: AnnIndex, vectors: np.ndarray, *, model_version: str = "",
                  device: str | torch.device = "cuda") -> tuple[AnnIndex, dict[str, Any]]:
    """Incremental refresh: assign the new vector table (updated and grown
    items) to the existing centroids and rebucket, without k-means. When the
    share of surviving items whose nearest centroid moved passes
    ``config.refresh_drift``, or the width changed, a full rebuild runs
    instead. Returns (new index, report with ``path`` and ``drift``)."""
    vecs = np.ascontiguousarray(vectors, np.float32)
    cfg = index.config
    if vecs.ndim != 2 or len(vecs) == 0:
        raise ValueError(f"need a [n, f] vector table, got shape {vecs.shape}")
    if vecs.shape[1] != index.dim:
        rebuilt = build_index(vecs, cfg, model_version=model_version, built_from="rebuild",
                              device=device)
        return rebuilt, {"path": "rebuild", "drift": 1.0, "reason": "dim-changed"}
    assign = _assign(vecs, index.centroids, cfg.assign_chunk, device)
    prev = index.assignments()
    shared = min(len(prev), len(assign))
    drift = float(np.mean(assign[:shared] != prev[:shared])) if shared else 1.0
    if drift > cfg.refresh_drift:
        rebuilt = build_index(vecs, cfg, model_version=model_version, built_from="rebuild",
                              device=device)
        return rebuilt, {"path": "rebuild", "drift": round(drift, 4), "reason": "drift-guard"}
    refreshed = _finish(vecs, index.centroids, assign, cfg, model_version, "refresh")
    return refreshed, {"path": "refresh", "drift": round(drift, 4)}


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------


class AnnFormatError(RuntimeError):
    """The blob is not a well-formed ANN index artifact."""


def serialize_index(index: AnnIndex) -> bytes:
    """magic + [u32 header length] + json header + raw C-order array bytes
    in header order. Deterministic for equal indexes."""
    arrays: dict[str, np.ndarray] = {
        "centroids": index.centroids,
        "bucket_ids": index.bucket_ids,
        "bucket_vecs": index.bucket_vecs,
    }
    if index.bucket_scale is not None:
        arrays["bucket_scale"] = index.bucket_scale
    if index.nearest_assign is not None:
        arrays["nearest_assign"] = index.nearest_assign
    header = {
        "meta": {
            "n_items": index.n_items,
            "nprobe": index.nprobe,
            "model_version": index.model_version,
            "built_from": index.built_from,
            "config": dataclasses.asdict(index.config),
        },
        "arrays": [
            {"name": name, "dtype": arr.dtype.str, "shape": list(arr.shape)}
            for name, arr in arrays.items()
        ],
    }
    head = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    parts = [_MAGIC, len(head).to_bytes(4, "big"), head]
    parts.extend(np.ascontiguousarray(arr).tobytes() for arr in arrays.values())
    return b"".join(parts)


def deserialize_index(blob: bytes) -> AnnIndex:
    if blob[: len(_MAGIC)] != _MAGIC:
        raise AnnFormatError("not an ANN index artifact (bad magic)")
    off = len(_MAGIC)
    head_len = int.from_bytes(blob[off : off + 4], "big")
    off += 4
    try:
        header = json.loads(blob[off : off + head_len].decode())
    except (ValueError, UnicodeDecodeError) as exc:
        raise AnnFormatError(f"corrupt index header: {exc}") from exc
    off += head_len
    arrays: dict[str, np.ndarray] = {}
    for spec in header["arrays"]:
        dtype = np.dtype(spec["dtype"])
        shape = tuple(int(s) for s in spec["shape"])
        n_bytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
        raw = blob[off : off + n_bytes]
        if len(raw) != n_bytes:
            raise AnnFormatError(f"truncated index artifact at array {spec['name']!r}")
        arrays[spec["name"]] = np.frombuffer(raw, dtype).reshape(shape).copy()
        off += n_bytes
    meta = header["meta"]
    known = {f.name for f in dataclasses.fields(AnnConfig)}
    config = AnnConfig(**{k: v for k, v in (meta.get("config") or {}).items() if k in known})
    try:
        return AnnIndex(
            centroids=arrays["centroids"],
            bucket_ids=arrays["bucket_ids"],
            bucket_vecs=arrays["bucket_vecs"],
            bucket_scale=arrays.get("bucket_scale"),
            nearest_assign=arrays.get("nearest_assign"),
            n_items=int(meta["n_items"]),
            nprobe=int(meta["nprobe"]),
            model_version=str(meta.get("model_version", "")),
            built_from=str(meta.get("built_from", "")),
            config=config,
        )
    except KeyError as exc:
        raise AnnFormatError(f"index artifact missing field {exc}") from exc
