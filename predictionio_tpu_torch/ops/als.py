"""Alternating least squares in PyTorch: the port of ``predictionio_tpu/ops/als.py``.

The formulation is the JAX package's: the COO rating list is packed into
fixed-width entity blocks (ALX layout), each half-iteration accumulates the
per-entity normal equations as one batched Gram product per chunk of blocks
plus a scatter-add of the per-block results, adds the ALS-WR degree-scaled
ridge, and solves every f-by-f system at once with the batched SPD solve
(kernel B1, ``ops/spd_solve.py``). See the JAX module's docstring for why
each of those choices was made.

What differs from the JAX module, and why:
  - PyTorch runs eagerly, so the scan over chunks is a Python loop and
    nothing is compiled; the block tables stay on the device across
    iterations as plain tensors.
  - Index tensors are int64 where they index (torch gathers and
    ``index_add_`` want int64); the block tables keep the JAX package's
    dtypes (int32 / f32 / int8) as built, and are widened once per train.
  - Out-of-range indices are never emitted: JAX drops an out-of-range
    scatter update and clips a gather, while torch raises on the CPU and
    trips a device-side assert on CUDA (which poisons the context). The
    host range checks stay, and ``_device_pack`` masks the start marks of
    trailing zero-degree entities explicitly.
  - ``index_add_`` on CUDA uses atomics, so sums differ at rounding from
    run to run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_auto
from predictionio_tpu_torch.utils import native
from predictionio_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    rank: int = 16
    iterations: int = 10
    reg: float = 0.1  # lambda
    implicit: bool = False
    alpha: float = 1.0  # implicit confidence scale
    seed: int = 3
    chunk: int = 16384  # COO entries per chunk (blocked: block_d * blocks)
    block_d: int = 128  # entity-block width
    # "cg" | "cg_fused" | "cholesky". cg and cg_fused are one algorithm
    # (Jacobi CG, f+4 iterations); both run kernel B1 on CUDA and its plain
    # version on the CPU. cholesky is the library factorisation.
    solver: str = "cg"
    # "auto" | "degree" | "constant" — ALS-WR regularisation scaling
    reg_scaling: str = "auto"
    # "f32" | "bf16": dtype of the gathered opposite-side rows only
    gather_dtype: str = "f32"
    # "auto" | "device" | "host": block tables built on the device from the
    # grouped wire form, or packed on the host (exact reference)
    pack: str = "auto"

    def __post_init__(self):
        if self.reg_scaling not in ("auto", "degree", "constant"):
            raise ValueError(
                f"reg_scaling must be auto|degree|constant, got {self.reg_scaling!r}"
            )
        if self.solver not in ("cg", "cg_fused", "cholesky"):
            raise ValueError(
                f"solver must be cg|cg_fused|cholesky, got {self.solver!r}"
            )
        if self.pack not in ("auto", "device", "host"):
            raise ValueError(f"pack must be auto|device|host, got {self.pack!r}")
        if self.gather_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"gather_dtype must be f32|bf16, got {self.gather_dtype!r}"
            )

    @property
    def degree_scaled_reg(self) -> bool:
        if self.reg_scaling == "auto":
            return not self.implicit
        return self.reg_scaling == "degree"


# ---------------------------------------------------------------------------
# Host packing (numpy)
# ---------------------------------------------------------------------------


def _block_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    d: int,
    block_chunk: int,
    dummy_row: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack a COO rating list into fixed-width entity blocks.

    Each entity owns ``ceil(degree / d)`` consecutive blocks of ``d``
    slots; unused slots carry weight 0. Returns ``(block_rows [NB],
    cols [NB, d], vals [NB, d], w [NB, d])`` with NB padded to a
    ``block_chunk`` multiple by blocks of ``dummy_row``; ``block_rows`` is
    sorted ascending.
    """
    n = rows.shape[0]
    if n == 0:
        nb = block_chunk
        return (
            np.full((nb,), dummy_row, np.int32),
            np.zeros((nb, d), np.int32),
            np.zeros((nb, d), np.float32),
            np.zeros((nb, d), np.int8),
        )
    order = np.argsort(rows, kind="stable")
    r, c, v = rows[order], cols[order], vals[order]
    uniq, start, deg = np.unique(r, return_index=True, return_counts=True)
    nblk = -(-deg // d)
    block_base = np.concatenate([[0], np.cumsum(nblk)])
    nb_real = int(block_base[-1])
    nb = _pad_blocks(nb_real, block_chunk)
    p = np.arange(n) - np.repeat(start, deg)
    eidx = np.repeat(np.arange(len(uniq)), deg)
    dest_block = block_base[eidx] + p // d
    dest_slot = p % d
    cols_pad = np.zeros((nb, d), np.int32)
    vals_pad = np.zeros((nb, d), np.float32)
    w_pad = np.zeros((nb, d), np.int8)
    cols_pad[dest_block, dest_slot] = c
    vals_pad[dest_block, dest_slot] = v
    w_pad[dest_block, dest_slot] = 1
    block_rows = np.full((nb,), dummy_row, np.int32)
    block_rows[:nb_real] = np.repeat(uniq, nblk)
    return block_rows, cols_pad, vals_pad, w_pad


def _compress_ratings_wire(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
    """Smallest lossless wire form of the ratings column: uint8 dictionary
    codes plus an f32 value table when there are at most 256 distinct
    values, else f16 when every value round-trips, else f32."""
    if vals.shape[0] == 0:
        return vals, None
    sample_uniq = np.unique(vals[:65536])
    if 0 < sample_uniq.size <= 256:
        idx = np.searchsorted(sample_uniq, vals)
        idx = np.minimum(idx, sample_uniq.size - 1)
        if np.array_equal(sample_uniq[idx], vals):
            return idx.astype(np.uint8), sample_uniq.astype(np.float32)
    v16 = vals.astype(np.float16)
    if np.array_equal(v16.astype(np.float32), vals):
        return v16, None
    return vals, None


def _host_group_by(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_entities: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable group-by-entity: the host library's counting sort
    (``utils/native.coo_group``, one pass each for histogram and scatter),
    as the JAX package does. Ids must lie in [0, n_entities), or it raises:
    an oversized id would corrupt every block table."""
    return native.coo_group(rows, cols, vals, n_entities)


def _host_group_by_plain(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_entities: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``_host_group_by``'s plain version (numpy stable argsort), which
    tests and chip_smoke.py hold it to bit for bit."""
    order = np.argsort(rows, kind="stable")
    deg = np.bincount(rows, minlength=n_entities).astype(np.int32)
    return cols[order], vals[order], deg


def _pad_blocks(nb_real: int, block_chunk: int) -> int:
    return max(nb_real + (-nb_real) % block_chunk, block_chunk)


# ---------------------------------------------------------------------------
# Device-side table build
# ---------------------------------------------------------------------------


def _expand_blocks_traced(deg, cols_sorted, vals_sorted, d: int, nb: int, dummy_row: int):
    """Device-side equivalent of ``_block_coo`` for an already-grouped side:
    ``deg`` [E] per-entity counts, ``cols_sorted``/``vals_sorted`` grouped by
    entity. Builds the [nb, d] tables with searchsorted and gathers only."""
    dev = deg.device
    n_entities = deg.shape[0]
    deg = deg.to(torch.int64)
    nblk = (deg + (d - 1)) // d
    bb_incl = torch.cumsum(nblk, 0)
    block_base = bb_incl - nblk
    start = torch.cumsum(deg, 0) - deg
    b = torch.arange(nb, dtype=torch.int64, device=dev)
    # owner[b] = first entity whose inclusive block prefix exceeds b;
    # == n_entities for pad blocks past the real range
    owner = torch.searchsorted(bb_incl, b, right=True)
    is_real = owner < n_entities
    e = torch.clamp(owner, max=n_entities - 1)
    local = b - block_base[e]
    offs = local[:, None] * d + torch.arange(d, dtype=torch.int64, device=dev)[None, :]
    valid = is_real[:, None] & (offs < deg[e][:, None])
    src = torch.where(valid, start[e][:, None] + offs, 0)
    cols_b = torch.where(valid, cols_sorted[src], 0).to(torch.int32)
    vals_b = torch.where(valid, vals_sorted[src], 0.0).to(torch.float32)
    w_b = valid.to(torch.int8)
    block_rows = torch.where(is_real, e, dummy_row).to(torch.int32)
    return block_rows, cols_b, vals_b, w_b


def _device_pack(
    cols_u: torch.Tensor,  # [nnz] item ids grouped by user (int16 or int32 wire)
    vals_u: torch.Tensor,  # [nnz] ratings grouped by user (uint8 codes / f16 / f32)
    deg_u: torch.Tensor,  # [n_users] int32 per-user rating count
    deg_i: torch.Tensor,  # [n_items] int32 per-item rating count
    val_table: torch.Tensor | None = None,  # [<=256] f32 table for uint8 codes
    *,
    d: int,
    nb_u: int,
    nb_i: int,
    n_users: int,
    n_items: int,
):
    """Build both sides' block tables on the device from the wire form.

    The user column is implicit in the grouped order: +1 at each user's
    start position, then a cumulative sum. Users of degree 0 at the end
    start at ``nnz``, past the array; their marks are dropped here (JAX
    drops the out-of-range update silently). The item-side order comes from
    one stable sort of the item column.
    """
    nnz = cols_u.shape[0]
    items_u = cols_u.to(torch.int64)
    if val_table is not None:
        ratings_u = val_table[vals_u.to(torch.int64)]
    else:
        ratings_u = vals_u.to(torch.float32)
    deg_u64 = deg_u.to(torch.int64)
    start_u = torch.cumsum(deg_u64, 0) - deg_u64
    marks = start_u[1:]
    marks = marks[marks < nnz]
    users_u = torch.cumsum(torch.bincount(marks, minlength=nnz), 0)
    u_tables = _expand_blocks_traced(deg_u, items_u, ratings_u, d, nb_u, n_users)
    _, order = torch.sort(items_u, stable=True)
    i_tables = _expand_blocks_traced(
        deg_i, users_u[order], ratings_u[order], d, nb_i, n_items
    )
    return (*u_tables, *i_tables)


# ---------------------------------------------------------------------------
# Normal equations and solve
# ---------------------------------------------------------------------------


def _normal_equations_blocked(
    block_rows: torch.Tensor,  # [NB] owning entity per block (int64)
    cols: torch.Tensor,  # [NB, D] opposite-entity indices (int64)
    vals: torch.Tensor,  # [NB, D] ratings (0 in pad slots)
    w: torch.Tensor,  # [NB, D] 1 real / 0 pad
    opposite: torch.Tensor,  # [n_opp, f] fixed factors
    n_entities: int,
    block_chunk: int,
    implicit: bool,
    alpha: float,
    gather_dtype: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accumulate A [E, f, f], b [E, f] and counts [E]: per chunk of blocks,
    one batched Gram product (``bdf,bdg->bfg``) and one scatter-add of the
    per-block results. ``gather_dtype="bf16"`` rounds only the gathered
    rows; weights and accumulators stay f32."""
    f = opposite.shape[1]
    dev = opposite.device
    gathered = opposite.to(torch.bfloat16) if gather_dtype == "bf16" else opposite
    A = torch.zeros((n_entities, f, f), dtype=torch.float32, device=dev)
    b = torch.zeros((n_entities, f), dtype=torch.float32, device=dev)
    n = torch.zeros((n_entities,), dtype=torch.float32, device=dev)
    for s in range(0, block_rows.shape[0], block_chunk):
        br = block_rows[s : s + block_chunk]
        ww = w[s : s + block_chunk].to(torch.float32)
        v = vals[s : s + block_chunk]
        vecs = gathered[cols[s : s + block_chunk]].to(torch.float32)  # [CB, D, f]
        if implicit:
            ow = ww * (alpha * v)  # (conf - 1), 0 in pad slots
            bw = ww * (1.0 + alpha * v)
        else:
            ow = ww
            bw = ww * v
        A_blk = torch.bmm((ow[..., None] * vecs).transpose(1, 2), vecs)
        b_blk = torch.bmm(bw[:, None, :], vecs)[:, 0, :]
        A.index_add_(0, br, A_blk)
        b.index_add_(0, br, b_blk)
        n.index_add_(0, br, ww.sum(dim=-1))
    return A, b, n


def _batched_spd_solve(A: torch.Tensor, b: torch.Tensor, solver: str) -> torch.Tensor:
    """Solve n independent f-by-f SPD systems. ``cg`` and ``cg_fused`` are
    the same Jacobi CG: kernel B1 for CUDA tensors, its plain version for
    CPU tensors. ``cholesky`` is the library factorisation."""
    if solver == "cholesky":
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return batched_spd_solve_auto(A, b)


def _normal_system(
    block_rows,
    cols,
    vals,
    w,
    opposite,
    n_entities,
    block_chunk,
    reg,
    implicit,
    alpha,
    degree_scaled_reg: bool,
    gather_dtype: str = "f32",
):
    """The regularised normal equations (A [E, f, f], b [E, f]) of one side."""
    f = opposite.shape[1]
    A, b, counts = _normal_equations_blocked(
        block_rows, cols, vals, w, opposite, n_entities, block_chunk, implicit,
        alpha, gather_dtype,
    )
    eye = torch.eye(f, dtype=A.dtype, device=A.device)
    if implicit:
        A += (opposite.T @ opposite)[None, :, :]  # shared dense term
    if degree_scaled_reg:
        A += (reg * torch.clamp(counts, min=1.0))[:, None, None] * eye[None, :, :]
    else:
        A += reg * eye[None, :, :]
    return A, b


def _solve_blocked(
    block_rows,
    cols,
    vals,
    w,
    opposite,
    n_entities,
    block_chunk,
    reg,
    implicit,
    alpha,
    degree_scaled_reg: bool,
    solver: str = "cg",
    gather_dtype: str = "f32",
):
    A, b = _normal_system(
        block_rows, cols, vals, w, opposite, n_entities, block_chunk, reg,
        implicit, alpha, degree_scaled_reg, gather_dtype,
    )
    return _batched_spd_solve(A, b, solver)


def _als_step(
    user_factors,
    item_factors,
    u_br,
    u_cols,
    u_vals,
    u_w,
    i_br,
    i_cols,
    i_vals,
    i_w,
    *,
    n_users: int,
    n_items: int,
    reg: float,
    implicit: bool,
    alpha: float,
    block_chunk: int,
    degree_scaled_reg: bool = True,
    solver: str = "cg",
    gather_dtype: str = "f32",
):
    """One ALS iteration: solve users against fixed items, then items
    against the new users. Factor tables carry one dummy row each."""
    user_factors = _solve_blocked(
        u_br, u_cols, u_vals, u_w, item_factors, n_users + 1, block_chunk,
        reg, implicit, alpha, degree_scaled_reg, solver, gather_dtype,
    )
    item_factors = _solve_blocked(
        i_br, i_cols, i_vals, i_w, user_factors, n_items + 1, block_chunk,
        reg, implicit, alpha, degree_scaled_reg, solver, gather_dtype,
    )
    return user_factors, item_factors


def _als_init(*, n_users: int, n_items: int, rank: int, seed: int, device):
    """Initial factors from a ``torch.Generator`` seeded with ``seed``,
    drawn on the CPU so every device starts from the same numbers (they
    differ from ``jax.random``'s)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    item_factors = torch.randn(n_items + 1, rank, generator=gen) / np.sqrt(rank)
    user_factors = torch.zeros(n_users + 1, rank)
    return (
        user_factors.to(device=device, dtype=torch.float32),
        item_factors.to(device=device, dtype=torch.float32),
    )


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def fetch_barrier(*tensors: torch.Tensor) -> float:
    """True completion barrier: synchronise the card, then fetch one scalar
    derived from every input, which cannot exist before they do. Returns
    the checksum so the fetch is not elided."""
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()  # pio-lint: disable=train-unaccounted-sync -- this IS the timing instrument; callers time around it
    total = 0.0
    for t in tensors:
        total += float(t.sum(dtype=torch.float32).item())  # pio-lint: disable=train-unaccounted-sync -- the instrument's checksum fetch
    return total


def upload(x, dtype=None, device: str | torch.device = "cuda") -> torch.Tensor:
    """Host-to-device upload that always copies. ``torch.from_numpy``
    aliases host memory; the serving path stages batches in reused scratch
    buffers and overwrites them while the previous batch may still be in
    flight, so the device tensor must own its bytes. Tensors pass through."""
    if isinstance(x, torch.Tensor):
        return x
    # pio-lint: disable=train-unaccounted-sync,serving-host-roundtrip -- host staging array (tensors returned above), never a device round-trip
    arr = np.asarray(x) if dtype is None else np.asarray(x, dtype)
    return torch.tensor(arr, device=device)


def pack_tables(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    device: str | torch.device = "cuda",
    timings: dict | None = None,
) -> tuple[list[torch.Tensor], int]:
    """Range-check the ratings and build both sides' block tables on
    ``device``: ``[u_br, u_cols, u_vals, u_w, i_br, i_cols, i_vals, i_w]``
    with the index tables widened to int64, and the blocks per chunk.
    With ``timings``, records ``pack_s``, ``upload_s`` and ``build_s``,
    each closed by a barrier."""
    dev = resolve_device(device)
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    ratings = np.asarray(ratings, np.float32)
    valid = (user_idx >= 0) & (item_idx >= 0)
    user_idx, item_idx, ratings = user_idx[valid], item_idx[valid], ratings[valid]
    if user_idx.shape[0]:
        for name, idx, bound in (
            ("user", user_idx, n_users),
            ("item", item_idx, n_items),
        ):
            mx = int(idx.max())
            if mx >= bound:
                raise ValueError(
                    f"{name} index {mx} out of range for n_{name}s={bound}"
                )
    d = max(8, min(config.block_d, config.chunk))
    block_chunk = max(8, config.chunk // d)
    use_device_pack = config.pack != "host" and user_idx.shape[0] > 0

    t0 = time.perf_counter()
    if use_device_pack:
        cols_u, vals_u, deg_u = _host_group_by(user_idx, item_idx, ratings, n_users)
        deg_i = np.bincount(item_idx, minlength=n_items).astype(np.int32)
        nb_u = _pad_blocks(int((-(-deg_u // d)).sum()), block_chunk)
        nb_i = _pad_blocks(int((-(-deg_i // d)).sum()), block_chunk)
        if n_items <= np.iinfo(np.int16).max:
            cols_u = cols_u.astype(np.int16)
        vals_u, val_table = _compress_ratings_wire(vals_u)
        t_pack = time.perf_counter()
        wire = [upload(a, device=dev) for a in (cols_u, vals_u, deg_u, deg_i)]
        table_dev = upload(val_table, device=dev) if val_table is not None else None
        if timings is not None:
            fetch_barrier(*wire)
        t_upload = time.perf_counter()
        tables = list(
            _device_pack(
                *wire, val_table=table_dev,
                d=d, nb_u=nb_u, nb_i=nb_i, n_users=n_users, n_items=n_items,
            )
        )
        if timings is not None:
            fetch_barrier(tables[0], tables[4])
        t_build = time.perf_counter()
    else:
        u_blocks = _block_coo(user_idx, item_idx, ratings, d, block_chunk, n_users)
        i_blocks = _block_coo(item_idx, user_idx, ratings, d, block_chunk, n_items)
        t_pack = time.perf_counter()
        tables = [upload(a, device=dev) for a in (*u_blocks, *i_blocks)]
        if timings is not None:
            fetch_barrier(*tables)
        t_upload = time.perf_counter()
        t_build = t_upload
    # widen the indices once: torch gathers and index_add_ take int64
    for k in (0, 1, 4, 5):
        tables[k] = tables[k].to(torch.int64)
    if timings is not None:
        timings["pack_s"] = t_pack - t0
        timings["upload_s"] = t_upload - t_pack
        timings["build_s"] = t_build - t_upload
        timings["nb_u"] = int(tables[0].shape[0])
        timings["nb_i"] = int(tables[4].shape[0])
        timings["d"] = d
    return tables, block_chunk


def als_train(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    timings: dict | None = None,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Train explicit or implicit ALS on ``device``; returns (user_factors
    [n_users, f], item_factors [n_items, f]) as tensors on that device.

    Pass a ``timings`` dict for a wall-clock decomposition: ``pack_s`` (host
    group-by or block packing), ``upload_s`` (host-to-device copy of the
    wire arrays), ``build_s`` (device-side block tables; 0 on the host pack
    path), ``device_s`` (solver iterations), each closed by a barrier, plus
    the block-table shapes ``nb_u``, ``nb_i`` and ``d``.
    """
    dev = resolve_device(device)
    tables, block_chunk = pack_tables(
        user_idx, item_idx, ratings, n_users, n_items, config, dev, timings
    )
    t_build = time.perf_counter()
    user_f, item_f = _als_init(
        n_users=n_users, n_items=n_items, rank=config.rank, seed=config.seed,
        device=dev,
    )
    for _ in range(config.iterations):
        user_f, item_f = _als_step(
            user_f,
            item_f,
            *tables,
            n_users=n_users,
            n_items=n_items,
            reg=config.reg,
            implicit=config.implicit,
            alpha=config.alpha,
            block_chunk=block_chunk,
            degree_scaled_reg=config.degree_scaled_reg,
            solver=config.solver,
            gather_dtype=config.gather_dtype,
        )
    if timings is not None:
        fetch_barrier(user_f, item_f)
        timings["device_s"] = time.perf_counter() - t_build
    return user_f[:n_users], item_f[:n_items]


def solver_hbm_bytes_per_iter(
    nb_u: int,
    nb_i: int,
    d: int,
    f: int,
    n_users: int,
    n_items: int,
    *,
    gather_dtype: str = "f32",
    solver: str = "cg",
    implicit: bool = False,
) -> int:
    """Memory traffic one ALS iteration (both half-solves) requires, in
    bytes: the block stream and factor-row gather, the Gram scatter-adds,
    the A assembly pass, the solve, and implicit mode's shared Gram. The
    solve term models the whole-array CG (f+4 passes over A); the CUDA
    kernel reads A once."""
    gb = 2 if gather_dtype == "bf16" else 4
    total = 0
    for nb, n_ent, n_opp in (
        (nb_u, n_users + 1, n_items + 1),
        (nb_i, n_items + 1, n_users + 1),
    ):
        stream = nb * d * (9 + f * gb)
        gram_scatter = 2 * nb * (f * f + f + 1) * 4
        assemble = 2 * n_ent * f * f * 4
        if solver == "cg":
            solve = (f + 4) * n_ent * (f * f + 8 * f) * 4
        else:
            solve = 2 * n_ent * f * f * 4
        shared = n_opp * f * 4 if implicit else 0
        total += stream + gram_scatter + assemble + solve + shared
    return int(total)


# ---------------------------------------------------------------------------
# Serving-side scoring
# ---------------------------------------------------------------------------
#
# Factor tables stay resident on the device; a query uploads user indices
# and the answer comes back as ONE packed int32 fetch: row 0 carries the
# float32 score bits (``.view(torch.int32)``), row 1 the item indices.


def _pack(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.stack([scores.view(torch.int32), idx.to(torch.int32)])


def _unpack(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    return packed[0].view(np.float32), packed[1]


def _serve_by_index(uidx, user_factors, item_factors, mask, k: int):
    scores = item_factors @ user_factors[uidx]  # [n_items]
    scores = torch.where(mask, scores, float("-inf"))
    s, i = torch.topk(scores, k)
    return _pack(s, i)


def _serve_by_index_batch(uidxs, user_factors, item_factors, mask, k: int):
    scores = user_factors[uidxs] @ item_factors.T  # [B, n_items]
    scores = torch.where(mask[None, :], scores, float("-inf"))
    s, i = torch.topk(scores, k, dim=1)
    return torch.stack([s.view(torch.int32), i.to(torch.int32)], dim=1)


def predict_scores(user_vec: torch.Tensor, item_factors: torch.Tensor) -> torch.Tensor:
    """Every item's score for one user vector, on the tensors' device."""
    return item_factors @ user_vec


def top_k_items(
    user_vec: torch.Tensor,
    item_factors: torch.Tensor,
    k: int,
    mask: torch.Tensor | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """One-shot top-k for an explicit user vector; one packed fetch.
    ``mask`` False = excluded item. Prefer ``ServingIndex`` on the serving
    path: it also keeps the user table resident."""
    if mask is None:
        mask = torch.ones(item_factors.shape[0], dtype=torch.bool, device=item_factors.device)
    scores = torch.where(mask, predict_scores(user_vec, item_factors), float("-inf"))
    # pio-lint: disable=train-unaccounted-sync -- serving-path fetch, accounted by the request waterfall
    return _unpack(_pack(*torch.topk(scores, k)).cpu().numpy())


def next_pow2(n: int) -> int:
    """Bucket-rounding rule of the batched predict path."""
    return 1 << max(0, n - 1).bit_length()


class ServingIndex:
    """Device-resident factor tables with index-addressed top-k serve. Per
    query: one int upload and one packed [2, k] int32 fetch."""

    def __init__(self, user_factors, item_factors, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.user_factors = upload(user_factors, np.float32, self.device).to(
            device=self.device, dtype=torch.float32
        )
        self.item_factors = upload(item_factors, np.float32, self.device).to(
            device=self.device, dtype=torch.float32
        )
        self._full_mask = torch.ones(
            (self.item_factors.shape[0],), dtype=torch.bool, device=self.device
        )

    @property
    def n_users(self) -> int:
        return self.user_factors.shape[0]

    @property
    def n_items(self) -> int:
        return self.item_factors.shape[0]

    def _mask(self, mask) -> torch.Tensor:
        if mask is None:
            return self._full_mask
        return upload(mask, np.bool_, self.device).to(self.device)

    def warmup(self, k: int) -> None:
        """First launch of the single-query path (cuBLAS handle and
        workspace creation happen here, not on the first request)."""
        self.serve(0, min(k, self.n_items))

    def warmup_buckets(self, k: int, max_batch: int) -> None:
        """One launch per power-of-two batch bucket up to ``max_batch``.
        Nothing compiles in eager PyTorch; this touches each shape once."""
        kk = min(next_pow2(k), self.n_items)
        b = 1
        while b <= next_pow2(max_batch):
            self.serve_batch(np.zeros((b,), np.int32), kk)
            b *= 2

    def serve(self, user_index: int, k: int, mask=None) -> tuple[np.ndarray, np.ndarray]:
        """Top-k (scores, item indices) for one user index."""
        packed = _serve_by_index(
            int(user_index), self.user_factors, self.item_factors, self._mask(mask), k
        )
        # pio-lint: disable=train-unaccounted-sync -- serving-path fetch, accounted by the request waterfall
        return _unpack(packed.cpu().numpy())

    def serve_batch(self, user_indices, k: int, mask=None) -> tuple[np.ndarray, np.ndarray]:
        """[B] indices -> ([B, k] scores, [B, k] items)."""
        return self.unpack_batch(
            # pio-lint: disable=train-unaccounted-sync -- serving-path fetch, accounted by the request waterfall
            self.serve_batch_async(user_indices, k, mask).cpu().numpy()
        )

    def serve_batch_async(self, user_indices, k: int, mask=None) -> torch.Tensor:
        """Launch the batched top-k and return the packed [B, 2, k] int32
        device tensor without fetching it; decode with ``unpack_batch``."""
        if isinstance(user_indices, torch.Tensor):
            idxs = user_indices.to(device=self.device, dtype=torch.int64)
        else:
            # upload() copies: callers stage indices in reused scratch buffers
            idxs = upload(user_indices, np.int64, self.device)
        return _serve_by_index_batch(
            idxs, self.user_factors, self.item_factors, self._mask(mask), k
        )

    @staticmethod
    def unpack_batch(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Decode a fetched [B, 2, k] packed result into ([B, k] float32
        scores, [B, k] int32 item indices)."""
        return (
            np.ascontiguousarray(packed[:, 0, :]).view(np.float32),
            packed[:, 1, :],
        )
