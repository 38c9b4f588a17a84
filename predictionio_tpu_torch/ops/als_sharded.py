"""ALS across ranks: the port of ``predictionio_tpu/ops/als_sharded.py``.

The layout is the JAX package's (ALX-style):

  - Users and items are split into one contiguous block per rank along a
    mesh axis; each rank owns its blocks' factors for the whole run.
  - Ratings are partitioned twice on the host, by owning user block and by
    owning item block (:func:`_block_partition_blocked`, the same arrays as
    the JAX function), once per train; each rank uploads its own shard,
    its ratings as a uint8 dictionary when they fit one.
  - Each half-iteration all-gathers the opposite side's factor blocks (the
    only traffic between ranks, f * n_opposite * 4 bytes, or 2 with the
    bf16 wire of explicit mode) and solves its own block's systems with the
    port's ``_solve_blocked``: the block-Gram normal equations and kernel
    B1 on a card (``ops/spd_solve.py``), its plain version on the CPU.

Where JAX runs one ``shard_map`` per iteration over devices, here every
rank is a process of a ``torch.distributed`` job and runs the same loop;
the all-gather is :func:`~predictionio_tpu_torch.parallel.collectives.all_gather`
on the mesh axis. A mesh of one rank runs the single-device schedule.

The initial item factors are the rows of ``ops.als._als_init``'s draw
that a rank owns (padding rows zeroed), so a one-rank run starts where
``als_train`` starts; they differ from ``jax.random``'s numbers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from predictionio_tpu_torch.obs import xray
from predictionio_tpu_torch.ops.als import (
    ALSConfig,
    _als_init,
    _compress_ratings_wire,
    _host_group_by,
    _pad_blocks,
    _solve_blocked,
    upload,
)
from predictionio_tpu_torch.parallel.collectives import all_gather
from predictionio_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh


def _block_partition_blocked(
    owner_idx: np.ndarray,
    other_idx: np.ndarray,
    vals: np.ndarray,
    block: int,
    n_dev: int,
    d: int,
    block_chunk: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split COO by owning rank block, localize owner indices, and pack
    each rank's shard into the entity-block layout. All ranks are padded
    to one common block count with dummy blocks (local dummy row =
    ``block``). One global stable group-by: rank blocks are contiguous
    entity ranges, so grouping by entity also groups by rank; within an
    entity the original event order stays.

    Returns stacked [n_dev, NB], [n_dev, NB, d] x2, [n_dev, NB, d] arrays.
    """
    n_ent = n_dev * block
    cols_g, vals_g, deg = _host_group_by(
        owner_idx.astype(np.int32),
        other_idx.astype(np.int32),
        vals.astype(np.float32),
        n_ent,
    )
    start = np.concatenate([[0], np.cumsum(deg)])
    nblk = -(-deg // d)  # blocks per entity (0 for unrated entities)
    per_dev_blocks = nblk.reshape(n_dev, block).sum(axis=1)
    nb = _pad_blocks(int(per_dev_blocks.max()), block_chunk)
    br = np.full((n_dev, nb), block, np.int32)
    cols = np.zeros((n_dev, nb, d), np.int32)
    v = np.zeros((n_dev, nb, d), np.float32)
    w = np.zeros((n_dev, nb, d), np.int8)
    for dev in range(n_dev):
        e0, e1 = dev * block, (dev + 1) * block
        deg_l = deg[e0:e1]
        r0, r1 = int(start[e0]), int(start[e1])
        if r1 == r0:
            continue  # no ratings for this rank's entities
        nblk_l = nblk[e0:e1]
        block_base = np.concatenate([[0], np.cumsum(nblk_l)])
        # position of each grouped row within its entity -> (block, slot)
        p = np.arange(r1 - r0) - np.repeat(start[e0:e1] - r0, deg_l)
        eidx = np.repeat(np.arange(block), deg_l)
        cols[dev, block_base[eidx] + p // d, p % d] = cols_g[r0:r1]
        v[dev, block_base[eidx] + p // d, p % d] = vals_g[r0:r1]
        w[dev, block_base[eidx] + p // d, p % d] = 1
        br[dev, : int(block_base[-1])] = np.repeat(np.arange(block), nblk_l)
    return br, cols, v, w


def _put_vals(v: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a [nb, d] ratings table in its smallest lossless form: uint8
    dictionary codes and the value table, decoded on the device by one
    gather (pad zeros join the dictionary); the f32 table otherwise."""
    codes, table = _compress_ratings_wire(v.reshape(-1))
    if table is None or codes.dtype != np.uint8:
        return upload(v, np.float32, device)
    decoded = upload(table, device=device)[upload(codes, device=device).to(torch.int64)]
    return decoded.reshape(v.shape)


def _rank_tables(blocks, rank: int, device: torch.device) -> list[torch.Tensor]:
    """This rank's shard of one side's tables on ``device``: block rows and
    columns widened to int64 (torch gathers and ``index_add_``)."""
    br, cols, v, w = blocks
    return [
        upload(br[rank], device=device).to(torch.int64),
        upload(cols[rank], device=device).to(torch.int64),
        _put_vals(v[rank], device),
        upload(w[rank], device=device),
    ]


def _als_sharded_init(*, rank_index: int, bu: int, bi: int, rank: int, seed: int,
                      n_users: int, n_items: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's initial factors: zero users, and its rows of
    ``_als_init``'s item draw (+ the dummy row), rows at or past
    ``n_items`` zeroed so they do not bias the implicit-mode Gram term of
    the first user solve."""
    _, item_all = _als_init(n_users=n_users, n_items=n_items, rank=rank, seed=seed, device="cpu")
    rows = rank_index * bi + torch.arange(bi + 1)
    vf = torch.where((rows < n_items)[:, None], item_all[rows.clamp(max=n_items)], 0.0)
    return (torch.zeros(bu + 1, rank).to(device), vf.to(device))


def _sync(*tensors: torch.Tensor) -> None:
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()  # pio-lint: disable=train-unaccounted-sync -- the timing barrier of the pack/upload and all-gather parts the caller reports


def _als_sharded_step(
    uf: torch.Tensor,
    vf: torch.Tensor,
    u_br, u_cols, u_vals, u_w,
    i_br, i_cols, i_vals, i_w,
    *,
    mesh: Mesh,
    axis: str,
    bu: int,
    bi: int,
    rank: int,
    reg: float,
    implicit: bool,
    alpha: float,
    block_chunk: int,
    degree_scaled_reg: bool = True,
    solver: str = "cg",
    gather_dtype: str = "f32",
    gather_s: list | None = None,
):
    """One iteration on this rank: all-gather the items, solve the owned
    users, all-gather the users, solve the owned items. ``uf`` [bu+1, f]
    and ``vf`` [bi+1, f] carry one dummy row each. ``gather_s``, when
    given, receives the iteration's all-gather seconds (the card
    synchronised around each)."""
    n_dev = mesh.axis_size(axis)
    # bf16 across ranks only in EXPLICIT mode: it halves the collective
    # bytes and hands _solve_blocked the same bf16 rows the single-device
    # path gathers; implicit mode gathers f32 so that the shared VᵀV term is
    # computed from full-precision factors
    wire_bf16 = gather_dtype == "bf16" and not implicit
    spent = [0.0]

    def gather_side(local: torch.Tensor, block: int) -> torch.Tensor:
        send = local.to(torch.bfloat16) if wire_bf16 else local
        if gather_s is not None:
            _sync(send)
        t0 = time.perf_counter()
        full = all_gather(send[None], mesh, axis)  # [n_dev, block + 1, f]
        if gather_s is not None:
            _sync(full)
            spent[0] += time.perf_counter() - t0
        return full[:, :block].reshape(n_dev * block, rank)

    v_full = gather_side(vf, bi)
    uf = _solve_blocked(
        u_br, u_cols, u_vals, u_w, v_full, bu + 1, block_chunk, reg, implicit, alpha,
        degree_scaled_reg, solver, gather_dtype,
    )
    u_full = gather_side(uf, bu)
    vf = _solve_blocked(
        i_br, i_cols, i_vals, i_w, u_full, bi + 1, block_chunk, reg, implicit, alpha,
        degree_scaled_reg, solver, gather_dtype,
    )
    if gather_s is not None:
        gather_s.append(spent[0])
    return uf, vf


def _fetch(local: torch.Tensor, mesh: Mesh, axis: str, block: int) -> np.ndarray:
    """Every rank's owned rows, gathered to every rank and to the host:
    [n_dev * block, f] (dummy rows dropped)."""
    full = all_gather(local[None], mesh, axis)
    full = xray.device_fetch(full, where="als-sharded-fetch")
    # pio-lint: disable=train-unaccounted-sync -- a host tensor already: device_fetch above accounted the fetch
    return full[:, :block].reshape(-1, local.shape[1]).numpy()


def als_train_sharded(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    ratings: np.ndarray,
    n_users: int,
    n_items: int,
    config: ALSConfig,
    mesh: Mesh | None = None,
    axis: str = "data",
    timings: dict | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """ALS over the ranks of ``mesh`` (default: every rank of the job on
    one ``axis``); every rank passes the same ratings and gets the same
    host numpy (user_factors [n_users, f], item_factors [n_items, f]).
    One rank runs the single-device schedule.

    ``timings``, when given, receives ``pack_s`` (host partition),
    ``upload_s``, ``device_s`` (the iterations), ``gather_s`` (each
    iteration's all-gather seconds), ``n_dev`` and this rank's ``nb_u`` /
    ``nb_i``."""
    if mesh is None:
        mesh = make_mesh(MeshSpec(((axis, -1),)), device)
    dev = mesh.device
    n_dev, me = mesh.axis_size(axis), mesh.axis_index(axis)

    t0 = time.perf_counter()
    with xray.phase(xray.PHASE_HOST_ETL):
        user_idx = np.asarray(user_idx, np.int32)
        item_idx = np.asarray(item_idx, np.int32)
        ratings = np.asarray(ratings, np.float32)
        valid = (user_idx >= 0) & (item_idx >= 0)
        user_idx, item_idx, ratings = user_idx[valid], item_idx[valid], ratings[valid]
        for name, idx, bound in (("user", user_idx, n_users), ("item", item_idx, n_items)):
            if idx.shape[0] and int(idx.max()) >= bound:
                raise ValueError(f"{name} index {int(idx.max())} out of range for n_{name}s={bound}")
        bu = max(1, -(-n_users // n_dev))  # users per rank block
        bi = max(1, -(-n_items // n_dev))
        d = max(8, min(config.block_d, config.chunk))
        block_chunk = max(8, config.chunk // d)
        u_blocks = _block_partition_blocked(user_idx, item_idx, ratings, bu, n_dev, d, block_chunk)
        i_blocks = _block_partition_blocked(item_idx, user_idx, ratings, bi, n_dev, d, block_chunk)
        t_pack = time.perf_counter()
        tables = _rank_tables(u_blocks, me, dev) + _rank_tables(i_blocks, me, dev)
        del u_blocks, i_blocks
        uf, vf = _als_sharded_init(
            rank_index=me, bu=bu, bi=bi, rank=config.rank, seed=config.seed,
            n_users=n_users, n_items=n_items, device=dev,
        )
        _sync(*tables)
    t_upload = time.perf_counter()
    gather_s: list[float] | None = [] if timings is not None else None
    for _ in range(config.iterations):
        with xray.phase(xray.PHASE_SWEEP):
            uf, vf = _als_sharded_step(
                uf, vf, *tables, mesh=mesh, axis=axis, bu=bu, bi=bi, rank=config.rank,
                reg=config.reg, implicit=config.implicit, alpha=config.alpha,
                block_chunk=block_chunk, degree_scaled_reg=config.degree_scaled_reg,
                solver=config.solver, gather_dtype=config.gather_dtype, gather_s=gather_s,
            )
    _sync(uf, vf)
    t_device = time.perf_counter()
    with xray.phase(xray.PHASE_HOST_ETL):
        user_f = _fetch(uf, mesh, axis, bu)[:n_users]
        item_f = _fetch(vf, mesh, axis, bi)[:n_items]
    if timings is not None:
        timings.update(pack_s=t_pack - t0, upload_s=t_upload - t_pack, device_s=t_device - t_upload,
                       gather_s=gather_s, n_dev=n_dev, nb_u=int(tables[0].shape[0]),
                       nb_i=int(tables[4].shape[0]), d=d)
    return user_f, item_f
