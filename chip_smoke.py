#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:
``python3 chip_smoke.py``. It builds the CUDA kernels from the checkout's
sources (nvcc, one process per source, all started together, into
build/kernels/), then drives the main path of every template.

The recommendation template (ALS, kernel B1):

1. kernel phase: kernel B1 (csrc/spd_cg.cu) against its plain PyTorch
   version on the card, on well-conditioned systems at ranks
   10/16/32/64/100 and, one block per system, 160 and 256; then one
   system at f = 11,700, past a block's shared memory (the grid plan);
2. train phase: the recommendation template's ALSAlgorithm.train at the
   ML-20M shape (138,000 users x 27,000 items x 20 M synthetic ratings,
   rank 32, 10 iterations), held-out RMSE gated at 0.45, with B1's launch
   count read around the run; then B1 against the plain version on the
   real user-side and item-side systems of that model and on 138,001
   rank-10 systems, each timed beside the plain version and a library
   Cholesky solve, eager (``ms``) and as a replayed CUDA graph
   (``graph_ms``);
3. serve phase: the port's CLI in subprocesses (app new, import of an
   ML-100K-shape event file, train, deploy) answering POST /queries.json,
   then the ML-20M model served in-process through ServingIndex.serve_batch
   and checked against a plain torch.topk;
4. rank 160: ALSAlgorithm.train at the ML-1M shape through B1's
   block-per-system plan, B1 against the plain version on its user-side
   systems and on 2,048 rank-256 systems, each timed.

The sequential template (attention scorer, kernels B1, B2 and B3):

5. kernel phase: B2 (csrc/attention_block.cu) and B3
   (csrc/flash_attention.cu) against their plain versions and the f32
   reference, causal and not, at the scorer's widths, at ragged lengths,
   with Lq != Lk, at head widths 160 and 256 and, for B2, with a
   10,000-key axis and at 70,000 batch·heads;
6. train phase: AttentionAlgorithm.train at the ML-1M shape (6,040 users x
   3,706 items x 1,000,209 synthetic view events from the bench's hop
   generator, rank 32, 10 iterations), B1's launches read around it, and
   held-out hit-rate@10 of the attention and Markov scorers;
7. serve phase: that model through AttentionAlgorithm.predict_batch_dispatch
   in batches of 64 at context 8, 200 and 1024, with B2's (or B3's)
   launches read around each context, served scores held against a
   torch.topk over the plain-version session vectors, and each kernel
   timed at its serving shape beside its bound, its plain version and
   torch's scaled_dot_product_attention as a yardstick: eager calls by CUDA
   events (``ms``, host cost included) and a replayed CUDA graph
   (``graph_ms``, device time per launch);
8. CLI phase: app new, import of an ML-100K-shape view file, train and
   deploy of the attention algorithm, then POST /queries.json.

The two-tower template (its history encoder through B2, forward in
training and serving):

9. train phase: TwoTowerAlgorithm.train at full width (138,000 users x
   27,000 items, embed 64, hidden [128], out 32, 2 heads, historyLen 256,
   batch 4096) for one epoch of 488 steps over 2,000,000 ML-20M-shape
   ratings, one B2 launch per step, a finite falling loss; the step split
   into B2's forward, the attention backward, Adam and the rest;
10. serve phase: predict_batch_dispatch in batches of 64 with histories,
   one B2 launch per dispatch, held against the plain version; B2 timed
   at the training and serving shapes beside its bound and SDPA;
11. quality phase: recall@10 on the bench's clustered data with and
   without a 32-item encoder;
12. CLI phase: app new, import, train with historyLen 50 from an
   engine.json naming the JAX package's factory string, deploy, POST
   /queries.json.

The rest of the template gallery (similar-product, e-commerce and
recommended-user train implicit ALS through kernel B1 at rank 10):

13. similar-product: the multi-events-multi-algos variant at the ML-1M
   shape (views-ALS, like-ALS, cooccurrence n = 20), B1 on the views
   train's own systems, batches of 64 filtered queries checked against
   their filters and the plain product; the same-cluster share of the
   top-10 on the bench's clustered data;
14. e-commerce: 20,000 users x 10,000 items, 1.2 M events in the store,
   trains at 10 and (adjust-score) 20 iterations, batches of 64 known and
   cold users with live store reads at cacheTtlS 0 and 60;
15. recommended-user: 50,000 users in 50 communities, 1,000,000 follows,
   the same-community share of the top-10;
16. classification: naive Bayes scores of 200,000 points on the card
   against the float64 host labels; the add-algorithm variant from the
   store;
17. CLI: each of the four from the JAX package's engine.json, app new ->
   import -> train (the four side by side) -> deploy -> 200 queries (one
   server at a time).

Every phase that fails raises, so the script exits non-zero and prints no
result. The last line is ``{"ok": true, "device": {...}}``; the line before
it is nvidia-smi's name and power limit; before that one JSON line lists
every kernel with its launches on the main paths, errors and times.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
# special-function (exp) rate, the figure FlashAttention-3 uses (Shah et al. 2024)
H100_EXP_PER_S = 3.9e12
SOURCE = "predictionio_tpu_torch/ops/csrc/spd_cg.cu"
REPLACES = "predictionio_tpu/ops/spd_solve.py:76"
KERNELS = ["spd_cg", "attention_block", "flash_attention"]


_T0 = time.perf_counter()


def emit(**fields) -> None:
    """One JSON line of a phase's results, with the script's elapsed seconds."""
    print(json.dumps({**fields, "elapsed_s": time.perf_counter() - _T0}), flush=True)


def synthesize_ratings(n_users: int, n_items: int, n_ratings: int, seed: int = 0):
    """The bench's synthetic ratings (bench.py:136): low-rank + noise with a
    zipf item popularity, quantised to half stars."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n_ratings).astype(np.int32)
    items = (rng.zipf(1.3, n_ratings).astype(np.int64) % n_items).astype(np.int32)
    k = 8
    U = rng.normal(size=(n_users, k)) / np.sqrt(k)
    V = rng.normal(size=(n_items, k)) / np.sqrt(k)
    vals = np.clip(
        np.sum(U[users] * V[items], axis=1) + 3.0 + 0.3 * rng.normal(size=n_ratings),
        1.0,
        5.0,
    ).astype(np.float32)
    return users, items, (np.round(vals * 2.0) / 2.0).astype(np.float32)


def spd_batch(n: int, f: int, seed: int, reg: float = 0.05):
    """ALS-shaped systems (tests/test_spd_solve.py:18): Gram of random data
    plus a scaled ridge."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, 3 * f, f)).astype(np.float32)
    # a batched BLAS product: the unoptimised einsum took over a minute at f = 256
    A = np.matmul(G.transpose(0, 2, 1), G) + reg * (3 * f) * np.eye(f, dtype=np.float32)
    return A.astype(np.float32), rng.normal(size=(n, f)).astype(np.float32)


def cg_bound_ms(n: int, f: int) -> tuple[float, str]:
    """Least time for B1's work: A and b read once, x written once, against
    the f32 operations of f+4 preconditioned CG steps."""
    iters = f + 4
    nbytes = n * (f * f + 2 * f) * 4
    flops = n * (2 * f * f + 6 * f + iters * (2 * f * f + 11 * f))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch) -> None:
    """B1 against its plain version: ranks 10..100 (atol 1e-4), and past
    rank 128, one block per system with A in shared memory (160) and read
    from device memory (256), row-relative 1e-4."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused, launch_plan

    for f in (10, 16, 32, 64, 100, 160, 256):
        n = 1000 + 7 * f + 3  # not a multiple of any tile
        A, b = spd_batch(n, f, seed=f)
        A_d, b_d = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        x = batched_spd_solve_fused(A_d, b_d)
        ref = _cg_body(A_d, b_d, f + 4)
        torch.cuda.synchronize()
        err = float((x - ref).abs().max())
        row_rel = float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)).max())
        # atol 1e-4: the same f32 algorithm, summed in another order over f+4 steps
        ok = err <= 1e-4 if f <= 128 else row_rel <= 1e-4
        if not (torch.isfinite(x).all() and ok):
            raise AssertionError(f"B1 disagrees with _cg_body at f={f}: max abs err {err}, "
                                 f"row-relative {row_rel}")
        emit(phase="kernel", kernel="spd_cg", n=n, f=f, plan=launch_plan(f).kernel,
             max_abs_err=err, max_row_rel_err=row_rel,
             limit={"atol": 1e-4} if f <= 128 else {"row_rel": 1e-4})


def kernel_grid_phase(torch) -> dict:
    """B1 past f = 11,619 (the grid plan, vectors in a device scratch
    buffer): one system at f = 11,700 (A 548 MB, M Mᵀ/f + 0.5 I from a seeded
    generator on the card) against the plain version at row-relative 1e-3,
    each timed once beside the library Cholesky."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused, launch_plan
    from predictionio_tpu_torch.utils.cuda_timing import event_ms

    f = 11_700
    gen = torch.Generator(device="cuda").manual_seed(11)
    M = torch.randn(f, f, generator=gen, device="cuda")
    A = (M @ M.T / f + 0.5 * torch.eye(f, device="cuda"))[None].contiguous()
    del M
    b = torch.randn(1, f, generator=gen, device="cuda")
    x = batched_spd_solve_fused(A, b)
    ref = _cg_body(A, b, f + 4)
    row_rel = float(((x - ref).norm(dim=1) / ref.norm(dim=1)).max())
    if not (torch.isfinite(x).all() and row_rel <= 1e-3):
        raise AssertionError(f"B1 at f = {f}: row-relative error {row_rel} against _cg_body")

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(L, b[..., None], upper=False), upper=True)

    bound_ms, bound_by = cg_bound_ms(1, f)
    row = {"systems": "one system past the block limit", "n": 1, "f": f,
           "plan": launch_plan(f).kernel, "max_abs_err": float((x - ref).abs().max()),
           "max_row_rel_err": row_rel,
           "ms": event_ms(lambda: batched_spd_solve_fused(A, b), reps=1, warmup=0),
           "plain_ms": event_ms(lambda: _cg_body(A, b, f + 4), reps=1, warmup=0),
           "library_ms": event_ms(library, reps=1, warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(phase="kernel_real", kernel="spd_cg", **row)
    return row


def train_phase(torch, home: str):
    from predictionio_tpu_torch.data.store import LocalStore
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        TrainingData,
    )
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_ratings, rank, iterations = 138_000, 27_000, 20_000_000, 32, 10
    t0 = time.perf_counter()
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings)
    test_mask = np.random.default_rng(42).random(n_ratings) < 0.02
    td = TrainingData(
        users[~test_mask], items[~test_mask], vals[~test_mask],
        [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)],
    )
    data_s = time.perf_counter() - t0
    algo = ALSAlgorithm(
        ALSAlgorithmParams(rank=rank, num_iterations=iterations, lambda_=0.05, chunk=65536)
    )
    algo.timings = {}
    ctx = WorkflowContext(device="cuda", store=LocalStore(home))
    batched_spd_solve_fused.launches = 0
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    train_wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    pred = np.sum(model.user_factors[users[test_mask]] * model.item_factors[items[test_mask]], 1)
    rmse = float(np.sqrt(np.mean((pred - vals[test_mask]) ** 2)))
    emit(
        phase="train", shape=[n_users, n_items, n_ratings], rank=rank,
        iterations=iterations, data_s=data_s, train_wall_s=train_wall_s,
        timings=algo.timings, heldout_rmse=rmse, rmse_gate=0.45, spd_cg_launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    if not rmse <= 0.45:
        raise AssertionError(f"held-out RMSE {rmse} above the 0.45 gate")
    if launches != 2 * iterations:
        raise AssertionError(f"B1 launched {launches} times, expected {2 * iterations}")
    return td, model, launches


def b1_times(torch, A, b) -> dict:
    """B1 on A [n, f, f], b [n, f], timed beside its plain version and the
    library Cholesky: ``ms`` by CUDA events over eager calls (host cost
    included), ``graph_ms`` the device time per launch from a replayed CUDA
    graph, and the same two for the library."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    n, f = b.shape

    def kernel():
        return batched_spd_solve_fused(A, b)

    def library():
        # cholesky_ex checks nothing on the host, and two triangular solves
        # replace cholesky_solve, whose batched path allocates device memory
        # on every call and so cannot be captured into a CUDA graph
        L, _ = torch.linalg.cholesky_ex(A)
        y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)

    bound_ms, bound_by = cg_bound_ms(n, f)
    return {
        "n": n, "f": f, "ms": event_ms(kernel, reps=20), "graph_ms": graph_ms(kernel),
        "plain_ms": event_ms(lambda: _cg_body(A, b, f + 4), reps=5),
        "library_ms": event_ms(library, reps=5),
        "library_graph_ms": graph_ms(library, launches=3, replays=3),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def b1_errors(torch, A, b) -> tuple[float, float]:
    """Max abs and max row-relative difference of B1 from the plain version."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    x = batched_spd_solve_fused(A, b)
    ref = _cg_body(A, b, b.shape[1] + 4)
    torch.cuda.synchronize()
    if not torch.isfinite(x).all():
        raise AssertionError(f"B1 gave non-finite values on {tuple(A.shape)}")
    row_rel = (x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return float((x - ref).abs().max()), float(row_rel.max())


def real_system_check(torch, td, model, launches: int) -> dict:
    """B1 on the real user-side and item-side systems of the trained model,
    and on 138,001 rank-10 systems (the template default), each against the
    plain version and timed beside it and the library Cholesky."""
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, pack_tables

    n_users, n_items = len(td.user_vocab), len(td.item_vocab)
    cfg = ALSConfig(rank=32, reg=0.05, chunk=65536)
    tables, block_chunk = pack_tables(
        td.user_idx, td.item_idx, td.ratings, n_users, n_items, cfg, "cuda"
    )
    factors = {}
    for side, trained, rows in (("item", model.item_factors, n_items),
                                ("user", model.user_factors, n_users)):
        factors[side] = torch.zeros(rows + 1, cfg.rank, device="cuda")
        factors[side][:rows] = torch.from_numpy(trained).cuda()
    rows = []
    for side, k, opposite, n_side in (("user", 0, "item", n_users), ("item", 4, "user", n_items)):
        A, b = _normal_system(*tables[k : k + 4], factors[opposite], n_side + 1, block_chunk,
                              cfg.reg, False, 1.0, True)
        abs_err, row_rel = b1_errors(torch, A, b)
        # row-relative 1e-3: one f32 algorithm, summed in another order over f+4 steps
        if not row_rel <= 1e-3:
            raise AssertionError(f"B1 on the ML-20M {side} side: row-relative error {row_rel}")
        rows.append({"systems": f"ML-20M {side} side", "max_abs_err": abs_err,
                     "max_row_rel_err": row_rel, **b1_times(torch, A, b)})
        del A, b
    del tables
    A, b = (torch.from_numpy(t).cuda() for t in spd_batch(n_users + 1, 10, seed=10))
    abs_err, row_rel = b1_errors(torch, A, b)
    if not abs_err <= 1e-4:  # the kernel phase's limit on these systems
        raise AssertionError(f"B1 on {n_users + 1} rank-10 systems: max abs err {abs_err}")
    rows.append({"systems": "spd_batch, template default rank", "max_abs_err": abs_err,
                 "max_row_rel_err": row_rel, **b1_times(torch, A, b)})
    for row in rows:
        emit(phase="kernel_real", kernel="spd_cg", **row)
    user = rows[0]
    return {
        "name": "spd_cg",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        **{key: user[key] for key in ("max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "library_graph_ms")},
        "shape": [user["n"], user["f"]],
        "other_shapes": rows[1:],
    }


def als_rank160_phase(torch, home: str) -> tuple[dict, int]:
    """ALSAlgorithm.train at rank 160 (B1 past rank 128: one block per
    system, A in shared memory) on the ML-1M shape, B1's launches read
    around it; then B1 on the trained model's user-side systems against the
    plain version (row-relative 1e-3) and timed, and on 2,048 seeded
    rank-256 systems (A read from device memory)."""
    from predictionio_tpu_torch.data.store import LocalStore
    from predictionio_tpu_torch.models.recommendation.engine import (
        ALSAlgorithm,
        ALSAlgorithmParams,
        TrainingData,
    )
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, pack_tables
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_ratings, rank, iterations = 6040, 3706, 1_000_209, 160, 5
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=3)
    test_mask = np.random.default_rng(43).random(n_ratings) < 0.02
    td = TrainingData(users[~test_mask], items[~test_mask], vals[~test_mask],
                      [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)])
    algo = ALSAlgorithm(ALSAlgorithmParams(rank=rank, num_iterations=iterations, lambda_=0.05,
                                           chunk=65536))
    ctx = WorkflowContext(device="cuda", store=LocalStore(home))
    batched_spd_solve_fused.launches = 0
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    train_wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    pred = np.sum(model.user_factors[users[test_mask]] * model.item_factors[items[test_mask]], 1)
    rmse = float(np.sqrt(np.mean((pred - vals[test_mask]) ** 2)))
    if launches != 2 * iterations or not np.isfinite(rmse):
        raise AssertionError(f"rank-160 ALS: B1 launched {launches} times (expected "
                             f"{2 * iterations}), held-out RMSE {rmse}")
    cfg = ALSConfig(rank=rank, reg=0.05, chunk=65536)
    tables, block_chunk = pack_tables(td.user_idx, td.item_idx, td.ratings, n_users, n_items,
                                      cfg, "cuda")
    items_f = torch.zeros(n_items + 1, rank, device="cuda")
    items_f[:n_items] = torch.from_numpy(model.item_factors).cuda()
    A, b = _normal_system(*tables[0:4], items_f, n_users + 1, block_chunk, cfg.reg, False, 1.0, True)
    abs_err, row_rel = b1_errors(torch, A, b)
    if not row_rel <= 1e-3:
        raise AssertionError(f"B1 at rank 160 on the user side: row-relative error {row_rel}")
    row = {"systems": "ML-1M user side, rank 160", "max_abs_err": abs_err,
           "max_row_rel_err": row_rel, **b1_times(torch, A, b)}
    del A, b, tables
    A, b = (torch.from_numpy(t).cuda() for t in spd_batch(2048, 256, seed=256))
    abs_err256, row_rel256 = b1_errors(torch, A, b)
    if not row_rel256 <= 1e-4:
        raise AssertionError(f"B1 on 2,048 rank-256 systems: row-relative error {row_rel256}")
    row256 = {"systems": "spd_batch, rank 256", "max_abs_err": abs_err256,
              "max_row_rel_err": row_rel256, **b1_times(torch, A, b)}
    emit(phase="als_rank160", shape=[n_users, n_items, n_ratings], rank=rank,
         iterations=iterations, train_wall_s=train_wall_s, heldout_rmse=rmse,
         spd_cg_launches=launches)
    for r in (row, row256):
        emit(phase="kernel_real", kernel="spd_cg", **r)
    return {"rows": [row, row256]}, launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, payload=None, timeout: float = 30.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0


def _check_result(body, num: int, n_items: int, banned=()) -> None:
    scores = body["itemScores"]
    if len(scores) != min(num, n_items):
        raise AssertionError(f"expected {num} itemScores, got {len(scores)}")
    for s in scores:
        if not (isinstance(s["item"], str) and np.isfinite(s["score"])):
            raise AssertionError(f"malformed itemScore {s}")
        if s["item"] in banned:
            raise AssertionError(f"blacklisted item {s['item']} served")
    got = [s["score"] for s in scores]
    if got != sorted(got, reverse=True):
        raise AssertionError("itemScores not in descending order")


def _cli(home: str):
    """The port's CLI command line for ``home``, its environment, and a
    runner that returns a verb's wall seconds and raises if it fails."""
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", home]

    def run(*args, timeout=600):
        t0 = time.perf_counter()
        proc = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"cli {args[0]} failed ({proc.returncode}):\n{proc.stderr}")
        return time.perf_counter() - t0

    return cli, env, run


def _start_deploy(cli, env, engine_dir, work, device):
    port = _free_port()
    with open(os.path.join(work, "deploy.err"), "w") as err:  # the child keeps its own copy
        server = subprocess.Popen(
            [*cli, "deploy", "--engine-dir", engine_dir, "--device", device,
             "--ip", "127.0.0.1", "--port", str(port)],
            env=env, stdout=subprocess.DEVNULL, stderr=err,
        )
    base = f"http://127.0.0.1:{port}"
    t0 = time.perf_counter()
    while True:
        if server.poll() is not None:
            with open(os.path.join(work, "deploy.err")) as fh:
                raise AssertionError(f"deploy exited {server.returncode}: {fh.read()}")
        try:
            status, _, _ = _http(base + "/", timeout=2)
            if status == 200:
                return server, base, time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, TimeoutError):
            pass
        if time.perf_counter() - t0 > 180:
            server.kill()
            server.wait()
            raise AssertionError("deploy did not answer GET / within 180 s")
        time.sleep(0.2)


def _stop(server) -> None:
    server.send_signal(signal.SIGTERM)
    try:
        server.wait(timeout=30)
    except subprocess.TimeoutExpired:
        server.kill()
        server.wait()


def cli_serve_phase(home: str, device: str = "cuda") -> dict:
    """app new -> import -> train -> deploy through the port's CLI, then
    POST /queries.json: a concurrent burst, an unknown user, a blacklist."""
    n_users, n_items, n_ratings = 943, 1682, 100_000
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=1)
    work = tempfile.mkdtemp(prefix="pio_smoke_cli_")
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(), vals.tolist())):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": r},
                "eventTime": f"2024-01-01T00:{k // 6000 % 60:02d}:{k // 100 % 60:02d}.{k % 100:03d}Z",
            }) + "\n")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({
            "id": "smoke-rec",
            "engineFactory": "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
            "datasource": {"params": {"appName": "smokeapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 32, "numIterations": 10, "lambda": 0.05, "seed": 3}}],
        }, fh)
    cli, env, run = _cli(home)

    steps = {
        "app_new_s": run("app", "new", "smokeapp"),
        "import_s": run("import", "--appname", "smokeapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    try:
        latencies = []
        banned = [f"i{i}" for i in range(0, 40)]
        checks = [({"user": "u1", "num": 4}, 4, ()),
                  ({"user": "u2"}, 10, ()),
                  ({"user": "u3", "num": 20, "blackList": banned}, 20, banned)]
        for payload, num, bl in checks:
            status, body, dt = _http(base + "/queries.json", payload)
            if status != 200:
                raise AssertionError(f"{payload} answered {status}")
            _check_result(body, num, n_items, bl)
            latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        latencies.append(dt)
        largest = 0
        for burst in range(3):  # until the micro-batcher has batched a burst
            with concurrent.futures.ThreadPoolExecutor(32) as pool:
                outs = list(pool.map(
                    lambda u: _http(base + "/queries.json", {"user": f"u{u}", "num": 10}),
                    range(burst * 64, burst * 64 + 64),
                ))
            for status, body, dt in outs:
                if status != 200:
                    raise AssertionError(f"burst query answered {status}")
                _check_result(body, 10, n_items)
                latencies.append(dt)
            _, st, _ = _http(base + "/")
            largest = st["largestBatch"]
            if largest > 1:
                break
        if largest < 2:
            raise AssertionError("the micro-batcher never batched a concurrent burst")
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
        shutil.rmtree(work, ignore_errors=True)
    lat_ms = np.asarray(latencies) * 1e3
    result = {
        **steps,
        "requests": len(latencies),
        "all_200": True,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "largest_batch": largest,
        "batches": st["batches"],
        "queries": st["queries"],
    }
    emit(phase="serve_cli", shape=[n_users, n_items, n_ratings], **result)
    return result


def inprocess_serve_phase(torch, model) -> None:
    """The ML-20M model through ServingIndex.serve_batch against a plain
    torch.topk over U[u] @ V^T."""
    index = model.serving_index()
    rng = np.random.default_rng(5)
    batch, k = 256, 10
    uidx = rng.integers(0, index.n_users, batch).astype(np.int32)
    scores, idx = index.serve_batch(uidx, k)
    U, V = index.user_factors, index.item_factors
    ref_s, _ = torch.topk(U[torch.from_numpy(uidx).long().cuda()] @ V.T, k, dim=1)
    ref_s = ref_s.cpu().numpy()
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=0)
    full = (U[torch.from_numpy(uidx).long().cuda()] @ V.T).cpu().numpy()
    for row in range(batch):  # every served id scores what it was served with
        np.testing.assert_allclose(full[row, idx[row]], scores[row], rtol=1e-5, atol=1e-6)
    lat = []
    for b in range(50):
        t0 = time.perf_counter()
        index.serve_batch(uidx[: 1 + b % 64], k)
        lat.append((time.perf_counter() - t0) * 1e3)
    emit(phase="serve_inprocess", n_users=index.n_users, n_items=index.n_items,
         batch=batch, k=k, serve_batch_p50_ms=float(np.percentile(lat, 50)))


# ---------------------------------------------------------------------------
# The sequential template: attention scorer, kernels B2 and B3
# ---------------------------------------------------------------------------

ATTENTION_SOURCES = {
    "attention_block": ("predictionio_tpu_torch/ops/csrc/attention_block.cu",
                        "predictionio_tpu/ops/attention.py:389"),
    "flash_attention": ("predictionio_tpu_torch/ops/csrc/flash_attention.cu",
                        "predictionio_tpu/ops/attention.py:285"),
}


def session_lengths(n_users: int, n_events: int, rng, n_long: int, max_len: int) -> np.ndarray:
    """Per-user session lengths of at least 20 that sum to ``n_events``:
    log-normal like the MovieLens releases, with ``n_long`` users past
    2,048 events so that a long window is full."""
    lengths = np.clip(np.round(rng.lognormal(4.55, 0.95, n_users)), 20, max_len).astype(np.int64)
    long_users = rng.choice(n_users, n_long, replace=False)
    lengths[long_users] = rng.integers(2049, max_len + 1, n_long)
    rest = np.setdiff1d(np.arange(n_users), long_users)
    target = n_events - int(lengths[long_users].sum())
    scaled = np.floor(lengths[rest] * target / lengths[rest].sum())
    scaled = np.clip(scaled, 20, max_len).astype(np.int64)
    order = rng.permutation(len(rest))
    while (diff := target - int(scaled.sum())) != 0:  # move the remainder one event at a time
        step = 1 if diff > 0 else -1
        room = order[(scaled[order] < max_len) if step > 0 else (scaled[order] > 20)]
        scaled[room[: abs(diff)]] += step
    lengths[rest] = scaled
    return lengths


def hop_sessions(lengths: np.ndarray, n_items: int, rng) -> list[np.ndarray]:
    """The bench's hop generator (bench.py:2731-2740), vectorised: a session
    starts at a random item; each next item is the last + 1..3 with
    probability 0.7, else a random item."""
    n = int(lengths.sum())
    jump = rng.random(n) >= 0.7
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    jump[starts] = True
    hop = np.where(jump, 0, rng.integers(1, 4, n))
    seg_start = np.flatnonzero(jump)
    seg = np.cumsum(jump) - 1
    walked = np.cumsum(hop)
    items = (rng.integers(0, n_items, n)[seg_start][seg] + walked - walked[seg_start][seg]) % n_items
    return np.split(items.astype(np.int32), starts[1:])


def attention_bound_ms(q, k, v, causal: bool):
    """Least time for the attention function on these tensors: each distinct
    input buffer read once and o written once, against the tensor work (4·D
    per visible query-key pair, bf16 rate) and the exponentials (one per
    visible pair, special-function rate). The scorer passes one tensor as q,
    k and v, which is then read once. The visible pairs are counted for
    these lengths: all of them, or under the causal mask sum_i min(i + 1, Lk).
    Returns the bound, what binds it ("bytes" or "operations") and each
    term."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    inputs = {t.data_ptr(): t.numel() * t.element_size() for t in (q, k, v)}
    nbytes = sum(inputs.values()) + q.numel() * q.element_size()
    pairs = sum(min(i + 1, Lk) for i in range(Lq)) if causal else Lq * Lk
    terms = {
        "bytes": nbytes / H100_BYTES_PER_S * 1e3,
        "tensor_operations": 4 * B * H * pairs * D / H100_BF16_FLOPS * 1e3,
        "exponentials": B * H * pairs / H100_EXP_PER_S * 1e3,
    }
    binding = max(terms, key=terms.get)
    return terms[binding], "bytes" if binding == "bytes" else "operations", terms


def attention_kernels(A) -> dict:
    """Kernel name -> (CUDA wrapper, plain version) of ops/attention.py."""
    return {"attention_block": (A.fused_attention_block, A._fused_attention_plain),
            "flash_attention": (A.flash_attention, A._flash_attention_plain)}


# B2 and B3 against their plain versions: one bf16 contract, f32 sums in
# another order, and every score whose tensor-core sum could move a row's
# max or flip bf16(p) summed again in the plain version's order (at most
# 2e-6 apart in earlier runs); a kernel that kept p in f32 before P·V would
# be 5e-4 or more off (tests/test_torch_attention.py)
ATTENTION_ATOL = 1e-5


def attention_kernel_phase(torch) -> None:
    """B2 and B3 against their plain versions and the f32 reference, causal
    and not. Limits: ATTENTION_ATOL against the plain version, 2e-2 against
    the reference (the bf16 bound of tests/test_attention.py:74)."""
    from predictionio_tpu_torch.ops import attention as A

    # (kernel, q shape [B, H, Lq, D], Lk)
    cases = [("attention_block", (64, 1, L, 32), L) for L in (8, 200, 1023)]
    cases += [("attention_block", (64, 1, 200, D), 200) for D in (10, 64)]
    cases += [("attention_block", (64, 2, 200, 32), 200)]
    # B2 keeps no score rows: a small tile with a long key axis, and Lq != Lk.
    # Lq = 3, not 1: at one query row torch's f32 product takes a matrix-vector
    # path that sums in another order than the plain version's column order
    cases += [("attention_block", (64, 1, 3, 32), 10_000), ("attention_block", (64, 1, 200, 32), 75)]
    cases += [("flash_attention", (64, 1, L, 32), L) for L in (1024, 2048, 1500)]
    cases += [("flash_attention", (16, 1, 700, 32), 2100), ("flash_attention", (16, 1, 2100, 32), 700)]
    # heads past 128 columns: the kernels' sliced variants
    cases += [(name, shape, shape[2]) for name in ("attention_block", "flash_attention")
              for shape in ((16, 2, 200, 160), (8, 1, 300, 256))]
    kernels = attention_kernels(A)
    for name, shape, Lk in cases:
        rng = np.random.default_rng(sum(shape) + Lk)
        q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        k, v = (torch.from_numpy(rng.normal(size=(*shape[:2], Lk, shape[3])).astype(np.float32)).cuda()
                for _ in range(2))
        wrapper, plain = kernels[name]
        for causal in (False, True):
            out = wrapper(q, k, v, causal)
            torch.cuda.synchronize()
            err = float((out - plain(q, k, v, causal)).abs().max())
            ref_err = float((out - A.attention_reference(q, k, v, causal=causal)).abs().max())
            if not (torch.isfinite(out).all() and err <= ATTENTION_ATOL and ref_err <= 2e-2):
                raise AssertionError(
                    f"{name} {shape} causal={causal}: max abs err {err} (plain, limit "
                    f"{ATTENTION_ATOL}), {ref_err} (reference, limit 2e-2)"
                )
            emit(phase="kernel_attention", kernel=name, shape=list(shape), Lk=Lk, causal=causal,
                 max_abs_err=err, max_abs_err_reference=ref_err, atol=ATTENTION_ATOL,
                 atol_reference=2e-2)
    # 70,000 batch·heads, past the 65,535 blocks of a 1-D grid that B2 once
    # refused: over 1.1 M rows the bf16 contract's own distance from the f32
    # reference passes 2e-2 in its tail, so the kernel is held to the plain
    # version and to the plain version's distance from the reference
    rng = np.random.default_rng(70)
    q, k, v = (torch.from_numpy(rng.normal(size=(35_000, 2, 16, 32)).astype(np.float32)).cuda()
               for _ in range(3))
    for causal in (False, True):
        out = A.fused_attention_block(q, k, v, causal)
        plain = A._fused_attention_plain(q, k, v, causal)
        ref = A.attention_reference(q, k, v, causal=causal)
        err = float((out - plain).abs().max())
        gap = float((out - ref).abs().max()) - float((plain - ref).abs().max())
        if not (torch.isfinite(out).all() and err <= ATTENTION_ATOL and abs(gap) <= ATTENTION_ATOL):
            raise AssertionError(f"B2 at 70,000 batch·heads causal={causal}: {err} from the "
                                 f"plain version, {gap} further from the reference")
        emit(phase="kernel_attention", kernel="attention_block", shape=[35_000, 2, 16, 32],
             Lk=16, causal=causal, max_abs_err=err, reference_gap=gap, atol=ATTENTION_ATOL)


def wide_head_times(torch) -> list[dict]:
    """B2 and B3 past head dim 128 (the sliced variants) at the sequential
    scorer's serving shapes for ranks 160 and 256, causal: against the
    plain version (ATTENTION_ATOL times the output's scale, see b2_times),
    timed eager and as a CUDA graph beside the bound and SDPA."""
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    kernels = attention_kernels(A)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, L in (("attention_block", 200), ("flash_attention", 1024)):
        wrapper, plain = kernels[name]
        for D in (160, 256):
            rng = np.random.default_rng(D + L)
            q, k, v = (torch.from_numpy(rng.normal(size=(64, 1, L, D)).astype(np.float32)).cuda()
                       for _ in range(3))
            want = plain(q, k, v, True)
            err = float((wrapper(q, k, v, True) - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            if not err <= ATTENTION_ATOL * scale:
                raise AssertionError(f"{name} at D={D}: {err} from the plain version")
            qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
            bound_ms, bound_by, bounds = attention_bound_ms(q, k, v, True)
            row = {"kernel": name, "shape": list(q.shape), "max_abs_err": err, "output_scale": scale,
                   "ms": event_ms(lambda: wrapper(q, k, v, True), reps=20),
                   "graph_ms": graph_ms(lambda: wrapper(q, k, v, True), launches=10),
                   "plain_ms": event_ms(lambda: plain(q, k, v, True), reps=3),
                   "library_ms": event_ms(lambda: sdpa(qb, kb, vb, is_causal=True), reps=20),
                   "library_graph_ms": graph_ms(lambda: sdpa(qb, kb, vb, is_causal=True), launches=10),
                   "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds}
            emit(phase="kernel_attention_wide", causal=True, **row)
            rows.append(row)
    return rows


def sequential_train_phase(torch, home: str):
    """AttentionAlgorithm.train on ML-1M-shaped sessions, held-out last item
    per user; hit-rate@10 of both scorers on the same held-out items."""
    from predictionio_tpu_torch.data.store import LocalStore
    from predictionio_tpu_torch.models.sequential import engine as seq
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_events, rank, iterations = 6040, 3706, 1_000_209, 32, 10
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    sessions = hop_sessions(session_lengths(n_users, n_events, rng, 12, 2314), n_items, rng)
    vocab = [f"i{j}" for j in range(n_items)]
    users = [f"u{k}" for k in range(n_users)]
    td = seq.TrainingData(users, [s[:-1] for s in sessions], vocab)
    data_s = time.perf_counter() - t0
    algo = seq.AttentionAlgorithm(
        seq.AttentionAlgorithmParams(rank=rank, num_iterations=iterations, context=8))
    algo.timings = {}
    ctx = WorkflowContext(device="cuda", store=LocalStore(home))
    torch.cuda.reset_peak_memory_stats()
    batched_spd_solve_fused.launches = 0
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    train_wall_s = time.perf_counter() - t0
    launches = batched_spd_solve_fused.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def hit_rate(predict, queries):
        hits = 0
        for b in range(0, n_users, 64):
            for r, s in zip(predict(queries[b : b + 64]), sessions[b : b + 64]):
                hits += vocab[s[-1]] in {x.item for x in r.item_scores}
        return hits / n_users

    markov = seq.MarkovAlgorithm(seq.MarkovAlgorithmParams())
    rates = {}
    # bare-user queries: the template answers from the stored last item of
    # the training prefix; 8-item sessions: the window of the default context
    for protocol, queries in (
        ("last_item", [seq.Query(user=u, num=10) for u in users]),
        ("session_8", [seq.Query(recent_items=tuple(vocab[i] for i in s[-9:-1]), num=10)
                       for s in sessions]),
    ):
        rates[protocol] = {
            "attention": hit_rate(lambda qs: algo.predict_batch(model, qs), queries),
            "markov": hit_rate(lambda qs: [markov.predict(model, q) for q in qs], queries),
        }
    emit(phase="sequential_train", shape=[n_users, n_items, n_events], rank=rank,
         iterations=iterations, data_s=data_s, train_wall_s=train_wall_s, timings=algo.timings,
         spd_cg_launches=launches, peak_mem_gb=peak_gb, hit_rate_at_10=rates)
    if launches != 2 * iterations:
        raise AssertionError(f"B1 launched {launches} times, expected {2 * iterations}")
    # the template's gate, on bare-user queries: the window is the stored
    # last item repeated, so it holds the trained tables to the Markov chain
    att, mk = rates["last_item"]["attention"], rates["last_item"]["markov"]
    if not att >= 0.5 * mk:
        raise AssertionError(f"attention hit-rate@10 {att} below half of Markov's {mk}")
    # 8-item sessions mix 8 embeddings through B2: a wrong gather, window or
    # kernel falls to chance (10 of n_items); both packages score these
    # below the bare-user rate (tests/test_torch_sequential.py)
    att8, chance = rates["session_8"]["attention"], 10 / n_items
    if not att8 >= 20 * chance:
        raise AssertionError(f"8-item session hit-rate@10 {att8} below 20x chance ({chance})")
    return model, sessions, launches


def sequential_serve_phase(torch, model, sessions) -> list[dict]:
    """The trained model served in batches of 64 at context 8, 200 and 1024
    through predict_batch_dispatch; then each kernel timed at its serving
    shape."""
    from predictionio_tpu_torch.models.sequential import engine as seq
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    vocab = model.item_vocab
    table_in, table_out = model.device_in(), model.device_out()
    kernels = attention_kernels(A)
    by_length = np.argsort([-len(s) for s in sessions], kind="stable")
    rng = np.random.default_rng(13)
    n_dispatch, batch = 12, 64
    launches: dict[str, dict[str, int]] = {"attention_block": {}, "flash_attention": {}}
    shapes: dict[int, object] = {}
    for context in (8, 200, 1024):
        algo = seq.AttentionAlgorithm(seq.AttentionAlgorithmParams(rank=32, context=context))
        # at the long window take the longest sessions, so that windows are full
        pool = by_length[:batch] if context == 1024 else rng.permutation(len(sessions))
        batches = []
        for d in range(n_dispatch):
            rows = [pool[(d * batch + r) % len(pool)] for r in range(batch)]
            batches.append([seq.Query(recent_items=tuple(vocab[i] for i in sessions[u][-context:]),
                                      num=10) for u in rows])
        A.fused_attention_block.launches = 0
        A.flash_attention.launches = 0
        lat, results = [], []
        for queries in batches:
            t0 = time.perf_counter()
            results.append(algo.predict_batch_dispatch(model, queries)())
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = {"attention_block": A.fused_attention_block.launches,
                  "flash_attention": A.flash_attention.launches}
        stage = []  # the host part of a dispatch: sessions, window and mask
        for queries in batches:
            t0 = time.perf_counter()
            algo._stage_batch(model, queries)
            stage.append((time.perf_counter() - t0) * 1e3)
        want = "attention_block" if A.route(context, context) == "block" else "flash_attention"
        if counts[want] != n_dispatch or sum(counts.values()) != n_dispatch:
            raise AssertionError(f"context {context}: launches {counts}, expected "
                                 f"{n_dispatch} of {want} (one per dispatch)")
        launches[want][f"serve_context_{context}"] = counts[want]
        # served scores against torch.topk over the plain-version session vectors
        worst = 0.0
        for queries, served in zip(batches[:3], results[:3]):
            hist, mask, sessions_idx, _ = algo._stage_batch(model, queries)
            x = table_in[torch.from_numpy(hist.copy()).cuda()].unsqueeze(1)
            vec = kernels[want][1](x, x, x, True)[:, 0, -1, :]
            scores = torch.where(torch.from_numpy(mask.copy()).cuda(), vec @ table_out.T, float("-inf"))
            ref = torch.topk(scores, 16, dim=1).values.cpu().numpy()
            for r, (res, sess) in enumerate(zip(served, sessions_idx)):
                got = np.asarray([s.score for s in res.item_scores])
                if len(got) != 10 or list(got) != sorted(got, reverse=True):
                    raise AssertionError(f"context {context}: a malformed result {res}")
                if set(sess) & {model.item_index()[s.item] for s in res.item_scores}:
                    raise AssertionError(f"context {context}: a session item was served")
                rel = float(np.abs(got - ref[r, :10]).max() / np.abs(ref[r, :10]).max())
                worst = max(worst, rel)
                if not rel <= ATTENTION_ATOL:
                    raise AssertionError(f"context {context}: served scores {got} against "
                                         f"plain {ref[r, :10]} (limit {ATTENTION_ATOL} of max)")
        shapes[context] = x
        emit(phase="sequential_serve", context=context, batch=batch, dispatches=n_dispatch,
             launches=counts, dispatch_p50_ms=float(np.percentile(lat, 50)),
             stage_p50_ms=float(np.percentile(stage, 50)),
             dispatch_p99_ms=float(np.percentile(lat, 99)), max_rel_score_err=worst)

    entries = []
    for context, name in ((8, "attention_block"), (200, "attention_block"), (1024, "flash_attention")):
        x = shapes[context]
        wrapper, plain = kernels[name]
        err = float((wrapper(x, x, x, True) - plain(x, x, x, True)).abs().max())
        xb = x.to(torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # ms: back-to-back eager calls, host enqueue cost included;
        # graph_ms: device time per launch from a replayed CUDA graph
        t = {
            "ms": event_ms(lambda: wrapper(x, x, x, True), reps=50),
            "graph_ms": graph_ms(lambda: wrapper(x, x, x, True)),
            "plain_ms": event_ms(lambda: plain(x, x, x, True), reps=5),
            "library_ms": event_ms(lambda: sdpa(xb, xb, xb, is_causal=True), reps=50),
            "library_graph_ms": graph_ms(lambda: sdpa(xb, xb, xb, is_causal=True)),
        }
        bound_ms, bound_by, bounds = attention_bound_ms(x, x, x, True)
        emit(phase="kernel_attention_real", kernel=name, shape=list(x.shape), causal=True,
             max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, bounds_ms=bounds, **t)
        if context == 8:
            continue  # the B2 entry of the kernels line is at SASRec's window
        source, replaces = ATTENTION_SOURCES[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": err, "ms": t["ms"], "graph_ms": t["graph_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "bounds_ms": bounds, "library_ms": t["library_ms"],
            "library_graph_ms": t["library_graph_ms"], "shape": list(x.shape),
        })
    return entries


def _write_sequential_events(path: str, n_users: int, n_items: int, n_events: int, seed: int):
    """ML-100K-shape view events, sessions interleaved across users, each
    line with a strictly increasing creationTime and an explicit eventId,
    so that the store's order is the session order."""
    import datetime as dt

    rng = np.random.default_rng(seed)
    lengths = session_lengths(n_users, n_events, rng, 0, 737)
    sessions = hop_sessions(lengths, n_items, rng)
    user_of = np.repeat(np.arange(n_users), lengths)
    items = np.concatenate(sessions)
    keys = rng.random(n_events)
    keys = keys[np.lexsort((keys, user_of))]  # ascending within each user's session
    order = np.argsort(keys, kind="stable")
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    with open(path, "w") as fh:
        for n, e in enumerate(order):
            t = (t0 + dt.timedelta(milliseconds=n)).isoformat()
            fh.write(json.dumps({
                "event": "view", "entityType": "user", "entityId": f"u{user_of[e]}",
                "targetEntityType": "item", "targetEntityId": f"i{items[e]}",
                "eventTime": t, "creationTime": t, "eventId": f"e{n:07d}",
            }) + "\n")
    return sessions


def sequential_cli_phase(home: str, device: str = "cuda") -> dict:
    """app new -> import -> train -> deploy of the attention algorithm
    through the port's CLI, then POST /queries.json."""
    n_users, n_items, n_events = 943, 1682, 100_000
    work = tempfile.mkdtemp(prefix="pio_smoke_seq_")
    events = os.path.join(work, "views.jsonl")
    sessions = _write_sequential_events(events, n_users, n_items, n_events, seed=14)
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({
            "id": "smoke-seq",
            "engineFactory": "predictionio_tpu_torch.models.sequential.engine.engine_factory",
            "datasource": {"params": {"appName": "seqapp"}},
            "algorithms": [{"name": "attention", "params": {
                "rank": 32, "numIterations": 10, "context": 8}}],
        }, fh)
    cli, env, run = _cli(home)

    steps = {
        "app_new_s": run("app", "new", "seqapp"),
        "import_s": run("import", "--appname", "seqapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    latencies = []
    try:
        for u in range(0, 40, 4):
            session = [f"i{i}" for i in sessions[u][-(3 + u % 9):]]
            status, body, dt = _http(base + "/queries.json", {"recentItems": session, "num": 10})
            if status != 200:
                raise AssertionError(f"recentItems query answered {status}")
            _check_result(body, 10, n_items, banned=set(session))
            latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "u5", "num": 6})
        # the stored last item of u5's session answers and is not served
        if status != 200:
            raise AssertionError(f"bare user query answered {status}")
        _check_result(body, 6, n_items, banned={f"i{sessions[5][-1]}"})
        latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        latencies.append(dt)
        largest = 0
        for burst in range(3):  # until the micro-batcher has batched a burst
            payloads = [{"recentItems": [f"i{i}" for i in sessions[u][-8:]], "num": 10}
                        for u in range(burst * 64, burst * 64 + 64)]
            with concurrent.futures.ThreadPoolExecutor(64) as pool:
                outs = list(pool.map(lambda p: _http(base + "/queries.json", p), payloads))
            for p, (status, body, dt) in zip(payloads, outs):
                if status != 200:
                    raise AssertionError(f"burst query answered {status}")
                _check_result(body, 10, n_items, banned=set(p["recentItems"]))
                latencies.append(dt)
            _, st, _ = _http(base + "/")
            largest = st["largestBatch"]
            if largest > 1:
                break
        if largest < 2:
            raise AssertionError("the micro-batcher never batched a concurrent burst")
    finally:
        _stop(server)
        shutil.rmtree(work, ignore_errors=True)
    lat_ms = np.asarray(latencies) * 1e3
    result = {**steps, "requests": len(latencies), "all_200": True,
              "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
              "largest_batch": largest, "batches": st["batches"], "queries": st["queries"]}
    emit(phase="sequential_cli", shape=[n_users, n_items, n_events], **result)
    return result


# ---------------------------------------------------------------------------
# The two-tower template: its history encoder through kernel B2, in training
# and in serving
# ---------------------------------------------------------------------------

# the JAX package's recall@10 on the bench's clustered data with a 32-item
# history encoder, trained on the CPU (the same data and config as
# twotower_quality_phase); the bench's own gate (> 0.4, bench.py:1299) is
# for the model without the encoder, which reaches 0.4745 there
JAX_CPU_RECALL_HISTORY_32 = 0.0545
BENCH_RECALL_GATE = 0.4


def encoder_qkv(torch, model, users: np.ndarray):
    """The q, k and v [B, 2, 256, 32] that the trained two-tower encoder
    hands to attention for these users' histories: the main path's own
    operands of B2."""
    from predictionio_tpu_torch.ops import attention as A

    hist = torch.from_numpy(model.history[users].astype(np.int64)).cuda()
    seen = []
    real = A._fused_attention_forward
    try:
        A._fused_attention_forward = lambda q, k, v, causal: seen.append((q, k, v)) or real(q, k, v, causal)
        with torch.no_grad():
            model.module().hist_encoder(hist)
    finally:
        A._fused_attention_forward = real
    return seen[0]


def b2_times(torch, q, k, v, label: str) -> dict:
    """B2 causal on the encoder's q, k, v against its plain version, timed
    eager (``ms``) and as a replayed CUDA graph (``graph_ms``) beside its
    bound and scaled_dot_product_attention on bf16 (eager and graph). The
    limit is ATTENTION_ATOL times the output's scale: the P·V sums are
    not settled, and their order's rounding grows with |o| (on unit-normal
    q = k = v at [4096, 2, 256, 32], where |o| reaches 4, the kernel came
    out just past 1e-5 from the plain version with the scores identical)."""
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    plain = A._fused_attention_plain(q, k, v, True)
    err = float((A.fused_attention_block(q, k, v, True) - plain).abs().max())
    scale = max(1.0, float(plain.abs().max()))
    if not err <= ATTENTION_ATOL * scale:
        raise AssertionError(f"B2 at {label} {tuple(q.shape)}: {err} from the plain version "
                             f"(limit {ATTENTION_ATOL} x {scale})")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    big = q.shape[0] >= 1024
    t = {
        "ms": event_ms(lambda: A.fused_attention_block(q, k, v, True), reps=10 if big else 50),
        "graph_ms": graph_ms(lambda: A.fused_attention_block(q, k, v, True),
                             launches=5 if big else 20),
        "plain_ms": event_ms(lambda: A._fused_attention_plain(q, k, v, True), reps=3),
        "library_ms": event_ms(lambda: sdpa(qb, kb, vb, is_causal=True), reps=10 if big else 50),
        "library_graph_ms": graph_ms(lambda: sdpa(qb, kb, vb, is_causal=True),
                                     launches=5 if big else 20),
    }
    bound_ms, bound_by, bounds = attention_bound_ms(q, k, v, True)
    row = {"shape": list(q.shape), "at": label, "max_abs_err": err, "output_scale": scale,
           "bound_ms": bound_ms, "bound_by": bound_by, "bounds_ms": bounds, **t}
    emit(phase="kernel_attention_real", kernel="attention_block", causal=True, **row)
    return row


def twotower_train_phase(torch, home: str, n_users: int = 138_000, n_items: int = 27_000,
                         n_slice: int = 2_000_000, batch: int = 4096):
    """TwoTowerAlgorithm.train at full width (ML-20M vocabulary, 138,000
    users x 27,000 items, embed 64, hidden [128], out 32, 2 heads of 32,
    historyLen 256, batch 4096) for one epoch over a 2,000,000-rating slice
    of the ML-20M data with synthetic times: 488 steps, B2's launches read
    around it (one forward per step: 256² f32 scores are under 4 MiB). The
    loss of the untrained model on the epoch's first batch, then the
    epoch's: finite and falling."""
    from predictionio_tpu_torch.data.store import LocalStore
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    t0 = time.perf_counter()
    users, items, _ = synthesize_ratings(n_users, n_items, 10 * n_slice)
    users, items = users[:n_slice], items[:n_slice]
    times = np.random.default_rng(21).random(n_slice) * 1e8
    td = tt.TrainingData(users, items, [f"u{i}" for i in range(n_users)],
                         [f"i{i}" for i in range(n_items)], times)
    data_s = time.perf_counter() - t0
    params = tt.TwoTowerAlgorithmParams(embed_dim=64, hidden=(128,), out_dim=32, n_heads=2,
                                        history_len=256, batch_size=batch, epochs=1)
    algo = tt.TwoTowerAlgorithm(params)
    steps = n_slice // params.batch_size
    # the untrained model's loss on the first batch of the epoch
    config = M.TwoTowerConfig(n_users=n_users, n_items=n_items, embed_dim=64, hidden=(128,),
                              out_dim=32, n_heads=2, history_len=256, batch_size=batch, epochs=1)
    hist = M.build_history_matrix(users, items, times, n_users, 256)
    first = np.random.default_rng(config.seed).permutation(n_slice)[: params.batch_size]
    net = M.build_model(config, "cuda")
    ub, ib, h = (torch.from_numpy(np.asarray(a, np.int64)).cuda()
                 for a in (users[first], items[first], hist[users[first]]))
    with torch.no_grad():
        h = torch.where(h == ib[:, None], -1, h)  # the step's target masking
        log_q = torch.from_numpy(M.item_log_q(items, n_items)).cuda()
        loss0 = float(M.loss_fn(net, ub, ib, config.temperature, h, log_q))
    del net
    torch.cuda.reset_peak_memory_stats()
    ctx = WorkflowContext(device="cuda", store=LocalStore(home))
    A.fused_attention_block.launches = 0
    A.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    train_wall_s = time.perf_counter() - t0
    launches = A.fused_attention_block.launches
    flash = A.flash_attention.launches
    losses = [loss0, *model.losses]
    emit(phase="twotower_train", shape=[n_users, n_items, n_slice], history_len=256,
         batch=params.batch_size, steps=steps, data_s=data_s, train_wall_s=train_wall_s,
         steps_per_s=steps / train_wall_s, examples_per_s=steps * params.batch_size / train_wall_s,
         loss_untrained=loss0, loss_per_epoch=model.losses,
         attention_block_launches=launches, flash_attention_launches=flash,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != steps or flash != 0:
        raise AssertionError(f"two-tower train: B2 launched {launches} times and B3 {flash}, "
                             f"expected {steps} and 0 (one B2 forward per step)")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"two-tower losses {losses}: not finite and falling")
    return model, algo, td, launches


def twotower_step_split(torch, td, batch: int = 4096) -> dict:
    """One full-width training step and its parts by CUDA events: B2's
    forward alone, the attention backward alone (the f32 reference's
    gradient as torch matrix products), Adam's update alone, and the rest
    (towers, encoder layers, loss, their backward) as the difference."""
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.utils.cuda_timing import event_ms

    n_users, n_items = len(td.user_vocab), len(td.item_vocab)
    config = M.TwoTowerConfig(n_users=n_users, n_items=n_items, embed_dim=64, hidden=(128,),
                              out_dim=32, n_heads=2, history_len=256, batch_size=batch)
    net = M.build_model(config, "cuda")
    opt = M.make_optimizer(net, config.learning_rate)
    log_q = torch.from_numpy(M.item_log_q(td.item_idx, n_items)).cuda()
    step = M.make_train_step(net, opt, config.temperature, True, log_q)
    hist = torch.from_numpy(M.build_history_matrix(
        td.user_idx, td.item_idx, td.timestamps, n_users, 256).astype(np.int64)).cuda()
    sel = np.random.default_rng(3).permutation(len(td.user_idx))[:batch]
    ub = torch.from_numpy(td.user_idx[sel].astype(np.int64)).cuda()
    ib = torch.from_numpy(td.item_idx[sel].astype(np.int64)).cuda()
    step_ms = event_ms(lambda: step(ub, ib, hist), reps=10, warmup=3)
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(batch, 2, 256, 32)).astype(np.float32)).cuda()
                  for _ in range(4))
    fwd_ms = event_ms(lambda: A.fused_attention_block(q, k, v, True), reps=10)
    bwd_ms = event_ms(lambda: A.attention_reference_grad(q, k, v, g, True), reps=5)
    adam_ms = event_ms(opt.step, reps=10)
    split = {"step_ms": step_ms, "b2_forward_ms": fwd_ms, "attention_backward_ms": bwd_ms,
             "adam_ms": adam_ms, "rest_ms": step_ms - fwd_ms - bwd_ms - adam_ms}
    emit(phase="twotower_step_split", **split)
    return split


def twotower_serve_phase(torch, model, algo) -> int:
    """The trained model through predict_batch_dispatch in batches of 64
    users with their 256-item histories: one B2 launch per dispatch. The
    encoder's output against its plain version (atol 1e-4: B2 within 1e-5
    of it, one f32 projection and a mean); served scores against a
    torch.topk over the plain version's user vectors (atol 1e-2: the bf16
    towers may round one input the other way on a 1e-6 difference), and
    every served id within that of the plain k-th score."""
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    model = algo.prepare_model(WorkflowContext(device="cuda"), model)
    rng = np.random.default_rng(22)
    n_dispatch, batch, k = 12, 64, 10
    picks = [rng.integers(0, len(model.user_vocab), batch) for _ in range(n_dispatch)]
    batches = [[tt.Query(user=model.user_vocab[u], num=k) for u in rows] for rows in picks]
    algo.predict_batch_dispatch(model, batches[0])()  # first use outside the count
    A.fused_attention_block.launches = 0
    lat, served = [], []
    for queries in batches:
        t0 = time.perf_counter()
        served.append(algo.predict_batch_dispatch(model, queries)())
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = A.fused_attention_block.launches
    if launches != n_dispatch:
        raise AssertionError(f"two-tower serve: B2 launched {launches} times for {n_dispatch} dispatches")
    net = model.module()
    item_index = {it: i for i, it in enumerate(model.item_vocab)}
    worst_enc = worst = 0.0
    for rows, results in zip(picks[:3], served[:3]):
        uidx = torch.from_numpy(rows.astype(np.int64)).cuda()
        hist = torch.from_numpy(model.history[rows].astype(np.int64)).cuda()
        real = A._fused_attention_forward
        with torch.no_grad():
            enc = net.hist_encoder(hist)
            try:
                A._fused_attention_forward = lambda q, k_, v, c: A._fused_attention_plain(q, k_, v, c)
                enc_plain = net.hist_encoder(hist)
                u = net.embed_users(uidx, hist)
            finally:
                A._fused_attention_forward = real
        worst_enc = max(worst_enc, float((enc - enc_plain).abs().max()))
        scores = (u @ model.device_items().T).cpu().numpy()
        top = np.sort(scores, axis=1)[:, ::-1][:, :k]
        for r, res in enumerate(results):
            got = np.asarray([s.score for s in res.item_scores])
            ids = [item_index[s.item] for s in res.item_scores]
            if len(got) != k or list(got) != sorted(got, reverse=True):
                raise AssertionError(f"two-tower serve: a malformed result {res}")
            worst = max(worst, float(np.abs(got - top[r]).max()))
            if not (np.abs(got - top[r]).max() <= 1e-2 and np.all(scores[r, ids] >= top[r, -1] - 1e-2)):
                raise AssertionError(f"two-tower serve: scores {got} against plain {top[r]}")
    if not worst_enc <= 1e-4:
        raise AssertionError(f"two-tower encoder: {worst_enc} from its plain version")
    emit(phase="twotower_serve", batch=batch, dispatches=n_dispatch, history_len=256,
         attention_block_launches=launches, dispatch_p50_ms=float(np.percentile(lat, 50)),
         dispatch_p99_ms=float(np.percentile(lat, 99)), max_encoder_err=worst_enc,
         max_score_err=worst)
    return launches


def clustered_recall_data(n_users=2000, n_items=1000, n_clusters=20, pos_per_user=30, seed=0):
    """The bench's clustered positives (bench.py:1506-1580): 90 % of a
    user's items in the user's cluster, one in-cluster item held out."""
    rng = np.random.default_rng(seed)
    user_cluster = rng.integers(0, n_clusters, n_users)
    item_cluster = rng.integers(0, n_clusters, n_items)
    items_by_cluster = [np.flatnonzero(item_cluster == c) for c in range(n_clusters)]
    all_items = np.arange(n_items)
    train_u, train_i, test_u, test_i = [], [], [], []
    for u in range(n_users):
        own = items_by_cluster[user_cluster[u]]
        if len(own) < 2:
            continue
        n_in = min(int(round(pos_per_user * 0.9)), len(own))
        in_cluster = rng.choice(own, n_in, replace=False)
        tail = rng.choice(all_items, pos_per_user - n_in, replace=False)
        pos = np.concatenate([in_cluster, tail[tail != in_cluster[0]]])
        train_u.extend([u] * (len(pos) - 1))
        train_i.extend(pos[1:])
        test_u.append(u)
        test_i.append(pos[0])
    return (np.asarray(train_u, np.int32), np.asarray(train_i, np.int32),
            np.asarray(test_u, np.int64), np.asarray(test_i, np.int64))


def twotower_quality_phase(torch, epochs: int = 16) -> dict:
    """recall@10 on the bench's clustered data (embed 32, hidden [64], out
    16, batch 1024, 16 epochs) with a 32-item history encoder, gated at the
    JAX package's CPU value less 0.05, and without the encoder, gated at the
    bench's 0.4; the held-out item ranked among the full catalogue with the
    user's other training items masked."""
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.ops import attention as A

    tu, ti, test_u, test_i = clustered_recall_data()
    out = {}
    for history_len, gate in ((32, JAX_CPU_RECALL_HISTORY_32 - 0.05), (0, BENCH_RECALL_GATE)):
        config = M.TwoTowerConfig(n_users=2000, n_items=1000, embed_dim=32, hidden=(64,),
                                  out_dim=16, batch_size=1024, epochs=epochs, seed=0,
                                  history_len=history_len)
        hist = M.build_history_matrix(tu, ti, None, 2000, history_len) if history_len else None
        A.fused_attention_block.launches = 0
        t0 = time.perf_counter()
        res = M.train_two_tower(tu, ti, config, history=hist, device="cuda")
        wall = time.perf_counter() - t0
        launches = A.fused_attention_block.launches
        net = M.TwoTower(config)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in res.params.items()})
        net = net.cuda().eval()
        h = torch.from_numpy(hist[test_u].astype(np.int64)).cuda() if history_len else None
        u = M.user_embedding(net, torch.from_numpy(test_u).cuda(), h).cpu().numpy()
        scores = u @ res.item_embeddings.T
        for row, user in enumerate(test_u):
            seen = ti[(tu == user) & (ti != test_i[row])]
            scores[row, seen] = -np.inf
        top10 = np.argpartition(-scores, 10, axis=1)[:, :10]
        recall = float(np.mean([t in r for r, t in zip(top10, test_i)]))
        out[history_len] = {"recall_at_10": recall, "gate": gate, "train_wall_s": wall,
                            "losses": res.losses, "attention_block_launches": launches}
        emit(phase="twotower_quality", history_len=history_len, recall_at_10=recall, gate=gate,
             jax_cpu_recall=JAX_CPU_RECALL_HISTORY_32 if history_len else 0.4745,
             chance=10 / 1000, train_wall_s=wall, losses=res.losses,
             attention_block_launches=launches)
        steps = epochs * (len(tu) // 1024)
        if history_len and launches != steps:
            raise AssertionError(f"recall train: B2 launched {launches} times, expected {steps}")
        if not (recall > gate and np.all(np.isfinite(res.losses))):
            raise AssertionError(f"two-tower recall@10 {recall} at history {history_len}: gate {gate}")
    return out


def twotower_cli_phase(home: str, device: str = "cuda") -> dict:
    """app new -> import of an ML-100K-shape file -> train with historyLen
    50 -> deploy, from an engine.json naming the JAX package's factory
    string, then POST /queries.json answered 200."""
    n_users, n_items, n_ratings = 943, 1682, 100_000
    users, items, vals = synthesize_ratings(n_users, n_items, n_ratings, seed=2)
    work = tempfile.mkdtemp(prefix="pio_smoke_tt_")
    events = os.path.join(work, "events.jsonl")
    with open(events, "w") as fh:
        for k, (u, i, r) in enumerate(zip(users.tolist(), items.tolist(), vals.tolist())):
            fh.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{i}",
                "properties": {"rating": r},
                "eventTime": f"2024-01-01T{k // 360000 % 24:02d}:{k // 6000 % 60:02d}:"
                             f"{k // 100 % 60:02d}.{k % 100:03d}Z",
            }) + "\n")
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump({
            "id": "smoke-twotower",
            "engineFactory": "predictionio_tpu.models.twotower.engine_factory",
            "datasource": {"params": {"appName": "ttapp"}},
            "algorithms": [{"name": "twotower", "params": {
                "embedDim": 64, "hidden": [128], "outDim": 32, "epochs": 5, "batchSize": 4096,
                "historyLen": 50, "nHeads": 2}}],
        }, fh)
    cli, env, run = _cli(home)
    steps = {
        "app_new_s": run("app", "new", "ttapp"),
        "import_s": run("import", "--appname", "ttapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    server, base, steps["deploy_ready_s"] = _start_deploy(cli, env, engine_dir, work, device)
    latencies = []
    try:
        for u in range(0, 40, 4):
            status, body, dt = _http(base + "/queries.json", {"user": f"u{u}", "num": 10})
            if status != 200:
                raise AssertionError(f"two-tower query answered {status}")
            _check_result(body, 10, n_items)
            latencies.append(dt)
        status, body, dt = _http(base + "/queries.json", {"user": "no-such-user", "num": 5})
        if status != 200 or body != {"itemScores": []}:
            raise AssertionError(f"unknown user answered {status} {body}")
        latencies.append(dt)
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            outs = list(pool.map(
                lambda u: _http(base + "/queries.json", {"user": f"u{u}", "num": 10}), range(64)))
        for status, body, dt in outs:
            if status != 200:
                raise AssertionError(f"burst query answered {status}")
            _check_result(body, 10, n_items)
            latencies.append(dt)
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
        shutil.rmtree(work, ignore_errors=True)
    lat_ms = np.asarray(latencies) * 1e3
    result = {**steps, "requests": len(latencies), "all_200": True,
              "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
              "largest_batch": st["largestBatch"], "batches": st["batches"], "queries": st["queries"]}
    emit(phase="twotower_cli", shape=[n_users, n_items, n_ratings], history_len=50, **result)
    return result


# ---------------------------------------------------------------------------
# The rest of the template gallery: similar-product, e-commerce and
# recommended-user (implicit ALS through kernel B1), and classification
# ---------------------------------------------------------------------------

# The JAX package's quality values on the CPU, which set the gates below
# (less 0.05); tests/test_torch_similarproduct.py and
# tests/test_torch_recommendeduser.py recompute them through the JAX package
# and hold these constants to them. Similar-product: the share of each
# item's top-10 similar items in its own cluster, on the bench's clustered
# data. Recommended-user: the share of each user's top-10 similar users in
# its own community, on the small follow graph FOLLOW_GATE_GRAPH.
JAX_CPU_SIMILAR_CLUSTER_SHARE = 1.0
JAX_CPU_FOLLOW_COMMUNITY_SHARE = 1.0
FOLLOW_GATE_GRAPH = (5_000, 50, 100_000)  # users, communities, follows
GALLERY_ALS = {"rank": 10, "num_iterations": 10, "lambda_": 0.01, "alpha": 1.0, "seed": 3}


def clustered_item_groups(n_users=2000, n_items=1000, n_clusters=20, seed=0) -> np.ndarray:
    """The item clusters of ``clustered_recall_data`` (its second draw)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, n_clusters, n_users)
    return rng.integers(0, n_clusters, n_items)


def follow_graph(n_users: int, n_communities: int, n_follows: int, seed: int = 0,
                 in_share: float = 0.9):
    """(follower, followed) pairs: user u belongs to community u mod
    ``n_communities``; a follow stays inside the follower's community with
    probability ``in_share``, else goes to any user; self-follows dropped."""
    rng = np.random.default_rng(seed)
    follower = rng.integers(0, n_users, n_follows)
    inside = rng.random(n_follows) < in_share
    same = follower % n_communities + n_communities * rng.integers(
        0, n_users // n_communities, n_follows)
    followed = np.where(inside, same, rng.integers(0, n_users, n_follows))
    keep = followed != follower
    return follower[keep].astype(np.int32), followed[keep].astype(np.int32)


def same_group_share(query_groups, answers) -> float:
    """Mean over queries of the share of the answered ids (integers) whose
    group is the query's; ``answers`` holds (ids, groups of the ids)."""
    shares = [float(np.mean(groups == g)) for g, (_, groups) in zip(query_groups, answers)
              if len(groups)]
    return float(np.mean(shares))


def similar_items_share(algo, model, query_cls, item_cluster: np.ndarray,
                        batch: int = 64) -> float:
    """Each item as a one-item query (top-10, in batches): the share of the
    answers in the query item's cluster."""
    n = len(item_cluster)
    answers = []
    for s in range(0, n, batch):
        res = algo.predict_batch(model, [query_cls(items=(f"i{i}",), num=10)
                                         for i in range(s, min(s + batch, n))])
        for r in res:
            ids = np.asarray([int(x.item[1:]) for x in r.item_scores], np.int64)
            answers.append((ids, item_cluster[ids]))
    return same_group_share(item_cluster, answers)


def similar_users_share(algo, model, query_cls, users: np.ndarray, n_communities: int,
                        batch: int = 64) -> float:
    """Each user as a one-user query (top-10, in batches): the share of the
    answers in the query user's community."""
    answers = []
    for s in range(0, len(users), batch):
        res = algo.predict_batch(model, [query_cls(users=(f"u{u}",), num=10)
                                         for u in users[s : s + batch]])
        for r in res:
            ids = np.asarray([int(x.user[1:]) for x in r.similar_user_scores], np.int64)
            answers.append((ids, ids % n_communities))
    return same_group_share(users % n_communities, answers)


def _counted_train(torch, algo, ctx, td):
    """algo.train with B1's launches counted around it and the wall time."""
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused

    algo.timings = {}
    batched_spd_solve_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = algo.train(ctx, td)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, batched_spd_solve_fused.launches


def _implicit_b1_rows(torch, users, items, counts, n_users, n_items, label: str) -> list[dict]:
    """B1 on a template train's own implicit systems (rank 10): the train
    is repeated outside the counted run to get its factors, then both
    sides' regularised normal equations are solved by B1 and its plain
    version and timed. The limit is the kernel phase's 1e-4 relative to
    each solution's norm: popular items' factors are large, and B1's
    absolute error grows with them."""
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, als_train, pack_tables

    cfg = ALSConfig(rank=GALLERY_ALS["rank"], iterations=GALLERY_ALS["num_iterations"],
                    reg=GALLERY_ALS["lambda_"], implicit=True, alpha=GALLERY_ALS["alpha"],
                    seed=GALLERY_ALS["seed"])
    uf, vf = als_train(users, items, counts, n_users, n_items, cfg, device="cuda")
    tables, block_chunk = pack_tables(users, items, counts, n_users, n_items, cfg, "cuda")
    rows = []
    for side, k, trained, n_side in (("user", 0, vf, n_users), ("item", 4, uf, n_items)):
        opposite = torch.zeros(trained.shape[0] + 1, cfg.rank, device="cuda")
        opposite[:-1] = trained
        A, b = _normal_system(*tables[k : k + 4], opposite, n_side + 1, block_chunk, cfg.reg,
                              True, cfg.alpha, cfg.degree_scaled_reg)
        abs_err, row_rel = b1_errors(torch, A, b)
        if not row_rel <= 1e-4:
            raise AssertionError(f"B1 on the {label} {side} side: row-relative error {row_rel} "
                                 f"(max abs {abs_err})")
        rows.append({"systems": f"{label} {side} side, implicit rank 10", "max_abs_err": abs_err,
                     "max_row_rel_err": row_rel, **b1_times(torch, A, b)})
        del A, b
    for row in rows:
        emit(phase="kernel_real", kernel="spd_cg", **row)
    return rows


def _item_categories(n_items: int, n_categories: int) -> list[frozenset[str]]:
    """One category per item, a second for every third item."""
    return [frozenset({f"c{i % n_categories}"} | ({f"c{(7 * i + 3) % n_categories}"}
                                                  if i % 3 == 0 else set()))
            for i in range(n_items)]


def similarproduct_phase(torch) -> dict:
    """The multi-events-multi-algos variant at the ML-1M shape (6,040 users x
    3,706 items x 1,000,209 views, a 10 % like subset, 200 categories):
    views-ALS and like-ALS at rank 10, 10 iterations, through B1, and
    cooccurrence n = 20; B1 on the views train's own systems; the views
    model served in batches of 64 queries of 1-5 items with category and
    white/black-list filters, every answer checked against its filters and
    its scores against the plain product."""
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.utils.cuda_timing import event_ms
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_items, n_views = 6040, 3706, 1_000_209
    users, items, _ = synthesize_ratings(n_users, n_items, n_views, seed=5)
    rng = np.random.default_rng(31)
    likes = rng.random(len(users)) < 0.1
    cats = _item_categories(n_items, 200)
    td = sp.TrainingData([f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)],
                         cats, users, items, users[likes], items[likes])
    ctx = WorkflowContext(device="cuda", store=None)
    out, launches = {}, {}
    models = {}
    for name, algo in (("als", sp.ALSAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))),
                       ("likealgo", sp.LikeAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))),
                       ("cooccurrence", sp.CooccurrenceAlgorithm(sp.CooccurrenceParams(n=20)))):
        model, wall, n_b1 = _counted_train(torch, algo, ctx, td)
        expected = 0 if name == "cooccurrence" else 2 * GALLERY_ALS["num_iterations"]
        if n_b1 != expected:
            raise AssertionError(f"similar-product {name}: B1 launched {n_b1} times, "
                                 f"expected {expected}")
        launches[name] = n_b1
        models[name] = (algo, model)
        out[name] = {"train_wall_s": wall, "spd_cg_launches": n_b1,
                     **{k: v for k, v in (algo.timings or {}).items() if k.endswith("_s")}}
    pair, counts = np.unique(np.stack([users, items], 1), axis=0, return_counts=True)
    rows = _implicit_b1_rows(torch, pair[:, 0], pair[:, 1], counts.astype(np.float32),
                             n_users, n_items, "ML-1M similar-product views")
    emit(phase="similarproduct_train", shape=[n_users, n_items, n_views],
         likes=int(likes.sum()), categories=200, **out)

    algo, model = models["als"]
    model = algo.prepare_model(WorkflowContext(mode="serving", device="cuda", store=None), model)
    algo.warmup_serving(model, 64)
    popular = np.argsort(-np.bincount(items, minlength=n_items))[:1000]
    all_cats = sorted({c for s in cats for c in s})
    batches = []
    for _ in range(30):
        queries = []
        for r in range(64):
            q_items = tuple(f"i{i}" for i in rng.choice(popular, int(rng.integers(1, 6)), replace=False))
            kw = {}
            if r % 4 == 1:
                kw["categories"] = frozenset(rng.choice(all_cats, 20, replace=False).tolist())
            if r % 5 == 2:
                kw["category_black_list"] = frozenset(rng.choice(all_cats, 20, replace=False).tolist())
            if r % 6 == 3:
                kw["white_list"] = frozenset(f"i{i}" for i in rng.choice(n_items, 400, replace=False))
            if r % 7 == 4:
                kw["black_list"] = frozenset(f"i{i}" for i in popular[:50])
            queries.append(sp.Query(items=q_items, num=10, **kw))
        batches.append(queries)
    lat, results = [], []
    for queries in batches:
        t0 = time.perf_counter()
        results.append(algo.predict_batch_dispatch(model, queries)())
        lat.append((time.perf_counter() - t0) * 1e3)
    table = model.device_factors()
    worst = 0.0
    for queries, served in zip(batches, results):
        for q, res in zip(queries, served):
            got = [s.item for s in res.item_scores]
            qidx = [model.item_index(i) for i in q.items]
            mask = sp.candidate_mask(model, q, qidx)
            if not got or len(got) > q.num or not all(mask[model.item_index(i)] for i in got):
                raise AssertionError(f"similar-product: {got} breaks the filters of {q}")
            scores = torch.where(torch.from_numpy(mask).cuda(), table @ table[qidx].sum(0),
                                 float("-inf"))
            ref = torch.topk(scores, len(got)).values.cpu().numpy()
            worst = max(worst, float(np.abs(np.asarray([s.score for s in res.item_scores]) - ref).max()))
    if not worst <= 1e-5:
        raise AssertionError(f"similar-product served scores off the plain product by {worst}")
    qidx = np.zeros((64, 8), np.int32)
    qidx[:, :3] = rng.choice(popular, (64, 3))
    qw = (qidx > 0).astype(np.float32)
    mask = np.ones((64, n_items), bool)
    ending_ms = event_ms(lambda: topk.gather_sum_top_k_async(table, qidx, qw, mask, 16), reps=50)
    coo_algo, coo_model = models["cooccurrence"]
    t0 = time.perf_counter()
    coo = coo_algo.predict_batch(coo_model, batches[0])
    coo_ms = (time.perf_counter() - t0) * 1e3
    if sum(len(r.item_scores) for r in coo) == 0:
        raise AssertionError("cooccurrence served nothing")
    serve = {"batch": 64, "dispatches": len(batches), "dispatch_p50_ms": float(np.percentile(lat, 50)),
             "dispatch_p99_ms": float(np.percentile(lat, 99)), "max_abs_score_err": worst,
             "gather_sum_ending_ms": ending_ms, "cooccurrence_batch_ms": coo_ms}
    emit(phase="similarproduct_serve", **serve)
    return {"launches": {"similarproduct_views_train": launches["als"],
                         "similarproduct_likes_train": launches["likealgo"]}, "rows": rows}


def similarproduct_quality_phase(torch) -> dict:
    """The views ALS on the bench's clustered data (2,000 users x 1,000
    items, 20 clusters, 90 % in-cluster): the share of each item's top-10
    similar items in its own cluster, gated at the JAX package's CPU value
    less 0.05."""
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    tu, ti, _, _ = clustered_recall_data()
    clusters = clustered_item_groups()
    td = sp.TrainingData([f"u{i}" for i in range(2000)], [f"i{i}" for i in range(1000)],
                         [None] * 1000, tu, ti, tu[:0], ti[:0])
    algo = sp.ALSAlgorithm(sp.ALSAlgorithmParams(**GALLERY_ALS))
    model, wall, _ = _counted_train(torch, algo, WorkflowContext(device="cuda", store=None), td)
    share = similar_items_share(algo, model, sp.Query, clusters)
    gate = JAX_CPU_SIMILAR_CLUSTER_SHARE - 0.05
    emit(phase="similarproduct_quality", same_cluster_share_at_10=share, gate=gate,
         jax_cpu_share=JAX_CPU_SIMILAR_CLUSTER_SHARE, chance=1 / 20, train_wall_s=wall)
    if not share > gate:
        raise AssertionError(f"similar-product same-cluster share {share} under the gate {gate}")
    return {"share": share, "gate": gate}


def ecommerce_phase(torch, home: str) -> dict:
    """bench.py:660's e-commerce shape: 20,000 users x 10,000 items; 1,000,000
    rate events (the template trains on rates) and 100,000 buys of 19,000
    known users, 100,000 views of known users and 500 cold users, 500 cold
    users with no events, 50 categories, an unavailableItems constraint of
    50 items and a weightedItems constraint, all in the port's store (live
    reads go to it). Trains rank 10 at 10 iterations, and 20 for
    adjust-score, through B1; serves batches of 64 (48 known users, 8 cold
    with views, 8 cold without) at cacheTtlS 0 and 60, counting store
    reads in a second pass over the same batches (a positive TTL's cache
    then holds every user's reads); no seen or unavailable item may come
    back, and adjust-score's scores are the plain product times the weight."""
    import datetime as dt

    from predictionio_tpu_torch.data.store import LocalStore
    from predictionio_tpu_torch.models.ecommerce import engine as ec
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.utils.cuda_timing import event_ms
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_known, n_items = 20_000, 19_000, 10_000
    t0 = time.perf_counter()
    ru, ri, rv = synthesize_ratings(n_known, n_items, 1_000_000, seed=7)
    rng = np.random.default_rng(37)
    bu = rng.integers(0, n_known, 100_000).astype(np.int32)
    bi = (rng.zipf(1.3, 100_000) % n_items).astype(np.int32)
    vu = np.where(rng.random(100_000) < 0.8, rng.integers(0, n_known, 100_000),
                  rng.integers(n_known, n_known + 500, 100_000)).astype(np.int32)
    vi = (rng.zipf(1.3, 100_000) % n_items).astype(np.int32)
    cats = [frozenset({f"c{i % 50}"}) for i in range(n_items)]
    unavailable = [f"i{i}" for i in rng.choice(n_items, 50, replace=False)]
    up, down = rng.choice(n_items, 150, replace=False).reshape(2, 75)
    weights_prop = [{"items": [f"i{i}" for i in up], "weight": 2.0},
                    {"items": [f"i{i}" for i in down], "weight": 0.5}]
    store = LocalStore(os.path.join(home, "ecom"))
    app_id = store.create_app("ecomapp")
    path = os.path.join(store.root, "events", f"{app_id}.jsonl")  # the store's layout
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t_base = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc).timestamp()

    def when(k):
        return dt.datetime.fromtimestamp(t_base + k * 1e-3, dt.timezone.utc).isoformat(
            timespec="milliseconds").replace("+00:00", "Z")

    def line(k, event, u, i, props="{}"):
        t = when(k)
        return (f'{{"creationTime": "{t}", "entityId": "u{u}", "entityType": "user", "event": '
                f'"{event}", "eventId": "{event[0]}{k}", "eventTime": "{t}", "properties": {props}, '
                f'"targetEntityId": "i{i}", "targetEntityType": "item"}}\n')

    k = 0
    lines = []
    for i in range(n_items):
        t = when(k)
        lines.append(json.dumps({"creationTime": t, "entityId": f"i{i}", "entityType": "item",
                                 "event": "$set", "eventId": f"s{k}", "eventTime": t,
                                 "properties": {"categories": sorted(cats[i])}}) + "\n")
        k += 1
    for name, us, its, vals in (("rate", ru, ri, rv), ("buy", bu, bi, None), ("view", vu, vi, None)):
        for n, (u, i) in enumerate(zip(us.tolist(), its.tolist())):
            props = f'{{"rating": {vals[n]}}}' if vals is not None else "{}"
            lines.append(line(k, name, u, i, props))
            k += 1
    for entity, props in (("unavailableItems", {"items": unavailable}),
                          ("weightedItems", {"weights": weights_prop})):
        t = when(k)
        lines.append(json.dumps({"creationTime": t, "entityId": entity, "entityType": "constraint",
                                 "event": "$set", "eventId": f"c{k}", "eventTime": t,
                                 "properties": props}) + "\n")
        k += 1
    with open(path, "a") as fh:
        fh.writelines(lines)
    del lines
    data_s = time.perf_counter() - t0
    td = ec.TrainingData([f"u{i}" for i in range(n_known)], [f"i{i}" for i in range(n_items)],
                         cats, ru, ri, rv, bu, bi)
    ctx = WorkflowContext(device="cuda", store=store, app_name="ecomapp")
    base = dict(GALLERY_ALS, app_name="ecomapp", unseen_only=True)
    trained, launches, train_out = {}, {}, {}
    for name, params in (("default", ec.ECommAlgorithmParams(**base)),
                         ("adjust-score", ec.ECommAlgorithmParams(**dict(
                             base, num_iterations=20, adjust_score=True)))):
        algo = ec.ECommAlgorithm(params)
        model, wall, n_b1 = _counted_train(torch, algo, ctx, td)
        if n_b1 != 2 * params.num_iterations:
            raise AssertionError(f"e-commerce {name}: B1 launched {n_b1} times")
        trained[name] = algo.prepare_model(ctx, model)
        launches[name] = n_b1
        train_out[name] = {"train_wall_s": wall, "spd_cg_launches": n_b1,
                           **{k: v for k, v in algo.timings.items() if k.endswith("_s")}}
    emit(phase="ecommerce_train", shape=[n_users, n_items, 1_000_000, 100_000, 100_000],
         events_in_store=k, data_s=data_s, **train_out)

    t0 = time.perf_counter()
    store.find_by_entity("ecomapp", "user", "u0")  # the entity index, built on first read
    index_s = time.perf_counter() - t0
    unavail = set(unavailable)
    batches = []
    for _ in range(12):
        us = np.concatenate([rng.integers(0, n_known, 48), rng.integers(n_known, n_known + 500, 8),
                             rng.integers(n_known + 500, n_users, 8)])
        queries = []
        for r, u in enumerate(us.tolist()):
            kw = {"categories": frozenset({f"c{r % 50}", f"c{(r + 7) % 50}"})} if r % 5 == 0 else {}
            queries.append(ec.Query(user=f"u{u}", num=10, **kw))
        batches.append(queries)
    serve = {"entity_index_build_s": index_s}
    reads = []
    real_find = store.find_by_entity
    store.find_by_entity = lambda *a, **kw: reads.append(1) or real_find(*a, **kw)
    try:
        for name, model in trained.items():
            for ttl in (0.0, 60.0):
                params = ec.ECommAlgorithmParams(**dict(
                    base, num_iterations=20 if name != "default" else 10,
                    adjust_score=name != "default", cache_ttl_s=ttl))
                algo = ec.ECommAlgorithm(params)
                algo.warmup_serving(model, 64)
                reads.clear()
                for queries in batches:  # a first pass fills a positive TTL's cache
                    algo.predict_batch(model, queries)
                first_reads = len(reads)
                lat, results = [], []
                reads.clear()
                for queries in batches[1:]:
                    t0 = time.perf_counter()
                    results.append(algo.predict_batch_dispatch(model, queries)())
                    lat.append((time.perf_counter() - t0) * 1e3)
                n_reads = len(reads)
                for queries, served in zip(batches[1:], results):
                    for q, res in zip(queries, served):
                        got = {s.item for s in res.item_scores}
                        seen = algo._seen_items_live(ctx, q.user)
                        if len(res.item_scores) != 10 or got & unavail or got & seen:
                            raise AssertionError(f"e-commerce {name}: {sorted(got)} for {q}")
                        if q.categories and not all(cats[int(i[1:])] & q.categories for i in got):
                            raise AssertionError(f"e-commerce {name}: category filter broken")
                n_q = 64 * (len(batches) - 1)
                serve[f"{name}_ttl_{int(ttl)}"] = {
                    "dispatch_p50_ms": float(np.percentile(lat, 50)),
                    "dispatch_p99_ms": float(np.percentile(lat, 99)),
                    "store_reads_per_query": n_reads / n_q,
                    "first_pass_store_reads_per_query": first_reads / (64 * len(batches))}
                if ttl > 0 and n_reads != 0:
                    raise AssertionError(f"e-commerce at cacheTtlS {ttl}: {n_reads} store reads")
    finally:
        store.find_by_entity = real_find
    model = trained["adjust-score"]
    algo = ec.ECommAlgorithm(ec.ECommAlgorithmParams(**dict(base, adjust_score=True)))
    weights = algo._item_weights_live(ctx, model)
    worst = 0.0
    for q, res in zip(batches[1][:48], algo.predict_batch(model, batches[1][:48])):
        u = model.user_index(q.user)
        for s in res.item_scores:
            i = model.item_index(s.item)
            plain = float(model.user_factors[u].astype(np.float64) @ model.item_factors[i])
            worst = max(worst, abs(s.score - plain * weights[i]) / max(abs(plain * weights[i]), 1e-6))
    if not worst <= 1e-5:
        raise AssertionError(f"adjust-score: weighted scores off plain x weight by {worst}")
    table = model.device_items()
    vecs = np.ascontiguousarray(model.user_factors[:64])
    mask = np.ones((64, n_items), bool)
    serve["weighted_dot_ending_ms"] = event_ms(
        lambda: topk.dot_top_k_async(table, vecs, mask, 16, weights=weights), reps=50)
    serve["adjust_score_max_rel_err"] = worst
    emit(phase="ecommerce_serve", batch=64, dispatches=len(batches) - 1, **serve)
    return {"launches": {"ecommerce_train": launches["default"],
                         "ecommerce_adjust_score_train": launches["adjust-score"]}}


def recommendeduser_phase(torch) -> dict:
    """A follow graph of 50,000 users in 50 communities with 1,000,000
    follows (90 % inside the community): implicit ALS at rank 10, 10
    iterations, through B1; 2,048 users served in batches of 64; the
    same-community share of their top-10 gated at the JAX package's CPU
    value on the small graph less 0.05."""
    from predictionio_tpu_torch.models.recommendeduser import engine as ru
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    n_users, n_comm, n_follows = 50_000, 50, 1_000_000
    follower, followed = follow_graph(n_users, n_comm, n_follows, seed=8)
    vocab = [f"u{i}" for i in range(n_users)]
    td = ru.TrainingData(vocab, vocab, follower, followed)
    algo = ru.ALSAlgorithm(ru.ALSAlgorithmParams(**GALLERY_ALS))
    ctx = WorkflowContext(device="cuda", store=None)
    model, wall, n_b1 = _counted_train(torch, algo, ctx, td)
    if n_b1 != 2 * GALLERY_ALS["num_iterations"]:
        raise AssertionError(f"recommended-user: B1 launched {n_b1} times")
    timings = {k: v for k, v in algo.timings.items() if k.endswith("_s")}
    model = algo.prepare_model(WorkflowContext(mode="serving", device="cuda", store=None), model)
    algo.warmup_serving(model, 64)
    users = np.random.default_rng(41).choice(n_users, 2048, replace=False)
    lat = []
    for s in range(0, 2048, 64):
        queries = [ru.Query(users=(f"u{u}",), num=10) for u in users[s : s + 64]]
        t0 = time.perf_counter()
        algo.predict_batch_dispatch(model, queries)()
        lat.append((time.perf_counter() - t0) * 1e3)
    share = similar_users_share(algo, model, ru.Query, users, n_comm)
    gate = JAX_CPU_FOLLOW_COMMUNITY_SHARE - 0.05
    emit(phase="recommendeduser", shape=[n_users, n_comm, len(follower)], train_wall_s=wall,
         spd_cg_launches=n_b1, **timings, dispatch_p50_ms=float(np.percentile(lat, 50)),
         dispatch_p99_ms=float(np.percentile(lat, 99)), same_community_share_at_10=share,
         gate=gate, jax_cpu_share=JAX_CPU_FOLLOW_COMMUNITY_SHARE,
         jax_cpu_graph=list(FOLLOW_GATE_GRAPH), chance=1 / n_comm)
    if not share > gate:
        raise AssertionError(f"recommended-user same-community share {share} under {gate}")
    return {"launches": {"recommendeduser_train": n_b1}}


def _nb_host_labels(model, X: np.ndarray):
    """The float64 host labels of naive Bayes, and where the top two scores
    lie within 1e-5 relative (a float32 score may order them otherwise)."""
    scores = model.log_priors[None, :] + np.asarray(X, np.float64) @ model.log_theta.T
    top2 = np.sort(scores, axis=1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 1e-5 * np.abs(top2[:, 1])
    return model.labels[np.argmax(scores, axis=1)], near


def classification_phase(torch, home: str) -> dict:
    """Naive Bayes at bench.py:2461's shape (200,000 points x 64 features x
    8 classes): scores and argmax of the 200,000 points on the card against
    the float64 host labels (equal except where the top two scores lie
    within 1e-5 relative); then the add-algorithm variant (naive Bayes and
    the forest) through Engine.train from 1,000 points in the store."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.store import LocalStore
    from predictionio_tpu_torch.models.classification import engine as cl
    from predictionio_tpu_torch.ops.classify import _nb_scores, train_naive_bayes
    from predictionio_tpu_torch.utils.cuda_timing import event_ms
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 8, 200_000).astype(np.float64)
    feats = rng.poisson(2.0, size=(200_000, 64)).astype(np.float64)
    t0 = time.perf_counter()
    model = train_naive_bayes(labels, feats, 1.0)
    train_s = time.perf_counter() - t0
    model.device = "cuda"
    model.predict_batch(feats[:8])  # the tables onto the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.predict_batch(feats)
    predict_s = time.perf_counter() - t0
    want, near = _nb_host_labels(model, feats)
    wrong = int(np.sum((got != want) & ~near))
    lp, lt = model.device_params()
    x = torch.from_numpy(feats.astype(np.float32)).cuda()
    scores_ms = event_ms(lambda: torch.argmax(_nb_scores(lp, lt, x), dim=1), reps=20)
    emit(phase="classification_nb", shape=[200_000, 64, 8], train_s=train_s,
         predict_batch_s=predict_s, nb_scores_argmax_ms=scores_ms,
         label_mismatches=int(np.sum(got != want)), near_ties=int(near.sum()),
         mismatches_outside_ties=wrong)
    if wrong:
        raise AssertionError(f"naive Bayes on the card: {wrong} labels differ outside near ties")
    store = LocalStore(os.path.join(home, "cls"))
    store.create_app("clsapp")
    c = rng.integers(0, 3, 1000)
    store.append("clsapp", [
        Event("$set", "user", f"u{p}", properties={
            "plan": float(c[p]), **{f"attr{j}": float(rng.poisson(2 + 3 * ((c[p] + j) % 3)))
                                    for j in range(3)}})
        for p in range(1000)])
    engine = cl.engine_factory()
    ep = engine.engine_params_from_variant({
        "datasource": {"params": {"appName": "clsapp"}},
        "algorithms": [{"name": "naive", "params": {"lambda": 1.0}},
                       {"name": "randomforest", "params": {"numTrees": 10, "maxDepth": 4,
                                                           "seed": 42}}]})
    ctx = WorkflowContext(device="cuda", store=store, app_name="clsapp")
    t0 = time.perf_counter()
    models = engine.prepare_deploy(ctx, ep, engine.train(ctx, ep))
    train2_s = time.perf_counter() - t0
    _, _, algos, _ = engine.make_components(ep)
    X = rng.poisson(4, size=(200, 3)).astype(np.float64)
    queries = [cl.Query(*x) for x in X]
    nb = [algos[0].predict(models[0], q).label for q in queries]
    rf = [algos[1].predict(models[1], q).label for q in queries]
    agree_nb_rf = float(np.mean(np.asarray(nb) == np.asarray(rf)))
    want, near = _nb_host_labels(models[0], X)
    if np.any((models[0].predict_batch(X) != np.asarray(nb)) & ~near) or not set(rf) <= {0.0, 1.0, 2.0}:
        raise AssertionError("add-algorithm: device labels differ from the host's, or bad labels")
    emit(phase="classification_add_algorithm", points=1000, train_s=train2_s,
         nb_forest_agreement=agree_nb_rf)
    return {}


# ---------------------------------------------------------------------------
# The four templates through the CLI
# ---------------------------------------------------------------------------


def _gallery_event_lines(template: str, rng) -> tuple[list[dict], list[dict]]:
    """ML-100K-shape events of a template (1,000 points for classification)
    and 200 queries for it."""
    n_users, n_items = 943, 1682
    events: list[dict] = []

    def ev(k, event, entity_type, entity_id, target=None, props=None, target_type="item"):
        d = {"event": event, "entityType": entity_type, "entityId": entity_id,
             "eventTime": f"2024-01-01T{k // 3600000 % 24:02d}:{k // 60000 % 60:02d}:"
                          f"{k // 1000 % 60:02d}.{k % 1000:03d}Z", "eventId": f"e{k}"}
        if target is not None:
            d.update(targetEntityType=target_type, targetEntityId=target)
        if props is not None:
            d["properties"] = props
        events.append(d)

    k = 0
    if template == "classification":
        for p in range(1000):
            c = int(rng.integers(3))
            ev(k, "$set", "user", f"u{p}", props={"plan": float(c), **{
                f"attr{j}": float(rng.poisson(2 + 3 * ((c + j) % 3))) for j in range(3)}})
            k += 1
        queries = [{f"attr{j}": float(x) for j, x in enumerate(rng.poisson(4, 3))}
                   for _ in range(200)]
        return events, queries
    if template == "recommendeduser":
        follower, followed = follow_graph(n_users, 23, 100_000, seed=9)
        for u, v in zip(follower.tolist(), followed.tolist()):
            ev(k, "follow", "user", f"u{u}", f"u{v}", target_type="user")
            k += 1
        queries = [{"users": [f"u{u}" for u in rng.choice(n_users, int(rng.integers(1, 4)))],
                    "num": 10} for _ in range(200)]
        return events, queries
    users, items, vals = synthesize_ratings(n_users, n_items, 100_000, seed=11)
    for i in range(n_items):
        ev(k, "$set", "item", f"i{i}", props={"categories": [f"c{i % 20}"]})
        k += 1
    if template == "similarproduct":
        likes = rng.random(len(users)) < 0.1
        for u, i, like in zip(users.tolist(), items.tolist(), likes.tolist()):
            ev(k, "like" if like else "view", "user", f"u{u}", f"i{i}")
            k += 1
        queries = [{"items": [f"i{i}" for i in rng.choice(400, int(rng.integers(1, 4)), replace=False)],
                    "num": 10, **({"categories": ["c1", "c2", "c3"]} if q % 4 == 0 else {})}
                   for q in range(200)]
        return events, queries
    for u, i, r in zip(users.tolist(), items.tolist(), vals.tolist()):
        ev(k, "rate", "user", f"u{u}", f"i{i}", props={"rating": r})
        k += 1
    for u, i in zip(rng.integers(0, n_users, 5000).tolist(), rng.integers(0, n_items, 5000).tolist()):
        ev(k, "buy", "user", f"u{u}", f"i{i}")
        k += 1
    for u, i in zip(rng.integers(0, n_users + 50, 5000).tolist(), rng.integers(0, n_items, 5000).tolist()):
        ev(k, "view", "user", f"u{u}", f"i{i}")
        k += 1
    ev(k, "$set", "constraint", "unavailableItems", props={"items": [f"i{i}" for i in range(0, 100, 10)]})
    queries = [{"user": f"u{u}", "num": 10} for u in rng.integers(0, n_users + 100, 200)]
    return events, queries


def _check_gallery_answer(template: str, query: dict, body: dict) -> None:
    if template == "classification":
        if set(body) != {"label"} or body["label"] not in (0.0, 1.0, 2.0):
            raise AssertionError(f"classification answered {body}")
        return
    key, id_key = (("similarUserScores", "user") if template == "recommendeduser"
                   else ("itemScores", "item"))
    rows = body[key]
    if set(body) != {key} or len(rows) > query.get("num", 10):
        raise AssertionError(f"{template} answered {body}")
    scores = [r["score"] for r in rows]
    if any(not (isinstance(r[id_key], str) and np.isfinite(r["score"])) for r in rows) or \
            scores != sorted(scores, reverse=True):
        raise AssertionError(f"{template}: malformed answer {body}")
    own = set(query.get("items", [])) | set(query.get("users", []))
    if own & {r[id_key] for r in rows}:
        raise AssertionError(f"{template}: a query's own id was served: {body}")
    if template == "ecommerce" and {r["item"] for r in rows} & {f"i{i}" for i in range(0, 100, 10)}:
        raise AssertionError(f"e-commerce served an unavailable item: {body}")


GALLERY_CLI = {
    # template -> the JAX package's engine.json (or variant) it deploys from
    "similarproduct": "predictionio_tpu/models/similarproduct/variants/multi-events-multi-algos.json",
    "ecommerce": "predictionio_tpu/models/ecommerce/engine.json",
    "recommendeduser": "predictionio_tpu/models/recommendeduser/engine.json",
    "classification": "predictionio_tpu/models/classification/variants/add-algorithm.json",
}


def gallery_cli_setup(home: str, template: str, device: str = "cuda") -> dict:
    """app new -> import -> train through the port's CLI from the JAX
    package's engine.json for the template (its engineFactory string)."""
    rng = np.random.default_rng(17)
    events, queries = _gallery_event_lines(template, rng)
    work = tempfile.mkdtemp(prefix=f"pio_smoke_{template}_")
    path = os.path.join(work, "events.jsonl")
    with open(path, "w") as fh:
        fh.writelines(json.dumps(e) + "\n" for e in events)
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, GALLERY_CLI[template])) as fh:
        variant = json.load(fh)
    app = f"{template}app"
    variant["datasource"]["params"]["appName"] = app
    for algo in variant["algorithms"]:
        if "appName" in algo["params"]:
            algo["params"]["appName"] = app
    engine_dir = os.path.join(work, "engine")
    os.makedirs(engine_dir)
    with open(os.path.join(engine_dir, "engine.json"), "w") as fh:
        json.dump(variant, fh)
    cli, env, run = _cli(os.path.join(home, template))
    steps = {"app_new_s": run("app", "new", app),
             "import_s": run("import", "--appname", app, "--input", path),
             "train_s": run("train", "--engine-dir", engine_dir, "--device", device)}
    return {"template": template, "work": work, "engine_dir": engine_dir, "cli": cli, "env": env,
            "queries": queries, "events": len(events), "steps": steps,
            "engine_factory": variant["engineFactory"]}


def gallery_cli_serve(setup: dict, device: str = "cuda") -> dict:
    """deploy, then 200 queries: 40 one at a time, 160 from 32 clients at
    once; every answer a 200 and well formed."""
    template = setup["template"]
    server, base, ready_s = _start_deploy(setup["cli"], setup["env"], setup["engine_dir"],
                                          setup["work"], device)
    queries = setup["queries"]
    try:
        outs = [_http(base + "/queries.json", q) for q in queries[:40]]
        with concurrent.futures.ThreadPoolExecutor(32) as pool:
            outs += list(pool.map(lambda q: _http(base + "/queries.json", q), queries[40:]))
        for q, (status, body, _) in zip(queries, outs):
            if status != 200:
                raise AssertionError(f"{template}: {q} answered {status}")
            _check_gallery_answer(template, q, body)
        _, st, _ = _http(base + "/")
    finally:
        _stop(server)
        shutil.rmtree(setup["work"], ignore_errors=True)
    lat_ms = np.asarray([dt for _, _, dt in outs]) * 1e3
    result = {**setup["steps"], "deploy_ready_s": ready_s, "requests": len(outs), "all_200": True,
              "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
              "largest_batch": st["largestBatch"], "batches": st["batches"],
              "events": setup["events"], "engine_factory": setup["engine_factory"]}
    emit(phase=f"{template}_cli", **result)
    return result


def gallery_cli_phase(home: str, device: str = "cuda") -> dict:
    """The four templates through the CLI: their imports and trains run
    side by side (independent processes and stores), then each is deployed
    and queried alone, so that latencies see one server at a time."""
    with concurrent.futures.ThreadPoolExecutor(len(GALLERY_CLI)) as pool:
        setups = list(pool.map(lambda t: gallery_cli_setup(home, t, device), GALLERY_CLI))
    return {s["template"]: gallery_cli_serve(s, device) for s in setups}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from predictionio_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    build_s = _build.build(KERNELS)
    emit(phase="env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kernel_build_s=build_s,
         ptxas={name: [ln.strip() for ln in _build.build_logs.get(name, "").splitlines()
                       if "registers" in ln or "spill" in ln] for name in KERNELS})
    home = tempfile.mkdtemp(prefix="pio_smoke_home_")
    try:
        kernel_phase(torch)
        grid_row = kernel_grid_phase(torch)
        td, model, launches = train_phase(torch, home)
        kernel = real_system_check(torch, td, model, launches)
        cli_serve_phase(os.path.join(home, "cli"))
        inprocess_serve_phase(torch, model)
        del td, model
        rank160, rank160_launches = als_rank160_phase(torch, home)
        attention_kernel_phase(torch)
        wide_rows = wide_head_times(torch)
        seq_model, sessions, seq_launches = sequential_train_phase(torch, home)
        attention = sequential_serve_phase(torch, seq_model, sessions)
        sequential_cli_phase(os.path.join(home, "seq_cli"))
        del seq_model, sessions
        tt_model, tt_algo, tt_td, tt_train_launches = twotower_train_phase(torch, home)
        tt_serve_launches = twotower_serve_phase(torch, tt_model, tt_algo)
        rng = np.random.default_rng(23)
        b2_rows = [b2_times(torch, *encoder_qkv(torch, tt_model, rng.integers(0, 138_000, b)), label)
                   for b, label in ((4096, "two-tower training"), (64, "two-tower serving"))]
        del tt_model
        twotower_step_split(torch, tt_td)
        del tt_td
        twotower_quality_phase(torch)
        twotower_cli_phase(os.path.join(home, "tt_cli"))
        similar = similarproduct_phase(torch)
        similarproduct_quality_phase(torch)
        ecommerce = ecommerce_phase(torch, home)
        recuser = recommendeduser_phase(torch)
        classification_phase(torch, home)
        gallery_cli_phase(os.path.join(home, "gallery_cli"))
    finally:
        shutil.rmtree(home, ignore_errors=True)
    kernel["launches_by_path"] = {"als_train": launches, "sequential_train": seq_launches,
                                  "als_train_rank_160": rank160_launches,
                                  **similar["launches"], **ecommerce["launches"],
                                  **recuser["launches"]}
    kernel["launches"] = sum(kernel["launches_by_path"].values())
    kernel["other_shapes"] += rank160["rows"] + similar["rows"] + [grid_row]
    block = next(e for e in attention if e["name"] == "attention_block")
    block["launches_by_path"].update(twotower_train=tt_train_launches,
                                     twotower_serve=tt_serve_launches)
    block["launches"] = sum(block["launches_by_path"].values())
    block["other_shapes"] = b2_rows + [r for r in wide_rows if r["kernel"] == "attention_block"]
    flash = next(e for e in attention if e["name"] == "flash_attention")
    flash["other_shapes"] = [r for r in wide_rows if r["kernel"] == "flash_attention"]
    print(json.dumps({"kernels": [kernel, *attention]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
