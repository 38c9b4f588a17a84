#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:
``python3 chip_smoke.py``. It builds the CUDA kernels from the checkout's
sources (nvcc, one process per source, all started together, into
build/kernels/), then drives two main paths.

The recommendation template (ALS, kernel B1):

1. kernel phase: kernel B1 (csrc/spd_cg.cu) against its plain PyTorch
   version on the card, on well-conditioned systems at ranks
   10/16/32/64/100;
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
   and checked against a plain torch.topk.

The sequential template (attention scorer, kernels B1, B2 and B3):

4. kernel phase: B2 (csrc/attention_block.cu) and B3
   (csrc/flash_attention.cu) against their plain versions and the f32
   reference, causal and not, at the scorer's widths, at ragged lengths,
   with Lq != Lk and, for B2, with a 10,000-key axis;
5. train phase: AttentionAlgorithm.train at the ML-1M shape (6,040 users x
   3,706 items x 1,000,209 synthetic view events from the bench's hop
   generator, rank 32, 10 iterations), B1's launches read around it, and
   held-out hit-rate@10 of the attention and Markov scorers;
6. serve phase: that model through AttentionAlgorithm.predict_batch_dispatch
   in batches of 64 at context 8, 200 and 1024, with B2's (or B3's)
   launches read around each context, served scores held against a
   torch.topk over the plain-version session vectors, and each kernel
   timed at its serving shape beside its bound, its plain version and
   torch's scaled_dot_product_attention as a yardstick: eager calls by CUDA
   events (``ms``, host cost included) and a replayed CUDA graph
   (``graph_ms``, device time per launch);
7. CLI phase: app new, import of an ML-100K-shape view file, train and
   deploy of the attention algorithm, then POST /queries.json.

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


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


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
    A = np.einsum("bdf,bdg->bfg", G, G) + reg * (3 * f) * np.eye(f, dtype=np.float32)
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
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    for f in (10, 16, 32, 64, 100):
        n = 1000 + 7 * f + 3  # not a multiple of any tile
        A, b = spd_batch(n, f, seed=f)
        A_d, b_d = torch.from_numpy(A).cuda(), torch.from_numpy(b).cuda()
        x = batched_spd_solve_fused(A_d, b_d)
        ref = _cg_body(A_d, b_d, f + 4)
        torch.cuda.synchronize()
        err = float((x - ref).abs().max())
        # atol 1e-4: the same f32 algorithm, summed in another order over f+4 steps
        if not (torch.isfinite(x).all() and err <= 1e-4):
            raise AssertionError(f"B1 disagrees with _cg_body at f={f}: max abs err {err}")
        emit(phase="kernel", kernel="spd_cg", n=n, f=f, max_abs_err=err, atol=1e-4)


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
        td, model, launches = train_phase(torch, home)
        kernel = real_system_check(torch, td, model, launches)
        cli_serve_phase(os.path.join(home, "cli"))
        inprocess_serve_phase(torch, model)
        del td, model
        attention_kernel_phase(torch)
        seq_model, sessions, seq_launches = sequential_train_phase(torch, home)
        attention = sequential_serve_phase(torch, seq_model, sessions)
        sequential_cli_phase(os.path.join(home, "seq_cli"))
    finally:
        shutil.rmtree(home, ignore_errors=True)
    kernel["launches_by_path"] = {"als_train": launches, "sequential_train": seq_launches}
    kernel["launches"] = launches + seq_launches
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
