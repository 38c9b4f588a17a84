#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:
``python3 chip_smoke.py``. It builds the CUDA kernels from the checkout's
sources (nvcc, into build/kernels/), then:

1. kernel phase: kernel B1 (csrc/spd_cg.cu) against its plain PyTorch
   version on the card, on well-conditioned systems at ranks 10/16/32/64;
2. train phase: the recommendation template's ALSAlgorithm.train at the
   ML-20M shape (138,000 users x 27,000 items x 20 M synthetic ratings,
   rank 32, 10 iterations), held-out RMSE gated at 0.45, with B1's launch
   count read around the run; then B1 against the plain version and the
   library Cholesky on the real user-side systems of that model, timed;
3. serve phase: the port's CLI in subprocesses (app new, import of an
   ML-100K-shape event file, train, deploy) answering POST /queries.json,
   then the ML-20M model served in-process through ServingIndex.serve_batch
   and checked against a plain torch.topk.

Every phase that fails raises, so the script exits non-zero and prints no
result. The last line is ``{"ok": true, "device": {...}}``; the line before
it is nvidia-smi's name and power limit; before that one JSON line lists
every kernel with its launches on the main path, errors and times.
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
SOURCE = "predictionio_tpu_torch/ops/csrc/spd_cg.cu"
REPLACES = "predictionio_tpu/ops/spd_solve.py:76"


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


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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

    for f in (10, 16, 32, 64):
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


def real_system_check(torch, td, model, launches: int) -> dict:
    """B1 on the real user-side systems of the trained model, against the
    plain version and timed beside it and the library Cholesky."""
    from predictionio_tpu_torch.ops.als import ALSConfig, _normal_system, pack_tables
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    n_users, n_items = len(td.user_vocab), len(td.item_vocab)
    cfg = ALSConfig(rank=32, reg=0.05, chunk=65536)
    tables, block_chunk = pack_tables(
        td.user_idx, td.item_idx, td.ratings, n_users, n_items, cfg, "cuda"
    )
    item_f = torch.zeros(n_items + 1, cfg.rank, device="cuda")
    item_f[:n_items] = torch.from_numpy(model.item_factors).cuda()
    A, b = _normal_system(
        *tables[:4], item_f, n_users + 1, block_chunk, cfg.reg, False, 1.0, True
    )
    del tables
    n, f = b.shape
    x = batched_spd_solve_fused(A, b)
    ref = _cg_body(A, b, f + 4)
    torch.cuda.synchronize()
    abs_err = float((x - ref).abs().max())
    row_rel = float(((x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)).max())
    # row-relative 1e-3: one f32 algorithm, summed in another order over f+4 steps
    if not (torch.isfinite(x).all() and row_rel <= 1e-3):
        raise AssertionError(f"B1 on the ML-20M user side: row-relative error {row_rel}")
    ms = cuda_ms(torch, lambda: batched_spd_solve_fused(A, b), reps=20)
    plain_ms = cuda_ms(torch, lambda: _cg_body(A, b, f + 4), reps=5)

    def library():
        L = torch.linalg.cholesky(A)
        return torch.cholesky_solve(b[..., None], L)

    library_ms = cuda_ms(torch, library, reps=5)
    bound_ms, bound_by = cg_bound_ms(n, f)
    emit(
        phase="kernel_real", kernel="spd_cg", n=n, f=f, max_abs_err=abs_err,
        max_row_rel_err=row_rel, kernel_ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
    )
    return {
        "name": "spd_cg",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
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
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", home]

    def run(*args, timeout=600):
        t0 = time.perf_counter()
        proc = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise AssertionError(f"cli {args[0]} failed ({proc.returncode}):\n{proc.stderr}")
        return time.perf_counter() - t0

    steps = {
        "app_new_s": run("app", "new", "smokeapp"),
        "import_s": run("import", "--appname", "smokeapp", "--input", events),
        "train_s": run("train", "--engine-dir", engine_dir, "--device", device),
    }
    port = _free_port()
    with open(os.path.join(work, "deploy.err"), "w") as err:  # the child keeps its own copy
        server = subprocess.Popen(
            [*cli, "deploy", "--engine-dir", engine_dir, "--device", device,
             "--ip", "127.0.0.1", "--port", str(port)],
            env=env, stdout=subprocess.DEVNULL, stderr=err,
        )
    base = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            if server.poll() is not None:
                with open(os.path.join(work, "deploy.err")) as fh:
                    raise AssertionError(f"deploy exited {server.returncode}: {fh.read()}")
            try:
                status, _, _ = _http(base + "/", timeout=2)
                if status == 200:
                    break
            except (urllib.error.URLError, ConnectionError, TimeoutError):
                pass
            if time.perf_counter() - t0 > 180:
                raise AssertionError("deploy did not answer GET / within 180 s")
            time.sleep(0.2)
        steps["deploy_ready_s"] = time.perf_counter() - t0
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
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
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
    build_s = _build.build(["spd_cg"])
    emit(phase="env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kernel_build_s=build_s,
         ptxas=[ln.strip() for ln in _build.build_logs.get("spd_cg", "").splitlines()
                if "registers" in ln or "spill" in ln])
    home = tempfile.mkdtemp(prefix="pio_smoke_home_")
    try:
        kernel_phase(torch)
        td, model, launches = train_phase(torch, home)
        kernel = real_system_check(torch, td, model, launches)
        cli_serve_phase(os.path.join(home, "cli"))
        inprocess_serve_phase(torch, model)
    finally:
        shutil.rmtree(home, ignore_errors=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
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
