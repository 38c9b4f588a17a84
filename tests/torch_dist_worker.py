"""One gloo rank of the port's multi-rank CPU tests, and the helper that
starts a job of them.

``run_world(n, cases, out_dir)`` starts ``n`` processes of this file with
the launcher's environment contract (``PIO_COORDINATOR``,
``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``), waits at most ``timeout``
seconds and fails on a hang or a non-zero exit. Each process joins the job
on the CPU (gloo; on the card for cases named ``*_cuda``), runs the named
cases in order and writes each case's arrays to
``out_dir/<case>.rank<r>.npz``. The inputs come from numpy seeds
through the functions below, which the tests call too; the two-tower
cases also read the initial state the test writes to ``out_dir``. This
file imports torch and the port, never JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# (rank f, implicit, gather_dtype) of the one-step ALS parity cases
ALS_STEP_CASES = [
    (4, False, "f32"), (8, False, "f32"), (4, True, "f32"), (8, True, "f32"),
    (4, False, "bf16"), (8, False, "bf16"), (8, True, "bf16"),
]
ALS_SHAPE = dict(n_users=50, n_items=37, nnz=1200, d=16, block_chunk=8, reg=0.05, alpha=0.7)
ATTN_SHAPE = (2, 4, 16, 8)  # B, H, L, D
TWO_TOWER_MESHES = {
    2: [("data=2,model=1", False, "ring"), ("data=1,model=2", True, "ring"),
        ("data=1,model=2", True, "ulysses"), ("model=2", False, "ring")],
    4: [("data=2,model=2", True, "ring")],
}


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds)
# ---------------------------------------------------------------------------


def als_ratings(n_users: int, n_items: int, nnz: int, seed: int = 11):
    """Low-rank half-star ratings; the last users and items get none."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users - 3, nnz).astype(np.int32)
    i = rng.integers(0, n_items - 4, nnz).astype(np.int32)
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
    v = np.round(np.sum(U[u] * V[i], axis=1) * 2) / 2 + 3
    return u, i, v.astype(np.float32)


def train_ratings(implicit: bool):
    """The whole-train problem: 120 users x 80 items, 4,000 ratings; in
    implicit mode clipped to at least 0.5 (a confidence 1 + alpha r must
    stay positive for the systems to be SPD)."""
    u, i, v = als_ratings(120, 80, 4000, seed=7)
    return u, i, (np.maximum(v, 0.5) if implicit else v)


def als_step_factors(n_dev: int, bu: int, bi: int, f: int, seed: int = 12):
    """Per-rank factor blocks [n_dev, b+1, f] for one sharded step."""
    rng = np.random.default_rng(seed + f)
    uf = rng.normal(size=(n_dev, bu + 1, f)).astype(np.float32)
    vf = (rng.normal(size=(n_dev, bi + 1, f)) / np.sqrt(f)).astype(np.float32)
    return uf, vf


def attention_inputs(seed: int = 3):
    """q, k, v and an output gradient [B, H, L, D] in f32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=ATTN_SHAPE).astype(np.float32) for _ in range(4)]


def two_tower_case(seed: int = 5):
    """A small two-tower problem: config kwargs, (users, items) of the
    global batch and the [n_users, T] history matrix."""
    rng = np.random.default_rng(seed)
    n_users, n_items, T = 40, 30, 8
    cfg = dict(n_users=n_users, n_items=n_items, embed_dim=16, hidden=(32,), out_dim=8,
               n_heads=2, history_len=T, batch_size=16, seed=7, learning_rate=1e-2)
    users = rng.integers(0, n_users, 16)
    items = rng.integers(0, n_items, 16)
    hist = rng.integers(-1, n_items, (n_users, T))
    hist[:, T - 2:] = -1  # end padding
    return cfg, users, items, hist


# ---------------------------------------------------------------------------
# the job
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, cases: list[str], out_dir: str, timeout: float = 50.0) -> None:
    """Run this file as an ``n``-rank gloo job over ``cases``; raise with
    the ranks' output on a non-zero exit or past ``timeout`` seconds."""
    port = _free_port()
    procs = []
    logs = []
    for r in range(n):
        env = {**os.environ, "PIO_COORDINATOR": f"127.0.0.1:{port}", "PIO_NUM_PROCESSES": str(n),
               "PIO_PROCESS_ID": str(r), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, __file__, out_dir, *cases], env=env,
                                      stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read()[-3000:])
        log.close()
    if hung or any(p.returncode for p in procs):
        raise AssertionError(
            f"{n}-rank job {cases}: {'hung past ' + str(timeout) + ' s' if hung else ''} "
            f"exit codes {[p.returncode for p in procs]}\n" + "\n".join(outputs))


def load(out_dir: str, case: str, rank: int = 0) -> dict:
    with np.load(os.path.join(out_dir, f"{case}.rank{rank}.npz")) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# cases (inside a rank)
# ---------------------------------------------------------------------------


def case_collectives(torch, mesh_2d, _out_dir):
    """Mesh coordinates and the collectives' values and gradients."""
    from predictionio_tpu_torch.parallel import collectives as C
    from predictionio_tpu_torch.parallel.ingest import shard_columns
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(mesh_2d, "cpu")
    out = {"coords": np.asarray([mesh.axis_index(a) for a in mesh.axis_names]),
           "axis_ranks": np.asarray([mesh.axis_ranks(a) for a in ("data",)])}
    r = mesh.rank
    for axis in mesh.axis_names:
        n = mesh.axis_size(axis)
        x = (torch.arange(12.0).reshape(3, 4) + 100 * r).requires_grad_()
        g = C.all_gather_grad(x, mesh, axis)
        (g * (torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape) + 1)).sum().backward()
        out[f"all_gather_{axis}"], out[f"all_gather_grad_{axis}"] = g.detach().numpy(), x.grad.numpy()
        y = (torch.arange(2.0 * n * 3 * n).reshape(2 * n, 3 * n) + 1000 * r).requires_grad_()
        a = C.all_to_all_grad(y, mesh, axis, 0, 1)
        (a * (torch.arange(a.numel(), dtype=torch.float32).reshape(a.shape) + 1)).sum().backward()
        out[f"all_to_all_{axis}"], out[f"all_to_all_grad_{axis}"] = a.detach().numpy(), y.grad.numpy()
        z = (torch.ones(3) * (r + 1)).requires_grad_()
        perm = [(i, (i + 1) % n) for i in range(n)]
        p = C.ppermute_grad(z, mesh, axis, perm)
        (p * (mesh.axis_index(axis) + 1)).sum().backward()
        out[f"ppermute_{axis}"], out[f"ppermute_grad_{axis}"] = p.detach().numpy(), z.grad.numpy()
        cols, n_local = shard_columns(mesh, {"a": np.arange(r + 1, dtype=np.int64)}, axis=axis,
                                      pad_values={"a": -1}, mask_name="ok")
        out[f"shard_{axis}"], out[f"shard_mask_{axis}"] = cols["a"].numpy(), cols["ok"].numpy()
        out[f"shard_n_{axis}"] = np.asarray(n_local)
    s = torch.full((5,), float(r + 1))
    C.all_reduce_sum([s[:2], s[2:]])
    out["all_reduce"] = s.numpy()
    return out


def case_als_step(torch, n_dev, _out_dir):
    """One _als_sharded_step per ALS_STEP_CASES entry, gathered to every
    rank, and the partitioned tables this rank built."""
    from predictionio_tpu_torch.ops import als_sharded as S
    from predictionio_tpu_torch.ops.als import ALSConfig
    from predictionio_tpu_torch.parallel.collectives import all_gather
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    sh = ALS_SHAPE
    mesh = make_mesh(f"data={n_dev}", "cpu")
    me = mesh.axis_index("data")
    u, i, v = als_ratings(sh["n_users"], sh["n_items"], sh["nnz"])
    bu, bi = -(-sh["n_users"] // n_dev), -(-sh["n_items"] // n_dev)
    ub = S._block_partition_blocked(u, i, v, bu, n_dev, sh["d"], sh["block_chunk"])
    ib = S._block_partition_blocked(i, u, v, bi, n_dev, sh["d"], sh["block_chunk"])
    tables = S._rank_tables(ub, me, mesh.device) + S._rank_tables(ib, me, mesh.device)
    out = {f"ublocks{k}": a for k, a in enumerate(ub)}
    out.update({f"iblocks{k}": a for k, a in enumerate(ib)})
    for f, implicit, gather_dtype in ALS_STEP_CASES:
        uf0, vf0 = als_step_factors(n_dev, bu, bi, f)
        cfg = ALSConfig(implicit=implicit)
        uf, vf = S._als_sharded_step(
            torch.from_numpy(uf0[me]), torch.from_numpy(vf0[me]), *tables, mesh=mesh, axis="data",
            bu=bu, bi=bi, rank=f, reg=sh["reg"], implicit=implicit, alpha=sh["alpha"],
            block_chunk=sh["block_chunk"], degree_scaled_reg=cfg.degree_scaled_reg,
            gather_dtype=gather_dtype)
        key = f"f{f}_{'implicit' if implicit else 'explicit'}_{gather_dtype}"
        out["uf_" + key] = all_gather(uf[None], mesh, "data").numpy()
        out["vf_" + key] = all_gather(vf[None], mesh, "data").numpy()
    return out


def case_als_train(torch, n_dev, _out_dir, device="cpu"):
    """The whole sharded train from its own init, explicit and implicit."""
    from predictionio_tpu_torch.ops.als import ALSConfig
    from predictionio_tpu_torch.ops.als_sharded import als_train_sharded
    from predictionio_tpu_torch.parallel.distributed import runtime

    out = {}
    for implicit in (False, True):
        u, i, v = train_ratings(implicit)
        timings: dict = {}
        cfg = ALSConfig(rank=4, iterations=6, reg=0.05, implicit=implicit, chunk=256)
        uf, vf = als_train_sharded(u, i, v, 120, 80, cfg, timings=timings, device=device)
        tag = "implicit" if implicit else "explicit"
        out[f"uf_{tag}"], out[f"vf_{tag}"] = uf, vf
        out[f"gathers_{tag}"] = np.asarray(timings["gather_s"])
    out["backend"] = np.asarray(runtime().backend)
    return out


def case_nccl(torch, _, _out_dir):
    """A one-rank job on the card: the backend, an all-gather and the
    ppermute autograd function with its gradient."""
    from predictionio_tpu_torch.parallel import collectives as C
    from predictionio_tpu_torch.parallel.distributed import runtime
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("data=1", "cuda")
    x = torch.arange(6.0, device=mesh.device).reshape(2, 3).requires_grad_()
    g = C.all_gather_grad(x, mesh, "data")
    p = C.ppermute_grad(g * 2.0, mesh, "data", [(0, 0)])
    (p * torch.arange(6.0, device=mesh.device).reshape(2, 3)).sum().backward()
    return {"backend": np.asarray(runtime().backend), "gathered": g.detach().cpu().numpy(),
            "permuted": p.detach().cpu().numpy(), "grad": x.grad.cpu().numpy(),
            "device": np.asarray(str(x.device))}


def case_attention(torch, n_world, _out_dir):
    """Ring and ulysses on "sp" (and "data" x "sp" on 4 ranks): each rank's
    output shard and the gradient of sum(out * dout) for its shards."""
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("sp=2" if n_world == 2 else "data=2,sp=2", "cpu")
    dp, di = mesh.axis_size("data"), mesh.axis_index("data")
    sp, si = mesh.axis_size("sp"), mesh.axis_index("sp")
    q, k, v, dout = (torch.from_numpy(a) for a in attention_inputs())
    B, _, L, _ = q.shape
    bpart = slice(di * (B // dp), (di + 1) * (B // dp))
    spart = slice(si * (L // sp), (si + 1) * (L // sp))
    out = {}
    for impl in ("ring", "ulysses"):
        fn = A.ring_attention if impl == "ring" else A.ulysses_attention
        for causal in (False, True):
            shards = [x[bpart, :, spart].clone().requires_grad_() for x in (q, k, v)]
            o = fn(*shards, mesh, axis="sp", causal=causal)
            (o * dout[bpart, :, spart]).sum().backward()
            tag = f"{impl}_{'causal' if causal else 'full'}"
            out["out_" + tag] = o.detach().numpy()
            for name, t in zip("qkv", shards):
                out[f"d{name}_{tag}"] = t.grad.numpy()
    if n_world == 2:
        out["sharded_causal"] = A.ring_attention_sharded(q, k, v, mesh, axis="sp", causal=True).numpy()
    return out


TWO_TOWER_INIT = "two_tower_init.npz"


def _state_arrays(model, opt) -> dict:
    """Every parameter and every tensor of the optimizer's state, as numpy."""
    out = {f"param.{n}": p.detach().numpy().copy() for n, p in model.named_parameters()}
    for idx, st in opt.state_dict()["state"].items():
        out.update({f"opt.{idx}.{k}": v.numpy().copy() for k, v in st.items()})
    return out


def case_two_tower(torch, n_world, out_dir):
    """One two-tower step per mesh of TWO_TOWER_MESHES[n_world] from the
    port state in ``out_dir/TWO_TOWER_INIT`` (the test's JAX init, carried
    over; a sharded table takes its rows), twice: as the port runs it
    ("port"), and with every local attention block the f32
    ``attention_reference`` ("f32"), the function the JAX package's
    attention computes off the TPU. Each gives the loss, the summed
    gradients and the updated parameters, the sharded tables' gathered
    whole, and each parameter's shape on this rank; on the "port" pass
    also the model as the JAX package's whole tree
    (``convert.twotower_params_to_numpy``), ``describe_shardings`` of the
    model and ``inspect_train_step``'s
    report of one more step, with the parameters and Adam's state before
    and after it."""
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.obs import xray
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.parallel.collectives import all_gather
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    cfg_kw, users, items, hist = two_tower_case()
    with np.load(os.path.join(out_dir, TWO_TOWER_INIT)) as z:
        init = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {}
    real = M.fused_attention, A.fused_attention
    for variant in ("port", "f32"):
        if variant == "f32":
            M.fused_attention = A.fused_attention = A.attention_reference
        try:
            for spec, cp, impl in TWO_TOWER_MESHES[n_world]:
                mesh = make_mesh(spec, "cpu")
                config = M.TwoTowerConfig(**cfg_kw, context_parallel=cp, sp_impl=impl)
                model = M.TwoTower(config, mesh)
                convert.load_twotower_params(model, init)
                opt = M.make_optimizer(model, config.learning_rate)
                log_q = torch.from_numpy(M.item_log_q(items, config.n_items))
                step = M.make_train_step(model, opt, config.temperature, True, log_q, mesh)
                batch = (torch.from_numpy(users), torch.from_numpy(items), torch.from_numpy(hist))
                loss = step(*batch)
                tag = f"{variant}|{spec}_{impl if cp else 'dp'}"
                out[f"loss|{tag}"] = loss.numpy()
                tables = M.sharded_tables(model)
                whole = M.gather_state_dict(model)
                for name, p in model.named_parameters():
                    g = p.grad
                    if name in tables:
                        g = all_gather(g, tables[name].mesh, tables[name].axis)
                    out[f"param|{tag}|{name}"] = whole[name].numpy()
                    out[f"grad|{tag}|{name}"] = g.numpy()
                    out[f"shape|{tag}|{name}"] = np.asarray(p.shape)
                if variant == "port":
                    for path, leaf in convert._flax_leaves(convert.twotower_params_to_numpy(model)):
                        out[f"flax|{tag}|{'/'.join(path)}"] = leaf
                    out[f"describe|{tag}"] = np.asarray(json.dumps(xray.describe_shardings(model, mesh)))
                    before = _state_arrays(model, opt)
                    report = xray.inspect_train_step(step, *batch, arg_names=("user_ids", "item_ids", "hist"))
                    after = _state_arrays(model, opt)
                    out[f"inspect|{tag}"] = np.asarray(json.dumps(report))
                    out[f"unchanged|{tag}"] = np.asarray(
                        sorted(before) == sorted(after)
                        and all(np.array_equal(before[k], after[k]) for k in before))
        finally:
            M.fused_attention, A.fused_attention = real
    return out


def case_two_tower_resume(torch, spec, out_dir):
    """A sharded train (two_tower_case's data, two epochs, no encoder) on
    ``spec`` three ways: uninterrupted; cut after epoch 1 (its checkpoint
    kept); resumed from that checkpoint. Each run's losses and whole
    parameters, whether the cut run left a checkpoint and whether the
    resumed run cleared it."""
    from predictionio_tpu_torch.models.twotower import model as M
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    cfg_kw, users, items, _ = two_tower_case()
    cfg_kw = {**cfg_kw, "history_len": 0, "batch_size": 8}
    users, items = np.tile(users, 3), np.tile(items[::-1], 3)
    mesh = make_mesh(spec, "cpu")
    out = {"table_rows": np.asarray(M.build_model(M.TwoTowerConfig(**cfg_kw), "cpu", mesh)
                                    .user_tower.embed.weight.shape[0])}
    ckpt = os.path.join(out_dir, "resume_ckpt")
    runs = {"uncut": (2, os.path.join(out_dir, "uncut_ckpt")), "cut": (1, ckpt), "resumed": (2, ckpt)}
    real_clear = M.clear_train_checkpoint
    for name, (epochs, directory) in runs.items():
        if name == "cut":
            M.clear_train_checkpoint = lambda d: None
        try:
            result = M.train_two_tower(users, items, M.TwoTowerConfig(**cfg_kw, epochs=epochs,
                                                                     checkpoint_dir=directory),
                                       device="cpu", mesh=mesh)
        finally:
            M.clear_train_checkpoint = real_clear
        # the next run stands for a new job: rank 0 has written or cleared
        # the checkpoint before any rank reads it
        torch.distributed.barrier()
        out[f"losses|{name}"] = np.asarray(result.losses)
        out[f"items|{name}"] = result.item_embeddings
        for k, v in result.params.items():
            out[f"param|{name}|{k}"] = v
        out[f"checkpoint_after|{name}"] = np.asarray(M.load_train_checkpoint(directory) is not None)
    return out


CLEANUP_HOOK_OUT = "cleanup_hook"


def case_cleanup(torch, _, out_dir):
    """run_train of the sample engine on this rank of the job with a
    CleanupFunctions hook that appends a line to
    ``out_dir/cleanup_hook.rank<r>``; the id run_train returned."""
    from predictionio_tpu_torch.controller import Engine
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.parallel.distributed import runtime
    from predictionio_tpu_torch.workflow.cleanup import CleanupFunctions
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest
    from tests import torch_sample_engine as se

    rank = runtime().rank
    path = os.path.join(out_dir, f"{CLEANUP_HOOK_OUT}.rank{rank}")
    CleanupFunctions.add(lambda: open(path, "a").write("ran\n"))
    engine = Engine(se.DataSource0, se.Preparator0, {"a": se.Algo0}, se.Serving0)
    params = engine.engine_params_from_variant({"algorithms": [{"name": "a", "params": {"id": 3}}]})
    storage = Storage(env={"PIO_FS_BASEDIR": out_dir, "PIO_STORAGE_SOURCES_S_TYPE": "memory",
                           **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "S" for r in ("METADATA", "EVENTDATA",
                                                                                     "MODELDATA")}})
    ctx = WorkflowContext(device="cpu", _storage=storage)
    iid = run_train(engine, EngineManifest(engine_id="e", version="1", variant="v", engine_factory="f"),
                    params, ctx)
    return {"instance_id": np.asarray(iid)}


CASES = {"collectives2": (case_collectives, "data=2"), "collectives4": (case_collectives, "data=2,model=2"),
         "als_step2": (case_als_step, 2), "als_step4": (case_als_step, 4),
         "als_train2": (case_als_train, 2), "attention2": (case_attention, 2),
         "attention4": (case_attention, 4), "two_tower2": (case_two_tower, 2),
         "two_tower4": (case_two_tower, 4),
         "two_tower_resume2": (case_two_tower_resume, "data=1,model=2"),
         "two_tower_resume4": (case_two_tower_resume, "data=2,model=2"),
         "cleanup2": (case_cleanup, 2),
         # on the card (tests/test_torch_gpu.py)
         "als_train2_cuda": (lambda torch, n, out_dir: case_als_train(torch, n, out_dir, "cuda"), 2),
         "nccl1_cuda": (case_nccl, 1)}


def main(argv: list[str]) -> int:
    import torch

    torch.set_num_threads(1)
    from predictionio_tpu_torch.parallel import distributed

    out_dir, cases = argv[0], argv[1:]
    device = "cuda" if any(c.endswith("_cuda") for c in cases) else "cpu"
    distributed.maybe_initialize_distributed(device)
    if distributed.runtime() is None:
        raise SystemExit("torch_dist_worker: needs the PIO_COORDINATOR contract")
    rank = distributed.runtime().rank
    for case in cases:
        fn, arg = CASES[case]
        result = fn(torch, arg, out_dir)
        np.savez(os.path.join(out_dir, f"{case}.rank{rank}.npz"), **result)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
