"""Tests of the port's CUDA kernels; they need a card and skip without one.

Run on a machine with an NVIDIA H100:
``python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest``.
This file imports no JAX: the kernels are held against their plain PyTorch
versions on the card. B1: f32 sum order differs over f+4 CG iterations,
and up to rank 64 B1 refines its answer (within 1e-6 of float64 wherever
f32 CG converges), so it differs from the plain version by that version's
own f32 error: atol 1e-4 on well-conditioned systems. B2 and B3: both sides follow
one bf16 contract and differ only in the order of f32 sums; the kernels
re-sum in the plain version's order every score whose tensor-core sum could
move a row's max or flip bf16(p), so atol 1e-5 against the plain version,
which a kernel that skipped the bf16 rounding of p (5e-4 to 4e-3 off at
these shapes, ``tests/test_torch_attention.py``) or that re-summed no score
(4e-4 off at [64, 1, 200, 32]) would fail; 2e-2 against the f32 reference.
Past rank 128 B1 runs one block per system, and the limit is row-relative
1e-4; past rank 11,619 the whole grid solves each system (f = 11,700, A of
548 MB), held to row-relative 1e-3 over its 11,704 CG steps. ``FusedAttention``'s gradient is the f32 reference's, as explicit
matrix products on the card against CPU autograd: atol 1e-4 (f32 sums in
another order over 256-key softmax rows). The query server's watchdog: a
dispatch thread that replaces one walked away from takes the server's card
and answers as ``serve_batch`` (rtol 1e-5). Ranks: two gloo ranks sharing
the card train sharded ALS to the one-rank CPU train's factors (atol 1e-3,
the whole-train tolerance of ``tests/test_torch_als.py``); a one-rank job
on the card runs NCCL's all-gather and the ppermute autograd function.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from predictionio_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _spd_batch(n, f, seed=0, reg=0.05):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, 3 * f, f)).astype(np.float32)
    A = np.einsum("bdf,bdg->bfg", G, G) + reg * (3 * f) * np.eye(f, dtype=np.float32)
    b = rng.normal(size=(n, f)).astype(np.float32)
    return A.astype(np.float32), b


def _c_plan(n, f):
    """pio_spd_cg_plan on the current card: (LaunchPlan, capacity, blocks)."""
    from predictionio_tpu_torch.ops import spd_solve as S

    out = np.zeros(7, np.int32)
    assert S._library().pio_spd_cg_plan(n, f, out.ctypes.data) == 0
    kind, width, exact, group, wpb, capacity, blocks = out.tolist()
    kernel = ("registers", "shared", "block", "block_global", "grid")[kind]
    plan = S.LaunchPlan(kernel, width, bool(exact), group)
    assert wpb == plan.warps_per_block
    return plan, capacity, blocks


def _wave(plan, capacity):
    """Systems that one full grid of the plan solves at once."""
    return capacity if plan.per_block else capacity * 2 * plan.systems_per_warp


_SPD_RANKS = [1, 8, 10, 16, 31, 32, 33, 64, 65, 100, 128]


@pytest.mark.parametrize("f", _SPD_RANKS)
@pytest.mark.parametrize("size", ["one", "ragged_group", "wave_plus_one"])
def test_spd_cg_matches_plain(cuda, size, f):
    """One system; a count that leaves a group of a warp's tile partly
    empty; and one system past a full persistent wave, so that one warp
    loops to a second tile that holds a single system."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    plan, capacity, _ = _c_plan(1, f)
    wave = _wave(plan, capacity)
    n = {"one": 1, "ragged_group": 4 * wave // 7 * 4 + 3, "wave_plus_one": wave + 1}[size]
    A, b = _spd_batch(n, f, seed=f + n)
    A_d, b_d = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    before = batched_spd_solve_fused.launches
    x = batched_spd_solve_fused(A_d, b_d)
    torch.cuda.synchronize()
    assert batched_spd_solve_fused.launches == before + 1
    ref = _cg_body(A_d, b_d, f + 4)
    assert x.shape == (n, f)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("f", [129, 160, 238, 239, 256])
def test_spd_cg_past_rank_128_matches_plain(cuda, f):
    """One block per system: A in shared memory up to f = 238, read from
    device memory at 239 and past. One system, a grid that is not full, and
    (where a wave is small) one system past a full wave, so that a block
    loops to a second system. Row-relative 1e-4."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    plan, capacity, _ = _c_plan(1, f)
    assert plan.kernel == ("block" if f <= 238 else "block_global")
    for n in sorted({1, 37, *([capacity + 1] if capacity <= 300 else [])}):
        A, b = _spd_batch(n, f, seed=f + n)
        A_d, b_d = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
        before = batched_spd_solve_fused.launches
        x = batched_spd_solve_fused(A_d, b_d)
        torch.cuda.synchronize()
        assert batched_spd_solve_fused.launches == before + 1
        ref = _cg_body(A_d, b_d, f + 4)
        assert x.shape == (n, f) and torch.isfinite(x).all()
        row_rel = (x - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
        assert float(row_rel.max()) <= 1e-4, (f, n, float(row_rel.max()))


def test_spd_cg_plan_is_the_python_plan(cuda):
    """The instantiation and grid the C entry picks are launch_plan's, for
    every rank up to 128 and at ranks past it, and that grid solves every
    system once."""
    from predictionio_tpu_torch.ops.spd_solve import MAX_WARP_RANK, launch_plan

    for f in [*range(1, MAX_WARP_RANK + 1), 129, 160, 238, 239, 256, 1000, 11619]:
        for n in (0, 1, 27_001, 138_001):
            plan, capacity, blocks = _c_plan(n, f)
            assert plan == launch_plan(f), f
            assert capacity > 0 and blocks == plan.blocks(n, capacity), (f, n)
        n = _wave(plan, capacity) + 1
        blocks = plan.blocks(n, capacity)
        solved = [s for blk in range(blocks) for s in plan.block_systems(n, blk, blocks)]
        assert sorted(solved) == list(range(n)), f
    for f in (11_620, 11_700):  # the grid plan: every resident block on each system
        for n in (0, 1, 3):
            plan, capacity, blocks = _c_plan(n, f)
            assert plan == launch_plan(f) and plan.kernel == "grid"
            assert blocks == plan.blocks(n, capacity) == (capacity if n else 0)


@pytest.mark.parametrize("f", [10, 32, 100, 160, 256])
def test_spd_cg_in_a_cuda_graph_matches_eager(cuda, f):
    """A launch captured into a CUDA graph and replayed gives the eager
    launch's result bit for bit, and the capture makes no device query."""
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused

    A, b = _spd_batch(3001 if f <= 128 else 301, f, seed=f)
    A_d, b_d = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    eager = batched_spd_solve_fused(A_d, b_d)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        batched_spd_solve_fused(A_d, b_d)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = batched_spd_solve_fused(A_d, b_d)
    captured.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def test_spd_cg_rejects_what_it_does_not_take(cuda):
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused

    A, b = _spd_batch(3, 8)
    A_d, b_d = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    with pytest.raises(TypeError):
        batched_spd_solve_fused(A_d.double(), b_d.double())
    with pytest.raises(ValueError, match="contiguous"):
        batched_spd_solve_fused(A_d.transpose(1, 2), b_d)
    with pytest.raises(ValueError, match="CUDA"):
        batched_spd_solve_fused(A_d.cpu(), b_d.cpu())


def test_spd_cg_past_the_block_limit_matches_plain(cuda):
    """f = 11,700, n = 1: the five CG vectors of the system outgrow a block's
    shared memory, so the whole grid solves it with its vectors in a device
    scratch buffer (A is 548 MB). Row-relative 1e-3 against the plain
    version, as the rank-160 phase of chip_smoke.py holds B1."""
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused, launch_plan

    f = 11_700
    assert launch_plan(f).kernel == "grid"
    gen = torch.Generator(device=cuda).manual_seed(11)
    M = torch.randn(f, f, generator=gen, device=cuda)
    A = (M @ M.T / f + 0.5 * torch.eye(f, device=cuda))[None].contiguous()
    del M
    b = torch.randn(1, f, generator=gen, device=cuda)
    before = batched_spd_solve_fused.launches
    x = batched_spd_solve_fused(A, b)
    torch.cuda.synchronize()
    assert batched_spd_solve_fused.launches == before + 1
    ref = _cg_body(A, b, f + 4)
    assert x.shape == (1, f) and torch.isfinite(x).all()
    row_rel = float(((x - ref).norm(dim=1) / ref.norm(dim=1)).max())
    assert row_rel <= 1e-3, row_rel
    assert float((A[0] @ x[0] - b[0]).norm() / b[0].norm()) <= 1e-3  # it solved the system


def _qkv(cuda, B, H, L, D, seed=0):
    gen = np.random.default_rng(seed)
    return [torch.from_numpy(gen.normal(size=(B, H, L, D)).astype(np.float32)).to(cuda)
            for _ in range(3)]


def _attention_pair(kernel):
    from predictionio_tpu_torch.ops import attention as A

    return {"block": (A.fused_attention_block, A._fused_attention_plain),
            "flash": (A.flash_attention, A._flash_attention_plain)}[kernel]


def _check_against_plain(wrapper, plain, q, k, v, causal):
    """One launch of ``wrapper``: counted, finite, within 1e-5 of the plain
    version and 2e-2 of the f32 reference."""
    from predictionio_tpu_torch.ops import attention as A

    before = wrapper.launches
    out = wrapper(q, k, v, causal)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert float((out - plain(q, k, v, causal)).abs().max()) <= 1e-5
    assert float((out - A.attention_reference(q, k, v, causal=causal)).abs().max()) <= 2e-2


# the kernel-phase shapes of chip_smoke.py: B2 at D=32 and L in {8, 200,
# 1023}, at D in {10, 64} and at H=2; B3 at L in {1024, 2048} and ragged 1500
_BLOCK_SHAPES = [(64, 1, 8, 32), (64, 1, 200, 32), (64, 1, 1023, 32),
                 (64, 1, 200, 10), (64, 1, 200, 64), (32, 2, 200, 32), (3, 1, 37, 128)]
_FLASH_SHAPES = [(8, 1, 1024, 32), (4, 1, 2048, 32), (8, 1, 1500, 32), (2, 2, 300, 100)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel,shape", [("block", s) for s in _BLOCK_SHAPES]
                         + [("flash", s) for s in _FLASH_SHAPES])
def test_attention_kernels_match_plain(cuda, kernel, shape, causal):
    _check_against_plain(*_attention_pair(kernel), *_qkv(cuda, *shape, seed=shape[2]), causal)


# The edges a tensor-core tile can get wrong: lengths around the 16-row warp
# tile, the 64-row query tile and the 64-key K tile; head widths off the
# 16-column mma chunk and the 32-column padding; Lq != Lk both ways (causal
# indices both from 0).
_EDGE_SHAPES = ([(3, 1, L, L, 32) for L in (1, 15, 17, 63, 65, 129)]
                + [(3, 1, 70, 70, D) for D in (1, 10, 16, 17, 100, 128)]
                + [(2, 2, 33, 130, 24), (2, 2, 130, 33, 24)])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["block", "flash"])
@pytest.mark.parametrize("B,H,Lq,Lk,D", _EDGE_SHAPES)
def test_attention_kernels_match_plain_at_tile_edges(cuda, kernel, B, H, Lq, Lk, D, causal):
    q = _qkv(cuda, B, H, Lq, D, seed=Lq * D)[0]
    _, k, v = _qkv(cuda, B, H, Lk, D, seed=Lk * D + 1)
    _check_against_plain(*_attention_pair(kernel), q, k, v, causal)


def test_fused_attention_routes_to_the_kernels(cuda):
    from predictionio_tpu_torch.ops import attention as A

    for L, wrapper in ((1023, A.fused_attention_block), (1024, A.flash_attention)):
        q, k, v = _qkv(cuda, 1, 1, L, 8, seed=L)
        before = (A.fused_attention_block.launches, A.flash_attention.launches)
        A.fused_attention(q, k, v, causal=True)
        after = (A.fused_attention_block.launches, A.flash_attention.launches)
        assert sum(after) - sum(before) == 1
        assert wrapper.launches == before[0 if wrapper is A.fused_attention_block else 1] + 1


@pytest.mark.parametrize("B,H,Lq,Lk,D", [(64, 1, 200, 200, 32), (64, 1, 1023, 1023, 32),
                                         (64, 1, 200, 200, 10), (8, 1, 64, 64, 32),
                                         (64, 1, 200, 200, 64), (2, 2, 64, 64, 100),
                                         (2, 1, 511, 2048, 32)])
def test_torch_sums_scores_in_column_order(cuda, B, H, Lq, Lk, D):
    """The kernels re-sum a score whose rounding matters one column after
    another (csrc/attention_common.cuh), because torch's f32 product of
    bf16-valued tensors on the card sums in that order at the plain
    versions' shapes: the same bits, with each exact product added and
    rounded in turn."""
    from predictionio_tpu_torch.ops import attention as A

    q = A._bf16(_qkv(cuda, B, H, Lq, D, seed=Lq + D)[0])
    k = A._bf16(_qkv(cuda, B, H, Lk, D, seed=Lk + D + 1)[0])
    column = torch.zeros(B, H, Lq, Lk, device=cuda)
    for d in range(D):
        column = column + q[..., d:d + 1] * k[..., d].unsqueeze(-2)
    assert torch.equal(torch.matmul(q, k.transpose(-1, -2)), column)


@pytest.mark.parametrize("Lq,Lk", [(1, 2048), (1, 2049), (1, 10000), (3, 10000), (511, 2048)])
def test_fused_attention_takes_every_small_tile(cuda, Lq, Lk):
    """A score tile under 4 MiB runs on B2 whatever its key axis: B2 keeps
    no score rows, so it takes any Lk, as the JAX routing assumes."""
    from predictionio_tpu_torch.ops import attention as A

    q = _qkv(cuda, 2, 1, Lq, 32, seed=Lq)[0]
    _, k, v = _qkv(cuda, 2, 1, Lk, 32, seed=Lk)
    assert A.route(Lq, Lk) == "block"
    for causal in (False, True):
        before = (A.fused_attention_block.launches, A.flash_attention.launches)
        out = A.fused_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert (A.fused_attention_block.launches, A.flash_attention.launches) == (
            before[0] + 1, before[1])
        assert float((out - A._fused_attention_plain(q, k, v, causal)).abs().max()) <= 1e-5
        ref = A.attention_reference(q, k, v, causal=causal)
        assert float((out - ref).abs().max()) <= 2e-2


@pytest.mark.parametrize("fn", ["fused_attention_block", "flash_attention"])
def test_attention_kernels_reject_what_they_do_not_take(cuda, fn):
    from predictionio_tpu_torch.ops import attention as A

    wrapper = getattr(A, fn)
    q, k, v = _qkv(cuda, 2, 1, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(TypeError):
        wrapper(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        wrapper(q.bfloat16(), k.bfloat16(), v.bfloat16())
    empty = [torch.empty(1, 1, 8, 0, device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="head dim"):
        wrapper(*empty)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError):
        wrapper(q, k[:, :, :5], v)


# heads past 128 columns: sliced into 128-column parts (attention_*_wide)
_WIDE_SHAPES = [(2, 2, 70, 129), (2, 1, 200, 160), (16, 2, 200, 160), (3, 1, 37, 256), (1, 2, 130, 256)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kernel", ["block", "flash"])
@pytest.mark.parametrize("shape", _WIDE_SHAPES)
def test_attention_kernels_past_head_dim_128_match_plain(cuda, kernel, shape, causal):
    _check_against_plain(*_attention_pair(kernel), *_qkv(cuda, *shape, seed=shape[3]), causal)


@pytest.mark.parametrize("kernel", ["block", "flash"])
def test_attention_kernels_take_70000_batch_heads(cuda, kernel):
    """More batch·heads than a 1-D grid of 65,535 blocks once held; the
    blocks loop over (query tile, batch·head) units. Within 1e-5 of the
    plain version. Over 1.1 M rows the bf16 contract's own error against
    the f32 reference reaches past 2e-2 in its tail (0.0226 for the plain
    version and the kernel alike), so the kernel is held to the plain
    version's distance from the reference instead."""
    from predictionio_tpu_torch.ops import attention as A

    wrapper, plain = _attention_pair(kernel)
    q, k, v = _qkv(cuda, 35_000, 2, 16, 32, seed=70)
    for causal in (False, True):
        before = wrapper.launches
        out = wrapper(q, k, v, causal)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1 and torch.isfinite(out).all()
        want = plain(q, k, v, causal)
        assert float((out - want).abs().max()) <= 1e-5
        ref = A.attention_reference(q, k, v, causal=causal)
        gap = float((out - ref).abs().max()) - float((want - ref).abs().max())
        assert abs(gap) <= 1e-5


def test_fused_attention_gradient_on_the_card_matches_cpu_autograd(cuda):
    """FusedAttention on CUDA tensors: the forward launches B2 once, the
    backward is the f32 reference's gradient; against CPU autograd of
    attention_reference on the same inputs."""
    from predictionio_tpu_torch.ops import attention as A

    q, k, v = (t.requires_grad_() for t in _qkv(cuda, 8, 2, 256, 32, seed=3))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(8, 2, 256, 32)).astype(np.float32))
    before = A.fused_attention_block.launches
    out = A.fused_attention(q, k, v, causal=True)
    out.backward(g.to(cuda))
    torch.cuda.synchronize()
    assert A.fused_attention_block.launches == before + 1
    qc, kc, vc = (t.detach().cpu().requires_grad_() for t in (q, k, v))
    A.attention_reference(qc, kc, vc, causal=True).backward(g)
    for dev_t, cpu_t in ((q, qc), (k, kc), (v, vc)):
        assert float((dev_t.grad.cpu() - cpu_t.grad).abs().max()) <= 1e-4


def test_two_tower_trains_and_serves_through_b2_on_the_card(cuda):
    """Small two-tower with a history encoder: one B2 launch per training
    step and per served batch, finite falling losses, and served top-k
    against a torch.topk over user vectors from the plain version."""
    from predictionio_tpu_torch.models.twotower import engine as tt
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    rng = np.random.default_rng(0)
    n_users, n_items, n = 300, 200, 6000
    users = rng.integers(0, n_users, n).astype(np.int32)
    items = ((users * 7 + rng.integers(0, 20, n)) % n_items).astype(np.int32)
    td = tt.TrainingData(users, items, [f"u{i}" for i in range(n_users)],
                         [f"i{i}" for i in range(n_items)], np.arange(n, dtype=np.float64))
    algo = tt.TwoTowerAlgorithm(tt.TwoTowerAlgorithmParams(
        embed_dim=16, hidden=(32,), out_dim=8, batch_size=256, epochs=3, history_len=16))
    before = A.fused_attention_block.launches
    model = algo.train(WorkflowContext(device=cuda), td)
    assert A.fused_attention_block.launches - before == 3 * (n // 256)
    assert all(np.isfinite(model.losses)) and model.losses[-1] < model.losses[0]
    model = algo.prepare_model(WorkflowContext(device=cuda), model)
    queries = [tt.Query(user=f"u{u}", num=5) for u in range(64)]
    before = A.fused_attention_block.launches
    served = algo.predict_batch(model, queries)
    assert A.fused_attention_block.launches == before + 1
    net = model.module()
    uidx = torch.arange(64, device=cuda)
    hist = torch.from_numpy(model.history[:64].astype(np.int64)).to(cuda)
    with torch.no_grad():
        enc = net.hist_encoder(hist)
        real = A._fused_attention_forward
        try:
            A._fused_attention_forward = lambda q, k, v, causal: A._fused_attention_plain(q, k, v, causal)
            enc_plain = net.hist_encoder(hist)
            u = net.embed_users(uidx, hist)
        finally:
            A._fused_attention_forward = real
    # the encoder's f32 output: B2 within 1e-5 of its plain version, through
    # one f32 projection and a mean
    assert float((enc - enc_plain).abs().max()) <= 1e-4
    # served scores: the bf16 tower can round an input one bf16 ulp the
    # other way on a 1e-6 difference, which moves a unit-vector score by up
    # to about 1e-2; every served id scores within that of the plain k-th
    scores = (u @ model.device_items().T).cpu().numpy()
    kth = np.sort(scores, axis=1)[:, -5]
    for r, res in enumerate(served):
        got = np.asarray([s.score for s in res.item_scores])
        ref = np.sort(scores[r])[::-1][:5]
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
        ids = [int(s.item[1:]) for s in res.item_scores]
        assert np.all(scores[r, ids] >= kth[r] - 1e-2)


@pytest.mark.parametrize("ending", ["dot", "dot_weighted", "gather_sum", "gather_sum_weighted"])
def test_topk_endings_on_cuda_match_their_plain_versions(cuda, ending):
    """The serving endings of the item templates on CUDA tensors against the
    same torch ops on the CPU: scores within 1e-5, ids equal outside ties."""
    from predictionio_tpu_torch.ops import topk

    rng = np.random.default_rng(12)
    n, f, B, Q, k = 3706, 10, 64, 4, 16
    table = rng.normal(size=(n, f)).astype(np.float32)
    mask = rng.random((B, n)) < 0.9
    weights = rng.uniform(0.5, 2.0, n) if ending.endswith("weighted") else None
    if ending.startswith("dot"):
        vecs = rng.normal(size=(B, f)).astype(np.float32)

        def run(dev):
            return topk.dot_top_k_async(torch.from_numpy(table).to(dev), vecs, mask, k,
                                        weights=weights)
    else:
        qidx = rng.integers(0, n, (B, Q)).astype(np.int32)
        qw = np.ones((B, Q), np.float32)
        qw[::2, 2:] = 0.0
        qidx[::2, 2:] = 0  # pad slots: row 0, weight 0

        def run(dev):
            return topk.gather_sum_top_k_async(torch.from_numpy(table).to(dev), qidx, qw, mask,
                                               k, weights=weights)

    handle = run(cuda)
    assert handle.is_cuda and handle.shape == (B, 2, k)
    got_s, got_i = topk.fetch_topk(handle)
    want_s, want_i = topk.fetch_topk(run("cpu"))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    for row in range(B):
        ties = np.isclose(want_s[row], want_s[row][-1], rtol=1e-5, atol=1e-5)
        assert set(got_i[row][~ties]) == set(want_i[row][~ties])
        assert mask[row, got_i[row]].all()


def test_implicit_als_trains_through_b1_at_rank_10(cuda, monkeypatch):
    """The similar-product template's implicit ALS at the template's rank 10
    on the card: B1 once per half-iteration, factors within atol 1e-3 of the
    same train with the plain CG (index_add_ sums in another order run to
    run)."""
    from predictionio_tpu_torch.models.similarproduct import engine as sp
    from predictionio_tpu_torch.ops import als as pt_als
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    rng = np.random.default_rng(13)
    n_users, n_items, nnz = 600, 400, 20_000
    users = rng.integers(0, n_users, nnz).astype(np.int32)
    items = (rng.zipf(1.3, nnz) % n_items).astype(np.int32)
    td = sp.TrainingData([f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)],
                         [None] * n_items, users, items, users[:0], items[:0])
    algo = sp.ALSAlgorithm(sp.ALSAlgorithmParams(rank=10, num_iterations=6))
    ctx = WorkflowContext(device=cuda)
    before = batched_spd_solve_fused.launches
    model = algo.train(ctx, td)
    assert batched_spd_solve_fused.launches == before + 12
    monkeypatch.setattr(pt_als, "batched_spd_solve_auto", lambda A, b: _cg_body(A, b, A.shape[-1] + 4))
    plain = algo.train(ctx, td)
    assert batched_spd_solve_fused.launches == before + 12
    np.testing.assert_allclose(model.item_factors, plain.item_factors, rtol=0, atol=1e-3)
    served = algo.predict_batch(model, [sp.Query(items=("i1", "i2"), num=10)])[0]
    assert len(served.item_scores) == 10


@pytest.mark.parametrize("rank", [10, 32])
def test_foldin_on_the_card_launches_b1_and_matches_its_plain_version(cuda, rank):
    """Stream fold-in on the card: one B1 launch per side per absorb, each
    launch's x held to the plain CG on the same A and b by chip_smoke's
    ``b1_rows_held`` at row-relative 1e-3, the limit it holds the smoke's
    fold-in to (rows the f32 CG does not determine to 1e-3, 1.2e-3 apart
    at rank 10 here, pass on their float64 errors), and the user factors
    within row-relative 1e-4 of the same absorbs with the plain CG, from
    the same tables before each absorb (both solve the same host-built
    systems). B1 refines its answer (ranks up to 64), and the plain CG on
    the CPU is up to 5e-4 off float64 at rank 32, so a user row past 1e-4
    passes only if B1's last solve of it is within row-relative 1e-6 of
    the float64 solution of its own system. Each launch is also held by
    ``b1_refinement_held``: B1 within 1e-6 of float64 on every row the
    plain CG solves to 1e-5, and no worse than it on average."""
    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused
    from predictionio_tpu_torch.stream.trainers import FoldInALSTrainer

    rng = np.random.default_rng(rank)
    n_users, n_items = 2_000, 500
    uf = rng.normal(size=(n_users, rank)).astype(np.float32) * 0.5
    vf = rng.normal(size=(n_items, rank)).astype(np.float32) * 0.5

    def model():
        return convert.als_model_from_numpy(uf, vf, [f"u{i}" for i in range(n_users)],
                                            [f"i{i}" for i in range(n_items)])

    events = []
    for n in range(3_000):
        u, i = int(rng.integers(0, n_users + 200)), int(rng.zipf(1.3) % n_items)
        base = float(uf[u] @ vf[i]) if u < n_users else 0.0
        events.append(Event(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                            target_entity_id=f"i{i}", properties={"rating": float(np.clip(round(3 + base), 1, 5))}))
    card = FoldInALSTrainer([model()], device=cuda)
    host = FoldInALSTrainer([model()], device="cpu")
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    held = []
    user_f64_err = {}  # user row -> B1's row-relative float64 error at its last solve

    def hold(side, order, A, b, x):
        assert A.is_cuda and A.is_contiguous() and A.dtype == torch.float32
        held.append(cs.b1_held(torch, A, b, 1e-3, f"a rank-{rank} fold-in's {side} side", x=x))
        if side == "user":
            exact = torch.linalg.solve(A.double(), b.double().unsqueeze(-1)).squeeze(-1)
            err = (x.double() - exact).norm(dim=1) / exact.norm(dim=1).clamp(min=1e-30)
            user_f64_err.update(zip(np.asarray(order).tolist(), err.cpu().tolist()))

    card.solve_hook = hold
    before = batched_spd_solve_fused.launches
    for s in range(0, len(events), 500):
        host.user_factors, host.item_factors = card.user_factors.copy(), card.item_factors.copy()
        card.absorb(events[s:s + 500])
        host.absorb(events[s:s + 500])
        rel = np.linalg.norm(card.user_factors - host.user_factors, axis=1) / np.maximum(
            np.linalg.norm(host.user_factors, axis=1), 1e-12)
        for row in np.flatnonzero(rel >= 1e-4):
            assert user_f64_err.get(int(row), np.inf) <= 1e-6, (row, rel[row])
    assert batched_spd_solve_fused.launches == before + 12 == before + len(held)
    assert len(card.user_vocab) > n_users  # new users got rows and factors


def _ann_corpus(n, f, seed=0):
    rng = np.random.default_rng(seed)
    modes = rng.normal(size=(max(32, n // 512), f))
    modes /= np.linalg.norm(modes, axis=1, keepdims=True)
    vecs = modes[rng.integers(0, len(modes), n)] + 0.15 * rng.normal(size=(n, f))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    q = modes[rng.integers(0, len(modes), 64)] + 0.15 * rng.normal(size=(64, f))
    return vecs.astype(np.float32), (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["plain", "excl", "masked", "q8"])
def test_ann_search_on_the_card_equals_the_cpu_copy(cuda, kind):
    """Each of the four searches on CUDA tables against the same call on
    the CPU copy of the index: scores within rtol 1e-5 (f32 sums in another
    order), ids equal where the scores are not tied, counts equal."""
    from predictionio_tpu_torch.ann import AnnConfig, build_index
    from predictionio_tpu_torch.ann.search import AnnSearcher

    vecs, q = _ann_corpus(20_000, 32, seed=3)
    index = build_index(vecs, AnnConfig(min_items=0, quantize_int8=kind == "q8"), device=cuda)
    rng = np.random.default_rng(4)
    kw = {}
    if kind in ("excl", "q8"):
        kw["exclude"] = rng.integers(0, len(vecs), (64, 3)).astype(np.int32)
    if kind == "masked":
        kw["mask"] = rng.random((64, len(vecs))) < 0.5
    table = torch.tensor(vecs) if kind == "q8" else None
    got = AnnSearcher.fetch(AnnSearcher(index, exact_table=None if table is None else table.cuda(),
                                        device=cuda).search_async(q, 16, **kw))
    want = AnnSearcher.fetch(AnnSearcher(index, exact_table=table, device="cpu").search_async(q, 16, **kw))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for gs, gi, wi in zip(got[0], got[1], want[1]):
        tied = np.isclose(gs[:, None], gs[None, :], rtol=1e-5, atol=1e-6).sum(axis=1) > 1
        np.testing.assert_array_equal(gi[~tied], wi[~tied])


def test_ann_build_on_the_card_is_byte_identical_across_runs(cuda):
    from predictionio_tpu_torch.ann import AnnConfig, build_index, serialize_index

    vecs, _ = _ann_corpus(30_000, 32, seed=5)
    blobs = {serialize_index(build_index(vecs, AnnConfig(min_items=0), device=cuda)) for _ in range(2)}
    assert len(blobs) == 1


def test_a_replacement_dispatch_thread_answers_on_the_servers_card(cuda):
    """A dispatch hung past its deadline is walked away from (503, one
    watchdog trip); the next query runs on a fresh dispatch thread that took
    the server's card as its current device, and answers as serve_batch."""
    import json
    import urllib.error
    import urllib.request

    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.resilience import FaultInjector
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig

    rng = np.random.default_rng(5)
    model = convert.als_model_from_numpy(rng.normal(size=(300, 16)), rng.normal(size=(500, 16)),
                                         [f"u{i}" for i in range(300)], [f"i{i}" for i in range(500)])
    ctx = WorkflowContext(mode="serving", device=cuda)
    engine = rec.engine_factory()
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
    models = engine.prepare_deploy(ctx, ep, [model])
    server = QueryServer(engine, ep, models, ctx,
                         ServerConfig(ip="127.0.0.1", port=0, request_timeout_s=1.0, breaker_threshold=100),
                         "inst-gpu")
    seen = []

    class Recording:
        def __init__(self, algo):
            self.algo = algo

        def predict_batch_dispatch(self, model, queries):
            seen.append((torch.cuda.current_device(), torch.empty(1, device="cuda").device.index))
            return self.algo.predict_batch_dispatch(model, queries)

        def __getattr__(self, name):
            return getattr(self.algo, name)

    algo = FaultInjector(Recording(server._active.algorithms[0]))
    algo.inject("predict_batch_dispatch", fail_count=1, hang_s=2.0)
    server._active.algorithms[0] = algo

    def post(user):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json", method="POST",
                                     data=json.dumps({"user": user, "num": 10}).encode())
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    port = server.start()
    try:
        assert post("u3")[0] == 503
        assert server.batcher.watchdog_trips == 1
        status, body = post("u7")
    finally:
        server.shutdown()
    assert status == 200
    assert seen == [(server._device_index, server._device_index)]
    served = models[0]
    scores, items = served.serving_index().serve_batch(np.asarray([served.user_index("u7")]), 10)
    assert [s["item"] for s in body["itemScores"]] == [served.item_vocab[int(i)] for i in items[0]]
    np.testing.assert_allclose([s["score"] for s in body["itemScores"]], scores[0], rtol=1e-5)


def test_a_profile_capture_finds_each_kernels_symbol(cuda, tmp_path):
    """torch.profiler on the card sees B1, B2 and B3, launched through
    ctypes, as kernel events under their symbols, one launch each."""
    from predictionio_tpu_torch.obs.profiler import ProfileSession, ProfileStore, kernel_launches
    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.ops.spd_solve import batched_spd_solve_fused

    A_np, b_np = _spd_batch(500, 32)
    Ad, bd = torch.from_numpy(A_np).to(cuda), torch.from_numpy(b_np).to(cuda)
    q = torch.randn(8, 1, 200, 32, device=cuda)
    ql = torch.randn(4, 1, 1024, 32, device=cuda)
    batched_spd_solve_fused(Ad, bd), A.fused_attention_block(q, q, q, True), A.flash_attention(ql, ql, ql, True)
    torch.cuda.synchronize()
    session = ProfileSession(ProfileStore(str(tmp_path)), device="cuda")
    with session.trace(trigger="test") as box:
        batched_spd_solve_fused(Ad, bd)
        A.fused_attention_block(q, q, q, True)
        A.flash_attention(ql, ql, ql, True)
    kernels = box["kernels"]
    assert kernel_launches(kernels, "spd_cg_registers") == 1, kernels
    assert kernel_launches(kernels, "attention_block_kernel") == 1, kernels
    assert kernel_launches(kernels, "flash_attention_kernel") == 1, kernels
    assert os.path.exists(os.path.join(box["path"], "trace", "trace.json"))


def test_device_memory_stats_keep_the_jax_keys(cuda):
    from predictionio_tpu_torch.obs import xray

    x = torch.ones(1 << 20, device=cuda)
    stats = xray.device_memory_stats()
    assert set(stats) == {"device", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert stats["bytes_limit"] > 0 and stats["bytes_in_use"] >= x.numel() * 4
    assert xray.live_array_bytes() >= x.numel() * 4


def _dist_worker():
    """tests/torch_dist_worker.py by path (a ``tests`` package installed on
    the card's machine can shadow this checkout's)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")
    spec = importlib.util.spec_from_file_location("torch_dist_worker", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_two_ranks_sharing_the_card_over_gloo_give_the_cpu_result(cuda, tmp_path, monkeypatch):
    from predictionio_tpu_torch.ops import als as pt_als
    from predictionio_tpu_torch.ops.als import ALSConfig, als_train
    worker = _dist_worker()
    load, run_world, train_ratings = worker.load, worker.run_world, worker.train_ratings

    init = pt_als._als_init

    def zero_dummy(**kw):  # the sharded init zeroes rows past n_items
        uf, vf = init(**kw)
        vf[-1] = 0.0
        return uf, vf

    monkeypatch.setattr(pt_als, "_als_init", zero_dummy)
    run_world(2, ["als_train2_cuda"], str(tmp_path), timeout=120)
    for implicit in (False, True):
        u, i, v = train_ratings(implicit)
        cfg = ALSConfig(rank=4, iterations=6, reg=0.05, implicit=implicit, chunk=256)
        pu, pv = als_train(u, i, v, 120, 80, cfg, device="cpu")
        tag = "implicit" if implicit else "explicit"
        got = load(str(tmp_path), "als_train2_cuda")
        assert str(got["backend"]) == "gloo"
        np.testing.assert_allclose(got[f"uf_{tag}"], pu.numpy(), rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[f"vf_{tag}"], pv.numpy(), rtol=0, atol=1e-3)


def test_a_one_rank_job_on_the_card_runs_nccl_collectives(cuda, tmp_path):
    worker = _dist_worker()
    load, run_world = worker.load, worker.run_world

    run_world(1, ["nccl1_cuda"], str(tmp_path), timeout=120)
    got = load(str(tmp_path), "nccl1_cuda")
    assert str(got["backend"]) == "nccl" and str(got["device"]).startswith("cuda")
    x = np.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(got["gathered"], x)
    np.testing.assert_array_equal(got["permuted"], 2 * x)
    np.testing.assert_array_equal(got["grad"], 2 * x)
