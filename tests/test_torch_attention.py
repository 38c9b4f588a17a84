"""The port's attention (``predictionio_tpu_torch/ops/attention.py``) against
the JAX package's, on the CPU, with inputs from numpy seeds.

Tolerances:
  - ``attention_reference`` is f32 on both sides: atol 1e-6.
  - The plain versions of kernels B2 and B3 against the Pallas kernels in
    interpret mode: atol 1e-3. Both follow one bf16 contract (q, k and p
    rounded to bf16, f32 sums), but XLA's and torch's ``exp`` may round p
    to different bf16 values.
  - Any of them against the f32 reference: atol 2e-2, the bf16 bound of
    ``tests/test_attention.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import attention as jax_attn  # noqa: E402
from predictionio_tpu_torch.ops import attention as pt_attn  # noqa: E402


def _qkv(B, H, L, D, seed=0, Lk=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, L, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk or L, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk or L, D)).astype(np.float32)
    return q, k, v


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 32, 8), (1, 3, 17, 5)])
def test_attention_reference_matches_jax(shape, causal):
    q, k, v = _qkv(*shape, seed=1)
    want = np.asarray(jax_attn.attention_reference(*_jax(q, k, v), causal=causal))
    got = pt_attn.attention_reference(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_attention_reference_offsets_and_empty_rows_match_jax():
    """A query offset below the key offset leaves rows with no visible key:
    both sides give zeros there (softmax of a -inf row, then nan_to_num)."""
    q, k, v = _qkv(1, 2, 8, 4, seed=2)
    want = np.asarray(jax_attn.attention_reference(*_jax(q, k, v), causal=True, q_offset=0, k_offset=4))
    got = pt_attn.attention_reference(*_torch(q, k, v), causal=True, q_offset=0, k_offset=4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(got[:, :, :4] == 0.0)


def test_online_block_matches_jax():
    q, k, v = _qkv(1, 2, 8, 4, seed=3)
    rng = np.random.default_rng(4)
    acc = rng.normal(size=(1, 2, 8, 4)).astype(np.float32)
    row_max = rng.normal(size=(1, 2, 8)).astype(np.float32)
    row_max[0, 0, 0] = -np.inf
    row_sum = rng.random(size=(1, 2, 8)).astype(np.float32)
    mask = np.tril(np.ones((8, 8), bool))
    mask[3] = False  # a fully masked row exercises the guards
    want = jax_attn._online_block(*_jax(q, k, v, acc, row_max, row_sum), jnp.asarray(mask))
    got = pt_attn._online_block(*_torch(q, k, v, acc, row_max, row_sum), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_block_plain_matches_pallas_interpret(causal):
    q, k, v = _qkv(1, 2, 16, 8)
    want = np.asarray(jax_attn._fused_attention_pallas(*_jax(q, k, v), causal, interpret=True))
    got = pt_attn._fused_attention_plain(*_torch(q, k, v), causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    ref = pt_attn.attention_reference(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_pallas_interpret(causal):
    """L = 1024, D = 8 with 256-row tiles on both sides, as
    ``tests/test_attention.py`` runs the Pallas kernel."""
    q, k, v = _qkv(1, 1, 1024, 8)
    want = np.asarray(jax_attn._flash_attention_pallas(
        *_jax(q, k, v), causal, interpret=True, block_q=256, block_k=256))
    got = pt_attn._flash_attention_plain(*_torch(q, k, v), causal, block_q=256, block_k=256).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    ref = pt_attn.attention_reference(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,Lk", [(1500, None), (70, 130), (130, 70)])
def test_flash_plain_ragged_edges_match_reference(L, Lk, causal):
    """The card's tiles (FLASH_BLOCK_Q, FLASH_BLOCK_K) on lengths that are
    no multiple of them, and Lq != Lk (causal indices both from 0)."""
    q, k, v = _qkv(1, 1, L, 6, seed=5, Lk=Lk)
    got = pt_attn._flash_attention_plain(*_torch(q, k, v), causal).numpy()
    ref = pt_attn.attention_reference(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)
    block = pt_attn._fused_attention_plain(*_torch(q, k, v), causal).numpy()
    np.testing.assert_allclose(got, block, rtol=0, atol=2e-2)


def test_flash_plain_skips_tiles_above_the_diagonal(monkeypatch):
    """Causal: a K tile that starts after the Q tile's last row never runs."""
    calls = []
    real = pt_attn._causal_keep

    def spy(q0, nq, k0, nk, device):
        calls.append((q0, k0))
        return real(q0, nq, k0, nk, device)

    monkeypatch.setattr(pt_attn, "_causal_keep", spy)
    q, k, v = _qkv(1, 1, 256, 4)
    pt_attn._flash_attention_plain(*_torch(q, k, v), True, block_q=64, block_k=64)
    assert calls and all(k0 <= q0 + 63 for q0, k0 in calls)
    assert len(calls) == 4 + 3 + 2 + 1


@pytest.mark.parametrize(
    "Lq,Lk,which",
    [(1023, 1023, "block"), (1024, 1024, "flash"), (8, 8, "block"), (200, 200, "block"),
     (511, 2048, "block"), (512, 2048, "flash"), (2048, 2048, "flash"),
     # B2 keeps no score rows, so a small score tile takes it at any Lk
     (1, 2049, "block"), (1, 1048575, "block"), (1, 1048576, "flash")],
)
def test_route_keeps_the_jax_thresholds(Lq, Lk, which):
    assert pt_attn.route(Lq, Lk) == which


@pytest.mark.parametrize("L,plain", [(1023, "_fused_attention_plain"), (1024, "_flash_attention_plain")])
def test_fused_attention_on_cpu_runs_the_plain_version_of_the_routed_kernel(L, plain):
    q, k, v = _torch(*_qkv(1, 1, L, 4, seed=6))
    got = pt_attn.fused_attention(q, k, v, causal=True)
    want = getattr(pt_attn, plain)(q, k, v, True)
    assert torch.equal(got, want)
    ref = pt_attn.attention_reference(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-2)


def test_fused_attention_on_cpu_takes_the_flash_plain_version_past_max_block_lk():
    """The longest key axis B2 takes at Lq rows is the last one whose f32
    score tile stays under 4 MiB; one key more takes B3's plain version."""
    Lq = 64
    max_block_lk = (pt_attn.BLOCK_TILE_BYTES - 1) // (4 * Lq)
    assert pt_attn.route(Lq, max_block_lk) == "block"
    q, _, _ = _qkv(1, 1, Lq, 4, seed=9)
    _, k, v = _qkv(1, 1, max_block_lk + 1, 4, seed=10)
    q, k, v = _torch(q, k, v)
    got = pt_attn.fused_attention(q, k, v, causal=False)
    assert torch.equal(got, pt_attn._flash_attention_plain(q, k, v, False))
    ref = pt_attn.attention_reference(q, k, v)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_on_cpu_takes_the_block_plain_version_for_a_long_key_axis(causal):
    """A small score tile with a key axis past the 2,048 keys B2 once took:
    B2's plain version, as the JAX routing has it."""
    q, _, _ = _qkv(1, 1, 3, 4, seed=11)
    _, k, v = _qkv(1, 1, 10000, 4, seed=12)
    q, k, v = _torch(q, k, v)
    got = pt_attn.fused_attention(q, k, v, causal=causal)
    assert torch.equal(got, pt_attn._fused_attention_plain(q, k, v, causal))
    ref = pt_attn.attention_reference(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_matches_jax_forced_pallas(causal):
    """The whole dispatch on both sides: the port's CPU route against the
    JAX dispatch forced through the Pallas kernels in interpret mode."""
    q, k, v = _qkv(2, 1, 24, 8, seed=7)
    want = np.asarray(jax_attn.fused_attention(*_jax(q, k, v), causal=causal, force_pallas=True))
    got = pt_attn.fused_attention(*_torch(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(64, 1, 8, 32), (64, 1, 200, 32), (3, 1, 37, 128)])
def test_a_skipped_p_rounding_is_far_outside_the_card_tolerance(shape, causal):
    """The card holds B2 and B3 to their plain versions at atol 1e-5
    (tests/test_torch_gpu.py, chip_smoke.py). A kernel that kept p in f32
    before P·V would miss that by far more, at the card tests' shapes."""
    import math

    q, k, v = _torch(*_qkv(*shape, seed=sum(shape)))
    s = torch.matmul(pt_attn._bf16(q), pt_attn._bf16(k).transpose(-1, -2)) / math.sqrt(shape[-1])
    if causal:
        s = s.masked_fill(~pt_attn._causal_keep(0, shape[2], 0, shape[2], q.device), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    unrounded = torch.matmul(p, pt_attn._bf16(v)) / p.sum(dim=-1, keepdim=True)
    assert float((unrounded - pt_attn._fused_attention_plain(q, k, v, causal)).abs().max()) > 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_another_summation_order_of_the_scores_is_far_outside_the_card_tolerance(causal):
    """The kernels' tensor cores sum Q·Kᵀ in another order than the plain
    version. Scores an ulp apart flip bf16(p) where p lies near a rounding
    midpoint: with the scores summed in f64 and rounded once, the output at
    the scorer's [64, 1, 200, 32] moves by more than 1e-4, ten times the
    card's limit. That is why the kernels sum such scores again in the plain
    version's column order (csrc/attention_common.cuh)."""
    import math

    shape = (64, 1, 200, 32)
    q, k, v = _torch(*_qkv(*shape, seed=sum(shape)))
    s = torch.matmul(pt_attn._bf16(q).double(), pt_attn._bf16(k).double().transpose(-1, -2))
    s = s.float() / math.sqrt(shape[-1])
    if causal:
        s = s.masked_fill(~pt_attn._causal_keep(0, shape[2], 0, shape[2], q.device), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    reordered = torch.matmul(pt_attn._bf16(p), pt_attn._bf16(v)) / p.sum(dim=-1, keepdim=True)
    assert float((reordered - pt_attn._fused_attention_plain(q, k, v, causal)).abs().max()) > 1e-4


@pytest.mark.parametrize("fn", ["fused_attention_block", "flash_attention"])
def test_cuda_wrappers_refuse_cpu_tensors(fn):
    q, k, v = _torch(*_qkv(1, 1, 8, 4))
    wrapper = getattr(pt_attn, fn)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(q, k, v, True)
    assert wrapper.launches == before


def test_output_keeps_q_dtype_and_shape():
    q, k, v = _torch(*_qkv(2, 3, 10, 7, seed=8))
    for out in (pt_attn._fused_attention_plain(q, k, v, True), pt_attn._flash_attention_plain(q, k, v, True)):
        assert out.dtype == torch.float32 and out.shape == q.shape
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 16, 8), (1, 3, 40, 5)])
def test_fused_attention_backward_matches_jax_grad_of_the_reference(shape, causal):
    """FusedAttention's gradient is the f32 attention_reference's: against
    jax.vjp of the JAX reference (the JAX package trains through it; a
    Pallas call has no reverse rule), atol 1e-5. Its forward is the plain
    version of the routed kernel, as without autograd."""
    q, k, v = _qkv(*shape, seed=sum(shape))
    g = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attn.attention_reference(a, b, c, causal=causal), *_jax(q, k, v))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out = pt_attn.fused_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), pt_attn._fused_attention_plain(*_torch(q, k, v), causal))
    out.backward(torch.from_numpy(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5)


def test_attention_reference_grad_slices_batch_heads(monkeypatch):
    """The backward in slices of batch·heads gives what one slice gives."""
    q, k, v = _torch(*_qkv(3, 2, 12, 4, seed=21))
    g = torch.from_numpy(np.random.default_rng(22).normal(size=(3, 2, 12, 4)).astype(np.float32))
    whole = pt_attn.attention_reference_grad(q, k, v, g, True)
    monkeypatch.setattr(pt_attn, "GRAD_SLICE_BYTES", 12 * 12 * 4 * 2)  # two batch·heads a slice
    sliced = pt_attn.attention_reference_grad(q, k, v, g, True)
    for a, b in zip(whole, sliced):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_fused_attention_without_grad_skips_autograd():
    q, k, v = (t.requires_grad_() for t in _torch(*_qkv(1, 1, 8, 4)))
    with torch.no_grad():
        out = pt_attn.fused_attention(q, k, v, causal=True)
    assert out.grad_fn is None


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [129, 160])
def test_block_plain_matches_pallas_interpret_past_head_dim_128(D, causal):
    """Heads wider than 128 columns, which the card's kernels take in
    128-column slices: the plain version against the Pallas kernel."""
    q, k, v = _qkv(1, 2, 16, D, seed=D)
    want = np.asarray(jax_attn._fused_attention_pallas(*_jax(q, k, v), causal, interpret=True))
    got = pt_attn._fused_attention_plain(*_torch(q, k, v), causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
