"""Ring and ulysses attention of the port (ops/attention.py) on gloo ranks,
against the JAX package's on a CPU mesh of as many devices.

Ring attention is f32 online softmax on both sides: atol 1e-5. The port's
ulysses attends each head's whole sequence through ``fused_attention``,
whose CPU path is kernel B2's plain version (bf16 operands, f32 sums). So
ulysses holds the port's one-device ``fused_attention`` at atol 1e-5 (the
all-to-alls only move data), and the JAX ulysses with its local block
forced through the Pallas kernel in interpret mode (B2's contract; off the
TPU its ``fused_attention`` is otherwise the f32 reference) at atol 1e-3,
the tolerance of ``tests/test_torch_attention.py`` for that pair. Gradients (of
sum(out * dout)) hold the one-device ``attention_reference_grad`` at atol
1e-5: ring's through its online softmax and the permutations' transposes,
ulysses' through ``FusedAttention``'s reference gradient and the
all-to-alls'. On 4 ranks the batch shards over ``data`` as well (JAX's
``batch_axis``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from predictionio_tpu.ops import attention as jax_attn  # noqa: E402
from predictionio_tpu_torch.ops import attention as pt_attn  # noqa: E402
from tests.torch_dist_worker import attention_inputs, load, run_world  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in (2, 4):
        d = str(tmp_path_factory.mktemp(f"attn{n}"))
        run_world(n, [f"attention{n}"], d)
        out[n] = d
    return out


def _shards(n_world, x):
    """Each rank's [B/dp, H, L/sp, D] part of a global array, by rank."""
    dp, sp = (1, 2) if n_world == 2 else (2, 2)
    B, _, L, _ = x.shape
    return [x[(r // sp) * (B // dp):(r // sp + 1) * (B // dp), :, (r % sp) * (L // sp):(r % sp + 1) * (L // sp)]
            for r in range(n_world)]


def _jax_mesh(n_world):
    if n_world == 2:
        return Mesh(np.asarray(jax.devices()[:2]), ("sp",)), None
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "sp")), "data"


@pytest.mark.parametrize("n_world", [2, 4])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax_and_one_device(worlds, n_world, impl, causal, monkeypatch):
    q, k, v, dout = attention_inputs()
    forced = jax_attn.fused_attention
    monkeypatch.setattr(jax_attn, "fused_attention",
                        lambda q, k, v, causal=False: forced(q, k, v, causal, force_pallas=True))
    mesh, batch_axis = _jax_mesh(n_world)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if impl == "ring":
        want = np.asarray(jax_attn.ring_attention_sharded(jq, jk, jv, mesh, axis="sp", causal=causal,
                                                          batch_axis=batch_axis))
        tol = 1e-5
    else:
        want = np.asarray(jax_attn.ulysses_attention(jq, jk, jv, mesh, axis="sp", causal=causal,
                                                     batch_axis=batch_axis))
        tol = 1e-3
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    one_device = pt_attn.fused_attention(tq, tk, tv, causal).numpy()
    dq, dk, dv = (g.numpy() for g in pt_attn.attention_reference_grad(tq, tk, tv, tdo, causal))
    tag = f"{impl}_{'causal' if causal else 'full'}"
    for r, (w, od, gq, gk, gv) in enumerate(zip(_shards(n_world, want), _shards(n_world, one_device),
                                                _shards(n_world, dq), _shards(n_world, dk),
                                                _shards(n_world, dv))):
        got = load(worlds[n_world], f"attention{n_world}", r)
        np.testing.assert_allclose(got["out_" + tag], w, rtol=0, atol=tol)
        if impl == "ulysses":
            np.testing.assert_allclose(got["out_" + tag], od, rtol=0, atol=1e-5)
        for name, g in zip("qkv", (gq, gk, gv)):
            np.testing.assert_allclose(got[f"d{name}_{tag}"], g, rtol=0, atol=1e-5)


def test_ring_attention_sharded_takes_and_returns_global_arrays(worlds):
    q, k, v, _ = attention_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    want = np.asarray(jax_attn.ring_attention_sharded(*map(jnp.asarray, (q, k, v)), mesh, axis="sp", causal=True))
    for r in range(2):
        np.testing.assert_allclose(load(worlds[2], "attention2", r)["sharded_causal"], want, rtol=0, atol=1e-5)


def test_one_rank_ring_is_the_online_softmax_of_the_whole_sequence():
    """Without a job the mesh is one rank: ring is one online-softmax block,
    equal to the f32 reference; ulysses is fused_attention."""
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh("sp=1", "cpu")
    q, k, v = (torch.from_numpy(a) for a in attention_inputs()[:3])
    for causal in (False, True):
        ref = pt_attn.attention_reference(q, k, v, causal)
        torch.testing.assert_close(pt_attn.ring_attention(q, k, v, mesh, "sp", causal), ref, rtol=0, atol=1e-5)
        assert torch.equal(pt_attn.ulysses_attention(q, k, v, mesh, "sp", causal),
                           pt_attn.fused_attention(q, k, v, causal))


def test_ulysses_refuses_heads_not_divisible_by_the_axis():
    from predictionio_tpu_torch.parallel.mesh import Mesh as PtMesh

    mesh = PtMesh(("sp",), [2], 0, torch.device("cpu"), {})
    x = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="head count 3 not divisible by sp=2"):
        pt_attn.ulysses_attention(x, x, x, mesh, "sp")
    with pytest.raises(ValueError, match="sequence length 5 not divisible by sp=2"):
        pt_attn.ring_attention_sharded(*(torch.zeros(1, 2, 5, 8),) * 3, mesh, "sp")
