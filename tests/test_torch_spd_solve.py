"""The port's batched SPD solve against the JAX package's, on the CPU.

The same numpy systems go through the JAX ``_cg_body``, the JAX pallas
kernel in interpret mode, and the port's plain ``_cg_body``; all three run
one f32 algorithm, so they agree to float rounding (atol 1e-4, as
tests/test_spd_solve.py holds the JAX kernel to the stock cg path).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from crowding the other workers' tests
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import als as jax_als  # noqa: E402
from predictionio_tpu.ops import spd_solve as jax_spd  # noqa: E402
from predictionio_tpu_torch.ops import als as pt_als  # noqa: E402
from predictionio_tpu_torch.ops import spd_solve as pt_spd  # noqa: E402


def _spd_batch(n, f, seed=0, reg=0.05):
    """ALS-shaped systems: Gram matrices of random data + scaled ridge."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, 3 * f, f)).astype(np.float32)
    A = np.einsum("bdf,bdg->bfg", G, G) + reg * (3 * f) * np.eye(f, dtype=np.float32)
    b = rng.normal(size=(n, f)).astype(np.float32)
    return A.astype(np.float32), b


@pytest.mark.parametrize("n,f,bs", [(17, 8, 8), (33, 16, 16), (5, 8, 4)])
def test_cg_body_matches_jax_cg_body(n, f, bs):
    A, b = _spd_batch(n, f, seed=n)
    x_jax = np.asarray(jax_spd._cg_body(jnp.asarray(A), jnp.asarray(b), f + 4, unroll=False))
    x_pt = pt_spd._cg_body(torch.from_numpy(A), torch.from_numpy(b), f + 4).numpy()
    np.testing.assert_allclose(x_pt, x_jax, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,f,bs", [(17, 8, 8), (33, 16, 16), (5, 8, 4)])
def test_cg_body_matches_pallas_kernel_interpret(n, f, bs):
    """The pallas kernel in interpret mode, the pad path included at (5, 8)."""
    A, b = _spd_batch(n, f, seed=n + 1)
    x_kernel = np.asarray(
        jax_spd.batched_spd_solve_fused(jnp.asarray(A), jnp.asarray(b), bs=bs, interpret=True)
    )
    x_pt = pt_spd._cg_body(torch.from_numpy(A), torch.from_numpy(b), f + 4).numpy()
    assert x_pt.shape == (n, f)
    np.testing.assert_allclose(x_pt, x_kernel, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,f", [(9, 8), (40, 10), (3, 32)])
def test_auto_on_cpu_is_the_plain_body_exactly(n, f):
    A, b = _spd_batch(n, f, seed=3)
    A_t, b_t = torch.from_numpy(A), torch.from_numpy(b)
    before = pt_spd.batched_spd_solve_fused.launches
    x = pt_spd.batched_spd_solve_auto(A_t, b_t)
    assert torch.equal(x, pt_spd._cg_body(A_t, b_t, f + 4))
    assert pt_spd.batched_spd_solve_fused.launches == before  # no kernel on the CPU


def test_fused_wrapper_refuses_cpu_tensors():
    """No silent fallback: the kernel wrapper raises for CPU tensors."""
    A, b = _spd_batch(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pt_spd.batched_spd_solve_fused(torch.from_numpy(A), torch.from_numpy(b))


@pytest.mark.parametrize("solver", ["cg", "cg_fused", "cholesky"])
def test_batched_spd_solve_matches_jax(solver):
    A, b = _spd_batch(17, 8, seed=5)
    x_jax = np.asarray(jax_als._batched_spd_solve(jnp.asarray(A), jnp.asarray(b), solver))
    x_pt = pt_als._batched_spd_solve(torch.from_numpy(A), torch.from_numpy(b), solver).numpy()
    np.testing.assert_allclose(x_pt, x_jax, rtol=0, atol=1e-4)


def test_cg_matches_cholesky():
    A, b = _spd_batch(17, 8)
    A_t, b_t = torch.from_numpy(A), torch.from_numpy(b)
    np.testing.assert_allclose(
        pt_als._batched_spd_solve(A_t, b_t, "cg").numpy(),
        pt_als._batched_spd_solve(A_t, b_t, "cholesky").numpy(),
        rtol=0,
        atol=2e-3,
    )


def test_train_quality_parity_across_solvers():
    """The tests/test_spd_solve.py:66 problem: cg and cg_fused are one
    algorithm; on the CPU both run the plain body, so they agree exactly."""
    rng = np.random.default_rng(7)
    n_u, n_i, nnz = 120, 80, 4000
    u = rng.integers(0, n_u, nnz).astype(np.int32)
    i = rng.integers(0, n_i, nnz).astype(np.int32)
    v = np.sum(rng.normal(size=(n_u, 4))[u] * rng.normal(size=(n_i, 4))[i], axis=1).astype(np.float32)

    def rmse(solver):
        cfg = pt_als.ALSConfig(rank=4, iterations=6, reg=0.05, solver=solver)
        uf, vf = pt_als.als_train(u, i, v, n_u, n_i, cfg, device="cpu")
        pred = (uf.numpy() @ vf.numpy().T)[u, i]
        return float(np.sqrt(np.mean((pred - v) ** 2)))

    assert rmse("cg") == rmse("cg_fused")
    assert abs(rmse("cg") - rmse("cholesky")) < 1e-3


def test_kernel_module_builds_nothing_on_import():
    code = (
        "import predictionio_tpu_torch.ops.spd_solve as s, "
        "predictionio_tpu_torch.ops._build as b; "
        "assert not b._libs and not b.build_logs; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
