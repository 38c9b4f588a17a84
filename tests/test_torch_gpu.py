"""Tests of the port's CUDA kernels; they need a card and skip without one.

Run on a machine with an NVIDIA H100:
``python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest``.
This file imports no JAX: the kernels are held against their plain PyTorch
versions on the card (f32 sum order differs over f+4 CG iterations, hence
atol 1e-4 on well-conditioned systems).
"""

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


@pytest.mark.parametrize("n,f", [(1, 1), (5, 8), (17, 10), (33, 16), (1001, 32),
                                 (403, 64), (77, 100), (39, 128)])
def test_spd_cg_matches_plain(cuda, n, f):
    from predictionio_tpu_torch.ops.spd_solve import _cg_body, batched_spd_solve_fused

    A, b = _spd_batch(n, f, seed=f)
    A_d, b_d = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    before = batched_spd_solve_fused.launches
    x = batched_spd_solve_fused(A_d, b_d)
    torch.cuda.synchronize()
    assert batched_spd_solve_fused.launches == before + 1
    ref = _cg_body(A_d, b_d, f + 4)
    assert x.shape == (n, f)
    assert torch.isfinite(x).all()
    np.testing.assert_allclose(x.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=1e-4)


def test_spd_cg_rejects_what_it_does_not_take(cuda):
    from predictionio_tpu_torch.ops.spd_solve import MAX_RANK, batched_spd_solve_fused

    A, b = _spd_batch(3, 8)
    A_d, b_d = torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda)
    with pytest.raises(TypeError):
        batched_spd_solve_fused(A_d.double(), b_d.double())
    with pytest.raises(ValueError, match="contiguous"):
        batched_spd_solve_fused(A_d.transpose(1, 2), b_d)
    with pytest.raises(ValueError, match="CUDA"):
        batched_spd_solve_fused(A_d.cpu(), b_d.cpu())
    big = torch.eye(MAX_RANK + 1, device=cuda).expand(2, -1, -1).contiguous()
    with pytest.raises(ValueError, match="rank"):
        batched_spd_solve_fused(big, torch.ones(2, MAX_RANK + 1, device=cuda))
