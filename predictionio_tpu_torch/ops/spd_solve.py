"""Batched small-SPD solve: the plain PyTorch CG and its CUDA kernel.

The ALS half-solve ends with one [f, f] SPD system per entity (f = rank).
``_cg_body`` is the Jacobi-preconditioned CG of the JAX package
(``predictionio_tpu/ops/spd_solve.py:_cg_body``) in plain PyTorch: the
same preconditioner, the same f+4 iterations, the same update order and
clamps. ``batched_spd_solve_fused`` launches ``csrc/spd_cg.cu``, which runs
that algorithm with one warp per system and A read from device memory once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from predictionio_tpu_torch.ops import _build

MAX_RANK = 128  # pio_spd_cg_max_rank() in csrc/spd_cg.cu


def _cg_body(A: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain version of kernel B1: x = A^-1 b for A [n, f, f], b [n, f]."""
    dinv = 1.0 / torch.diagonal(A, dim1=-2, dim2=-1)

    def mv(v):
        return torch.bmm(A, v.unsqueeze(-1)).squeeze(-1)

    x = b * dinv
    r = b - mv(x)
    z = r * dinv
    p = z
    rz = torch.sum(r * z, -1)
    for _ in range(iters):
        Ap = mv(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap, -1), min=1e-30)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = r * dinv
        rz2 = torch.sum(r * z, -1)
        p = z + (rz2 / torch.clamp(rz, min=1e-30))[:, None] * p
        rz = rz2
    return x


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("spd_cg")
    lib.pio_spd_cg_solve.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pio_spd_cg_solve.restype = ctypes.c_int
    lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pio_cuda_error_string.restype = ctypes.c_char_p
    lib.pio_spd_cg_max_rank.restype = ctypes.c_int
    if lib.pio_spd_cg_max_rank() != MAX_RANK:
        raise RuntimeError("spd_cg.cu and spd_solve.MAX_RANK disagree")
    return lib


def batched_spd_solve_fused(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel B1 on CUDA tensors: A [n, f, f] f32 SPD, b [n, f] f32, both
    contiguous on one card, f <= MAX_RANK. Raises on anything else."""
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(
            f"batched_spd_solve_fused needs A and b on one CUDA device, got "
            f"{A.device} and {b.device} (the CPU version is _cg_body)"
        )
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"float32 only, got {A.dtype} and {b.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(
            f"shapes must be A [n, f, f] and b [n, f], got {tuple(A.shape)} "
            f"and {tuple(b.shape)}"
        )
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("A and b must be contiguous")
    n, f = A.shape[0], A.shape[-1]
    if not 1 <= f <= MAX_RANK:
        raise ValueError(f"rank {f} outside what the CUDA solve takes (1..{MAX_RANK})")
    x = torch.empty_like(b)
    if n == 0:
        return x
    lib = _library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        rc = lib.pio_spd_cg_solve(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), n, f, f + 4, stream
        )
    if rc != 0:
        raise RuntimeError(
            f"spd_cg launch failed: {lib.pio_cuda_error_string(rc).decode()} ({rc})"
        )
    batched_spd_solve_fused.launches += 1
    return x


batched_spd_solve_fused.launches = 0


def batched_spd_solve_auto(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if A.device.type == "cuda":
        return batched_spd_solve_fused(A, b)
    return _cg_body(A, b, A.shape[-1] + 4)
