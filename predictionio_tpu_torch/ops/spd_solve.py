"""Batched small-SPD solve: the plain PyTorch CG and its CUDA kernel.

The ALS half-solve ends with one [f, f] SPD system per entity (f = rank).
``_cg_body`` is the Jacobi-preconditioned CG of the JAX package
(``predictionio_tpu/ops/spd_solve.py:_cg_body``) in plain PyTorch: the
same preconditioner, the same f+4 iterations, the same update order and
clamps. ``batched_spd_solve_fused`` launches ``csrc/spd_cg.cu``, which runs
that algorithm with A read from device memory once: for ranks up to 64 a
group of lanes holds one system's A in registers, for ranks up to 128 a
warp keeps it in shared memory, past that a block of 256 threads solves
one system, with A in shared memory while it fits (f <= 238) and read from
device memory at every step beyond, and past f = 11,619, where the five CG
vectors of one system outgrow a block's shared memory, the whole grid
solves each system in turn with its vectors in a device scratch buffer
that the wrapper allocates. ``launch_plan`` says which, as the source
does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from predictionio_tpu_torch.ops import _build

MAX_REGISTER_RANK = 64  # ranks whose A one warp holds in registers
MAX_WARP_RANK = 128  # ranks one warp solves; past it one block per system
WARPS_PER_BLOCK = 2  # of the warp kernels
BLOCK_THREADS = 256  # of the block kernel
WARP = 32
SMEM_OPTIN = 232_448  # a block's dynamic shared memory on sm_90 (csrc/spd_cg.cu)


def block_smem(f: int, shared_a: bool) -> int:
    """Shared-memory bytes of the block kernel at rank f (``block_smem`` in
    the source): A when held there, five vectors, two rows of warp sums."""
    return ((f * f if shared_a else 0) + 5 * f + 2 * (BLOCK_THREADS // WARP)) * 4


def grid_scratch_floats(f: int, blocks: int) -> int:
    """Floats of the grid plan's device scratch (``grid_scratch_floats`` in
    the source): r, p, Ap, 1/diag(A), and three partial sums per block."""
    return 4 * f + 3 * blocks


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``csrc/spd_cg.cu`` lays rank-f systems over the card (its
    ``run``): ``kernel`` "registers" (a group of ``group`` lanes holds one
    system's A in registers), "shared" (a warp keeps A in shared memory),
    "block" (a block of ``group`` threads per system, A in shared memory),
    "block_global" (the same, A read from device memory at every step) or
    "grid" (every block of the grid works on each system in turn),
    compiled for ``width`` >= f, for exactly f when ``exact``. In the warp
    kernels a warp solves tiles of ``systems_per_warp`` consecutive systems
    and loops over tiles with the stride of the whole grid; in the block
    kernels a block loops over systems with the stride of the grid."""

    kernel: str
    width: int
    exact: bool
    group: int

    @property
    def per_block(self) -> bool:
        return self.kernel in ("block", "block_global", "grid")

    @property
    def warps_per_block(self) -> int:
        return BLOCK_THREADS // WARP if self.per_block else WARPS_PER_BLOCK

    @property
    def systems_per_warp(self) -> int:
        """Of a warp kernel."""
        return WARP // self.group

    def tiles(self, n: int) -> int:
        """Units of work: a warp's tile of systems, or one system per block."""
        return n if self.per_block else -(-n // self.systems_per_warp)

    def blocks(self, n: int, capacity: int) -> int:
        """The grid for n systems: one warp per tile (one block per system),
        at most ``capacity`` blocks (what the card keeps resident at once);
        the grid plan takes all ``capacity`` blocks for any n > 0."""
        if self.kernel == "grid":
            return capacity if n > 0 else 0
        if self.per_block:
            return min(n, capacity)
        return min(-(-self.tiles(n) // WARPS_PER_BLOCK), capacity)

    def warp_systems(self, n: int, warp: int, warps: int) -> list[int]:
        """The systems that warp ``warp`` of a grid of ``warps`` solves (a
        warp kernel)."""
        spw = self.systems_per_warp
        return [
            s
            for tile in range(warp, self.tiles(n), warps)
            for s in range(tile * spw, min(tile * spw + spw, n))
        ]

    def block_systems(self, n: int, block: int, blocks: int) -> list[int]:
        """The systems that block ``block`` of a grid of ``blocks`` solves
        (in the grid plan: works on, as every block does)."""
        if self.kernel == "grid":
            return list(range(n))
        if self.per_block:
            return list(range(block, n, blocks))
        warps = blocks * WARPS_PER_BLOCK
        return sorted(
            s
            for w in range(block * WARPS_PER_BLOCK, (block + 1) * WARPS_PER_BLOCK)
            for s in self.warp_systems(n, w, warps)
        )


def launch_plan(f: int) -> LaunchPlan:
    """The kernel instantiation for rank f: exact widths for the template
    default (10) and the ALS main paths (32), padded widths 8, 16, 32 and 64
    otherwise, A in a warp's shared memory past rank 64, one block per
    system past rank 128, the whole grid per system past the block's
    shared memory (f > 11,619)."""
    if f < 1:
        raise ValueError(f"rank {f} must be at least 1")
    if f > MAX_WARP_RANK:
        if block_smem(f, False) > SMEM_OPTIN:
            return LaunchPlan("grid", f, True, BLOCK_THREADS)
        kernel = "block" if block_smem(f, True) <= SMEM_OPTIN else "block_global"
        return LaunchPlan(kernel, f, True, BLOCK_THREADS)
    if f > MAX_REGISTER_RANK:
        return LaunchPlan("shared", -(-f // WARP) * WARP, False, WARP)
    if f in (10, 32):
        return LaunchPlan("registers", f, True, 8)
    width = next(w for w in (8, 16, 32, 64) if f <= w)
    return LaunchPlan("registers", width, False, 8 if width <= 32 else WARP)


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
    lib.pio_spd_cg_solve_scratch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.pio_spd_cg_solve_scratch.restype = ctypes.c_int
    lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pio_cuda_error_string.restype = ctypes.c_char_p
    lib.pio_spd_cg_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.pio_spd_cg_plan.restype = ctypes.c_int
    return lib


def batched_spd_solve_fused(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel B1 on CUDA tensors: A [n, f, f] f32 SPD, b [n, f] f32, both
    contiguous on one card, any rank that ``launch_plan`` takes. Raises on
    anything else."""
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
    plan = launch_plan(f)  # raises on a rank the kernel does not take
    x = torch.empty_like(b)
    if n == 0:
        return x
    lib = _library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        if plan.kernel == "grid":
            out = (ctypes.c_int * 7)()
            rc = lib.pio_spd_cg_plan(n, f, out)
            if rc == 0:
                floats = grid_scratch_floats(f, out[6])
                scratch = torch.empty(floats, dtype=torch.float32, device=A.device)
                rc = lib.pio_spd_cg_solve_scratch(
                    A.data_ptr(), b.data_ptr(), x.data_ptr(), n, f, f + 4,
                    scratch.data_ptr(), floats, stream,
                )
        else:
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
