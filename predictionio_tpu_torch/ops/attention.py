"""Attention: the plain PyTorch versions, the CUDA kernels, and sequence
parallelism over ranks.

Port of ``predictionio_tpu/ops/attention.py``. Two TPU kernels compute
one single-device function there, and both have a hand-written
CUDA counterpart here:

  - B2, ``_fused_attention_pallas`` (:389): one block per batch·head holds
    the whole [Lq, Lk] score tile. Port: ``fused_attention_block``, which
    launches ``csrc/attention_block.cu``; plain version
    ``_fused_attention_plain``.
  - B3, ``_flash_attention_pallas`` (:285): tiles over (batch·head, Q, K)
    with an online softmax across the K tiles. Port: ``flash_attention``,
    which launches ``csrc/flash_attention.cu``; plain version
    ``_flash_attention_plain``.

Both keep the kernels' numeric contract: q and k are rounded to bf16
before Q·Kᵀ, p is rounded to bf16 before P·V, every sum runs in f32, the
divide by the row sum comes after P·V, and the output takes q's dtype.
The plain versions compute in f32 on bf16-rounded values, which is that
contract exactly (a product of two bf16 values is exact in f32).

``fused_attention`` routes as the JAX function does (:455-479): B2 when
the f32 score tile Lq·Lk·4 bytes is under 4 MiB, else B3. On a CPU tensor
it runs the plain version of the kernel the card would take. One
deliberate difference, chosen by shape, the function the same: for a long
L that is not a multiple of 256 the JAX package takes
``attention_reference`` on a TPU (:474-477); the port takes B3, whose
ragged edge is masked by index, so the card never runs a plain version.

Training goes through ``FusedAttention``: the kernels' forward, and the
gradient of the f32 reference as explicit matrix products.

Sequence parallelism over a mesh axis (``parallel.mesh``): each rank of
the axis holds one [B, H, L/P, D] shard of the sequence.
``ring_attention`` runs P online-softmax steps (``_online_block``, plain
torch ops as jnp in JAX) and passes its K/V shard to the next rank each
step (``ppermute``); ``ulysses_attention`` re-shards heads for sequence
with one all-to-all, attends the whole sequence locally through
``fused_attention`` (B2, B3 past the tile limit) and re-shards back. Both
train: the collectives' gradients are JAX's transposes. Batch sharding
(dp x sp) composes through the mesh: an axis's process group lies within
one coordinate of every other axis.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.parallel.collectives import all_gather, all_to_all_grad, ppermute_grad
from predictionio_tpu_torch.parallel.mesh import Mesh

# one f32 score tile under this many bytes takes B2 (attention.py:465)
BLOCK_TILE_BYTES = 4 * 1024 * 1024
# B3's tile sizes on the card (flash_attention.cu); the plain version takes
# the same K tile so that both round the online softmax at the same places
FLASH_BLOCK_Q = 64
FLASH_BLOCK_K = 64


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and widen back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Reference and online-softmax block (f32)
# ---------------------------------------------------------------------------


def attention_reference(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,  # [B, H, Lk, D]
    causal: bool = False,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Dense f32 attention; a row with no visible key gives zeros."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[2], device=q.device)[None, :] + k_offset
        scores = scores.masked_fill(qi < ki, float("-inf"))
    weights = torch.nan_to_num(torch.softmax(scores, dim=-1))
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def _online_block(q, k, v, acc, row_max, row_sum, mask):
    """One flash-attention accumulation step (f32).

    q [B,H,Lq,D]; k,v [B,H,Lk,D]; acc [B,H,Lq,D]; row_max/row_sum [B,H,Lq];
    mask [Lq, Lk] boolean (True = attend) or None.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
    new_max = torch.maximum(row_max, scores.amax(dim=-1))
    safe_max = torch.where(torch.isneginf(new_max), 0.0, new_max)
    correction = torch.where(
        torch.isneginf(row_max), 0.0, torch.exp(row_max - safe_max)
    )
    p = torch.exp(scores - safe_max[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    row_sum = row_sum * correction + p.sum(dim=-1)
    return acc, new_max, row_sum


# ---------------------------------------------------------------------------
# Plain versions of B2 and B3
# ---------------------------------------------------------------------------


def _causal_keep(q0: int, nq: int, k0: int, nk: int, device) -> torch.Tensor:
    """[nq, nk] True where query row q0+i may see key k0+j (qi >= ki, no
    offset: both index from 0, also when Lq != Lk)."""
    qi = torch.arange(q0, q0 + nq, device=device)[:, None]
    ki = torch.arange(k0, k0 + nk, device=device)[None, :]
    return qi >= ki


def _bf16_scores(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Q·Kᵀ of bf16-valued f32 tensors, summed in f32 one column after
    another: the order in which the kernels settle a score. On the card
    torch's product sums in that order for heads of at most 128 columns
    (``tests/test_torch_gpu.py``); past 128 it does not at every shape (a
    few query rows by 160 columns differed on an H100), so the sum is
    written out there: each exact bf16 product added and rounded in turn,
    as a fused multiply-add rounds it."""
    if qb.shape[-1] <= 128:
        return torch.matmul(qb, kb.transpose(-1, -2))
    s = torch.zeros((*qb.shape[:-1], kb.shape[-2]), dtype=torch.float32, device=qb.device)
    for d in range(qb.shape[-1]):
        s = s + qb[..., d : d + 1] * kb[..., d].unsqueeze(-2)
    return s


def _fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Plain version of kernel B2: the whole score tile at once, exact row
    max, no −inf guard (a causal row always sees key 0)."""
    Lq, Lk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _bf16_scores(_bf16(q), _bf16(k)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(0, Lq, 0, Lk, q.device), float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(_bf16(p), _bf16(v))
    return (out / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = FLASH_BLOCK_Q,
    block_k: int = FLASH_BLOCK_K,
) -> torch.Tensor:
    """Plain version of kernel B3: an explicit loop over Q tiles and, inside,
    over K tiles with the running max, sum and f32 accumulator, the guards
    of :339-342 and :363, and the causal skip of K tiles that lie wholly
    above the diagonal (:354). A ragged last tile is simply shorter."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qb, kb, vb = _bf16(q), _bf16(k), _bf16(v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    neg_inf = float("-inf")
    for q0 in range(0, Lq, block_q):
        qt = qb[:, :, q0 : q0 + block_q]
        nq = qt.shape[2]
        acc = torch.zeros((B, H, nq, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H, nq, 1), neg_inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, nq, 1), dtype=torch.float32, device=q.device)
        for k0 in range(0, Lk, block_k):
            if causal and k0 > q0 + nq - 1:
                break  # this and every later K tile is fully masked
            kt = kb[:, :, k0 : k0 + block_k]
            s = _bf16_scores(qt, kt) * scale
            if causal:
                keep = _causal_keep(q0, nq, k0, kt.shape[2], q.device)
                s = s.masked_fill(~keep, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
            p = torch.exp(s - safe)
            p = torch.where(torch.isneginf(s), 0.0, p)
            acc = acc * corr + torch.matmul(_bf16(p), vb[:, :, k0 : k0 + block_k])
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
        denom = torch.where(l == 0.0, 1.0, l)
        out[:, :, q0 : q0 + nq] = (acc / denom).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _declare(lib: ctypes.CDLL, fn: str) -> ctypes.CDLL:
    getattr(lib, fn).argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    getattr(lib, fn).restype = ctypes.c_int
    lib.pio_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pio_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _block_library() -> ctypes.CDLL:
    return _declare(_build.load("attention_block"), "pio_attention_block")


@functools.cache
def _flash_library() -> ctypes.CDLL:
    lib = _declare(_build.load("flash_attention"), "pio_flash_attention")
    lib.pio_flash_tile.argtypes = [ctypes.c_int]
    lib.pio_flash_tile.restype = ctypes.c_int
    if (lib.pio_flash_tile(0), lib.pio_flash_tile(1)) != (FLASH_BLOCK_Q, FLASH_BLOCK_K):
        raise RuntimeError("flash_attention.cu and FLASH_BLOCK_Q/K disagree")
    return lib


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What both kernels take: q [B,H,Lq,D], k and v [B,H,Lk,D], f32,
    contiguous, on one CUDA device, D >= 1 (a head past 128 columns runs
    the kernels' sliced variant)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"{name} needs q, k and v on one CUDA device, got {q.device}, "
            f"{k.device} and {v.device} (on the CPU use fused_attention)"
        )
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError(f"{name} takes float32 only, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"shapes must be q [B,H,Lq,D] and k, v [B,H,Lk,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if q.shape[3] < 1:
        raise ValueError(f"{name} needs a head dim of at least 1, got {q.shape[3]}")
    if k.shape[2] < 1:
        raise ValueError(f"{name} needs at least one key")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")


def _launch(lib: ctypes.CDLL, fn: str, q, k, v, causal: bool) -> torch.Tensor:
    B, H, Lq, D = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B * H, Lq, k.shape[2], D, int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.pio_cuda_error_string(rc).decode()} ({rc})")
    return out


def fused_attention_block(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Kernel B2 on CUDA tensors (``csrc/attention_block.cu``)."""
    _check("fused_attention_block", q, k, v)
    out = _launch(_block_library(), "pio_attention_block", q, k, v, causal)
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Kernel B3 on CUDA tensors (``csrc/flash_attention.cu``)."""
    _check("flash_attention", q, k, v)
    out = _launch(_flash_library(), "pio_flash_attention", q, k, v, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def route(Lq: int, Lk: int) -> str:
    """"block" (B2) when the f32 score tile is under 4 MiB (the JAX
    threshold, strict less-than included), else "flash" (B3)."""
    return "block" if Lq * Lk * 4 < BLOCK_TILE_BYTES else "flash"


def _fused_attention_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> torch.Tensor:
    which = route(q.shape[2], k.shape[2])
    if q.device.type == "cuda":
        if which == "block":
            return fused_attention_block(q, k, v, causal)
        return flash_attention(q, k, v, causal)
    if q.device.type != "cpu":
        raise ValueError(f"fused_attention runs on cuda or cpu, got {q.device}")
    if which == "block":
        return _fused_attention_plain(q, k, v, causal)
    return _flash_attention_plain(q, k, v, causal)


# batch·heads per slice of the backward: its f32 [Lq, Lk] tensors stay near
# this many bytes each
GRAD_SLICE_BYTES = 256 * 1024 * 1024


def attention_reference_grad(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    causal: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the gradient of ``attention_reference`` at q, k, v for
    the output gradient ``dout``, in f32 explicit matrix products, one slice
    of batch·heads at a time (the [Lq, Lk] tensors of all of them at once
    would take gigabytes at the two-tower training shape):
    P = softmax(S) with S = q·kᵀ/√D (masked), dV = Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ∘ (dP − rowsum(P ∘ dP)), dQ = dS·K/√D, dK = dSᵀ·Q/√D.
    rowsum(P ∘ dP) is rowsum(dO ∘ O) of the reference's own O."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    flat = [t.reshape(B * H, t.shape[2], D).float() for t in (q, k, v, dout)]
    grads = [torch.empty_like(t) for t in flat[:3]]
    keep = _causal_keep(0, Lq, 0, Lk, q.device) if causal else None
    step = max(1, GRAD_SLICE_BYTES // (Lq * Lk * 4))
    for a in range(0, B * H, step):
        qs, ks, vs, dos = (t[a : a + step] for t in flat)
        s = torch.matmul(qs, ks.transpose(1, 2)) * scale
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1))
        del s
        grads[2][a : a + step] = torch.matmul(p.transpose(1, 2), dos)
        dp = torch.matmul(dos, vs.transpose(1, 2))
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        del p, dp
        grads[0][a : a + step] = torch.matmul(ds, ks) * scale
        grads[1][a : a + step] = torch.matmul(ds.transpose(1, 2), qs) * scale
    return tuple(  # type: ignore[return-value]
        g.reshape(t.shape).to(t.dtype) for g, t in zip(grads, (q, k, v))
    )


class FusedAttention(torch.autograd.Function):
    """Attention that trains: the forward is ``fused_attention``'s (kernel
    B2 or B3 by ``route`` on a CUDA tensor, the plain version on a CPU
    tensor), the backward the gradient of the f32 ``attention_reference``
    at the saved q, k and v (``attention_reference_grad``). The JAX package
    trains the same model through the same gradient: a Pallas call has no
    reverse rule there, so its models train through ``attention_reference``
    off the TPU. A hand-written backward kernel is later work."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _fused_attention_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_reference_grad(q, k, v, dout, ctx.causal)
        return dq, dk, dv, None


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Single-device attention: kernel B2 or B3 on a CUDA tensor, the plain
    version of the same kernel on a CPU tensor. Through ``FusedAttention``
    when autograd records and an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FusedAttention.apply(q, k, v, causal)
    return _fused_attention_forward(q, k, v, causal)


# ---------------------------------------------------------------------------
# Sequence parallelism over a mesh axis
# ---------------------------------------------------------------------------


def ring_attention(
    q: torch.Tensor,  # [B, H, L/P, D]: this rank's shard of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """Attention of this rank's query shard over the whole sequence, whose
    shards lie in rank order on ``axis``. Each of the P steps attends the
    K/V shard held (in f32, online softmax) and passes it to the next rank;
    the causal mask uses global positions. Returns this rank's [B, H, L/P,
    D] output in q's dtype."""
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    B, H, Lq, D = q.shape
    q32 = q.float()
    k_cur, v_cur = k.float(), v.float()
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    row_max = torch.full((B, H, Lq), float("-inf"), dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    pos = torch.arange(Lq, device=q.device)
    for i in range(n):
        src = (me - i) % n  # the rank whose K/V shard is held now
        mask = (pos[:, None] + me * Lq) >= (pos[None, :] + src * Lq) if causal else None
        acc, row_max, row_sum = _online_block(q32, k_cur, v_cur, acc, row_max, row_sum, mask)
        if i + 1 < n:
            k_cur = ppermute_grad(k_cur, mesh, axis, perm)
            v_cur = ppermute_grad(v_cur, mesh, axis, perm)
    safe_sum = torch.where(row_sum == 0.0, 1.0, row_sum)
    return (acc / safe_sum[..., None]).to(q.dtype)


def ring_attention_sharded(
    q: torch.Tensor,  # [B, H, L, D]: the whole sequence, on every rank
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """Ring attention of global arrays: every rank passes the whole
    sequence, attends its own shard and gets the whole output back (the
    form of JAX's jit-wrapped ``ring_attention_sharded``). Requires L %
    P == 0."""
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    L = q.shape[2]
    if L % n:
        raise ValueError(f"sequence length {L} not divisible by {axis}={n}")
    part = slice(me * (L // n), (me + 1) * (L // n))
    out = ring_attention(q[:, :, part], k[:, :, part], v[:, :, part], mesh, axis, causal)
    return all_gather(out, mesh, axis, dim=2)


def ulysses_attention(
    q: torch.Tensor,  # [B, H, L/P, D]: this rank's shard of the sequence
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    axis: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): one all-to-all
    gives each rank H/P heads over the whole sequence, ``fused_attention``
    attends them (kernel B2 or B3 on a card, through ``FusedAttention`` for
    the gradient), and a second all-to-all restores this rank's sequence
    shard of every head. Requires H % P == 0."""
    n = mesh.axis_size(axis)
    H = q.shape[1]
    if H % n:
        raise ValueError(f"head count {H} not divisible by {axis}={n}")

    def to_heads(x):  # [B, H, L/P, D] -> [B, H/P, L, D]
        return all_to_all_grad(x, mesh, axis, 1, 2).contiguous()

    out = fused_attention(to_heads(q), to_heads(k), to_heads(v), causal=causal)
    return all_to_all_grad(out, mesh, axis, 2, 1)
