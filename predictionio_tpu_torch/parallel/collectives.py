"""Collectives along one axis of a :class:`~.mesh.Mesh`, with gradients.

``all_gather``, ``all_to_all`` and ``ppermute`` follow the JAX ``lax``
primitives' tiled semantics, and their autograd forms (the
``*_grad`` functions) backpropagate as JAX transposes them: an all-gather
by a reduce-scatter of the gradient (every rank's use of the gathered
tensor is summed into the owner's shard), an all-to-all by the inverse
all-to-all, a permutation by the inverse permutation. Outside a joined job
(no process group) each is the identity.

Under gloo every collective stages CUDA tensors through host memory and
copies the result back: one rule, chosen from the backend, for every call
(two ranks sharing one card run gloo).

Every collective issued bumps one process-wide counter of its kind, under
the names the JAX inspector counts in compiled HLO (``all_gather``,
``all_reduce``, ``reduce_scatter``, ``collective_permute`` for
:func:`ppermute`, ``all_to_all``); :func:`collective_counts` reads them
and ``obs.xray.count_collectives`` takes their difference around a step.
The identity outside a joined job issues nothing and counts nothing.
"""

from __future__ import annotations

import threading

import torch

from predictionio_tpu_torch.parallel.mesh import Mesh

COLLECTIVE_KINDS = ("all_gather", "all_reduce", "reduce_scatter", "collective_permute", "all_to_all")
_COUNTS = dict.fromkeys(COLLECTIVE_KINDS, 0)
_COUNTS_LOCK = threading.Lock()


def _count(kind: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[kind] += 1


def collective_counts() -> dict[str, int]:
    """The collectives this process has issued so far, by kind."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def _dist():
    import torch.distributed as dist

    return dist


def _host_staged() -> bool:
    return _dist().get_backend() == "gloo"


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    # pio-lint: disable=train-unaccounted-sync -- gloo's transport: a host-staged collective moves through host memory by design
    return x.cpu() if x.is_cuda and _host_staged() else x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` on ``axis``, concatenated along ``dim`` in axis
    order (``lax.all_gather(..., tiled=True)``). Shapes must agree."""
    group = mesh.group(axis)
    if group is None:
        return x
    send = _wire(x)
    parts = [torch.empty_like(send) for _ in range(mesh.axis_size(axis))]
    _count("all_gather")
    _dist().all_gather(parts, send, group=group)
    return torch.cat(parts, dim).to(x.device)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x``, split along ``dim`` into
    one equal chunk per rank: this rank's chunk."""
    group = mesh.group(axis)
    if group is None:
        return x
    parts = [_wire(c) for c in x.chunk(mesh.axis_size(axis), dim)]
    out = torch.empty_like(parts[0])
    _count("reduce_scatter")
    _dist().reduce_scatter(out, parts, group=group)
    return out.to(x.device)


def _exchange(mesh: Mesh, axis: str, sends: list[tuple[int, torch.Tensor]],
              recvs: list[tuple[int, torch.Tensor]]) -> None:
    """Point-to-point: each (axis index, tensor) of ``sends`` goes to that
    rank and each of ``recvs`` is filled from it, all in one batch."""
    dist = _dist()
    group, ranks = mesh.group(axis), mesh.axis_ranks(axis)
    ops = [dist.P2POp(dist.isend, t, ranks[j], group) for j, t in sends]
    ops += [dist.P2POp(dist.irecv, t, ranks[j], group) for j, t in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``: chunk
    j of ``x`` along ``split_dim`` goes to rank j of the axis, and the
    chunks received are concatenated along ``concat_dim`` in axis order.
    Point-to-point sends (gloo builds of torch without ``alltoall`` run
    it too)."""
    if mesh.group(axis) is None:
        return x
    n, me = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} not divisible by {axis}={n}")
    parts = [_wire(c) for c in x.chunk(n, split_dim)]
    outs = [parts[j] if j == me else torch.empty_like(parts[j]) for j in range(n)]
    others = [j for j in range(n) if j != me]
    _count("all_to_all")
    _exchange(mesh, axis, [(j, parts[j]) for j in others], [(j, outs[j]) for j in others])
    return torch.cat(outs, concat_dim).to(x.device)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm: list[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: for each (src, dst) in ``perm`` (axis indices),
    rank src's ``x`` becomes rank dst's result; a rank no pair sends to
    gets zeros."""
    if mesh.group(axis) is None:
        return x
    me = mesh.axis_index(axis)
    send = _wire(x)
    out = torch.zeros_like(send)
    _count("collective_permute")
    _exchange(mesh, axis, [(d, send) for s, d in perm if s == me], [(s, out) for s, d in perm if d == me])
    return out.to(x.device)


def all_reduce_sum(tensors: list[torch.Tensor], group=None) -> None:
    """Sum each tensor over ``group`` (the whole job by default) in place,
    as one flat buffer: one collective for a model's gradients."""
    if not tensors:
        return
    flat = _wire(torch.cat([t.reshape(-1) for t in tensors]))
    _count("all_reduce")
    _dist().all_reduce(flat, group=group)
    flat = flat.to(tensors[0].device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``x`` (``lax.psum``), as a new
    tensor."""
    group = mesh.group(axis)
    if group is None:
        return x
    out = x.clone()
    all_reduce_sum([out], group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, split_dim, concat_dim = ctx.args
        return all_to_all(grad.contiguous(), mesh, axis, concat_dim, split_dim), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        return ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, inverse = ctx.args
        return ppermute(grad.contiguous(), mesh, axis, inverse), None, None, None


def all_reduce_grad(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """:func:`all_reduce` that autograd records: every rank's output is the
    sum, so each rank's input gets the cotangents summed over ``axis``
    (JAX's transpose of ``psum`` on a value every rank then uses)."""
    return _AllReduce.apply(x, mesh, axis)


def all_gather_grad(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` that autograd records (backward: reduce-scatter)."""
    return _AllGather.apply(x, mesh, axis, dim)


def all_to_all_grad(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """:func:`all_to_all` that autograd records (backward: the inverse)."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def ppermute_grad(x: torch.Tensor, mesh: Mesh, axis: str, perm: list[tuple[int, int]]) -> torch.Tensor:
    """:func:`ppermute` that autograd records (backward: the inverse
    permutation, as JAX transposes ``lax.ppermute``)."""
    return _PPermute.apply(x, mesh, axis, perm)
