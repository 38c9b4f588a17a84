"""Two-tower retrieval network and its training loop on PyTorch (port of
``predictionio_tpu/models/twotower/model.py``).

  - Towers: id embedding -> MLP -> L2-normalised output embedding. The
    Dense layers run in bf16 as flax's ``dtype=jnp.bfloat16`` does: inputs,
    weights and biases cast to bf16, the product and the bias add rounded
    to bf16; the output widens to f32 for the norm and the loss.
  - Loss: in-batch sampled softmax with temperature, log-Q correction and
    duplicate-collision masking, symmetric (user->item and item->user).
  - Optional sequence encoder (``history_len > 0``): a causal self-attention
    encoding of the user's recent item history is added to the user's id
    embedding. Attention runs through ``ops.attention.fused_attention``:
    kernel B2 (B3 past a 1,024-long history) forward on the card, in
    training and serving, and the f32 reference's gradient backward
    (``ops.attention.FusedAttention``). Histories are chronological with -1
    padding at the END, so causal masking keeps pad keys invisible to real
    positions and pooling masks the rest.

Across ranks (``train_two_tower(..., mesh=...)``, a ``parallel.mesh`` of
``data`` x ``model``): each ``data`` rank embeds its slice of the global
batch, the tower outputs are all-gathered over ``data`` (with gradients)
so that every rank computes the one in-batch softmax over the global
batch, as the JAX loss does; with ``context_parallel`` the history
encoder's attention shards the history over ``model`` (ring or ulysses,
``ops.attention``) and gathers its output back. Every rank computes the
same loss, so each backpropagates a 1/ranks share of it. The user and item
towers' id tables are sharded over ``model`` along the vocabulary, as the
JAX package's ``param_sharding_tree`` places them (a 2-D leaf under a key
``embed``; ``hist_embed`` and ``pos`` stay whole): the rank at ``model``
index r holds rows [r·V/M, (r+1)·V/M) (:class:`ShardedEmbedding`), looks
up the ids that fall there, writes zeros elsewhere and sums over
``model``. A shard's gradient is summed over ``data``, every whole
parameter's over every rank, so every rank takes the one-rank step; Adam
keeps each shard's moments on its rank. The parameters a train returns,
and its checkpoints, hold the whole tables (gathered over ``model``), so a
model trained sharded loads mesh-less for serving. Initialisation draws
from a ``torch.Generator`` seeded by
``config.seed`` with flax's distributions; it does not give
``jax.random``'s numbers, so parity tests carry a JAX init over with
``convert.twotower_params_from_numpy``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import math
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from predictionio_tpu_torch.ops.attention import fused_attention, ring_attention, ulysses_attention
from predictionio_tpu_torch.parallel.collectives import all_gather, all_gather_grad, all_reduce_grad, all_reduce_sum
from predictionio_tpu_torch.parallel.mesh import Mesh, ShardSpec
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    n_users: int
    n_items: int
    embed_dim: int = 64
    hidden: tuple[int, ...] = (128,)
    out_dim: int = 32
    temperature: float = 0.05
    learning_rate: float = 1e-3
    batch_size: int = 4096
    epochs: int = 5
    seed: int = 0
    # epoch checkpoints: directory (None disables), cadence in epochs, and
    # whether to continue from a checkpoint of the same run
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = True
    # sequence encoder: 0 disables; > 0 = length of the per-user item
    # history consumed by causal self-attention in the user tower
    history_len: int = 0
    n_heads: int = 2
    # sequence parallelism of the history encoder over the mesh's model
    # axis (ring or ulysses); without a mesh of model > 1 it attends on one
    # device
    context_parallel: bool = False
    sp_impl: str = "ring"  # "ring" | "ulysses"
    # sampled-softmax log-Q debiasing of in-batch negatives (see loss_fn)
    logq_correction: bool = True

    def __post_init__(self):
        if self.history_len > 0 and self.embed_dim % self.n_heads:
            raise ValueError(
                f"embed_dim ({self.embed_dim}) must be divisible by n_heads "
                f"({self.n_heads}) for the history encoder"
            )
        if self.sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be ring|ulysses, got {self.sp_impl!r}")
        if self.context_parallel and self.history_len <= 0:
            raise ValueError(
                "context_parallel requires a history encoder (history_len > 0)"
            )


def _bf16_dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``Dense(dtype=bfloat16)``: x, kernel and bias in bf16, the
    product rounded to bf16, then the bias added in bf16."""
    w = layer.weight.to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16), w.t()) + layer.bias.to(torch.bfloat16)


class SeqEncoder(nn.Module):
    """Causal self-attention over a user's recent item history: [B, T] item
    indices, chronological, -1 padding at the end -> [B, embed_dim].

    With a ``mesh`` whose ``sp_axis`` holds more than one rank, attention
    shards T over that axis (``sp_impl`` ring or ulysses) and the output is
    all-gathered back; the rest runs whole on every rank."""

    def __init__(self, vocab: int, embed_dim: int, n_heads: int, max_len: int,
                 mesh: Mesh | None = None, sp_axis: str = "model", sp_impl: str = "ring"):
        super().__init__()
        self.vocab = vocab
        self.n_heads = n_heads
        self.mesh, self.sp_axis, self.sp_impl = mesh, sp_axis, sp_impl
        # index ``vocab`` is a learned mask token: end pads and train-time
        # target masking map to it instead of item 0
        self.hist_embed = nn.Embedding(vocab + 1, embed_dim)
        self.pos = nn.Parameter(torch.empty(max_len, embed_dim))
        self.ln = nn.LayerNorm(embed_dim, eps=1e-6)  # flax's epsilon
        self.q = nn.Linear(embed_dim, embed_dim)
        self.k = nn.Linear(embed_dim, embed_dim)
        self.v = nn.Linear(embed_dim, embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)

    def _attend(self, q, k, v):  # [B, H, T, Dh] each
        sp = self.mesh.axis_size(self.sp_axis) if self.mesh is not None else 1
        if sp <= 1:
            return fused_attention(q, k, v, causal=True)
        T, H = q.shape[2], q.shape[1]
        # fail loud: a silent fallback would turn the configured sequence
        # parallelism into a no-op nobody notices
        if T % sp:
            raise ValueError(f"history_len {T} not divisible by mesh axis {self.sp_axis}={sp}")
        if self.sp_impl == "ulysses" and H % sp:
            raise ValueError(
                f"n_heads {H} not divisible by mesh axis {self.sp_axis}={sp} (ulysses splits heads)"
            )
        me = self.mesh.axis_index(self.sp_axis)
        part = slice(me * (T // sp), (me + 1) * (T // sp))
        q, k, v = (x[:, :, part].contiguous() for x in (q, k, v))
        attend = ulysses_attention if self.sp_impl == "ulysses" else ring_attention
        out = attend(q, k, v, self.mesh, axis=self.sp_axis, causal=True)
        return all_gather_grad(out, self.mesh, self.sp_axis, dim=2)

    def forward(self, hist_ids: torch.Tensor) -> torch.Tensor:
        valid = hist_ids >= 0
        ids = torch.where(valid, hist_ids.clamp(min=0), self.vocab)
        x = self.hist_embed(ids) + self.pos[None, : ids.shape[1]]
        x = self.ln(x)
        B, T, E = x.shape
        H = self.n_heads

        def heads(layer: nn.Linear) -> torch.Tensor:
            # the kernels take contiguous [B, H, T, Dh] only
            return layer(x).reshape(B, T, H, E // H).transpose(1, 2).contiguous()

        out = self._attend(heads(self.q), heads(self.k), heads(self.v))
        out = out.transpose(1, 2).reshape(B, T, E)
        out = x + self.proj(out)  # residual
        # masked mean-pool over valid (non-pad) positions
        w = valid.to(out.dtype)[..., None]
        denom = w.sum(dim=1).clamp(min=1.0)
        return (out * w).sum(dim=1) / denom


class ShardedEmbedding(nn.Module):
    """An id table of ``vocab`` rows sharded over ``mesh``'s ``axis`` along
    the vocabulary (``P(axis, None)``): this rank's ``weight`` is rows
    [start, start + vocab/M) of the whole table. A lookup gathers the ids
    that fall in those rows, writes zeros for the rest and sums over the
    axis (with gradients), so every rank gets the whole table's rows. A
    vocabulary the axis does not divide is refused, as ``jax.device_put``
    refuses that placement."""

    def __init__(self, vocab: int, embed_dim: int, mesh: Mesh, axis: str = "model", name: str = "embed"):
        super().__init__()
        n = mesh.axis_size(axis)
        if vocab % n:
            raise ValueError(
                f"{name}: a vocabulary of {vocab} rows cannot be sharded over mesh axis {axis}={n}: "
                f"the global size of its dimension 0 should be divisible by {n}"
            )
        rows = vocab // n
        self.mesh, self.axis = mesh, axis
        self.start = mesh.axis_index(axis) * rows
        self.weight = nn.Parameter(torch.empty(rows, embed_dim))
        # the placement, read by obs.xray.describe_shardings
        self.weight.shard_spec = ShardSpec(axis=axis, dim=0, global_shape=(vocab, embed_dim), start=self.start)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.start
        mine = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(torch.where(mine, local, 0), self.weight)
        return all_reduce_grad(torch.where(mine[..., None], rows, 0.0), self.mesh, self.axis)


def sharded_tables(model: nn.Module) -> dict[str, ShardedEmbedding]:
    """Parameter name -> its ShardedEmbedding, for every sharded table."""
    return {f"{name}.weight": m for name, m in model.named_modules() if isinstance(m, ShardedEmbedding)}


class Tower(nn.Module):
    def __init__(self, vocab: int, embed_dim: int, hidden: tuple[int, ...], out_dim: int,
                 mesh: Mesh | None = None, name: str = "embed"):
        super().__init__()
        sharded = mesh is not None and mesh.axis_size("model") > 1
        self.embed = ShardedEmbedding(vocab, embed_dim, mesh, name=name) if sharded else nn.Embedding(vocab, embed_dim)
        widths = [embed_dim, *hidden]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.out = nn.Linear(widths[-1], out_dim)

    def forward(self, ids: torch.Tensor, extra: torch.Tensor | None = None) -> torch.Tensor:
        x = self.embed(ids)
        if extra is not None:
            x = x + extra  # history encoding fused into the id embedding
        x = x.to(torch.bfloat16)
        for layer in self.dense:
            x = torch.relu(_bf16_dense(x, layer))
        x = _bf16_dense(x, self.out).to(torch.float32)
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class TwoTower(nn.Module):
    """``mesh``: the ranks the model spreads over. With ``model`` > 1 the
    towers' id tables are sharded over it; with ``config.context_parallel``
    the history encoder's sequence parallelism rides it too. The whole
    parameters (:func:`gather_state_dict`) load into a mesh-less model for
    serving."""

    def __init__(self, config: TwoTowerConfig, mesh: Mesh | None = None):
        super().__init__()
        c = config
        self.config = c
        self.mesh = mesh
        self.user_tower = Tower(c.n_users, c.embed_dim, c.hidden, c.out_dim, mesh, "user_tower.embed")
        self.item_tower = Tower(c.n_items, c.embed_dim, c.hidden, c.out_dim, mesh, "item_tower.embed")
        self.hist_encoder = (
            SeqEncoder(c.n_items, c.embed_dim, c.n_heads, c.history_len,
                       mesh=mesh if c.context_parallel else None, sp_impl=c.sp_impl)
            if c.history_len > 0
            else None
        )

    def _user_extra(self, user_hist):
        if self.hist_encoder is not None and user_hist is not None:
            return self.hist_encoder(user_hist)
        return None

    def forward(self, user_ids, item_ids, user_hist=None):
        return self.embed_users(user_ids, user_hist), self.item_tower(item_ids)

    def embed_users(self, user_ids, user_hist=None):
        return self.user_tower(user_ids, self._user_extra(user_hist))

    def embed_items(self, item_ids):
        return self.item_tower(item_ids)


@torch.no_grad()
def init_params(model: TwoTower, seed: int) -> None:
    """flax's initialisers from a generator seeded by ``seed``: Embed
    normal(0, 1/√features) (``variance_scaling(1, fan_in, normal)``), Dense
    kernels lecun-normal (truncated at ±2σ) with zero bias, ``pos``
    normal(0.02), LayerNorm scale 1 and bias 0. Drawn on the CPU in module
    order, so a seed gives the same weights on every device; a sharded
    table takes its rows of the whole table's draw."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, nn.Embedding):
            w = torch.empty(module.weight.shape).normal_(0.0, 1.0 / math.sqrt(module.weight.shape[1]), generator=gen)
            module.weight.copy_(w)
        elif isinstance(module, ShardedEmbedding):  # the whole table's draw, this rank's rows
            shape = module.weight.shard_spec.global_shape
            w = torch.empty(shape).normal_(0.0, 1.0 / math.sqrt(shape[1]), generator=gen)
            module.weight.copy_(w[module.start : module.start + module.weight.shape[0]])
        elif isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features) / 0.87962566103423978
            w = torch.empty(module.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            module.weight.copy_(w)
            module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, SeqEncoder):
            module.pos.copy_(torch.empty(module.pos.shape).normal_(0.0, 0.02, generator=gen))


def in_batch_loss(
    u: torch.Tensor,
    v: torch.Tensor,
    item_ids: torch.Tensor,
    temperature: float,
    item_log_q: torch.Tensor | None = None,
) -> torch.Tensor:
    """The loss of the JAX ``loss_fn`` on tower outputs u, v [B, out_dim]:
    logits u·vᵀ/temperature, minus log Q(item_j) in column j when given
    (sampled-softmax debiasing; a row-constant shift of the transposed
    direction), off-diagonal duplicates of one item masked to -1e9 (false
    negatives), and the mean of both directions' softmax cross-entropy."""
    logits = (u @ v.T) / temperature
    B = u.shape[0]
    labels = torch.arange(B, device=u.device)
    if item_log_q is not None:
        logits = logits - item_log_q[item_ids][None, :]
    same_item = item_ids[None, :] == item_ids[:, None]
    dup = same_item & ~torch.eye(B, dtype=torch.bool, device=u.device)
    logits = logits.masked_fill(dup, -1e9)
    l1 = F.cross_entropy(logits, labels)
    l2 = F.cross_entropy(logits.T, labels)
    return 0.5 * (l1 + l2)


def loss_fn(
    model: TwoTower,
    user_ids: torch.Tensor,
    item_ids: torch.Tensor,
    temperature: float,
    user_hist: torch.Tensor | None = None,
    item_log_q: torch.Tensor | None = None,
) -> torch.Tensor:
    u, v = model(user_ids, item_ids, user_hist)
    return in_batch_loss(u, v, item_ids, temperature, item_log_q)


def make_optimizer(model: TwoTower, learning_rate: float) -> torch.optim.Adam:
    """optax.adam's defaults: β 0.9 / 0.999, eps 1e-8 added outside the
    square root."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def global_batch_loss(
    model: TwoTower,
    user_ids: torch.Tensor,
    item_ids: torch.Tensor,
    temperature: float,
    hist_matrix: torch.Tensor | None = None,
    item_log_q: torch.Tensor | None = None,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """The train step's loss on a global batch of (user, item) index
    tensors. With a [n_users, T] ``hist_matrix`` each example's history is
    gathered on its device and its own target masked out (-1, the mask
    token) so the encoder cannot copy it into the logits. With a ``mesh``,
    every rank passes the same global batch and embeds its ``data`` slice;
    the tower outputs are all-gathered over ``data`` (with gradients) into
    the one in-batch softmax of the global batch."""
    batch_items = item_ids
    if mesh is not None:
        dp, di = mesh.axis_size("data"), mesh.axis_index("data")
        part = slice(di * (len(user_ids) // dp), (di + 1) * (len(user_ids) // dp))
        user_ids, item_ids = user_ids[part], item_ids[part]
    h = None
    if hist_matrix is not None:
        h = hist_matrix[user_ids]
        h = torch.where(h == item_ids[:, None], -1, h)
    u, v = model(user_ids, item_ids, h)
    if mesh is not None:
        u, v = all_gather_grad(u, mesh, "data"), all_gather_grad(v, mesh, "data")
    return in_batch_loss(u, v, batch_items, temperature, item_log_q)


def make_train_step(
    model: TwoTower,
    optimizer: torch.optim.Optimizer,
    temperature: float,
    with_history: bool = False,
    item_log_q: torch.Tensor | None = None,
    mesh: Mesh | None = None,
):
    """One step on a global batch of (user, item) index tensors: the loss
    of :func:`global_batch_loss`, its gradient, the Adam update; returns
    the loss tensor. With history the history matrix is a third argument.
    With a ``mesh`` each rank backpropagates loss / ranks; a sharded
    table's gradient is summed over ``data`` (the ranks holding the same
    rows; nothing to sum on a mesh without that axis) and every other
    gradient over every rank before Adam, so every rank takes the
    one-rank step. The step carries ``model``,
    ``optimizer`` and ``mesh`` as attributes (``obs.xray.inspect_train_step``
    reads them)."""
    world = mesh.size if mesh is not None else 1
    shard_names = set(sharded_tables(model))
    named = list(model.named_parameters())
    whole = [p for n, p in named if n not in shard_names]
    shards = [p for n, p in named if n in shard_names]

    def train_step(user_ids, item_ids, hist_matrix=None):
        optimizer.zero_grad(set_to_none=True)
        loss = global_batch_loss(model, user_ids, item_ids, temperature,
                                 hist_matrix if with_history else None, item_log_q, mesh)
        (loss / world).backward()
        if world > 1:
            for _, p in named:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            all_reduce_sum([p.grad for p in whole])
            # a mesh without a data axis has one rank on it: the shards'
            # gradients are already whole (a None group would sum the job)
            if shards and mesh.group("data") is not None:
                all_reduce_sum([p.grad for p in shards], group=mesh.group("data"))
        optimizer.step()
        return loss.detach()

    train_step.model, train_step.optimizer, train_step.mesh = model, optimizer, mesh
    return train_step


def gather_state_dict(model: TwoTower) -> dict[str, torch.Tensor]:
    """The model's ``state_dict`` with every sharded table whole (gathered
    over its axis: every rank of that axis must call this)."""
    tables = sharded_tables(model)
    return {k: all_gather(v.detach(), tables[k].mesh, tables[k].axis) if k in tables else v
            for k, v in model.state_dict().items()}


def _rows(model: TwoTower, name: str, t):
    """This rank's rows of a whole tensor for parameter ``name`` (the
    tensor itself when the parameter is not sharded)."""
    m = sharded_tables(model).get(name)
    if m is None:
        return t
    whole = m.weight.shard_spec.global_shape
    if tuple(t.shape) != whole:
        raise ValueError(f"{name}: a whole table of shape {tuple(t.shape)}, expected {whole}")
    return t[m.start : m.start + m.weight.shape[0]]


def load_whole_state_dict(model: TwoTower, state: dict[str, Any]) -> None:
    """Load a whole ``state_dict`` (tensors or numpy) into the model; a
    sharded table takes its rows."""
    model.load_state_dict({k: _rows(model, k, torch.as_tensor(v)) for k, v in state.items()})


def gather_optimizer_state(model: TwoTower, optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's ``state_dict`` with a sharded table's moments whole
    (a collective, as :func:`gather_state_dict`)."""
    tables = sharded_tables(model)
    names = [n for n, _ in model.named_parameters()]
    sd = optimizer.state_dict()
    state = {}
    for idx, st in sd["state"].items():
        m = tables.get(names[idx])
        state[idx] = {k: all_gather(v, m.mesh, m.axis) if m is not None and torch.is_tensor(v) and v.dim() else v
                      for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_whole_optimizer_state(model: TwoTower, optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """Load a whole optimizer ``state_dict``; a sharded table's moments
    take their rows."""
    names = [n for n, _ in model.named_parameters()]
    state = {int(idx): {k: _rows(model, names[int(idx)], v) if torch.is_tensor(v) and v.dim() else v
                        for k, v in st.items()}
             for idx, st in sd["state"].items()}
    optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


@dataclasses.dataclass
class TrainResult:
    params: dict[str, np.ndarray]  # host-numpy state_dict
    losses: list[float]
    item_embeddings: np.ndarray  # [n_items, out_dim] precomputed for serving


def build_history_matrix(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    timestamps: np.ndarray | None,
    n_users: int,
    history_len: int,
) -> np.ndarray:
    """Per-user last-``history_len`` item indices, chronological, -1 padded
    at the END (the layout SeqEncoder requires). Without timestamps each
    user's events keep their original order (a stable sort by user)."""
    hist = np.full((n_users, history_len), -1, np.int32)
    n = len(user_idx)
    if n == 0:
        return hist
    if timestamps is not None:
        order = np.lexsort((item_idx, timestamps, user_idx))
    else:
        order = np.argsort(user_idx, kind="stable")
    u_sorted, i_sorted = user_idx[order], item_idx[order]
    # each row's position within its user's run; keep the last K of each run
    starts = np.searchsorted(u_sorted, np.arange(n_users))
    deg = np.searchsorted(u_sorted, np.arange(n_users), side="right") - starts
    pos = np.arange(n) - starts[u_sorted]
    drop = np.maximum(deg - history_len, 0)[u_sorted]  # rows trimmed from front
    keep = pos >= drop
    hist[u_sorted[keep], (pos - drop)[keep]] = i_sorted[keep]
    return hist


def build_model(config: TwoTowerConfig, device: str | torch.device = "cuda",
                mesh: Mesh | None = None) -> TwoTower:
    """A TwoTower with flax-distributed weights from ``config.seed``."""
    model = TwoTower(config, mesh)
    init_params(model, config.seed)
    return model.to(resolve_device(device))


def item_log_q(item_idx: np.ndarray, n_items: int) -> np.ndarray:
    """log of each item's share of the interactions (1e-12 floor), f32."""
    freq = np.bincount(np.asarray(item_idx, np.int64), minlength=n_items).astype(np.float64)
    q = freq / max(1.0, freq.sum())
    return np.log(np.maximum(q, 1e-12)).astype(np.float32)


def train_two_tower(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    config: TwoTowerConfig,
    history: np.ndarray | None = None,
    device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> TrainResult:
    """The JAX package's loop: batch min(batch_size, max(n, 8)) (rounded to
    a multiple of the mesh's ``data`` axis), one permutation per epoch from
    ``np.random.default_rng(seed)`` (a resumed run replays the permutations
    it skips), n // batch steps per epoch with a short last batch padded by
    wrapping, the loss of each epoch's last step, epoch checkpoints, and
    the item-embedding table for serving at the end. ``history``
    ([n_users, history_len], -1 padded) enables the encoder when
    ``config.history_len > 0``. ``mesh`` (``parallel.mesh``, axes ``data``
    and ``model``) spreads each step over its ranks, on each rank's
    device; every rank returns the same result and only rank 0 writes
    checkpoints."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model = build_model(config, dev, mesh)
    optimizer = make_optimizer(model, config.learning_rate)
    n = len(user_idx)
    B = min(config.batch_size, max(n, 8))
    writes = mesh is None or mesh.rank == 0
    if mesh is not None:
        dp = mesh.axis_size("data")
        B = max(dp, (B // dp) * dp)
    with_history = config.history_len > 0 and history is not None
    log_q = None
    if config.logq_correction and n:
        log_q = torch.from_numpy(item_log_q(item_idx, config.n_items)).to(dev)
    step = make_train_step(model, optimizer, config.temperature, with_history, log_q, mesh)
    hist_dev = torch.from_numpy(np.asarray(history, np.int64)).to(dev) if with_history else None
    users_dev = torch.from_numpy(np.asarray(user_idx, np.int64)).to(dev)
    items_dev = torch.from_numpy(np.asarray(item_idx, np.int64)).to(dev)

    losses: list[float] = []
    start_epoch = 0
    run_signature = _train_signature(config, user_idx, item_idx)
    if config.checkpoint_dir and config.resume:
        state = load_train_checkpoint(config.checkpoint_dir)
        if state is not None and state.get("signature") != run_signature:
            logger.warning(
                "ignoring checkpoint in %s: it belongs to a different config/dataset",
                config.checkpoint_dir,
            )
            state = None
        if state is not None:
            load_whole_state_dict(model, state["params"])
            load_whole_optimizer_state(model, optimizer, _opt_state_from_host(state["opt_state"]))
            start_epoch = int(state["epoch"])
            losses = list(state["losses"])

    shuffle_rng = np.random.default_rng(config.seed)
    steps_per_epoch = max(1, n // B)
    model.train()
    for epoch in range(config.epochs):
        perm = shuffle_rng.permutation(n)
        if epoch < start_epoch:
            continue
        perm_dev = torch.from_numpy(perm).to(dev)
        loss = None
        for s in range(steps_per_epoch):
            sel = perm_dev[s * B : (s + 1) * B]
            if len(sel) < B:  # pad by wrapping, as the JAX package's static shapes do
                sel = torch.cat([sel, perm_dev[: B - len(sel)]])
            loss = step(users_dev[sel], items_dev[sel], hist_dev)
        losses.append(float(loss))
        if config.checkpoint_dir and (epoch + 1) % max(1, config.checkpoint_every) == 0:
            save_train_checkpoint(  # every rank gathers; the coordinator writes
                config.checkpoint_dir, model, optimizer, epoch + 1, losses,
                signature=run_signature,
            )
    if writes and config.checkpoint_dir:
        # a finished run's checkpoint must not turn the next train into a no-op
        clear_train_checkpoint(config.checkpoint_dir)

    model.eval()
    item_emb = embed_all_items(model, config.n_items)
    params = {k: v.detach().cpu().numpy() for k, v in gather_state_dict(model).items()}
    return TrainResult(params, losses, item_emb)


@torch.no_grad()
def embed_all_items(model: TwoTower, n_items: int, chunk: int = 65536) -> np.ndarray:
    """Every item's tower output, [n_items, out_dim] on the host; on a
    sharded model every rank of its ``model`` axis must call it."""
    dev = next(model.parameters()).device
    out = [
        model.embed_items(torch.arange(a, min(a + chunk, n_items), device=dev)).cpu()
        for a in range(0, n_items, chunk)
    ]
    return torch.cat(out).numpy()


def user_embedding(
    model: TwoTower, user_ids: torch.Tensor, user_hist: torch.Tensor | None = None
) -> torch.Tensor:
    with torch.no_grad():
        return model.embed_users(user_ids, user_hist)


# ---------------------------------------------------------------------------
# Epoch checkpoints: the port's own blob (model_io framing, host numpy)
# ---------------------------------------------------------------------------

_CKPT_NAME = "twotower_torch_train_ckpt.bin"


def _train_signature(config: TwoTowerConfig, user_idx: np.ndarray, item_idx: np.ndarray) -> str:
    """Identity of one training run: the model-shaping config fields plus a
    cheap fingerprint of the interactions. A checkpoint of another run is
    never resumed (a table of another vocab size, or other data)."""
    u = np.asarray(user_idx, np.int64)
    i = np.asarray(item_idx, np.int64)
    h = hashlib.sha1()
    for a in (u[:4096], u[-4096:], i[:4096], i[-4096:]):
        h.update(np.ascontiguousarray(a).tobytes())
    key = (
        config.n_users, config.n_items, config.embed_dim, tuple(config.hidden),
        config.out_dim, config.history_len, config.n_heads, config.seed,
        config.batch_size, len(u), h.hexdigest(),
    )
    return hashlib.sha1(repr(key).encode()).hexdigest()


def _opt_state_from_host(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _opt_state_from_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_opt_state_from_host(v) for v in x)
    return x


def save_train_checkpoint(
    directory, model: TwoTower, optimizer, epoch: int, losses, signature: str = ""
) -> str | None:
    """Atomic epoch checkpoint: parameters, Adam moments and progress, all
    host numpy, in the model store's framing (``workflow/model_io.py``),
    with the sharded tables and their moments whole. Every rank of a
    model's mesh calls it (the gather is a collective); rank 0 writes and
    returns the path, the others None."""
    from predictionio_tpu_torch.controller.algorithm import model_to_host
    from predictionio_tpu_torch.workflow.model_io import serialize_models

    params = model_to_host(gather_state_dict(model))
    opt_state = model_to_host(gather_optimizer_state(model, optimizer))
    if model.mesh is not None and model.mesh.rank != 0:
        return None
    blob = serialize_models([{
        "params": params,
        "opt_state": opt_state,
        "epoch": epoch,
        "losses": list(losses),
        "signature": signature,
    }])
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _CKPT_NAME)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)
    return path


def clear_train_checkpoint(directory) -> None:
    """Remove a run's checkpoint (called when training completes)."""
    with contextlib.suppress(FileNotFoundError):
        os.unlink(os.path.join(directory, _CKPT_NAME))


def load_train_checkpoint(directory) -> dict | None:
    from predictionio_tpu_torch.workflow.model_io import deserialize_models

    path = os.path.join(directory, _CKPT_NAME)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return deserialize_models(fh.read())[0]
