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

One device. The JAX package shards the batch over a mesh's ``data`` axis
and the embedding tables over ``model``; here ``context_parallel`` runs as
the JAX package runs it on a mesh whose ``model`` axis is 1 (plain
single-device attention). Initialisation draws from a ``torch.Generator``
seeded by ``config.seed`` with flax's distributions; it does not give
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

from predictionio_tpu_torch.ops.attention import fused_attention
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
    # the JAX package's sequence parallelism over a mesh's model axis; one
    # device here, so the encoder attends on that device (A14 ports the
    # sharded attention)
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
    indices, chronological, -1 padding at the end -> [B, embed_dim]."""

    def __init__(self, vocab: int, embed_dim: int, n_heads: int, max_len: int):
        super().__init__()
        self.vocab = vocab
        self.n_heads = n_heads
        # index ``vocab`` is a learned mask token: end pads and train-time
        # target masking map to it instead of item 0
        self.hist_embed = nn.Embedding(vocab + 1, embed_dim)
        self.pos = nn.Parameter(torch.empty(max_len, embed_dim))
        self.ln = nn.LayerNorm(embed_dim, eps=1e-6)  # flax's epsilon
        self.q = nn.Linear(embed_dim, embed_dim)
        self.k = nn.Linear(embed_dim, embed_dim)
        self.v = nn.Linear(embed_dim, embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)

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

        out = fused_attention(heads(self.q), heads(self.k), heads(self.v), causal=True)
        out = out.transpose(1, 2).reshape(B, T, E)
        out = x + self.proj(out)  # residual
        # masked mean-pool over valid (non-pad) positions
        w = valid.to(out.dtype)[..., None]
        denom = w.sum(dim=1).clamp(min=1.0)
        return (out * w).sum(dim=1) / denom


class Tower(nn.Module):
    def __init__(self, vocab: int, embed_dim: int, hidden: tuple[int, ...], out_dim: int):
        super().__init__()
        self.embed = nn.Embedding(vocab, embed_dim)
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
    def __init__(self, config: TwoTowerConfig):
        super().__init__()
        c = config
        self.config = c
        self.user_tower = Tower(c.n_users, c.embed_dim, c.hidden, c.out_dim)
        self.item_tower = Tower(c.n_items, c.embed_dim, c.hidden, c.out_dim)
        self.hist_encoder = (
            SeqEncoder(c.n_items, c.embed_dim, c.n_heads, c.history_len)
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
    order, so a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, nn.Embedding):
            w = torch.empty(module.weight.shape).normal_(0.0, 1.0 / math.sqrt(module.weight.shape[1]), generator=gen)
            module.weight.copy_(w)
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


def make_train_step(
    model: TwoTower,
    optimizer: torch.optim.Optimizer,
    temperature: float,
    with_history: bool = False,
    item_log_q: torch.Tensor | None = None,
):
    """One step on a batch of (user, item) index tensors: loss, gradient,
    Adam update; returns the loss tensor. With history the [n_users, T]
    history matrix is a third argument, gathered per batch on its device,
    and the example's own target is masked out of its history (-1, the
    mask token) so the encoder cannot copy it into the logits."""

    def train_step(user_ids, item_ids, hist_matrix=None):
        h = None
        if with_history:
            h = hist_matrix[user_ids]
            h = torch.where(h == item_ids[:, None], -1, h)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, user_ids, item_ids, temperature, h, item_log_q)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


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


def build_model(config: TwoTowerConfig, device: str | torch.device = "cuda") -> TwoTower:
    """A TwoTower with flax-distributed weights from ``config.seed``."""
    model = TwoTower(config)
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
) -> TrainResult:
    """The JAX package's loop on one device: batch min(batch_size, max(n, 8)),
    one permutation per epoch from ``np.random.default_rng(seed)`` (a
    resumed run replays the permutations it skips), n // batch steps per
    epoch with a short last batch padded by wrapping, the loss of each
    epoch's last step, epoch checkpoints, and the item-embedding table for
    serving at the end. ``history`` ([n_users, history_len], -1 padded)
    enables the encoder when ``config.history_len > 0``."""
    dev = resolve_device(device)
    model = build_model(config, dev)
    optimizer = make_optimizer(model, config.learning_rate)
    n = len(user_idx)
    B = min(config.batch_size, max(n, 8))
    with_history = config.history_len > 0 and history is not None
    log_q = None
    if config.logq_correction and n:
        log_q = torch.from_numpy(item_log_q(item_idx, config.n_items)).to(dev)
    step = make_train_step(model, optimizer, config.temperature, with_history, log_q)
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
            model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state["params"].items()})
            optimizer.load_state_dict(_opt_state_from_host(state["opt_state"]))
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
            save_train_checkpoint(
                config.checkpoint_dir, model, optimizer, epoch + 1, losses,
                signature=run_signature,
            )
    if config.checkpoint_dir:
        # a finished run's checkpoint must not turn the next train into a no-op
        clear_train_checkpoint(config.checkpoint_dir)

    model.eval()
    item_emb = embed_all_items(model, config.n_items)
    params = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return TrainResult(params, losses, item_emb)


@torch.no_grad()
def embed_all_items(model: TwoTower, n_items: int, chunk: int = 65536) -> np.ndarray:
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
) -> str:
    """Atomic epoch checkpoint: parameters, Adam moments and progress, all
    host numpy, in the model store's framing (``workflow/model_io.py``)."""
    from predictionio_tpu_torch.controller.algorithm import model_to_host
    from predictionio_tpu_torch.workflow.model_io import serialize_models

    blob = serialize_models([{
        "params": model_to_host(model.state_dict()),
        "opt_state": model_to_host(optimizer.state_dict()),
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
