"""Weights carried across from the JAX package.

The models of the JAX package's templates are host numpy and plain Python
containers. ``als_model_from_numpy``
and ``sequential_model_from_numpy`` build the port's models from them,
``twotower_params_from_numpy`` turns a flax parameter tree into the port's
``state_dict``, and ``ModelUnpickler`` loads a blob that ``pio train`` of
the JAX package wrote by mapping its class paths to the port's classes,
without importing the JAX package or flax.
"""

from __future__ import annotations

import pickle
import re
from typing import Sequence

import numpy as np

# JAX-package class path -> the port's class path
CLASS_MAP = {
    ("predictionio_tpu.models.recommendation.engine", "ALSModel"): (
        "predictionio_tpu_torch.models.recommendation.engine",
        "ALSModel",
    ),
    ("predictionio_tpu.models.sequential.engine", "SequentialModel"): (
        "predictionio_tpu_torch.models.sequential.engine",
        "SequentialModel",
    ),
    ("predictionio_tpu.e2.markov_chain", "MarkovChainModel"): (
        "predictionio_tpu_torch.e2.markov_chain",
        "MarkovChainModel",
    ),
    ("predictionio_tpu.models.twotower.engine", "TwoTowerModelState"): (
        "predictionio_tpu_torch.models.twotower.engine",
        "TwoTowerModelState",
    ),
    ("predictionio_tpu.models.twotower.model", "TwoTowerConfig"): (
        "predictionio_tpu_torch.models.twotower.model",
        "TwoTowerConfig",
    ),
    ("predictionio_tpu.models.similarproduct.engine", "SimilarModel"): (
        "predictionio_tpu_torch.models.similarproduct.engine",
        "SimilarModel",
    ),
    ("predictionio_tpu.models.similarproduct.engine", "CooccurrenceModel"): (
        "predictionio_tpu_torch.models.similarproduct.engine",
        "CooccurrenceModel",
    ),
    ("predictionio_tpu.models.ecommerce.engine", "ECommModel"): (
        "predictionio_tpu_torch.models.ecommerce.engine",
        "ECommModel",
    ),
    ("predictionio_tpu.models.recommendeduser.engine", "SimilarUserModel"): (
        "predictionio_tpu_torch.models.recommendeduser.engine",
        "SimilarUserModel",
    ),
    ("predictionio_tpu.e2.naive_bayes", "CategoricalNaiveBayesModel"): (
        "predictionio_tpu_torch.e2.naive_bayes",
        "CategoricalNaiveBayesModel",
    ),
    ("predictionio_tpu.e2.naive_bayes", "LabeledPoint"): (
        "predictionio_tpu_torch.e2.naive_bayes",
        "LabeledPoint",
    ),
    ("predictionio_tpu.ops.classify", "NaiveBayesModel"): (
        "predictionio_tpu_torch.ops.classify",
        "NaiveBayesModel",
    ),
    ("predictionio_tpu.ops.classify", "RandomForestModel"): (
        "predictionio_tpu_torch.ops.classify",
        "RandomForestModel",
    ),
    ("predictionio_tpu.ops.classify", "_Node"): ("predictionio_tpu_torch.ops.classify", "_Node"),
    # an older flax pickles a parameter tree as FrozenDict(dict): a plain dict here
    ("flax.core.frozen_dict", "FrozenDict"): ("builtins", "dict"),
}


class ModelUnpickler(pickle.Unpickler):
    """Unpickler for model blobs: classes of the JAX package resolve to
    their counterparts in the port; one with no counterpart is refused
    rather than imported."""

    def find_class(self, module: str, name: str):
        mapped = CLASS_MAP.get((module, name))
        if mapped is not None:
            module, name = mapped
        elif module == "predictionio_tpu" or module.startswith("predictionio_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name} has no counterpart in predictionio_tpu_torch"
            )
        return super().find_class(module, name)


def als_model_from_numpy(
    user_factors: np.ndarray,
    item_factors: np.ndarray,
    user_vocab: Sequence[str],
    item_vocab: Sequence[str],
):
    """The port's ALSModel from host factor tables and vocabularies."""
    from predictionio_tpu_torch.models.recommendation.engine import ALSModel

    uf = np.ascontiguousarray(user_factors, dtype=np.float32)
    vf = np.ascontiguousarray(item_factors, dtype=np.float32)
    if uf.ndim != 2 or vf.ndim != 2 or uf.shape[1] != vf.shape[1]:
        raise ValueError(f"factor shapes {uf.shape} and {vf.shape} do not match")
    if uf.shape[0] != len(user_vocab) or vf.shape[0] != len(item_vocab):
        raise ValueError("factor rows and vocabulary lengths differ")
    return ALSModel(uf, vf, list(user_vocab), list(item_vocab))


def sequential_model_from_numpy(
    item_vocab: Sequence[str],
    item_in: np.ndarray | None,
    item_out: np.ndarray | None,
    pair_counts: dict[tuple[int, int], float],
    user_last: dict[str, int],
    top_n: int = 10,
    context: int = 8,
):
    """The port's SequentialModel from the vocabulary, the two attention
    tables (None for a markov-only model), the summed transition-pair
    counts and each user's last item; the Markov model is rebuilt from the
    counts with the e2 math, as the JAX package builds it."""
    from predictionio_tpu_torch.models.sequential.engine import (
        SequentialModel,
        markov_from_counts,
    )

    n = len(item_vocab)
    tables = []
    for name, t in (("item_in", item_in), ("item_out", item_out)):
        if t is not None:
            t = np.ascontiguousarray(t, dtype=np.float32)
            if t.ndim != 2 or t.shape[0] != n:
                raise ValueError(f"{name} has shape {t.shape}, expected [{n}, f]")
        tables.append(t)
    if (tables[0] is None) != (tables[1] is None) or (
        tables[0] is not None and tables[0].shape != tables[1].shape
    ):
        raise ValueError("item_in and item_out must both be given, with one shape")
    counts = {(int(i), int(j)): float(c) for (i, j), c in pair_counts.items()}
    if any(not (0 <= i < n and 0 <= j < n) for i, j in counts):
        raise ValueError("a transition pair indexes outside the vocabulary")
    return SequentialModel(
        item_vocab=list(item_vocab),
        markov=markov_from_counts(counts, n, top_n),
        pair_counts=counts,
        user_last={str(u): int(i) for u, i in user_last.items()},
        top_n=int(top_n),
        item_in=tables[0],
        item_out=tables[1],
        context=int(context),
    )


def is_flax_tree(params) -> bool:
    """Whether ``params`` is a flax parameter tree (nested dicts), not the
    port's flat ``state_dict``."""
    return isinstance(params, dict) and any(isinstance(v, dict) for v in params.values())


def _flax_path(name: str) -> tuple[tuple[str, ...], bool]:
    """The flax path of a port TwoTower parameter and whether its layout
    is transposed: an Embedding ``weight`` is the Embed's ``embedding``, a
    Linear ``weight`` [out, in] the Dense ``kernel`` [in, out], a
    LayerNorm ``weight`` its ``scale``; ``pos`` and biases carry over."""
    parts = re.sub(r"\.dense\.(\d+)\.", r".dense_\1.", name).split(".")
    leaf = parts[-1]
    module = parts[-2] if len(parts) > 1 else ""
    if leaf == "weight" and module in ("embed", "hist_embed"):
        return (*parts[:-1], "embedding"), False
    if leaf == "weight" and module == "ln":
        return (*parts[:-1], "scale"), False
    if leaf == "weight":
        return (*parts[:-1], "kernel"), True
    return tuple(parts), False


def _flax_leaves(params, prefix: tuple[str, ...] = ()):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _port_name(path: tuple[str, ...]) -> str:
    """The port name of a flax path (the inverse of :func:`_flax_path`)."""
    *mods, leaf = path
    mods = [f"dense.{m[len('dense_'):]}" if m.startswith("dense_") else m for m in mods]
    leaf = {"embedding": "weight", "kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join([*mods, leaf])


def twotower_params_from_numpy(params) -> dict[str, np.ndarray]:
    """The port's TwoTower ``state_dict`` (numpy) from the JAX package's
    flax tree in numpy: an Embed's ``embedding`` is the Embedding
    ``weight``; a Dense ``kernel`` [in, out] becomes the Linear ``weight``
    [out, in]; ``pos`` and LayerNorm ``scale``/``bias`` carry over. The
    tables are whole; :func:`load_twotower_params` gives a sharded model
    its rows."""
    known = {"user_tower", "item_tower", "hist_encoder"}
    if set(params) - known:
        raise ValueError(f"unknown two-tower parameter groups {sorted(set(params) - known)}")
    out: dict[str, np.ndarray] = {}
    for path, leaf in _flax_leaves(params):
        name = _port_name(path)
        a = np.asarray(leaf)
        # an owned, writable copy
        out[name] = np.array(a.T if _flax_path(name)[1] else a, dtype=np.float32, order="C")
    return out


def twotower_key_map(state) -> dict[str, tuple[str, ...]]:
    """Port parameter name -> flax path, for every name of ``state`` (a
    port ``state_dict`` or a model's ``named_parameters`` names)."""
    return {name: _flax_path(name)[0] for name in state}


def load_twotower_params(model, params) -> None:
    """Load a whole parameter tree (the JAX package's flax tree, or the
    port's whole ``state_dict``) into a TwoTower, sharded or not: a
    sharded table takes this rank's rows."""
    from predictionio_tpu_torch.models.twotower.model import load_whole_state_dict

    load_whole_state_dict(model, twotower_params_from_numpy(params) if is_flax_tree(params) else params)


def twotower_params_to_numpy(model) -> dict:
    """The JAX package's flax tree (numpy, whole tables) of a TwoTower,
    sharded or not; on a sharded model every rank of its ``model`` axis
    must call it (the tables are gathered)."""
    from predictionio_tpu_torch.models.twotower.model import gather_state_dict

    tree: dict = {}
    for name, t in gather_state_dict(model).items():
        path, transposed = _flax_path(name)
        a = t.detach().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(a.T if transposed else a)
    return tree
