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


def twotower_params_from_numpy(params) -> dict[str, np.ndarray]:
    """The port's TwoTower ``state_dict`` (numpy) from the JAX package's
    flax tree in numpy: an Embed's ``embedding`` is the Embedding
    ``weight``; a Dense ``kernel`` [in, out] becomes the Linear ``weight``
    [out, in]; ``pos`` and LayerNorm ``scale``/``bias`` carry over."""

    def arr(x) -> np.ndarray:
        return np.array(x, dtype=np.float32, order="C")  # an owned, writable copy

    def dense(prefix: str, node) -> dict[str, np.ndarray]:
        return {f"{prefix}.weight": arr(np.asarray(node["kernel"]).T), f"{prefix}.bias": arr(node["bias"])}

    out: dict[str, np.ndarray] = {}
    for tower in ("user_tower", "item_tower"):
        node = params[tower]
        out[f"{tower}.embed.weight"] = arr(node["embed"]["embedding"])
        i = 0
        while f"dense_{i}" in node:
            out.update(dense(f"{tower}.dense.{i}", node[f"dense_{i}"]))
            i += 1
        out.update(dense(f"{tower}.out", node["out"]))
    if "hist_encoder" in params:
        node = params["hist_encoder"]
        out["hist_encoder.hist_embed.weight"] = arr(node["hist_embed"]["embedding"])
        out["hist_encoder.pos"] = arr(node["pos"])
        out["hist_encoder.ln.weight"] = arr(node["ln"]["scale"])
        out["hist_encoder.ln.bias"] = arr(node["ln"]["bias"])
        for name in ("q", "k", "v", "proj"):
            out.update(dense(f"hist_encoder.{name}", node[name]))
    known = {"user_tower", "item_tower", "hist_encoder"}
    if set(params) - known:
        raise ValueError(f"unknown two-tower parameter groups {sorted(set(params) - known)}")
    return out
