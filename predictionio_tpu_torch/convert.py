"""Weights carried across from the JAX package.

A model of the JAX package's recommendation template is host numpy: two
factor tables and two vocabularies. ``als_model_from_numpy`` builds the
port's ``ALSModel`` from them, and ``ModelUnpickler`` loads a blob that
``pio train`` of the JAX package wrote by mapping its class path to the
port's class, without importing the JAX package.
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
