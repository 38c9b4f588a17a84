"""EngineParamsGenerator — hyperparameter search spaces.

Reference parity: ``core/.../controller/EngineParamsGenerator.scala:46``
(a trait holding ``engineParamsList``); ``grid_search`` builds the cartesian
product the reference's examples assembled by hand.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterable, Mapping, Sequence

from predictionio_tpu_torch.controller.engine import EngineParams


class EngineParamsGenerator:
    """Subclass and set ``engine_params_list``."""

    engine_params_list: Sequence[EngineParams] = ()

    def __init__(self, engine_params_list: Sequence[EngineParams] | None = None):
        if engine_params_list is not None:
            self.engine_params_list = list(engine_params_list)


def grid_search(
    base: EngineParams,
    algorithm_grid: Mapping[str, Iterable[Any]],
    algorithm_index: int = 0,
) -> EngineParamsGenerator:
    """Vary fields of one algorithm's params over a cartesian grid.

    ``algorithm_grid`` maps param field name -> iterable of values, e.g.
    ``{"rank": [8, 16], "lambda_": [0.01, 0.1]}``.
    """
    name, params = base.algorithms[algorithm_index]
    keys = list(algorithm_grid)
    out: list[EngineParams] = []
    for combo in itertools.product(*(list(algorithm_grid[k]) for k in keys)):
        new_params = dataclasses.replace(params, **dict(zip(keys, combo)))
        algorithms = list(base.algorithms)
        algorithms[algorithm_index] = (name, new_params)
        out.append(
            EngineParams(
                data_source=base.data_source,
                preparator=base.preparator,
                algorithms=algorithms,
                serving=base.serving,
            )
        )
    return EngineParamsGenerator(out)
