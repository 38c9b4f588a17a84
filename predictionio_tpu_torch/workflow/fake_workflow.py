"""FakeRun — run an arbitrary function under the exact workflow environment.

Reference parity: ``core/src/main/scala/org/apache/predictionio/workflow/
FakeWorkflow.scala:18-109`` — ``FakeRun`` is an ``Evaluation`` whose
"evaluator" just calls a user function with the SparkContext, and whose
result carries ``noSave = true`` so nothing is persisted. It exists so new
features can be developed with ``pio eval HelloWorld`` and the full env
(storage config, logging, cleanup hooks) without defining DASE components.

Here the function receives the :class:`WorkflowContext` (the SparkContext
analogue: device + storage + mode). Port of
``predictionio_tpu/workflow/fake_workflow.py``.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

from predictionio_tpu_torch.workflow.context import WorkflowContext


@dataclasses.dataclass
class FakeEvalResult:
    """Sentinel result; ``no_save=True`` keeps run_evaluation from writing an
    EvaluationInstance (ref ``FakeEvalResult.noSave``)."""

    value: Any = None
    no_save: bool = True

    def one_liner(self) -> str:
        return "FakeRun (not persisted)"

    def to_json_dict(self) -> dict[str, Any]:
        return {"fakeRun": True}

    def to_html(self) -> str:
        return "<p>FakeRun (not persisted)</p>"


class FakeRun:
    """Wraps ``func(ctx) -> Any`` as an Evaluation-shaped object accepted by
    ``run_evaluation`` and ``pio eval`` (ref ``FakeRun`` trait usage:
    ``pio eval HelloWorld`` with ``func = f``).

    Subclass and set ``func`` (plain function, ``@staticmethod``, or a
    lambda — all three spellings work), or construct with the function::

        class HelloWorld(FakeRun):
            @staticmethod
            def func(ctx):
                print("hello from", ctx.mode)
    """

    func: Callable[[WorkflowContext], Any] | None = None

    def __init__(self, func: Callable[[WorkflowContext], Any] | None = None):
        if func is not None:
            self.func = func  # type: ignore[assignment]

    def run(self, ctx: WorkflowContext) -> FakeEvalResult:
        # instance attribute first (set by __init__ — a plain function there
        # never binds); then the CLASS DICT, bypassing descriptor binding: a
        # plain ONE-ARGUMENT function assigned as `func = my_fn` (the
        # natural spelling, @staticmethod omitted) would otherwise arrive
        # as a bound method and receive the FakeRun instance in place of
        # the context. A conventional method spelling (def func(self, ctx))
        # still binds: arity decides.
        fn = self.__dict__.get("func")
        if fn is None:
            for klass in type(self).__mro__:
                if "func" in klass.__dict__:
                    raw = klass.__dict__["func"]
                    if isinstance(raw, (staticmethod, classmethod)):
                        fn = raw.__get__(None, type(self))
                    elif callable(raw):
                        try:
                            n_pos = sum(
                                1
                                for p in inspect.signature(
                                    raw
                                ).parameters.values()
                                if p.kind
                                in (
                                    p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD,
                                )
                            )
                        except (TypeError, ValueError):
                            n_pos = 1
                        # a callable INSTANCE (defines __call__, no
                        # __get__) is not a descriptor — invoke it
                        # directly regardless of arity
                        fn = (
                            raw.__get__(self, type(self))
                            if n_pos >= 2 and hasattr(raw, "__get__")
                            else raw
                        )
                    else:
                        fn = raw
                    break
        if fn is None:
            raise ValueError("FakeRun has no func")
        return FakeEvalResult(value=fn(ctx))
