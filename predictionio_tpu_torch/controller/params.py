"""Typed engine parameters extracted from engine.json (own copy of
``predictionio_tpu/controller/params.py``).

Reference parity: ``Params`` marker + ``EmptyParams``
(``core/.../controller/Params.scala``), JSON -> param-case-class extraction
(``Engine.scala:355-418``, ``workflow/JsonExtractor.scala``). Here params are
Python dataclasses; extraction is typed field-by-field with clear errors and
tolerance for missing optional fields.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Mapping, Type, TypeVar

P = TypeVar("P", bound="Params")


@dataclasses.dataclass(frozen=True)
class Params:
    """Base class for all component parameter sets."""

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    pass


class ParamsError(ValueError):
    pass


def _coerce(value: Any, annotation: Any, field_name: str) -> Any:
    origin = typing.get_origin(annotation)
    if annotation is Any or annotation is dataclasses.MISSING:
        return value
    import types as _types

    if origin is typing.Union or origin is _types.UnionType:  # Optional / unions
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if value is None:
            return None
        for a in args:
            try:
                return _coerce(value, a, field_name)
            except (TypeError, ValueError):
                continue
        raise ParamsError(f"field {field_name}: cannot coerce {value!r} to {annotation}")
    if origin in (list, tuple, set):
        args = typing.get_args(annotation)
        inner = args[0] if args else Any
        items = [_coerce(v, inner, field_name) for v in value]
        return origin(items) if origin is not list else items
    if origin is dict:
        return dict(value)
    if dataclasses.is_dataclass(annotation) and isinstance(value, Mapping):
        return params_from_dict(annotation, value)
    if annotation is float and isinstance(value, (int, float)):
        return float(value)
    if annotation is int:
        if isinstance(value, bool):
            raise ParamsError(f"field {field_name}: bool given for int")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise ParamsError(f"field {field_name}: expected int, got {value!r}")
    if annotation is bool and not isinstance(value, bool):
        raise ParamsError(f"field {field_name}: expected bool, got {value!r}")
    if annotation is str and not isinstance(value, str):
        raise ParamsError(f"field {field_name}: expected str, got {value!r}")
    return value


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def params_from_dict(cls: Type[P], data: Mapping[str, Any] | None) -> P:
    """Build a params dataclass from a JSON object. Unknown keys error (the
    reference silently ignores them, which hides typos — flagged instead);
    missing keys fall back to dataclass defaults or error when required.

    JSON keys may be camelCase (``numIterations`` -> ``num_iterations``) for
    wire parity with reference engine.json files; keys colliding with Python
    keywords map to the trailing-underscore field (``lambda`` -> ``lambda_``).
    """
    raw = dict(data or {})
    if not dataclasses.is_dataclass(cls):
        raise ParamsError(f"{cls} is not a dataclass")
    field_names = {f.name for f in dataclasses.fields(cls)}
    data = {}
    for key, value in raw.items():
        for candidate in (key, _snake(key), key + "_", _snake(key) + "_"):
            if candidate in field_names:
                data[candidate] = value
                break
        else:
            data[key] = value
    hints = typing.get_type_hints(cls)
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(data.pop(f.name), hints.get(f.name, Any), f.name)
        elif (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        ):
            raise ParamsError(f"{cls.__name__}: required field {f.name} missing")
    if data:
        raise ParamsError(
            f"{cls.__name__}: unknown fields {sorted(data)} (known: {sorted(field_names)})"
        )
    return cls(**kwargs)  # type: ignore[return-value]


def params_from_json(cls: Type[P], text: str) -> P:
    return params_from_dict(cls, json.loads(text) if text.strip() else {})
