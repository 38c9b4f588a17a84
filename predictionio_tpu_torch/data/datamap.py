"""DataMap / PropertyMap — typed JSON property bags (own copy of
``predictionio_tpu/data/datamap.py``). The port's ``Event.properties`` stays
a plain dict; ``data/aggregator.py`` wraps it in these maps.

Reference parity: ``data/.../storage/DataMap.scala`` (typed getters, ``++``
merge / ``--`` diff, required-field errors) and ``PropertyMap.scala``
(firstUpdated / lastUpdated timestamps from property-replay aggregation).
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Any, Iterable, Iterator, Mapping


class DataMapError(KeyError):
    """Raised when a required field is missing or null (ref DataMap.scala:52-58)."""


class DataMap(Mapping[str, Any]):
    """An immutable mapping of property names to JSON values.

    Unlike a plain dict it distinguishes "missing" from "present but null"
    the way the reference does: ``get`` raises on missing, ``get_opt``
    returns None for missing or null.
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Mapping[str, Any] | None = None):
        self._fields: dict[str, Any] = dict(fields) if fields else {}

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        return self._fields[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, name: object) -> bool:
        return name in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self) -> int:  # stable enough for memo keys
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- reference API ------------------------------------------------------
    @property
    def fields(self) -> dict[str, Any]:
        return dict(self._fields)

    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def contains(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str, default: Any = ...) -> Any:
        """Required getter: raises DataMapError when missing or null,
        unless an explicit ``default`` is supplied (dict.get compatibility)."""
        if name not in self._fields:
            if default is not ...:
                return default
            raise DataMapError(f"The field {name} is required.")
        value = self._fields[name]
        if value is None:
            if default is not ...:
                return default
            raise DataMapError(f"The required field {name} cannot be null.")
        return value

    def get_opt(self, name: str) -> Any | None:
        return self._fields.get(name)

    def get_or_else(self, name: str, default: Any) -> Any:
        value = self._fields.get(name)
        return default if value is None else value

    def get_list(self, name: str) -> list[Any]:
        value = self.get(name)
        if not isinstance(value, list):
            raise DataMapError(f"The field {name} is not an array.")
        return value

    def get_string(self, name: str) -> str:
        return str(self.get(name))

    def get_double(self, name: str) -> float:
        return float(self.get(name))

    def get_int(self, name: str) -> int:
        return int(self.get(name))

    def keyset(self) -> set[str]:
        return set(self._fields)

    def union(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """``++`` in the reference: right-hand side wins on key conflicts."""
        merged = dict(self._fields)
        merged.update(dict(other))
        return DataMap(merged)

    def diff(self, keys: Iterable[str]) -> "DataMap":
        """``--`` in the reference: remove the listed keys."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    def is_empty(self) -> bool:
        return not self._fields

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "DataMap":
        obj = json.loads(s) if s else {}
        if not isinstance(obj, dict):
            raise ValueError("DataMap JSON must be an object")
        return DataMap(obj)


EMPTY_DATAMAP = DataMap()


class PropertyMap(DataMap):
    """A DataMap produced by $set/$unset/$delete replay, carrying the first
    and last update times of the special events that built it
    (ref PropertyMap.scala:28-45).
    """

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Mapping[str, Any] | None,
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        self.first_updated = first_updated
        self.last_updated = last_updated

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self.fields!r}, first_updated={self.first_updated}, "
            f"last_updated={self.last_updated})"
        )

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self.fields == other.fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    __hash__ = DataMap.__hash__
