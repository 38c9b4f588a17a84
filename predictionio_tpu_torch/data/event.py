"""The event record and its JSON codec (the ``pio import`` JSON-lines format).

Own copy of ``predictionio_tpu/data/event.py`` (wire format and validation
rules); properties are a plain dict here.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Any, Mapping

UTC = _dt.timezone.utc
SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})


def now_utc() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def parse_event_time(value: str) -> _dt.datetime:
    """Parse an ISO8601 timestamp; it must carry a timezone."""
    if value.endswith(("Z", "z")):
        value = value[:-1] + "+00:00"
    t = _dt.datetime.fromisoformat(value)
    if t.tzinfo is None:
        raise ValueError(f"eventTime {value!r} must include a timezone offset")
    return t


def format_event_time(t: _dt.datetime) -> str:
    """ISO8601 with milliseconds, ``Z`` for UTC."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t.isoformat(timespec="milliseconds").replace("+00:00", "Z")


def _reserved(name: str) -> bool:
    return name.startswith("$") or name.startswith("pio_")


@dataclasses.dataclass(frozen=True)
class Event:
    event: str
    entity_type: str
    entity_id: str
    target_entity_type: str | None = None
    target_entity_id: str | None = None
    properties: dict[str, Any] = dataclasses.field(default_factory=dict)
    event_time: _dt.datetime = dataclasses.field(default_factory=now_utc)
    event_id: str | None = None
    pr_id: str | None = None
    creation_time: _dt.datetime = dataclasses.field(default_factory=now_utc)

    def to_json_dict(self, with_creation_time: bool = False) -> dict[str, Any]:
        d: dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
        }
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        d["properties"] = dict(self.properties)
        d["eventTime"] = format_event_time(self.event_time)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        if with_creation_time:
            d["creationTime"] = format_event_time(self.creation_time)
        return d

    @staticmethod
    def from_json_dict(d: Mapping[str, Any]) -> "Event":
        """Decode and validate one wire event; raises ValueError."""
        for field in ("event", "entityType", "entityId"):
            if field not in d or not isinstance(d[field], str):
                raise ValueError(f"field {field} is required and must be a string")
        for field in ("targetEntityType", "targetEntityId", "eventId", "prId"):
            if d.get(field) is not None and not isinstance(d[field], str):
                raise ValueError(f"field {field} must be a string")
        props = d.get("properties")
        if props is None:
            props = {}
        if not isinstance(props, Mapping):
            raise ValueError("properties must be a JSON object")
        raw_time = d.get("eventTime")
        raw_created = d.get("creationTime")
        e = Event(
            event=d["event"],
            entity_type=d["entityType"],
            entity_id=d["entityId"],
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=dict(props),
            event_time=parse_event_time(raw_time) if raw_time else now_utc(),
            event_id=d.get("eventId"),
            pr_id=d.get("prId"),
            creation_time=parse_event_time(raw_created) if raw_created else now_utc(),
        )
        validate(e)
        return e


def event_seq_key(e: Event) -> tuple[int, str]:
    """The store's total order for ordered reads: creation time in whole
    microseconds (when the store accepted the event, not the client's event
    time), then the event id. Two events accepted in the same microsecond
    still have one order (own copy of ``event_seq_key`` in
    ``predictionio_tpu/data/storage/base.py``)."""
    return (int(e.creation_time.timestamp() * 1_000_000), e.event_id or "")


def validate(e: Event) -> None:
    """The event API's validation rules."""

    def require(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(msg)

    require(bool(e.event), "event must not be empty.")
    require(bool(e.entity_type), "entityType must not be empty string.")
    require(bool(e.entity_id), "entityId must not be empty string.")
    require(
        e.target_entity_type is None or bool(e.target_entity_type),
        "targetEntityType must not be empty string",
    )
    require(
        e.target_entity_id is None or bool(e.target_entity_id),
        "targetEntityId must not be empty string.",
    )
    require(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    require(
        not (e.event == "$unset" and not e.properties),
        "properties cannot be empty for $unset event",
    )
    require(
        not _reserved(e.event) or e.event in SPECIAL_EVENTS,
        f"{e.event} is not a supported reserved event name.",
    )
    require(
        e.event not in SPECIAL_EVENTS
        or (e.target_entity_type is None and e.target_entity_id is None),
        f"Reserved event {e.event} cannot have targetEntity",
    )
    for kind, value in (("entityType", e.entity_type), ("targetEntityType", e.target_entity_type)):
        require(
            value is None or not _reserved(value) or value in BUILTIN_ENTITY_TYPES,
            f"The {kind} {value} is not allowed. 'pio_' is a reserved name prefix.",
        )
    for k in e.properties:
        require(
            not _reserved(k),
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )
