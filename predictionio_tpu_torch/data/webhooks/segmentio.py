"""Segment.io webhook connector.

Reference parity: ``data/.../webhooks/segmentio/SegmentIOConnector.scala`` —
supports the spec v2 message types identify / track / alias / page / screen /
group; entity is always the user (``userId`` falling back to
``anonymousId``); per-type payload fields land in ``properties`` with the
optional ``context`` object merged alongside.

The port's own copy of ``predictionio_tpu/data/webhooks/segmentio.py``.
"""

from __future__ import annotations

from typing import Any, Mapping

from predictionio_tpu_torch.data.webhooks import ConnectorException, JsonConnector


class SegmentIOConnector(JsonConnector):
    TYPES = ("identify", "track", "alias", "page", "screen", "group")

    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        if "version" not in data:
            raise ConnectorException("Failed to get segment.io API version.")
        msg_type = data.get("type")
        if msg_type not in self.TYPES:
            raise ConnectorException(
                f"Cannot convert unknown type {msg_type} to event JSON."
            )
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields."
            )

        if msg_type == "identify":
            props: dict[str, Any] = {"traits": data.get("traits")}
        elif msg_type == "track":
            props = {
                "properties": data.get("properties"),
                "event": data.get("event"),
            }
        elif msg_type == "alias":
            props = {"previous_id": data.get("previousId") or data.get("previous_id")}
        elif msg_type in ("page", "screen"):
            props = {
                "name": data.get("name"),
                "properties": data.get("properties"),
            }
        else:  # group
            props = {
                "group_id": data.get("groupId") or data.get("group_id"),
                "traits": data.get("traits"),
            }
        if data.get("context") is not None:
            props["context"] = data["context"]
        props = {k: v for k, v in props.items() if v is not None}

        out: dict[str, Any] = {
            "event": msg_type,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": props,
        }
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out
