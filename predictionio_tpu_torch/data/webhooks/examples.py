"""Example connectors for custom-webhook development.

Reference parity: ``data/.../webhooks/examplejson/ExampleJsonConnector.scala``
and ``exampleform/ExampleFormConnector.scala``.

The port's own copy of ``predictionio_tpu/data/webhooks/examples.py``.
"""

from __future__ import annotations

from typing import Any, Mapping

from predictionio_tpu_torch.data.webhooks import (
    ConnectorException,
    FormConnector,
    JsonConnector,
)


class ExampleJsonConnector(JsonConnector):
    """Expects {"type": "userAction"|"userActionItem", ...} payloads."""

    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        msg_type = data.get("type")
        try:
            if msg_type == "userAction":
                out = {
                    "event": "userAction",
                    "entityType": "user",
                    "entityId": data["userId"],
                    "properties": data.get("properties", {}),
                }
            elif msg_type == "userActionItem":
                out = {
                    "event": data["action"],
                    "entityType": "user",
                    "entityId": data["userId"],
                    "targetEntityType": "item",
                    "targetEntityId": data["itemId"],
                    "properties": data.get("properties", {}),
                }
            else:
                raise ConnectorException(
                    f"Cannot convert unknown type {msg_type} to event JSON."
                )
        except KeyError as exc:
            raise ConnectorException(f"The field {exc} is required.") from exc
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out


class ExampleFormConnector(FormConnector):
    """Expects type=userAction form payloads."""

    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        if data.get("type") != "userAction":
            raise ConnectorException(
                f"Cannot convert unknown type {data.get('type')} to event JSON."
            )
        try:
            out: dict[str, Any] = {
                "event": "userAction",
                "entityType": "user",
                "entityId": data["userId"],
                "properties": {
                    k: v for k, v in data.items() if k not in ("type", "userId", "timestamp")
                },
            }
        except KeyError as exc:
            raise ConnectorException(f"The field {exc} is required.") from exc
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out
