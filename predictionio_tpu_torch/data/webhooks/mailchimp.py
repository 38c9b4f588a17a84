"""MailChimp webhook (form) connector.

Reference parity: ``data/.../webhooks/mailchimp/MailChimpConnector.scala`` —
handles subscribe / unsubscribe / profile / upemail / cleaned / campaign form
payloads; ``fired_at`` is ``yyyy-MM-dd HH:mm:ss`` in UTC, converted to
ISO8601.

The port's own copy of ``predictionio_tpu/data/webhooks/mailchimp.py``.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Mapping

from predictionio_tpu_torch.data.event import UTC, format_event_time
from predictionio_tpu_torch.data.webhooks import ConnectorException, FormConnector


def _fired_at(data: Mapping[str, str]) -> str:
    raw = data.get("fired_at")
    if not raw:
        raise ConnectorException("The field 'fired_at' is required.")
    try:
        t = _dt.datetime.strptime(raw, "%Y-%m-%d %H:%M:%S").replace(tzinfo=UTC)
    except ValueError as exc:
        raise ConnectorException(f"Cannot parse fired_at {raw!r}") from exc
    return format_event_time(t)


def _req(data: Mapping[str, str], key: str) -> str:
    if key not in data:
        raise ConnectorException(f"The field '{key}' is required for MailChimp data.")
    return data[key]


class MailChimpConnector(FormConnector):
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        msg_type = data.get("type")
        if msg_type is None:
            raise ConnectorException("The field 'type' is required for MailChimp data.")
        handler = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }.get(msg_type)
        if handler is None:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp data type {msg_type} to event JSON"
            )
        return handler(data)

    @staticmethod
    def _merges(data: Mapping[str, str]) -> dict[str, Any]:
        merges = {
            "EMAIL": data.get("data[merges][EMAIL]"),
            "FNAME": data.get("data[merges][FNAME]"),
            "LNAME": data.get("data[merges][LNAME]"),
        }
        if "data[merges][INTERESTS]" in data:
            merges["INTERESTS"] = data["data[merges][INTERESTS]"]
        return {k: v for k, v in merges.items() if v is not None}

    def _subscribe(self, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            "event": "subscribe",
            "entityType": "user",
            "entityId": _req(data, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(data, "data[list_id]"),
            "eventTime": _fired_at(data),
            "properties": {
                "email": data.get("data[email]"),
                "email_type": data.get("data[email_type]"),
                "merges": self._merges(data),
                "ip_opt": data.get("data[ip_opt]"),
                "ip_signup": data.get("data[ip_signup]"),
            },
        }

    def _unsubscribe(self, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            "event": "unsubscribe",
            "entityType": "user",
            "entityId": _req(data, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(data, "data[list_id]"),
            "eventTime": _fired_at(data),
            "properties": {
                "action": data.get("data[action]"),
                "reason": data.get("data[reason]"),
                "email": data.get("data[email]"),
                "email_type": data.get("data[email_type]"),
                "merges": self._merges(data),
                "campaign_id": data.get("data[campaign_id]"),
                "ip_opt": data.get("data[ip_opt]"),
            },
        }

    def _profile(self, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            "event": "profile",
            "entityType": "user",
            "entityId": _req(data, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(data, "data[list_id]"),
            "eventTime": _fired_at(data),
            "properties": {
                "email": data.get("data[email]"),
                "email_type": data.get("data[email_type]"),
                "merges": self._merges(data),
                "ip_opt": data.get("data[ip_opt]"),
            },
        }

    def _upemail(self, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            "event": "upemail",
            "entityType": "list",
            "entityId": _req(data, "data[list_id]"),
            "eventTime": _fired_at(data),
            "properties": {
                "new_id": data.get("data[new_id]"),
                "new_email": data.get("data[new_email]"),
                "old_email": data.get("data[old_email]"),
            },
        }

    def _cleaned(self, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            "event": "cleaned",
            "entityType": "list",
            "entityId": _req(data, "data[list_id]"),
            "eventTime": _fired_at(data),
            "properties": {
                "campaign_id": data.get("data[campaign_id]"),
                "reason": data.get("data[reason]"),
                "email": data.get("data[email]"),
            },
        }

    def _campaign(self, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            "event": "campaign",
            "entityType": "campaign",
            "entityId": _req(data, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _req(data, "data[list_id]"),
            "eventTime": _fired_at(data),
            "properties": {
                "subject": data.get("data[subject]"),
                "status": data.get("data[status]"),
                "reason": data.get("data[reason]"),
            },
        }
