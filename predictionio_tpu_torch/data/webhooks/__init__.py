"""Webhooks framework: adapt third-party payloads into the Event JSON contract.

Reference parity: ``data/.../webhooks/JsonConnector.scala`` /
``FormConnector.scala`` / ``ConnectorUtil.scala`` — a connector maps one
incoming JSON object (or form-field map) to event JSON, which then flows
through the standard insert path.

The port's own copy of ``predictionio_tpu/data/webhooks/__init__.py``.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

from predictionio_tpu_torch.data.event import Event


class ConnectorException(Exception):
    """Raised when a payload cannot be converted (-> HTTP 400)."""


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        """Map a third-party JSON object to event JSON."""


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        """Map submitted form fields to event JSON."""


def connector_to_event(connector: JsonConnector | FormConnector, data) -> Event:
    """ref ConnectorUtil.toEvent: convert then validate via the normal
    Event wire decoder."""
    return Event.from_json_dict(connector.to_event_json(data))


_JSON_CONNECTORS: dict[str, JsonConnector] = {}
_FORM_CONNECTORS: dict[str, FormConnector] = {}


def register_json_connector(name: str, connector: JsonConnector) -> None:
    _JSON_CONNECTORS[name] = connector


def register_form_connector(name: str, connector: FormConnector) -> None:
    _FORM_CONNECTORS[name] = connector


def json_connector(name: str) -> JsonConnector | None:
    _ensure_builtin()
    return _JSON_CONNECTORS.get(name)


def form_connector(name: str) -> FormConnector | None:
    _ensure_builtin()
    return _FORM_CONNECTORS.get(name)


_loaded = False


def _ensure_builtin() -> None:
    """Register the shipped connectors (ref WebhooksConnectors.scala)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    from predictionio_tpu_torch.data.webhooks import examples, mailchimp, segmentio

    register_json_connector("segmentio", segmentio.SegmentIOConnector())
    register_form_connector("mailchimp", mailchimp.MailChimpConnector())
    register_json_connector("examplejson", examples.ExampleJsonConnector())
    register_form_connector("exampleform", examples.ExampleFormConnector())
