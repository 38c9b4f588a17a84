"""Event-server plugin SPI.

Reference parity: ``data/.../api/EventServerPlugin.scala:34`` — two plugin
kinds: input *blockers* run synchronously in the request path and may raise to
reject an event; input *sniffers* observe asynchronously. Plugins register via
``register_plugin`` (the Python analog of JVM ``ServiceLoader`` discovery) or
via entry-point style setup in engine code.

The port's own copy of ``predictionio_tpu/data/api/plugins.py``.
"""

from __future__ import annotations

import abc
from typing import Any

from predictionio_tpu_torch.data.event import Event

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


class EventInfo:
    __slots__ = ("app_id", "channel_id", "event")

    def __init__(self, app_id: int, channel_id: int | None, event: Event):
        self.app_id = app_id
        self.channel_id = channel_id
        self.event = event


class EventServerPlugin(abc.ABC):
    plugin_name: str = ""
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    def start(self, context: "EventServerPluginContext") -> None:
        pass

    @abc.abstractmethod
    def process(self, event_info: EventInfo, context: "EventServerPluginContext") -> None:
        """Blockers raise to reject; sniffers observe."""

    def handle_rest(
        self, app_id: int, channel_id: int | None, args: list[str]
    ) -> Any:
        """Serve GET /plugins/<type>/<name>/... (ref handleREST)."""
        return {"message": "handleREST is not implemented."}


class EventServerPluginContext:
    """Holds the live plugin registry for one server instance."""

    def __init__(self, plugins: list[EventServerPlugin] | None = None):
        self.input_blockers: dict[str, EventServerPlugin] = {}
        self.input_sniffers: dict[str, EventServerPlugin] = {}
        # None = global registry; an EXPLICIT empty list means a
        # plugin-free server (a falsy-list fallback would let globally
        # registered blockers reject events the caller opted out of)
        for p in list(_REGISTRY) if plugins is None else plugins:
            if p.plugin_type == INPUT_BLOCKER:
                self.input_blockers[p.plugin_name] = p
            else:
                self.input_sniffers[p.plugin_name] = p

    def to_json_dict(self) -> dict[str, Any]:
        def describe(ps: dict[str, EventServerPlugin]) -> dict[str, Any]:
            return {
                n: {
                    "name": p.plugin_name,
                    "description": p.plugin_description,
                    "class": type(p).__module__ + "." + type(p).__qualname__,
                }
                for n, p in ps.items()
            }

        return {
            "plugins": {
                "inputblockers": describe(self.input_blockers),
                "inputsniffers": describe(self.input_sniffers),
            }
        }


_REGISTRY: list[EventServerPlugin] = []


def register_plugin(plugin: EventServerPlugin) -> None:
    _REGISTRY.append(plugin)


def clear_plugins() -> None:
    _REGISTRY.clear()
