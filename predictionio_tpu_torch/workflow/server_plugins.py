"""Engine-server plugin SPI (port of
``predictionio_tpu/workflow/server_plugins.py``).

Reference parity: ``core/.../workflow/EngineServerPlugin.scala:41`` +
``EngineServerPluginContext.scala:91`` — two kinds: output *blockers* run
synchronously and may rewrite or veto the prediction before it is returned;
output *sniffers* observe asynchronously. Mirrors the event server's input
plugin SPI.
"""

from __future__ import annotations

import abc
import logging
from typing import Any

logger = logging.getLogger(__name__)

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EngineServerPlugin(abc.ABC):
    plugin_name: str = ""
    plugin_description: str = ""
    plugin_type: str = OUTPUT_SNIFFER

    def start(self, context: "EngineServerPluginContext") -> None:
        pass

    @abc.abstractmethod
    def process(
        self,
        engine_variant: str,
        query: Any,
        prediction: Any,
        context: "EngineServerPluginContext",
    ) -> Any:
        """Blockers return the (possibly rewritten) prediction or raise to
        veto; sniffers observe (return value ignored)."""

    def handle_rest(self, args: list[str]) -> Any:
        return {"message": "handleREST is not implemented."}


class EngineServerPluginContext:
    def __init__(
        self,
        plugins: list[EngineServerPlugin] | None = None,
        plugin_params: dict[str, dict] | None = None,
    ):
        self.plugin_params = plugin_params or {}
        self.output_blockers: dict[str, EngineServerPlugin] = {}
        self.output_sniffers: dict[str, EngineServerPlugin] = {}
        for p in plugins if plugins is not None else list(_REGISTRY):
            if p.plugin_type == OUTPUT_BLOCKER:
                self.output_blockers[p.plugin_name] = p
            else:
                self.output_sniffers[p.plugin_name] = p
            p.start(self)

    def apply_output_blockers(
        self, engine_variant: str, query: Any, prediction: Any
    ) -> Any:
        """Fold prediction through blockers (ref CreateServer.scala:572-576)."""
        for p in self.output_blockers.values():
            prediction = p.process(engine_variant, query, prediction, self)
        return prediction

    def notify_output_sniffers(
        self, engine_variant: str, query: Any, prediction: Any
    ) -> None:
        for p in self.output_sniffers.values():
            try:
                p.process(engine_variant, query, prediction, self)
            except Exception:
                logger.exception("output sniffer %s failed", p.plugin_name)

    def to_json_dict(self) -> dict[str, Any]:
        def describe(ps: dict[str, EngineServerPlugin]) -> dict[str, Any]:
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
                "outputblockers": describe(self.output_blockers),
                "outputsniffers": describe(self.output_sniffers),
            }
        }


_REGISTRY: list[EngineServerPlugin] = []


def register_plugin(plugin: EngineServerPlugin) -> None:
    _REGISTRY.append(plugin)


def clear_plugins() -> None:
    _REGISTRY.clear()
