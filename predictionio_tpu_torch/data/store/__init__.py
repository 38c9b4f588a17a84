"""Engine-facing event stores (app-name addressed).

Reference parity: ``data/.../store/LEventStore.scala``, ``PEventStore.scala``,
``Common.scala`` (appName -> appId / channelName -> channelId resolution).

The port's own copy of ``predictionio_tpu/data/store/__init__.py``.
"""

from predictionio_tpu_torch.data.store.event_store import LEventStore, PEventStore

__all__ = ["LEventStore", "PEventStore"]
