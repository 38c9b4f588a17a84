"""Interactive shell with the stores bound (port of
``predictionio_tpu/tools/shell.py``; ref ``bin/pio-shell``: a REPL with
PEventStore and CleanupFunctions bound). ``torch`` and the run's
``device`` stand where the JAX shell binds ``jax`` and ``jnp``; with
``device="cpu"`` the card stays hidden from the shell
(``utils.platform.ensure_cpu_if_requested``)."""

from __future__ import annotations

BANNER = """predictionio_tpu_torch shell
Preloaded: storage, p_event_store, l_event_store, Event, DataMap, CleanupFunctions, torch, device
Example: list(p_event_store.find("MyApp1", limit=5))
"""


def run_shell(device: str = "cuda", storage=None) -> None:
    """A REPL (IPython when installed, else ``code.interact``) over
    ``storage`` (default ``Storage.instance()``) on ``device``; the
    cleanup hooks run when it exits."""
    from predictionio_tpu_torch.utils.platform import ensure_cpu_if_requested

    ensure_cpu_if_requested(device)
    import torch

    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.store.event_store import LEventStore, PEventStore
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.cleanup import CleanupFunctions

    storage = storage or Storage.instance()
    namespace = {
        "storage": storage,
        "p_event_store": PEventStore(storage),
        "l_event_store": LEventStore(storage),
        "Event": Event,
        "DataMap": DataMap,
        "CleanupFunctions": CleanupFunctions,
        "torch": torch,
        "device": resolve_device(device),
    }
    print(BANNER)
    try:
        from IPython import start_ipython
    except ImportError:
        start_ipython = None
    try:
        if start_ipython is not None:
            start_ipython(argv=["--no-banner"], user_ns=namespace)
        else:
            import code

            code.interact(banner="", local=namespace)
    finally:
        CleanupFunctions.run()
