"""Process-level guards of the port's entry points (the counterpart of
``predictionio_tpu/utils/platform.py``).

The JAX guard makes an explicit ``JAX_PLATFORMS=cpu`` run unable to reach
an accelerator plugin. Here :func:`ensure_cpu_if_requested` does the same
for a caller that asked for the CPU: it hides the card from this process
(``CUDA_VISIBLE_DEVICES=""``) before CUDA initialises, so nothing the run
imports can open a context on it. A run that asked for the card is never
moved. :func:`wait_for_signal` blocks a server's main thread until SIGINT
or SIGTERM.
"""

from __future__ import annotations

import os
import signal
import sys
import threading


def ensure_cpu_if_requested(device) -> bool:
    """For ``device`` "cpu", hide the card from this process before CUDA
    initialises; returns whether it is hidden. Any other device is left
    alone. Once CUDA is up in the process it is too late, and that is
    refused."""
    if str(device).split(":")[0] != "cpu":
        return False
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("the CPU was asked for after CUDA initialised in this process")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    return True


# how often the waiting main thread returns to the interpreter loop
SIGNAL_POLL_S = 0.05


def wait_for_signal(stop: threading.Event | None = None) -> int | None:
    """Block until SIGINT, SIGTERM or ``stop`` is set; returns the signal
    that ended the wait, None for ``stop``. Call from the main thread.

    The wait polls: Python runs a signal's handler only in the main thread,
    between bytecodes, and when the kernel delivers the signal to another
    of the process's threads, nothing interrupts a main thread blocked in
    an untimed lock wait — the handler then never runs (a served process
    ignored SIGTERM that way)."""
    stop = stop or threading.Event()
    got: list[int] = []

    def handler(signum, frame):
        got.append(signum)
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, handler)
    while not stop.wait(SIGNAL_POLL_S):
        pass
    return got[0] if got else None
