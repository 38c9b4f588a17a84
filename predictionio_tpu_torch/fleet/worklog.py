"""Worker stderr/stdout capture: bounded rotating tail files per replica.

Port of ``predictionio_tpu/fleet/worklog.py``, unchanged.

Before this module the supervisor's workers inherited the parent's fds —
a crashed replica left exactly zero log evidence, and the incident
bundle that matters most (the crash) had nothing to embed. The logbook
gives every worker a stable log file the supervisor can tail after the
process is gone:

- :meth:`WorkerLogBook.open_for` returns a binary append handle for the
  worker's ``<name>.log``; rotation happens *at open time* (a respawned
  worker whose log outgrew ``max_bytes`` shifts it to ``<name>.log.1``
  first) because the file is owned by the child's fd while it runs —
  truncating under a live writer would interleave garbage.
- :func:`spawn_with_log` is the ``subprocess.Popen`` wrapper the fleet
  launcher uses: open, spawn with stdout+stderr pointed at the log,
  close the parent's copy (the child holds its own dup), return the
  proc.
- :meth:`WorkerLogBook.tail` reads the last ``max_bytes`` of the
  current log (reaching into ``.log.1`` when the current file is
  shorter than asked) — the excerpt incident bundles capture and
  ``pio incidents show`` prints.

Bounded by construction: at most ``max_bytes`` per generation and two
generations per worker, however long the fleet runs. Stdlib-only.
"""

from __future__ import annotations

import os
import subprocess
from typing import IO, Any

DEFAULT_MAX_BYTES = 256 * 1024


class WorkerLogBook:
    def __init__(self, dir_path: str, max_bytes: int = DEFAULT_MAX_BYTES):
        self.dir = dir_path
        self.max_bytes = int(max_bytes)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.log")

    def rotated_path(self, name: str) -> str:
        return self.path(name) + ".1"

    def open_for(self, name: str) -> IO[bytes]:
        """Append handle for the worker's log, rotating first when the
        previous generation outgrew the budget."""
        path = self.path(name)
        try:
            if os.path.getsize(path) > self.max_bytes:
                os.replace(path, self.rotated_path(name))
        except OSError:
            pass  # no previous log: nothing to rotate
        return open(path, "ab")

    def tail(self, name: str, max_bytes: int = 8192) -> str:
        """Last ``max_bytes`` of the worker's output, rotation-aware:
        when the live log is shorter than asked, the gap is filled from
        the previous generation (a worker that crashed right after a
        rotation still shows its dying words)."""
        max_bytes = max(0, int(max_bytes))
        chunks: list[bytes] = []
        remaining = max_bytes
        for path in (self.path(name), self.rotated_path(name)):
            if remaining <= 0:
                break
            data = _tail_bytes(path, remaining)
            if data:
                chunks.insert(0, data)
                remaining -= len(data)
        return b"".join(chunks).decode("utf-8", errors="replace")


def _tail_bytes(path: str, n: int) -> bytes:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(max(0, size - n))
            return fh.read()
    except OSError:
        return b""


def spawn_with_log(
    argv: list[str],
    logbook: WorkerLogBook,
    name: str,
    **popen_kw: Any,
) -> subprocess.Popen:
    """Spawn a worker with stdout+stderr captured into its logbook file.
    The parent's handle is closed right after the spawn — the child owns
    a dup, so the parent never leaks an fd per restart."""
    fh = logbook.open_for(name)
    try:
        return subprocess.Popen(
            argv, stdout=fh, stderr=subprocess.STDOUT, **popen_kw
        )
    finally:
        fh.close()


__all__ = ["WorkerLogBook", "spawn_with_log", "DEFAULT_MAX_BYTES"]
