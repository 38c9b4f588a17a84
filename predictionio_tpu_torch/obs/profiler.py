"""On-demand device trace capture into content-addressed profile bundles.

Port of ``predictionio_tpu/obs/profiler.py`` on ``torch.profiler``. The
device trace is ``torch.profiler``'s Chrome trace JSON (``trace/
trace.json`` in the bundle), in place of the XLA ``.xplane.pb``: CPU and
CUDA activities on a card, CPU only when the session's device is the CPU.
It is bounded in duration and published as a **profile bundle** with the
content-addressed layout of the incident flight recorder
(``obs/incidents``): JSON parts, raw texts and a ``trace/`` subtree under
``<dir>/<utc-stamp>-<sha12>/``, written tmp+rename, GC'd to the newest
``max_bundles``. The manifest carries the JAX fields (trigger, capture
times, the caller's context with engine and model version, the parts, the
trace inventory) and, in its context, what the trace holds.

What a capture on the card records: CUPTI reports every CUDA kernel and
runtime call of the process, from every thread, so the micro-batcher's
dispatch and fetch threads' launches are in the trace whichever thread
started the capture. CPU operator events are recorded only for the thread
that started the profiler (the handler thread of ``POST
/profile/capture``). The port's kernels are launched through ``ctypes``,
not as torch operators, so they appear as kernel events under their
demangled symbols (``void (anonymous namespace)::spd_cg_registers<32, 8,
true>(...)``); :func:`kernel_launches` counts them by name.

Capture is **single-flight** per process: Kineto keeps one profiler per
process, and a second ``torch.profiler.profile`` started while one runs
does not raise but corrupts the first. A module-wide lock therefore
guards every session; a second capture gets :class:`ProfileBusyError`
(HTTP 409). A capture on the card that records no CUDA activity is an
error, never a bundle without a device trace: every capture launches one
marker kernel at its start, and a trace without any kernel event raises
:class:`ProfileCaptureError`. The first trace of a process on the card
sets CUPTI up: seconds when idle and tens of seconds under serving load
on an H100, against milliseconds for later starts.
:meth:`ProfileSession.warm_up` pays that ahead; a server does not call
it on its own, since a set-up running beside traffic slowed a deploy's
first queries about threefold on the card, so its first capture pays it.

``PIO_PROFILE_DIR``: :func:`maybe_profile_train` wraps the port's
``run_train`` with the JAX package's gate; the trace lands as a bundle.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Callable

from predictionio_tpu_torch.obs.incidents import (
    MANIFEST_NAME,
    BundleRef,
    _jsonable,
    export_bundle,
    list_bundles,
    load_bundle,
)

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV = "PIO_PROFILE_DIR"
TRACE_FILE = "trace.json"

# duration rails for HTTP-triggered captures: the trace buffers device
# events in memory and writes multi-MB files, so an unbounded ms
# parameter is a self-DoS — clamp, don't trust
DEFAULT_CAPTURE_MS = 500
MAX_CAPTURE_MS = 10_000

# one profiler per process (Kineto): every session shares this flight lock
_FLIGHT = threading.Lock()
# CUPTI's one-time set-up is paid once per process, by the first trace on
# a card; later traces start in milliseconds
_CUDA_READY = threading.Event()


class ProfileBusyError(RuntimeError):
    """A capture is already in flight in this process; HTTP 409."""


class ProfileCaptureError(RuntimeError):
    """A capture on the card recorded no CUDA activity."""


def _activities(device: str) -> list:
    from torch.profiler import ProfilerActivity

    if device == "cpu":
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _trace_events(path: str) -> list[dict[str, Any]]:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def trace_kernels(trace_dir_or_file: str) -> dict[str, int]:
    """Kernel name -> launches in one Chrome trace (a bundle's ``trace/``
    directory or the file itself)."""
    path = trace_dir_or_file
    if os.path.isdir(path):
        path = os.path.join(path, TRACE_FILE)
    counts: collections.Counter = collections.Counter()
    for event in _trace_events(path):
        if str(event.get("cat", "")).lower() == "kernel":
            counts[str(event.get("name", ""))] += 1
    return dict(counts)


def kernel_launches(kernels: dict[str, int], symbol: str) -> int:
    """Launches of the ``__global__`` function ``symbol`` among demangled
    kernel names (``...::symbol<...>(...)`` or ``symbol(...)``)."""
    total = 0
    for name, n in kernels.items():
        if f"::{symbol}<" in name or f"::{symbol}(" in name or name.startswith((f"{symbol}(", f"{symbol}<")):
            total += n
    return total


class _DeviceTrace:
    """One ``torch.profiler`` capture writing ``trace.json`` into a
    directory; on the card it launches one marker kernel at its start and
    refuses a trace without kernel events."""

    def __init__(self, trace_dir: str, device: str):
        self.trace_dir = trace_dir
        self.device = device
        self.kernels: dict[str, int] = {}
        # seconds of each step of the capture's own cost
        self.timings: dict[str, float] = {}
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import profile

        if self.device != "cpu" and not torch.cuda.is_available():
            raise ProfileCaptureError(f"device {self.device!r}: no CUDA card in this process")
        t0 = time.perf_counter()
        self._prof = profile(activities=_activities(self.device))
        self._prof.start()
        if self.device != "cpu":
            # the marker: proof that CUPTI records this process's kernels
            torch.ones(1, device=self.device).add_(1)
        self.timings["startS"] = time.perf_counter() - t0

    def stop(self) -> None:
        import torch

        t0 = time.perf_counter()
        if self.device != "cpu":
            # pio-lint: disable=hostsync-serving-path,train-unaccounted-sync -- the capture's own barrier: its trace must hold every kernel queued before stop; runs on the capture thread, not a handler
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        t1 = time.perf_counter()
        path = os.path.join(self.trace_dir, TRACE_FILE)
        self._prof.export_chrome_trace(path)
        self._prof = None  # its event buffers go with it
        t2 = time.perf_counter()
        self.kernels = trace_kernels(path)
        self.timings.update(stopS=t1 - t0, exportS=t2 - t1, readS=time.perf_counter() - t2)
        if self.device != "cpu" and not self.kernels:
            raise ProfileCaptureError(
                "torch.profiler recorded no CUDA kernel on the card (not even the "
                "capture's marker): CUPTI is not tracing this process"
            )

    def context(self) -> dict[str, Any]:
        return {
            "deviceTrace": f"torch.profiler chrome trace ({TRACE_FILE})",
            "activities": ["cpu"] if self.device == "cpu" else ["cpu", "cuda"],
            "device": self.device,
            "cpuOps": "the capturing thread only; CUDA kernels and runtime calls of every thread",
            "kernelLaunches": sum(self.kernels.values()),
            "captureTimingsS": self.timings,
        }


class ProfileStore:
    """Content-addressed profile bundles under one directory.

    Same bundle grammar as :class:`obs.incidents.IncidentRecorder` plus a
    ``trace/`` subtree for the device trace; the manifest inventories
    every trace file (name, bytes, sha256) so ``pio profile show`` can
    verify what it prints.
    """

    def __init__(self, dir_path: str, max_bundles: int = 20):
        self.dir = dir_path
        self.max_bundles = int(max_bundles)

    def ensure_dir(self) -> str:
        """Lazy creation: constructing a server must not scatter empty
        obs directories; the first capture makes it."""
        os.makedirs(self.dir, exist_ok=True)
        return self.dir

    # -------------------------------------------------------------- publish
    def publish(
        self,
        trigger: str,
        context: dict[str, Any] | None = None,
        parts: dict[str, Any] | None = None,
        texts: dict[str, str] | None = None,
        trace_dir: str | None = None,
    ) -> str:
        """Write one bundle; returns its path. ``trace_dir`` (the capture's
        output tree) is *moved* into the bundle's ``trace/`` subtree.
        Blocking file I/O: the servers call it on a handler thread."""
        self.ensure_dir()
        captured_at = time.time()
        parts = {k: _jsonable(v) for k, v in (parts or {}).items()}
        texts = dict(texts or {})
        trace_files = self._trace_inventory(trace_dir)
        manifest: dict[str, Any] = {
            "trigger": trigger,
            "capturedAt": captured_at,
            "capturedAtMonotonic": time.monotonic(),
            "context": _jsonable(context or {}),
            "parts": sorted(parts),
            "texts": sorted(texts),
            "trace": trace_files,
        }
        hasher = hashlib.sha256()
        hasher.update(json.dumps(manifest, sort_keys=True).encode())
        for name in sorted(parts):
            hasher.update(json.dumps(parts[name], sort_keys=True).encode())
        for name in sorted(texts):
            hasher.update(texts[name].encode("utf-8", errors="replace"))
        digest = hasher.hexdigest()
        manifest["sha256"] = digest
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(captured_at))
        bundle_id = f"{stamp}-{digest[:12]}"
        final = os.path.join(self.dir, bundle_id)
        tmp = os.path.join(self.dir, f".tmp-{bundle_id}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        try:
            for name, value in parts.items():
                with open(
                    os.path.join(tmp, f"{name}.json"), "w", encoding="utf-8"
                ) as fh:
                    json.dump(value, fh, indent=2, sort_keys=True)
            for name, text in texts.items():
                with open(
                    os.path.join(tmp, f"{name}.txt"),
                    "w",
                    encoding="utf-8",
                    errors="replace",
                ) as fh:
                    fh.write(text)
            if trace_dir is not None and os.path.isdir(trace_dir):
                shutil.move(trace_dir, os.path.join(tmp, "trace"))
            with open(
                os.path.join(tmp, MANIFEST_NAME), "w", encoding="utf-8"
            ) as fh:
                json.dump(manifest, fh, indent=2, sort_keys=True)
            if os.path.isdir(final):
                shutil.rmtree(tmp)  # identical evidence already captured
            else:
                os.rename(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        logger.info("profile bundle published: %s (%s)", bundle_id, trigger)
        return final

    @staticmethod
    def _trace_inventory(trace_dir: str | None) -> list[dict[str, Any]]:
        if trace_dir is None or not os.path.isdir(trace_dir):
            return []
        inventory: list[dict[str, Any]] = []
        for root, _dirs, files in os.walk(trace_dir):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, trace_dir)
                h = hashlib.sha256()
                try:
                    with open(path, "rb") as fh:
                        for chunk in iter(lambda: fh.read(1 << 20), b""):
                            h.update(chunk)
                    size = os.path.getsize(path)
                except OSError:
                    continue
                inventory.append(
                    {"name": rel, "bytes": size, "sha256": h.hexdigest()}
                )
        inventory.sort(key=lambda e: e["name"])
        return inventory

    def _gc(self) -> None:
        refs = list_bundles(self.dir)
        for ref in refs[: max(0, len(refs) - self.max_bundles)]:
            shutil.rmtree(ref.path, ignore_errors=True)

    # ------------------------------------------------------------ inspection
    def list(self) -> list[BundleRef]:
        return list_bundles(self.dir)

    def load(self, bundle_id: str) -> dict[str, Any]:
        return load_bundle(self.dir, bundle_id)

    def export(self, bundle_id: str, dest: str) -> str:
        return export_bundle(self.dir, bundle_id, dest)


class ProfileSession:
    """Single-flight device-trace capture publishing into a store.

    One session per server; ``capture()`` raises :class:`ProfileBusyError`
    when any capture of the process is running. Alert paths use
    ``capture_alert()``: rate-limited per trigger kind and never raising.
    ``device`` is what the trace records: ``"cuda"`` (CPU and CUDA
    activities; the default) or ``"cpu"``.
    """

    def __init__(
        self,
        store: ProfileStore,
        *,
        device: str = "cuda",
        default_ms: int = DEFAULT_CAPTURE_MS,
        max_ms: int = MAX_CAPTURE_MS,
        alert_min_interval_s: float = 60.0,
        alert_trace_ms: int = 0,
        context_fn: Callable[[], dict[str, Any]] | None = None,
        counters_fn: Callable[[], dict[str, int]] | None = None,
        metrics: Any | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.store = store
        self.device = str(device)
        self.default_ms = int(default_ms)
        self.max_ms = int(max_ms)
        self.alert_min_interval_s = float(alert_min_interval_s)
        self.alert_trace_ms = int(alert_trace_ms)
        # manifest enrichment (engine/model version, registry generation)
        # supplied by the owning server at capture time
        self.context_fn = context_fn
        # launch counters read before and after a device trace: their
        # deltas land in the manifest (``launchesCounted``) beside the
        # trace's own kernel counts
        self.counters_fn = counters_fn
        self._clock = clock
        # the process-wide flight lock (one profiler per process)
        self._flight = _FLIGHT
        self._last_alert: dict[str, float] = {}
        self._alert_lock = threading.Lock()
        # the kernels of the most recent device trace (name -> launches)
        # and the launches the counters saw over its window
        self.last_kernels: dict[str, int] = {}
        self.last_counted: dict[str, int] | None = None

        # true from just after a device trace started to just before it
        # stops: the window ``launchesCounted`` covers
        self.capturing = False
        if metrics is not None:
            self._m_captures = metrics.counter(
                "pio_profile_captures_total",
                "profile bundles captured, by trigger kind (manual / "
                "slo-alert / breaker-trip / train)",
                labelnames=("trigger",),
            )
            self._m_busy = metrics.counter(
                "pio_profile_capture_busy_total",
                "capture requests rejected because one was already in "
                "flight (the single-flight rail; HTTP 409)",
            )
            self._m_errors = metrics.counter(
                "pio_profile_capture_errors_total",
                "captures that failed (tracer unavailable, publish error)",
            )
            self._m_last_ms = metrics.gauge(
                "pio_profile_last_capture_ms",
                "requested duration of the most recent device capture",
            )
            self._m_bundles = metrics.gauge(
                "pio_profile_bundles",
                "profile bundles currently on disk in this server's store",
            )
            self._m_bundles.set_function(lambda: float(len(self.store.list())))
        else:
            self._m_captures = self._m_busy = None
            self._m_errors = self._m_last_ms = None

    @property
    def ready(self) -> bool:
        """Whether a capture starts without CUPTI's one-time set-up
        (seconds idle, tens of seconds under serving load on an H100): on
        the CPU always, on a card once any trace of this process ran."""
        return self.device == "cpu" or _CUDA_READY.is_set()

    def warm_up(self) -> None:
        """Start and stop one empty trace, so CUPTI's one-time set-up is not
        paid by the first capture: on the main thread of an idle process,
        before it serves on the card (a capture meanwhile answers busy). A
        failure is logged and leaves ``ready`` false; the first capture
        then raises."""
        if self.ready or not self._flight.acquire(blocking=False):
            return
        try:
            trace_dir = tempfile.mkdtemp(prefix=".warmup-")
            try:
                trace = _DeviceTrace(trace_dir, self.device)
                trace.start()
                trace.stop()
            finally:
                shutil.rmtree(trace_dir, ignore_errors=True)
            _CUDA_READY.set()
            logger.info("profiler ready on %s (set-up %.1f s)", self.device, trace.timings.get("startS", 0.0))
        except Exception:
            logger.exception("profiler warm-up failed on %s", self.device)
        finally:
            self._flight.release()

    def clamp_ms(self, ms: int | None) -> int:
        if ms is None:
            return self.default_ms
        return max(0, min(int(ms), self.max_ms))

    def _base_context(self) -> dict[str, Any]:
        if self.context_fn is None:
            return {}
        try:
            return dict(self.context_fn())
        except Exception as exc:  # context must not sink capture
            return {"contextError": f"{type(exc).__name__}: {exc}"}

    def _counters(self) -> dict[str, int] | None:
        return dict(self.counters_fn()) if self.counters_fn is not None else None

    def _counted(self, before: dict[str, int] | None) -> dict[str, Any]:
        if before is None:
            return {}
        after = self._counters()
        return {"launchesCounted": {k: after[k] - before.get(k, 0) for k in after}}

    def _window(self, body: Callable[[], Any]) -> dict[str, Any]:
        """Run ``body`` inside a started trace with the counters read at
        its edges: every launch counted ran while the trace recorded, so
        the trace holds at least as many; it may hold more, from launches
        already under way at the edges."""
        before = self._counters()
        self.capturing = True
        try:
            body()
        finally:
            self.capturing = False
        return self._counted(before)

    def _acquire(self) -> None:
        if not self._flight.acquire(blocking=False):
            if self._m_busy is not None:
                self._m_busy.inc()
            raise ProfileBusyError("a profile capture is already in flight")

    # -------------------------------------------------------------- capture
    def capture(
        self,
        ms: int | None = None,
        trigger: str = "manual",
        context: dict[str, Any] | None = None,
        parts: dict[str, Any] | None = None,
        texts: dict[str, str] | None = None,
    ) -> str:
        """Capture a bounded device trace (``ms`` clamped to ``[0,
        max_ms]``; 0 publishes a host-only bundle without a trace) and
        publish it. Blocking. Raises :class:`ProfileBusyError` when a
        capture is in flight, :class:`ProfileCaptureError` when the card's
        trace holds no kernel."""
        self._acquire()
        try:
            duration_ms = self.clamp_ms(ms)
            ctx = {**self._base_context(), **(context or {})}
            ctx["durationMs"] = duration_ms
            trace_dir: str | None = None
            if duration_ms > 0:
                trace_dir = tempfile.mkdtemp(prefix=".trace-", dir=self.store.ensure_dir())
                trace = _DeviceTrace(trace_dir, self.device)
                trace.start()
                try:
                    counted = self._window(lambda: time.sleep(duration_ms / 1000.0))
                finally:
                    trace.stop()
                self.last_kernels = trace.kernels
                self.last_counted = counted.get("launchesCounted")
                if self.device != "cpu":
                    _CUDA_READY.set()
                ctx.update(trace.context(), **counted)
            path = self.store.publish(
                trigger, context=ctx, parts=parts, texts=texts, trace_dir=trace_dir
            )
            if self._m_captures is not None:
                self._m_captures.inc(trigger=trigger)
                self._m_last_ms.set(float(duration_ms))
            return path
        except ProfileBusyError:
            raise
        except Exception:
            if self._m_errors is not None:
                self._m_errors.inc()
            raise
        finally:
            self._flight.release()

    def capture_alert(
        self,
        trigger: str,
        context: dict[str, Any] | None = None,
        parts: dict[str, Any] | None = None,
        texts: dict[str, str] | None = None,
    ) -> str | None:
        """The profile-on-alert entry: rate-limited per trigger kind, never
        raises into the failure path that called it (a failed capture is
        logged and counted in ``pio_profile_capture_errors_total``). A
        device trace only when ``alert_trace_ms`` > 0; the host-stack
        snapshot in ``parts``/``texts`` is the always-available evidence."""
        now = self._clock()
        with self._alert_lock:
            last = self._last_alert.get(trigger)
            if last is not None and now - last < self.alert_min_interval_s:
                return None
            self._last_alert[trigger] = now
        try:
            return self.capture(
                ms=self.alert_trace_ms, trigger=trigger, context=context, parts=parts, texts=texts
            )
        except ProfileBusyError:
            return None
        except Exception:
            logger.exception("profile-on-alert capture failed (%s)", trigger)
            return None

    @contextlib.contextmanager
    def trace(
        self,
        trigger: str = "train",
        context: dict[str, Any] | None = None,
        parts_fn: Callable[[], dict[str, Any]] | None = None,
    ):
        """Single-flight device trace around a long-running body (a
        train), unbounded by ``max_ms``. Yields a box whose ``"path"`` key
        holds the bundle path after exit (and ``"kernels"`` the trace's
        kernel counts); ``parts_fn`` runs at exit."""
        self._acquire()
        box: dict[str, Any] = {}
        try:
            trace_dir = tempfile.mkdtemp(prefix=".trace-", dir=self.store.ensure_dir())
            trace = _DeviceTrace(trace_dir, self.device)
            t0 = time.perf_counter()
            trace.start()
            before = self._counters()
            try:
                yield box
            finally:
                counted = self._counted(before)
                trace.stop()
            wall_ms = int((time.perf_counter() - t0) * 1000.0)
            self.last_kernels = box["kernels"] = trace.kernels
            if self.device != "cpu":
                _CUDA_READY.set()
            parts = dict(parts_fn() if parts_fn is not None else {})
            ctx = {**self._base_context(), **(context or {}), **trace.context(), **counted}
            ctx["durationMs"] = wall_ms
            box["path"] = self.store.publish(trigger, context=ctx, parts=parts, trace_dir=trace_dir)
            if self._m_captures is not None:
                self._m_captures.inc(trigger=trigger)
                self._m_last_ms.set(float(wall_ms))
        finally:
            self._flight.release()


@contextlib.contextmanager
def maybe_profile_train(
    context: dict[str, Any] | None = None,
    parts_fn: Callable[[], dict[str, Any]] | None = None,
    device: str = "cuda",
    counters_fn: Callable[[], dict[str, int]] | None = None,
):
    """The ``PIO_PROFILE_DIR`` gate: unset -> no-op (yields ``None``); set
    -> the train runs inside a device trace on ``device`` whose trace lands
    as a content-addressed bundle under that directory. Yields the
    session's box (``box["path"]`` after exit)."""
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield None
        return
    session = ProfileSession(ProfileStore(profile_dir), device=device, counters_fn=counters_fn)
    with session.trace(trigger="train", context=context, parts_fn=parts_fn) as box:
        yield box
    logger.info("training profile bundle written to %s", box.get("path"))


__all__ = [
    "DEFAULT_CAPTURE_MS",
    "MAX_CAPTURE_MS",
    "PROFILE_DIR_ENV",
    "ProfileBusyError",
    "ProfileCaptureError",
    "ProfileSession",
    "ProfileStore",
    "kernel_launches",
    "maybe_profile_train",
    "trace_kernels",
]
