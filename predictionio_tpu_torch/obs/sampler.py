"""Always-on host sampling profiler: folded stacks by thread role.

The device trace (``obs/profiler``) answers "where did the *device* time
go"; this module answers the other half — where the *host* threads are
when a query is slow. A daemon thread wakes every ``period_s`` and walks
``sys._current_frames()``, attributing each thread's stack to a serving
role (HTTP handler / collect / dispatch / fetch / finish / shadow /
sniffer / background HTTP / stream) through a thread-*name* registry — the
port's query server names its workers ``pio-collect``, ``pio-dispatch``,
``pio-fetch``, ``pio-finish``, ``pio-shadow``, ``pio-sniffer`` and
``pio-bg-http``, and its ``ThreadingHTTPServer`` handler threads are
renamed ``pio-handler`` when they take a request (see
``workflow/create_server.py``), so attribution costs one prefix match, no
instrumentation in the hot path. The port's own copy of
``predictionio_tpu/obs/sampler.py``; the JAX package's map names aiohttp's
event loop, which the port does not have.

Samples aggregate into **folded stacks** (the flamegraph interchange
format: ``role;frame;frame;leaf count`` per line, leaf last) inside a
bounded window ring: the current window rotates every ``window_s`` and
the ring keeps the newest ``ring_windows`` windows, so ``snapshot()``
always covers roughly the last ``ring_windows * window_s`` seconds with
hard memory bounds (``max_stacks`` distinct stacks per window; overflow
collapses into a ``<other>`` leaf rather than growing).

The sampler measures its own cost: every sampling pass's wall time
accumulates into a busy counter, and ``overhead_frac()`` = busy / elapsed
is exported as the ``pio_profile_sampler_overhead_frac`` gauge — the
"always-on" claim is held by measurement (<1% CPU at the default 20 Hz
period; asserted in ``tests/test_torch_profiler.py``). The port's HTTP
servers run a thread per connection, so a pass over every thread of 512
connected clients costs tens of times one over 16: on an H100 host the
JAX sampler's fixed period over every thread slowed a burst of 512
clients until the admission queue stopped reaching its high water. So a
pass walks at most ``MAX_THREADS_PER_ROLE`` threads of one role (a
rotating slice), and the wait after a pass stretches past the period
when the pass was dear, keeping passes within ``OVERHEAD_BUDGET``.

Standard library only: the event server uses it without importing torch.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable

# thread-name prefix -> role, first match wins (checked in order). The
# names are the contract: the port's serving threads are created (or, for
# the ThreadingHTTPServer's per-connection threads, renamed) with these
# prefixes; MainThread is the process's own (the CLI's wait loop, a test).
DEFAULT_ROLES: tuple[tuple[str, str], ...] = (
    ("pio-handler", "http-handler"),  # ThreadingHTTPServer request threads
    ("pio-http", "http-listener"),  # serve_forever: accept()
    ("pio-events", "http-listener"),
    ("pio-collect", "collect"),
    ("pio-dispatch", "dispatch"),
    ("pio-fetch", "fetch"),
    ("pio-finish", "finish"),
    ("pio-shadow", "shadow"),
    ("pio-sniffer", "sniffer"),
    ("pio-bg-http", "feedback"),  # feedback and remote-log POSTs
    ("pio-stream", "stream"),
    ("pio-rollout", "rollout"),
    ("pio-registry-sync", "rollout"),
    ("pio-sampler", "sampler"),
    ("MainThread", "main"),
    ("ThreadPoolExecutor", "executor"),
)

OTHER_LEAF = "<other>"
# the share of wall time the sampler's passes may take (the JAX package's
# always-on budget, which its fixed period meets for its few threads)
OVERHEAD_BUDGET = 0.01
# the threads of one role walked in one pass (the rest rotate in later)
MAX_THREADS_PER_ROLE = 16


def _frame_label(frame) -> str:
    """Compact ``module.function`` frame label (file basename, no .py):
    stable across hosts — absolute paths and line numbers would make the
    folded key differ per checkout and defeat aggregation."""
    code = frame.f_code
    mod = os.path.basename(code.co_filename)
    if mod.endswith(".py"):
        mod = mod[:-3]
    return f"{mod}.{code.co_name}"


class HostSampler:
    """Interval stack sampler with role attribution and a window ring.

    Thread-safe; ``start()``/``stop()`` are idempotent. All reads
    (``snapshot``, ``folded``, ``hotspots``, ``overhead_frac``) are safe
    while sampling runs.
    """

    def __init__(
        self,
        period_s: float = 0.05,
        *,
        max_depth: int = 40,
        max_stacks: int = 512,
        window_s: float = 60.0,
        ring_windows: int = 5,
        roles: tuple[tuple[str, str], ...] = DEFAULT_ROLES,
        metrics: Any | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.period_s = max(0.001, float(period_s))
        self.max_depth = int(max_depth)
        self.max_stacks = int(max_stacks)
        self.window_s = float(window_s)
        self._roles = tuple(roles)
        self._clock = clock
        self._lock = threading.Lock()
        self._window: dict[str, int] = {}
        self._ring: deque[dict[str, int]] = deque(maxlen=max(1, ring_windows))
        self._window_started = clock()
        self._started_at: float | None = None
        self._busy_s = 0.0
        self._samples = 0
        self._truncated = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        if metrics is not None:
            self._m_samples = metrics.counter(
                "pio_profile_sampler_samples_total",
                "host sampling passes taken by the always-on stack sampler",
            )
            self._m_overhead = metrics.gauge(
                "pio_profile_sampler_overhead_frac",
                "self-measured sampler cost: sampling wall time / elapsed "
                "wall time since start (the <1% always-on budget)",
            )
            self._m_overhead.set_function(self.overhead_frac)
            self._m_stacks = metrics.gauge(
                "pio_profile_sampler_stacks",
                "distinct folded stacks currently held across the window "
                "ring (bounded by max_stacks per window)",
            )
            self._m_stacks.set_function(lambda: float(len(self._merged())))
        else:
            self._m_samples = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._started_at = self._clock()
            self._busy_s = 0.0
            self._thread = threading.Thread(
                target=self._run, name="pio-sampler", daemon=True
            )
            self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        thread = self._thread
        self._stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        thread = self._thread
        return thread is not None and thread.is_alive()

    def _run(self) -> None:
        wait = self.period_s
        while not self._stop.wait(wait):
            t0 = time.perf_counter()
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - the sampler must never die
                pass
            wait = self.next_wait(time.perf_counter() - t0)

    def next_wait(self, busy_s: float) -> float:
        """The wait after a pass of ``busy_s``: the period, or longer when
        the pass was dear. A pass walks every thread, and the port's HTTP
        servers run one thread per connection, so this keeps the passes
        within ``OVERHEAD_BUDGET`` whatever the connection count."""
        return max(self.period_s, busy_s / OVERHEAD_BUDGET - busy_s)

    # ------------------------------------------------------------- sampling
    def role_of(self, thread_name: str) -> str:
        for prefix, role in self._roles:
            if thread_name.startswith(prefix):
                return role
        return "other"

    def sample_once(self) -> int:
        """One sampling pass over every live thread except the sampler
        itself; returns the number of stacks recorded. Public so tests
        (and the bench overhead probe) can drive it deterministically."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        recorded = 0
        folded_keys: list[str] = []
        by_role: dict[str, list] = {}
        for ident, frame in frames.items():
            if ident == me:
                continue
            role = self.role_of(names.get(ident, "?"))
            if role != "sampler":
                by_role.setdefault(role, []).append(frame)
        walked = []
        for role, role_frames in by_role.items():
            n = len(role_frames)
            if n > MAX_THREADS_PER_ROLE:
                # a thread per connection: walk a rotating slice of the
                # role's threads, so a pass costs the same at 16 clients
                # as at 512
                start = (self._samples * MAX_THREADS_PER_ROLE) % n
                role_frames = (role_frames + role_frames)[start:start + MAX_THREADS_PER_ROLE]
            walked.extend((role, frame) for frame in role_frames)
        for role, frame in walked:
            stack: list[str] = []
            depth = 0
            while frame is not None and depth < self.max_depth:
                stack.append(_frame_label(frame))
                frame = frame.f_back
                depth += 1
            stack.reverse()  # folded format: root first, leaf last
            folded_keys.append(role + ";" + ";".join(stack))
            recorded += 1
        busy = time.perf_counter() - t0
        now = self._clock()
        with self._lock:
            if now - self._window_started >= self.window_s and self._window:
                self._ring.append(self._window)
                self._window = {}
                self._window_started = now
            for key in folded_keys:
                if key in self._window or len(self._window) < self.max_stacks:
                    self._window[key] = self._window.get(key, 0) + 1
                else:
                    # bounded: collapse overflow under the role's <other>
                    role = key.split(";", 1)[0]
                    other = f"{role};{OTHER_LEAF}"
                    self._window[other] = self._window.get(other, 0) + 1
                    self._truncated += 1
            self._busy_s += busy
            self._samples += 1
        if self._m_samples is not None:
            self._m_samples.inc()
        return recorded

    # --------------------------------------------------------------- views
    def _merged(self) -> dict[str, int]:
        with self._lock:
            windows = list(self._ring) + [self._window]
        merged: dict[str, int] = {}
        for window in windows:
            for key, count in window.items():
                merged[key] = merged.get(key, 0) + count
        return merged

    def overhead_frac(self) -> float:
        with self._lock:
            started, busy = self._started_at, self._busy_s
        if started is None:
            return 0.0
        elapsed = self._clock() - started
        if elapsed <= 0:
            return 0.0
        return busy / elapsed

    def snapshot(self) -> dict[str, Any]:
        """The ``GET /profile/stacks?format=json`` payload: folded stacks
        plus role totals and the self-measured overhead."""
        merged = self._merged()
        roles: dict[str, int] = {}
        for key, count in merged.items():
            role = key.split(";", 1)[0]
            roles[role] = roles.get(role, 0) + count
        with self._lock:
            samples, truncated = self._samples, self._truncated
        return {
            "periodS": self.period_s,
            "samples": samples,
            "truncated": truncated,
            "overheadFrac": self.overhead_frac(),
            "roles": roles,
            "stacks": merged,
        }

    def folded(self) -> str:
        """Flamegraph-ready folded text: ``stack count`` lines, hottest
        first — pipe straight into ``flamegraph.pl`` or speedscope."""
        merged = self._merged()
        lines = [
            f"{key} {count}"
            for key, count in sorted(merged.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def hotspots(self, top_n: int = 3) -> dict[str, list[dict[str, Any]]]:
        """Per-role top leaf frames (the ``pio top --hotspots`` table):
        role -> [{"frame": leaf, "count": n, "frac": of-role}, ...]."""
        merged = self._merged()
        by_role: dict[str, dict[str, int]] = {}
        totals: dict[str, int] = {}
        for key, count in merged.items():
            role, _, rest = key.partition(";")
            leaf = rest.rsplit(";", 1)[-1] if rest else OTHER_LEAF
            by_role.setdefault(role, {})
            by_role[role][leaf] = by_role[role].get(leaf, 0) + count
            totals[role] = totals.get(role, 0) + count
        out: dict[str, list[dict[str, Any]]] = {}
        for role, leaves in by_role.items():
            total = totals[role] or 1
            ranked = sorted(leaves.items(), key=lambda kv: -kv[1])[:top_n]
            out[role] = [
                {"frame": leaf, "count": count, "frac": round(count / total, 4)}
                for leaf, count in ranked
            ]
        return out


__all__ = ["DEFAULT_ROLES", "HostSampler", "OTHER_LEAF"]
