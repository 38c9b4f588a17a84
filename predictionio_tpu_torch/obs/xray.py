"""The step profiler (port of ``TrainProfile`` and its context helpers in
``predictionio_tpu/obs/xray.py``; the capacity planner and the sharding
inspector are not ported).

A :class:`TrainProfile` records a run's phases with exclusive-time nesting
and monotonic wall time; the phases tile the measured wall clock, which the
offline pipeline's and the grid's contract tests hold. Profiles flow through
a contextvar (:func:`use_profile` / :func:`current_profile`), and the
module-level :func:`phase` no-ops when nothing is recording. Where the JAX
package fetches a derived scalar as its device barrier,
:meth:`TrainProfile.device_barrier` synchronises the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import Any, Callable, Iterator

import torch

from predictionio_tpu_torch.obs.metrics import MetricsRegistry

PHASE_HOST_ETL = "host_etl"  # event-store reads, preparation
PHASE_SWEEP = "sweep"  # fold-in absorbs of the stream pipeline
PHASE_SOLVE = "solve"  # whole-algorithm train
PHASE_EVAL = "eval"  # held-out scoring


@dataclasses.dataclass
class _PhaseAgg:
    wall_s: float = 0.0
    device_s: float = 0.0
    count: int = 0


def register_train_metrics(registry: MetricsRegistry) -> dict[str, Any]:
    """Get-or-create the ``pio_train_*`` family (idempotent)."""
    return {
        "phase": registry.histogram(
            "pio_train_phase_seconds",
            "per-occurrence phase wall time (exclusive/self time)",
            labelnames=("trainer", "phase"),
        ),
        "device": registry.counter(
            "pio_train_device_seconds_total",
            "device waits accounted inside phases",
            labelnames=("trainer", "phase"),
        ),
        "rows": registry.counter(
            "pio_train_rows_total", "rows processed", labelnames=("trainer",)
        ),
        "active": registry.gauge(
            "pio_train_active", "1 while the profile is measuring", labelnames=("trainer",)
        ),
    }


class TrainProfile:
    """One run's recorder. Wall clock accumulates only inside
    :meth:`measure`; phases nest with self-time semantics, so a nested
    phase is never counted twice. Not thread-safe: one profile per loop."""

    def __init__(
        self,
        trainer: str,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.trainer = trainer
        self.registry = registry
        self._clock = clock
        self.phases: dict[str, _PhaseAgg] = {}
        self.rows_total = 0
        self.device_s = 0.0
        self.peak_device_bytes = 0
        self.finished = False
        self._wall_s = 0.0
        self._measure_t0: float | None = None
        self._phase_stack: list[list[Any]] = []  # [name, t0, child_elapsed]
        self._m = register_train_metrics(registry) if registry is not None else None

    # -- measuring -------------------------------------------------------------
    def resume(self) -> None:
        if self.finished or self._measure_t0 is not None:
            return
        self._measure_t0 = self._clock()
        if self._m is not None:
            self._m["active"].set(1.0, trainer=self.trainer)

    def pause(self) -> None:
        if self._measure_t0 is None:
            return
        self._wall_s += self._clock() - self._measure_t0
        self._measure_t0 = None
        if self._m is not None:
            self._m["active"].set(0.0, trainer=self.trainer)

    @contextlib.contextmanager
    def measure(self) -> Iterator["TrainProfile"]:
        self.resume()
        try:
            yield self
        finally:
            self.pause()

    @property
    def wall_s(self) -> float:
        if self._measure_t0 is not None:
            return self._wall_s + (self._clock() - self._measure_t0)
        return self._wall_s

    @property
    def attributed_s(self) -> float:
        """Wall time covered by phases: the tiling contract's numerator."""
        return sum(p.wall_s for p in self.phases.values())

    # -- phases ----------------------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        frame: list[Any] = [name, self._clock(), 0.0]
        self._phase_stack.append(frame)
        try:
            yield
        finally:
            self._phase_stack.pop()
            elapsed = self._clock() - frame[1]
            self_s = max(0.0, elapsed - frame[2])
            if self._phase_stack:
                self._phase_stack[-1][2] += elapsed
            agg = self.phases.setdefault(name, _PhaseAgg())
            agg.wall_s += self_s
            agg.count += 1
            if self._m is not None:
                self._m["phase"].observe(self_s, trainer=self.trainer, phase=name)

    def add_rows(self, n: int) -> None:
        self.rows_total += int(n)
        if self._m is not None:
            self._m["rows"].inc(int(n), trainer=self.trainer)

    # -- device time -----------------------------------------------------------
    def note_device_time(self, seconds: float) -> None:
        seconds = max(0.0, seconds)
        self.device_s += seconds
        phase = self._phase_stack[-1][0] if self._phase_stack else "unattributed"
        self.phases.setdefault(phase, _PhaseAgg()).device_s += seconds
        if self._m is not None:
            self._m["device"].inc(seconds, trainer=self.trainer, phase=phase)

    def device_barrier(self, device: str | torch.device) -> None:
        """Wait for every kernel queued on ``device`` and account the wait
        to the current phase (a no-op wait on the CPU)."""
        t0 = self._clock()
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            self.peak_device_bytes = max(
                self.peak_device_bytes, torch.cuda.max_memory_allocated(dev)
            )
        self.note_device_time(self._clock() - t0)

    # -- finish ----------------------------------------------------------------
    def finish(self) -> "TrainProfile":
        """Stop the clock; idempotent."""
        if not self.finished:
            self.pause()
            self.finished = True
        return self

    def to_json_dict(self) -> dict[str, Any]:
        wall = self.wall_s
        attributed = self.attributed_s
        return {
            "trainer": self.trainer,
            "wallClockS": round(wall, 6),
            "attributedS": round(attributed, 6),
            "deviceS": round(self.device_s, 6),
            "rowsTotal": self.rows_total,
            "rowsPerS": round(self.rows_total / wall, 2) if wall > 0 else 0.0,
            "phases": {
                name: {
                    "count": agg.count,
                    "wallS": round(agg.wall_s, 6),
                    "deviceS": round(agg.device_s, 6),
                    "meanS": round(agg.wall_s / agg.count, 6) if agg.count else 0.0,
                }
                for name, agg in sorted(self.phases.items())
            },
            "peakDeviceBytes": self.peak_device_bytes,
        }


_CURRENT: contextvars.ContextVar[TrainProfile | None] = contextvars.ContextVar(
    "pio_train_profile", default=None
)


def current_profile() -> TrainProfile | None:
    prof = _CURRENT.get()
    return None if prof is not None and prof.finished else prof


@contextlib.contextmanager
def use_profile(profile: TrainProfile) -> Iterator[TrainProfile]:
    token = _CURRENT.set(profile)
    try:
        yield profile
    finally:
        _CURRENT.reset(token)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Record into the current profile; a no-op when nothing records."""
    prof = current_profile()
    if prof is None:
        yield
        return
    with prof.phase(name):
        yield
