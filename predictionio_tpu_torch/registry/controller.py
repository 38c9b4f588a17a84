"""Rollout controller: metric-gated promote / rollback decisions.

The controller turns the per-version serving metrics
(:class:`~predictionio_tpu_torch.registry.router.RolloutInstruments`) into one
of four verdicts for the active candidate:

- ``wait``     — bake window or minimum sample size not reached yet;
- ``promote``  — candidate matched or beat stable across every gate;
- ``rollback`` — candidate breached a gate (error rate, p95 latency, or
  shadow divergence), with the breached gate in the reason;
- ``ready``    — gates passed but auto-promotion is disabled (an operator
  promotes via ``pio models promote`` / ``POST /models/promote``).

It is deliberately *pure decision logic*: the QueryServer owns applying
the verdict (swapping lanes, persisting registry state) and the candidate
lane's circuit breaker provides the fast path — a breaker trip forces an
instant rollback without waiting for the next evaluation tick.

Stable-lane counters accumulate across rollouts, so every comparison uses
deltas since the candidate was staged — the two models are judged on the
same traffic window.

(Own copy of ``predictionio_tpu/registry/controller.py``: the same
verdicts on the same metric sequences.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from predictionio_tpu_torch.registry.router import RolloutInstruments

VERDICT_IDLE = "idle"
VERDICT_WAIT = "wait"
VERDICT_PROMOTE = "promote"
VERDICT_ROLLBACK = "rollback"
VERDICT_READY = "ready"


@dataclasses.dataclass(frozen=True)
class PromotionCriteria:
    """The promotion-gate knobs (docs/model_registry.md)."""

    # candidate must bake at least this long AND serve at least this many
    # queries (shadow: score this many) before any verdict
    bake_window_s: float = 60.0
    min_requests: int = 20
    # error-rate gate: candidate rate may not exceed
    # stable_rate * max_error_ratio + error_rate_floor (the floor keeps a
    # perfect stable lane from making a single candidate error fatal)
    max_error_ratio: float = 2.0
    error_rate_floor: float = 0.02
    # latency gate: candidate predict p95 may not exceed stable's by this
    # factor (only enforced once both versions have predict samples)
    max_p95_ratio: float = 1.5
    # shadow gate: fraction of shadow-scored queries whose result diverged
    max_divergence_rate: float = 0.25
    auto_promote: bool = True


@dataclasses.dataclass
class _Baseline:
    stable_version: str
    candidate_version: str
    mode: str
    staged_at: float
    stable_requests: float
    stable_errors: float
    cand_requests: float
    cand_errors: float
    shadow_scored: float
    divergence: float
    stable_predict_counts: list
    cand_predict_counts: list


class RolloutController:
    def __init__(
        self,
        instruments: RolloutInstruments,
        criteria: PromotionCriteria | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.instruments = instruments
        self.criteria = criteria or PromotionCriteria()
        self._clock = clock
        self._baseline: _Baseline | None = None

    # ----------------------------------------------------------- lifecycle
    def begin(self, stable_version: str, candidate_version: str, mode: str) -> None:
        """Snapshot both lanes' counters at stage time; every later
        comparison is a delta against this point."""
        stable = self.instruments.lane_counts(stable_version)
        cand = self.instruments.lane_counts(candidate_version)
        self._baseline = _Baseline(
            stable_version=stable_version,
            candidate_version=candidate_version,
            mode=mode,
            staged_at=self._clock(),
            stable_requests=stable["requests"],
            stable_errors=stable["errors"],
            cand_requests=cand["requests"],
            cand_errors=cand["errors"],
            shadow_scored=cand["shadow_scored"],
            divergence=cand["divergence"],
            stable_predict_counts=self.instruments.predict_bucket_counts(
                stable_version
            ),
            cand_predict_counts=self.instruments.predict_bucket_counts(
                candidate_version
            ),
        )

    def end(self) -> None:
        self._baseline = None

    @property
    def active(self) -> bool:
        return self._baseline is not None

    # ------------------------------------------------------------ verdicts
    def evaluate(self) -> tuple[str, str]:
        """One (verdict, reason) pair; call on a timer or on demand."""
        b = self._baseline
        c = self.criteria
        if b is None:
            return VERDICT_IDLE, "no rollout active"
        stable = self.instruments.lane_counts(b.stable_version)
        cand = self.instruments.lane_counts(b.candidate_version)
        stable_n = stable["requests"] - b.stable_requests
        stable_err = stable["errors"] - b.stable_errors
        cand_n = cand["requests"] - b.cand_requests
        cand_err = cand["errors"] - b.cand_errors
        scored = cand["shadow_scored"] - b.shadow_scored
        diverged = cand["divergence"] - b.divergence
        # the candidate's sample is real traffic in canary mode, async
        # shadow scores in shadow mode
        sample_n = scored if b.mode == "shadow" else cand_n
        sample_err = cand_err
        elapsed = self._clock() - b.staged_at
        if elapsed < c.bake_window_s or sample_n < c.min_requests:
            return (
                VERDICT_WAIT,
                f"baking: {sample_n:.0f}/{c.min_requests} queries, "
                f"{elapsed:.1f}/{c.bake_window_s:.1f}s",
            )
        # -- error-rate gate ------------------------------------------------
        cand_rate = sample_err / sample_n if sample_n else 0.0
        stable_rate = stable_err / stable_n if stable_n else 0.0
        allowed = stable_rate * c.max_error_ratio + c.error_rate_floor
        if cand_rate > allowed:
            return (
                VERDICT_ROLLBACK,
                f"error-rate gate: candidate {cand_rate:.3f} > allowed "
                f"{allowed:.3f} (stable {stable_rate:.3f})",
            )
        # -- latency gate (windowed: this bake's samples only — a re-staged
        # candidate must not be judged on a previous bake's latency) -------
        cand_p95 = self.instruments.p95_since(
            b.candidate_version, b.cand_predict_counts
        )
        stable_p95 = self.instruments.p95_since(
            b.stable_version, b.stable_predict_counts
        )
        if cand_p95 > 0 and stable_p95 > 0 and cand_p95 > stable_p95 * c.max_p95_ratio:
            return (
                VERDICT_ROLLBACK,
                f"latency gate: candidate p95 {cand_p95 * 1e3:.1f}ms > "
                f"{c.max_p95_ratio:.2f}x stable {stable_p95 * 1e3:.1f}ms",
            )
        # -- divergence gate (shadow only) ----------------------------------
        if b.mode == "shadow" and scored > 0:
            div_rate = diverged / scored
            if div_rate > c.max_divergence_rate:
                return (
                    VERDICT_ROLLBACK,
                    f"divergence gate: {div_rate:.3f} of shadow traffic "
                    f"diverged (> {c.max_divergence_rate:.3f})",
                )
        reason = (
            f"gates passed over {sample_n:.0f} queries "
            f"(err {cand_rate:.3f} vs stable {stable_rate:.3f})"
        )
        if not c.auto_promote:
            return VERDICT_READY, reason
        return VERDICT_PROMOTE, reason

    def snapshot(self) -> dict:
        """JSON-ready controller state for /models and `pio models show`."""
        b = self._baseline
        out: dict = {"active": b is not None, "criteria": dataclasses.asdict(self.criteria)}
        if b is not None:
            verdict, reason = self.evaluate()
            out.update(
                {
                    "stable": b.stable_version,
                    "candidate": b.candidate_version,
                    "mode": b.mode,
                    "elapsed_s": round(self._clock() - b.staged_at, 3),
                    "verdict": verdict,
                    "reason": reason,
                }
            )
        return out
