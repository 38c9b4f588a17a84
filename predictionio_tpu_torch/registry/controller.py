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

The latency gate compares the two models on equal work. A lane's predict
time is taken once per micro-batch over that lane's share of the batch,
so it grows with the share: at a 0.9 split the candidate's batches are
nine times the stable's. The gate therefore scales every sample to one
common batch size along a cost shape, a fixed cost plus a per-row
cost, fitted to both lanes, or to each lane where their samples show two
shapes (:func:`matched_work_p95`), and compares the p95s there. Dividing
by the row count instead would make the small lane read slow, since a
batch has a fixed launch cost.

A p95 over a bake's few candidate batches is its largest sample or close
to it, so one slow batch would move it. The veto therefore also counts
the candidate's samples above ``max_p95_ratio`` times the stable's p95
(both at the common size) and needs a count that an equal candidate, 5 %
of whose samples lie above the stable's p95, reaches with probability
below 1 % (:func:`slow_batches_needed`). A candidate with too few samples
for any such count waits.

(Own copy of ``predictionio_tpu/registry/controller.py``: the same
verdicts on the same metric sequences, except the latency gate's. The
reference compares raw per-batch p95s and so vetoes an equal candidate
that serves most of the traffic, as the bandit's split does; ROADMAP
C16.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

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
    stable_predict_mark: int
    cand_predict_mark: int


# the relative per-row costs the latency gate's fit tries (0, then 1e-3 to
# 10 times a batch's fixed cost per row, log-spaced)
_KAPPAS = np.concatenate([[0.0], np.geomspace(1e-3, 10.0, 200)])
# F statistic (1 and many degrees of freedom, p = 0.001) above which the
# lanes' samples show two cost shapes rather than one
_SHAPES_DIFFER_F = 10.83
# distinct row counts a lane needs before it may have a shape of its own
_MIN_ROW_COUNTS = 3
# the latency veto's count: each sample of an equal candidate lies above the
# stable's p95 with probability TAIL_SHARE, and the count a veto needs is one
# such a lane reaches with probability below VETO_ALPHA
TAIL_SHARE = 0.05
VETO_ALPHA = 0.01


def slow_batches_needed(n: int) -> int | None:
    """The smallest k with P(Binomial(n, TAIL_SHARE) >= k) < VETO_ALPHA:
    how many of a candidate's n samples must be slow for the latency veto.
    None when no k <= n qualifies (n < 2): too few samples to judge."""
    p = TAIL_SHARE
    pmf = (1.0 - p) ** n  # P(X = 0)
    below = 0.0  # P(X < k)
    for k in range(1, n + 1):
        below += pmf
        if 1.0 - below < VETO_ALPHA:
            return k
        pmf *= (n - k + 1) / k * p / (1.0 - p)  # P(X = k)
    return None


def _shape_errors(rows: np.ndarray, secs: np.ndarray) -> np.ndarray:
    """For every kappa of the grid, the squared error of
    log secs = log m + log(1 + kappa * rows) with m at its least squares
    (log space: the noise of a timing is relative, and each sample counts
    alike whatever its lane's size)."""
    res = np.log(np.maximum(secs, 1e-12))[None, :] - np.log1p(_KAPPAS[:, None] * rows[None, :])
    res -= res.mean(axis=1, keepdims=True)
    return (res**2).sum(axis=1)


def _relative_row_costs(data: list[tuple[np.ndarray, np.ndarray]]) -> list[float]:
    """Each lane's kappa in the cost shape m_lane * (1 + kappa * r) of a
    batch of r rows.

    One kappa for every lane (a slower model that scales its fixed and its
    per-row cost alike), unless each lane saw at least three row counts and
    a kappa of each lane's own fits better than the shared one beyond noise
    (an F test of the one extra parameter at p = 0.001): then each lane
    keeps its own, so a model slower per row only reads slower at the
    common size, as it is. A lane that saw one or two row counts cannot
    tell its shape from its noise and takes the shared kappa."""
    errors = [_shape_errors(rows, secs) for rows, secs in data]
    total = np.sum(errors, axis=0)
    shared = int(np.argmin(total))
    own = [int(np.argmin(e)) for e in errors]
    n = sum(rows.size for rows, _ in data)
    if len(data) > 1 and n > 2 * len(data) and all(np.unique(rows).size >= _MIN_ROW_COUNTS for rows, _ in data):
        sse_shared = float(total[shared])
        sse_own = float(sum(e[i] for e, i in zip(errors, own)))
        dof = n - 2 * len(data)
        if sse_shared - sse_own > _SHAPES_DIFFER_F * (len(data) - 1) * max(sse_own, 1e-300) / dof:
            return [float(_KAPPAS[i]) for i in own]
    return [float(_KAPPAS[shared])] * len(data)


def matched_work_samples(lanes: list[list[tuple[int, float]]]) -> list[np.ndarray]:
    """Each lane's predict seconds scaled to one common batch size.

    ``lanes`` holds each lane's (rows, seconds) samples. Every sample is
    scaled along its lane's cost shape (:func:`_relative_row_costs`) to the
    common size, the mean of the lanes' mean row counts. The lanes share
    one shape, fitted from all their samples, unless their samples show
    two: a lane that saw few row counts (the small arm of a 0.05 split)
    cannot bend the shared one, as a slope of its own would. Samples of
    equal rows are not moved, so lanes served at one batch size are
    compared as they were measured. An empty array for a lane without
    samples."""
    data = [
        (np.asarray([r for r, _ in pairs], np.float64), np.asarray([t for _, t in pairs], np.float64))
        for pairs in lanes
    ]
    seen = [(rows, secs) for rows, secs in data if rows.size]
    if not seen:
        return [secs for _, secs in data]
    kappas = iter(_relative_row_costs(seen))
    common = float(np.mean([rows.mean() for rows, _ in seen]))
    out = []
    for rows, secs in data:
        if rows.size:
            kappa = next(kappas)
            secs = secs * (1.0 + kappa * common) / (1.0 + kappa * rows)
        out.append(secs)
    return out


def matched_work_p95(
    lanes: list[list[tuple[int, float]]], p95: Callable[[list[float]], float]
) -> list[float]:
    """Each lane's predict p95 at one common batch size: ``p95`` over the
    lane's :func:`matched_work_samples`, so the tail stays in. 0.0 for a
    lane without samples."""
    return [p95(secs.tolist()) if secs.size else 0.0 for secs in matched_work_samples(lanes)]


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
            stable_predict_mark=self.instruments.predict_mark(stable_version),
            cand_predict_mark=self.instruments.predict_mark(candidate_version),
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
        # candidate must not be judged on a previous bake's latency; both
        # lanes at one batch size — the split must not read as latency;
        # more slow batches than an equal lane's tail gives) ---------------
        read = self.latency_read()
        cand_p95, stable_p95 = read["candidate_p95"], read["stable_p95"]
        if cand_p95 > 0 and stable_p95 > 0:
            if read["slow_needed"] is None:
                return (
                    VERDICT_WAIT,
                    f"latency gate: {read['samples']} candidate batch(es), too few to judge",
                )
            if cand_p95 > stable_p95 * c.max_p95_ratio and read["slow"] >= read["slow_needed"]:
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

    def latency_read(self) -> dict:
        """What the latency gate reads over this bake's samples, both lanes
        at the common batch size of :func:`matched_work_samples`: each
        lane's predict p95 (the histogram's, 0.0 for a lane without
        samples), the candidate's sample count, how many of them lie above
        ``max_p95_ratio`` times the stable's exact p95 (``slow``), and the
        count a veto needs (:func:`slow_batches_needed`)."""
        b = self._baseline
        if b is None:
            return {"candidate_p95": 0.0, "stable_p95": 0.0, "samples": 0, "slow": 0, "slow_needed": None}
        cand, stable = matched_work_samples([
            self.instruments.predict_samples_since(b.candidate_version, b.cand_predict_mark),
            self.instruments.predict_samples_since(b.stable_version, b.stable_predict_mark),
        ])
        slow = 0
        if cand.size and stable.size:
            slow = int((cand > self.criteria.max_p95_ratio * float(np.percentile(stable, 95))).sum())
        # pio-lint: disable=hostsync-serving-path -- host numpy arrays of latency samples, no tensor
        cand_p95, stable_p95 = (self.instruments.p95_of(x.tolist()) if x.size else 0.0 for x in (cand, stable))
        return {
            "candidate_p95": cand_p95,
            "stable_p95": stable_p95,
            "samples": int(cand.size),
            "slow": slow,
            "slow_needed": slow_batches_needed(int(cand.size)),
        }

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
