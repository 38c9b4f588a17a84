"""The bandit loop: glue between policy, reward accounting, the registry
artifact grammar, and the serving tier's rollout state machine.

The QueryServer drives it from the SAME heartbeat as the bake gate
(``_rollout_tick``): the bake gate keeps its veto on errors/latency (a
reward-winning arm that 5xxes still rolls back), while the bandit owns
the promote decision and the live traffic split — the bake gate doubling
as reward accounting. All decisions route through the existing
promote/rollback transitions, so a losing arm retires with zero
client-visible 5xx by construction (candidate failures already re-answer
on stable).

The port's own copy of ``predictionio_tpu/bandit/controller.py``.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

import numpy as np

from predictionio_tpu_torch.bandit.policy import (
    ARM_CANDIDATE,
    ARM_STABLE,
    ArmState,
    BanditCriteria,
    BanditDecision,
    decide,
    make_policy,
    regret_proxy,
)
from predictionio_tpu_torch.bandit.rewards import ImpressionLog, RewardTailer

logger = logging.getLogger(__name__)


class BanditLoop:
    """One two-arm bandit per live rollout. Inactive between rollouts."""

    def __init__(
        self,
        policy_name: str,
        *,
        epsilon: float = 0.1,
        criteria: BanditCriteria | None = None,
        instruments=None,
        store=None,  # registry ArtifactStore (posterior persistence)
        engine_id: str | None = None,
        impression_capacity: int = 65536,
        seed: int = 0,
    ):
        self.policy = make_policy(policy_name, epsilon)
        self.criteria = criteria or BanditCriteria()
        self.instruments = instruments
        self.store = store
        self.engine_id = engine_id
        self.impressions = ImpressionLog(impression_capacity)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._stable: ArmState | None = None
        self._candidate: ArmState | None = None
        self._tailer: RewardTailer | None = None
        self._dirty = False
        self._evicted_seen = 0

    # ----------------------------------------------------------- lifecycle
    @property
    def active(self) -> bool:
        return self._candidate is not None

    def begin(
        self, stable_version: str, candidate_version: str, tailer: RewardTailer
    ) -> None:
        """Arm the bandit for a freshly staged candidate. A persisted
        posterior for the SAME (stable, candidate) pair resumes — a
        serving restart mid-experiment must not forget paid-for evidence."""
        with self._lock:
            stable = ArmState(stable_version, ARM_STABLE)
            candidate = ArmState(candidate_version, ARM_CANDIDATE)
            saved = (
                self.store.load_bandit_state(self.engine_id)
                if self.store is not None and self.engine_id is not None
                else None
            )
            if saved and not saved.get("ended"):
                s = ArmState.from_json_dict(saved.get("stable", {}))
                c = ArmState.from_json_dict(saved.get("candidate", {}))
                if (
                    s.version == stable_version
                    and c.version == candidate_version
                ):
                    stable, candidate = s, c
                    logger.info(
                        "bandit resumed persisted posterior (%g/%g stable, "
                        "%g/%g candidate)",
                        s.rewards, s.pulls, c.rewards, c.pulls,
                    )
            self._stable, self._candidate = stable, candidate
            self._tailer = tailer
            self._dirty = True
        if self.instruments is not None:
            self.instruments.active.set(1.0)

    def end(self, outcome: str) -> None:
        """Rollout finished (promote | retire | rollback | unstage): count
        the terminal verdict, persist the final posterior for audit, and
        disarm."""
        with self._lock:
            state = self._snapshot_locked()
            self._stable = self._candidate = None
            self._tailer = None
            self._dirty = False
        ins = self.instruments
        if ins is not None:
            ins.active.set(0.0)
            if outcome == "promote":
                ins.promoted.inc()
            elif outcome in ("retire", "rollback"):
                ins.retired.inc()
        if self.store is not None and self.engine_id is not None and state:
            state["ended"] = outcome
            try:
                self.store.save_bandit_state(self.engine_id, state)
            except OSError:
                logger.warning("bandit state save failed", exc_info=True)

    # ------------------------------------------------------------- serving
    def record_impression(self, trace_id: str, arm: str, version: str) -> None:
        """Hot-path accounting for one answered request: the impression
        is a pull the moment it is served (unrewarded impressions decay
        the posterior mean — CTR semantics), and the trace id becomes
        matchable for later feedback."""
        with self._lock:
            target = (
                self._candidate
                if arm == ARM_CANDIDATE
                else self._stable
            )
            if target is None or target.version != version:
                return  # raced a promote/rollback; not this rollout's pull
            target.pulls += 1.0
            self._dirty = True
        self.impressions.record(trace_id, arm, version)
        if self.instruments is not None:
            self.instruments.pulls.inc(arm=arm)

    # ---------------------------------------------------------------- tick
    def tick(self) -> BanditDecision | None:
        """One heartbeat: drain new feedback, credit posteriors, choose
        the traffic fraction, and report the reward verdict. Persists the
        posterior when it changed (atomic content-addressed write)."""
        with self._lock:
            stable, candidate, tailer = self._stable, self._candidate, self._tailer
            if stable is None or candidate is None or tailer is None:
                return None
        credits, unmatched = tailer.poll(self.impressions)
        ins = self.instruments
        with self._lock:
            if self._candidate is not candidate:
                return None  # rollout flipped underneath the poll
            for arm_name, version, reward in credits:
                target = candidate if arm_name == ARM_CANDIDATE else stable
                if target.version != version:
                    unmatched += 1
                    continue
                target.rewards += reward
                self._dirty = True
                if ins is not None:
                    ins.rewards.inc(reward, arm=arm_name)
                    ins.matched.inc()
            fraction = self.policy.fraction(
                stable, candidate, self.criteria, self._rng
            )
            decision = decide(
                stable, candidate, self.criteria, fraction, self._rng
            )
            dirty, self._dirty = self._dirty, False
            state = self._snapshot_locked() if dirty else None
        if ins is not None:
            if unmatched:
                ins.unmatched.inc(unmatched)
            evicted = self.impressions.evicted
            if evicted > self._evicted_seen:
                ins.evicted.inc(evicted - self._evicted_seen)
                self._evicted_seen = evicted
            ins.sync_arms((stable, candidate))
            ins.fraction.set(decision.fraction)
            ins.p_better.set(
                decision.p_better if decision.p_better is not None else -1.0
            )
            ins.regret_pulls.set(regret_proxy(stable, candidate))
        if state is not None and self.store is not None and self.engine_id:
            try:
                self.store.save_bandit_state(self.engine_id, state)
            except OSError:
                logger.warning("bandit state save failed", exc_info=True)
        return decision

    # ------------------------------------------------------------ snapshot
    def _snapshot_locked(self) -> dict[str, Any]:
        if self._stable is None or self._candidate is None:
            return {}
        return {
            "policy": self.policy.name,
            "epsilon": self.policy.epsilon,
            "stable": self._stable.to_json_dict(),
            "candidate": self._candidate.to_json_dict(),
        }

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready view for the status endpoint and ``pio top``."""
        with self._lock:
            out = self._snapshot_locked()
            out["active"] = self.active
            out["impressions_pending"] = len(self.impressions)
            return out
