"""The lifecycle decision engine: drift → retune → bake → promote → warm.

The lifecycle control plane closes the loop the existing subsystems
left open: stream drift guards detect that the serving model went
stale, the evaluation grid can find a better one, the bake gates
can judge it, and nightly batchpredict can pre-warm it —
but until now a human typed every command in between. This module is the
*policy* half of the controller: a pure state machine in the autoscaler's
idiom (fleet/autoscaler.py ``ScalingPolicy``) — every method takes an
explicit ``now``, all inputs arrive as plain values (ring records,
registry state, grid status), and tests drive every branch with a fake
clock and hand-built records, no processes anywhere.

States (the episode)::

    IDLE ──trigger (drift|cadence|manual)──▶ TRIGGERED
        TRIGGERED ──rollout active──▶ (DEFERRED, stays TRIGGERED)
        TRIGGERED ──clear──▶ TUNING          (grid launched)
    TUNING ──winner staged──▶ BAKING         (bake gates own it now)
    TUNING ──failed / no winner / timeout──▶ ABORTED
    BAKING ──registry stable == winner──▶ PROMOTED  (then cache warm)
    BAKING ──rollout off, stable != winner──▶ ROLLED_BACK
    BAKING ──timeout──▶ ABORTED              (controller unstages)

PROMOTED / ROLLED_BACK / ABORTED are terminal *outcomes*: the episode
ends, the policy returns to IDLE, and the cooldown clock starts. The
mid-bake deferral is an EPISODE exactly like the autoscaler's resize
deferral: one DEFER decision when the episode starts, HOLD afterwards,
so the deferred counter counts retunes deferred, not ticks spent baking
— and a grid run is NEVER started while a rollout bakes (the
never-concurrent rule the chaos e2e asserts).

The policy is serializable (:meth:`LifecyclePolicy.to_json_dict` /
``from_json_dict``) — the controller persists it tmp+rename after every
transition so a SIGKILLed controller resumes its episode, including a
TUNING run picked back up through the grid's durable ledger.

The port's own copy of ``predictionio_tpu/lifecycle/policy.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# episode states
STATE_IDLE = "idle"
STATE_TRIGGERED = "triggered"
STATE_TUNING = "tuning"
STATE_BAKING = "baking"

# terminal outcomes (recorded on the ring / metrics, never a live state)
OUTCOME_PROMOTED = "promoted"
OUTCOME_ROLLED_BACK = "rolled-back"
OUTCOME_ABORTED = "aborted"

# decision actions
HOLD = "hold"
TRIGGER = "trigger"
DEFER = "defer"
START_TUNE = "start-tune"
BAKE = "bake"
WARM = "warm"
FINISH = "finish"

# trigger reasons
REASON_DRIFT = "drift"
REASON_CADENCE = "cadence"
REASON_MANUAL = "manual"

# grid states the controller reports (LifecycleInputs.grid_state)
GRID_NONE = ""
GRID_RUNNING = "running"
GRID_DONE = "done"
GRID_FAILED = "failed"


@dataclasses.dataclass
class LifecycleConfig:
    """Controller knobs (docs/lifecycle.md)."""

    # scheduled retune cadence; 0 disables (drift/manual only)
    cadence_s: float = 0.0
    # how far back ring drift records count as a live signal
    drift_window_s: float = 600.0
    # distinct drift records inside the window needed to trigger (one
    # breach already suppressed a publish — the default acts on it)
    min_drift_records: int = 1
    # after any terminal outcome, no drift/cadence retrigger sooner than
    # this (manual triggers bypass the cooldown, never an active episode)
    cooldown_s: float = 600.0
    # a grid run older than this is abandoned (ABORTED; its ledger keeps
    # the finished cells for the next episode's resume)
    tune_timeout_s: float = 7200.0
    # a bake the server never resolves is abandoned (controller unstages)
    bake_timeout_s: float = 3600.0
    # controller tick cadence
    tick_interval_s: float = 2.0
    # bounded post-promote cache warm (queries replayed; 0 disables)
    warm_limit: int = 256


@dataclasses.dataclass(frozen=True)
class LifecycleInputs:
    """One tick's world view, assembled by the controller: ring records
    (the policy reads ``kind="drift"``), the shared rollout probe, the
    control file's pause/manual-trigger flags, the background grid's
    status, and the engine's registry rollout state."""

    records: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    rollout_active: bool = False
    paused: bool = False
    # monotonically increasing manual-trigger token (0 = never); the
    # policy remembers the last token it consumed
    manual_token: int = 0
    grid_state: str = GRID_NONE
    grid_staged_version: str = ""
    registry_stable: str = ""
    registry_candidate: str = ""
    registry_mode: str = "off"


@dataclasses.dataclass(frozen=True)
class LifecycleDecision:
    """One tick's verdict. ``action`` drives the controller; ``reason`` is
    the triggering signal or outcome cause; ``outcome`` is set only on
    FINISH/WARM (what the episode resolved to)."""

    action: str
    reason: str
    outcome: str = ""

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "action": self.action,
            "reason": self.reason,
            "outcome": self.outcome,
        }


class LifecyclePolicy:
    """The pure decision engine: inputs in, :class:`LifecycleDecision`
    out. Stateful only in what the episode needs — current state, the
    staged winner being baked, the drift high-water mark, the cooldown
    anchor, and the pending mid-bake deferral — and every method takes an
    explicit ``now``. The controller MUST confirm each applied transition via
    the ``note_*`` methods; a decision that could not be executed leaves
    the episode untouched (the same contract as
    ``ScalingPolicy.note_applied``)."""

    def __init__(self, config: LifecycleConfig | None = None):
        self.config = config or LifecycleConfig()
        self.state = STATE_IDLE
        # why the current episode triggered (drift/cadence/manual)
        self.trigger_reason = ""
        # when the current state was entered (timeout anchor)
        self.since: float | None = None
        # the grid winner's registry version while BAKING
        self.staged_version = ""
        # cooldown anchor: when the last episode resolved (also the
        # cadence anchor, so a retune schedules from the last outcome)
        self.last_done_at: float | None = None
        self.last_outcome = ""
        # drift high-water mark: ring seq of the newest drift record any
        # trigger consumed — one breach never re-triggers forever
        self.drift_seq = -1
        # manual high-water mark (control-file token)
        self.manual_seq = 0
        # episodic mid-bake deferral flag (DEFER once, HOLD after)
        self.deferred = False

    # ------------------------------------------------------------- signals
    def _drift_records(
        self, records: list[dict[str, Any]], now: float
    ) -> list[dict[str, Any]]:
        cutoff = now - self.config.drift_window_s
        return [
            r
            for r in records
            if r.get("kind") == "drift"
            and float(r.get("t", 0.0)) >= cutoff
            and int(r.get("seq", 0)) > self.drift_seq
        ]

    def wants_trigger(self, inp: LifecycleInputs, now: float) -> str | None:
        """The trigger reason when a retune is due, else None. Manual
        outranks drift outranks cadence; manual bypasses the cooldown
        (an operator typed it), the automatic signals respect it."""
        if inp.manual_token > self.manual_seq:
            return REASON_MANUAL
        if inp.paused:
            return None
        cfg = self.config
        in_cooldown = (
            self.last_done_at is not None
            and now - self.last_done_at < cfg.cooldown_s
        )
        if in_cooldown:
            return None
        fresh = self._drift_records(inp.records, now)
        if len(fresh) >= max(1, cfg.min_drift_records):
            return REASON_DRIFT
        if cfg.cadence_s > 0:
            anchor = self.last_done_at
            if anchor is None:
                # first-ever cadence run anchors at the first tick that
                # observed the clock (note_started sets it)
                anchor = self.started_at
            if anchor is not None and now - anchor >= cfg.cadence_s:
                return REASON_CADENCE
        return None

    # the first tick's clock reading — the cadence anchor before any
    # episode has resolved (set by the controller via note_started)
    started_at: float | None = None

    def note_started(self, now: float) -> None:
        if self.started_at is None:
            self.started_at = now

    # ------------------------------------------------------------- deciding
    def decide(self, inp: LifecycleInputs, now: float) -> LifecycleDecision:
        """One tick. The controller executes the returned action and
        confirms it via the matching ``note_*`` method."""
        self.note_started(now)
        if self.state == STATE_IDLE:
            reason = self.wants_trigger(inp, now)
            if reason is None:
                return LifecycleDecision(HOLD, "paused" if inp.paused else "steady")
            return LifecycleDecision(TRIGGER, reason)
        if self.state == STATE_TRIGGERED:
            if inp.rollout_active:
                # never start a grid while a candidate bakes — DEFER is
                # an episode, exactly like the autoscaler's resizes
                if self.deferred:
                    return LifecycleDecision(HOLD, "mid-bake-pending")
                return LifecycleDecision(DEFER, "mid-bake")
            return LifecycleDecision(START_TUNE, self.trigger_reason)
        if self.state == STATE_TUNING:
            if inp.grid_state == GRID_DONE:
                if inp.grid_staged_version:
                    return LifecycleDecision(BAKE, "winner-staged")
                # grid finished but staged nothing: NaN winner, winner is
                # already the stable, or publish disabled
                return LifecycleDecision(FINISH, "no-candidate", OUTCOME_ABORTED)
            if inp.grid_state == GRID_FAILED:
                return LifecycleDecision(FINISH, "grid-failed", OUTCOME_ABORTED)
            if (
                self.since is not None
                and now - self.since > self.config.tune_timeout_s
            ):
                return LifecycleDecision(FINISH, "tune-timeout", OUTCOME_ABORTED)
            return LifecycleDecision(HOLD, "tuning")
        if self.state == STATE_BAKING:
            baking = (
                inp.registry_mode != "off"
                and inp.registry_candidate == self.staged_version
            )
            if baking:
                if (
                    self.since is not None
                    and now - self.since > self.config.bake_timeout_s
                ):
                    # the controller unstages: a bake no server resolves
                    # must not pin the candidate lane forever
                    return LifecycleDecision(FINISH, "bake-timeout", OUTCOME_ABORTED)
                return LifecycleDecision(HOLD, "baking")
            # the rollout resolved (or something else took the lane over)
            if inp.registry_stable == self.staged_version:
                return LifecycleDecision(WARM, "bake-promoted", OUTCOME_PROMOTED)
            return LifecycleDecision(FINISH, "bake-rejected", OUTCOME_ROLLED_BACK)
        raise AssertionError(f"unknown lifecycle state {self.state!r}")

    # ---------------------------------------------------------- transitions
    def note_triggered(self, reason: str, inp: LifecycleInputs, now: float) -> None:
        """IDLE -> TRIGGERED applied: consume the signal's high-water
        marks so the same drift records / manual token never re-fire."""
        fresh = self._drift_records(inp.records, now)
        if fresh:
            self.drift_seq = max(int(r.get("seq", 0)) for r in fresh)
        if inp.manual_token > self.manual_seq:
            self.manual_seq = inp.manual_token
        self.state = STATE_TRIGGERED
        self.trigger_reason = reason
        self.since = now
        self.deferred = False

    def note_deferred(self) -> None:
        self.deferred = True

    def note_tuning(self, now: float) -> None:
        self.state = STATE_TUNING
        self.since = now
        self.deferred = False

    def note_baking(self, version: str, now: float) -> None:
        self.state = STATE_BAKING
        self.staged_version = version
        self.since = now

    def note_finished(self, outcome: str, now: float) -> None:
        """Any terminal outcome: episode over, cooldown starts."""
        self.state = STATE_IDLE
        self.trigger_reason = ""
        self.staged_version = ""
        self.since = None
        self.deferred = False
        self.last_done_at = now
        self.last_outcome = outcome

    # -------------------------------------------------------- serialization
    def to_json_dict(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "triggerReason": self.trigger_reason,
            "since": self.since,
            "stagedVersion": self.staged_version,
            "lastDoneAt": self.last_done_at,
            "lastOutcome": self.last_outcome,
            "driftSeq": self.drift_seq,
            "manualSeq": self.manual_seq,
            "deferred": self.deferred,
            "startedAt": self.started_at,
        }

    @classmethod
    def from_json_dict(
        cls, data: dict[str, Any], config: LifecycleConfig | None = None
    ) -> "LifecyclePolicy":
        policy = cls(config)
        policy.state = str(data.get("state", STATE_IDLE))
        if policy.state not in (
            STATE_IDLE,
            STATE_TRIGGERED,
            STATE_TUNING,
            STATE_BAKING,
        ):
            policy.state = STATE_IDLE
        policy.trigger_reason = str(data.get("triggerReason", ""))
        policy.since = data.get("since")
        policy.staged_version = str(data.get("stagedVersion", ""))
        policy.last_done_at = data.get("lastDoneAt")
        policy.last_outcome = str(data.get("lastOutcome", ""))
        policy.drift_seq = int(data.get("driftSeq", -1))
        policy.manual_seq = int(data.get("manualSeq", 0))
        policy.deferred = bool(data.get("deferred", False))
        policy.started_at = data.get("startedAt")
        return policy


__all__ = [
    "BAKE",
    "DEFER",
    "FINISH",
    "GRID_DONE",
    "GRID_FAILED",
    "GRID_NONE",
    "GRID_RUNNING",
    "HOLD",
    "LifecycleConfig",
    "LifecycleDecision",
    "LifecycleInputs",
    "LifecyclePolicy",
    "OUTCOME_ABORTED",
    "OUTCOME_PROMOTED",
    "OUTCOME_ROLLED_BACK",
    "REASON_CADENCE",
    "REASON_DRIFT",
    "REASON_MANUAL",
    "START_TUNE",
    "STATE_BAKING",
    "STATE_IDLE",
    "STATE_TRIGGERED",
    "STATE_TUNING",
    "TRIGGER",
    "WARM",
]
