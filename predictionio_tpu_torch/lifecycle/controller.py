"""The lifecycle controller: ring → :class:`LifecyclePolicy` → grid →
registry → cache warm, with every transition on the telemetry ring.

The controller owns the impure half the policy refuses to touch: it
reads drift records off the ring, probes the registry's rollout state
through the shared :func:`~predictionio_tpu_torch.registry.probe
.registry_rollout_probe`, launches the eval grid on a background thread
(the grid is synchronous and minutes-long; the tick loop must keep
deciding while it runs), watches the bake through the registry state
file, and replays warm-up queries after a promote. Two small files make
it operable and crash-safe:

``lifecycle.json``
    The durable state (tmp+rename, the registry's ``_atomic_write``
    idiom). Written after every transition; read back on start so a
    SIGKILLed controller resumes its episode — a persisted TUNING state
    relaunches the grid with ``resume=True`` and the grid ledger skips
    every finished cell. Also the data source for ``pio lifecycle
    status`` and ``pio top --lifecycle``.

``lifecycle-control.json``
    The operator's mailbox: ``{"paused": bool, "trigger": N}`` written
    by ``pio lifecycle pause|trigger`` and polled every tick. The
    trigger field is a counter, not a flag — the policy remembers the
    last token it consumed, so one ``trigger`` command fires exactly one
    episode even across controller restarts.

The port's own copy of ``predictionio_tpu/lifecycle/controller.py``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import threading
import time
from typing import Any, Callable

from predictionio_tpu_torch.lifecycle.policy import (
    BAKE,
    DEFER,
    FINISH,
    GRID_DONE,
    GRID_FAILED,
    GRID_NONE,
    GRID_RUNNING,
    HOLD,
    START_TUNE,
    STATE_TUNING,
    TRIGGER,
    WARM,
    LifecycleDecision,
    LifecycleInputs,
    LifecyclePolicy,
    OUTCOME_ABORTED,
    OUTCOME_PROMOTED,
    OUTCOME_ROLLED_BACK,
)
from predictionio_tpu_torch.obs.metrics import MetricsRegistry

logger = logging.getLogger("predictionio_tpu_torch.lifecycle")

STATE_FILE = "lifecycle.json"
CONTROL_FILE = "lifecycle-control.json"


def register_lifecycle_metrics(registry: MetricsRegistry) -> dict[str, Any]:
    """Get-or-create the ``pio_lifecycle_*`` family (idempotent — the
    same template as ``register_eval_metrics``, so the controller, the
    metrics contract test, and a bare exporter all converge on one set).
    The names here are contract-tested against docs/observability.md."""
    return {
        "ticks": registry.counter(
            "pio_lifecycle_ticks_total", "lifecycle control-loop passes"
        ),
        "errors": registry.counter(
            "pio_lifecycle_errors_total",
            "lifecycle ticks that failed (ring read, registry probe, grid "
            "launch, or state-file write) — counted and retried",
        ),
        "triggers": registry.counter(
            "pio_lifecycle_triggers_total",
            "retune episodes started, by signal",
            labelnames=("reason",),
        ),
        "transitions": registry.counter(
            "pio_lifecycle_transitions_total",
            "episode state transitions, by destination state",
            labelnames=("to",),
        ),
        "runs": registry.counter(
            "pio_lifecycle_runs_total",
            "completed lifecycle episodes, by terminal outcome "
            "(promoted / rolled-back / aborted)",
            labelnames=("outcome",),
        ),
        "deferred": registry.counter(
            "pio_lifecycle_deferred_total",
            "retunes deferred because a rollout was mid-bake (started "
            "after promote/rollback, never concurrently)",
        ),
        "warm_queries": registry.counter(
            "pio_lifecycle_warm_queries_total",
            "cache-warm queries replayed after promotes, by result",
            labelnames=("result",),
        ),
        "state": registry.gauge(
            "pio_lifecycle_state",
            "current episode state (0=idle 1=triggered 2=tuning 3=baking)",
        ),
        "paused": registry.gauge(
            "pio_lifecycle_paused",
            "1 while the operator paused automatic triggers "
            "(in-flight episodes still run to completion)",
        ),
        "last_transition_unix": registry.gauge(
            "pio_lifecycle_last_transition_unix",
            "unix time of the last episode transition (0 = never)",
        ),
    }


_STATE_GAUGE = {"idle": 0.0, "triggered": 1.0, "tuning": 2.0, "baking": 3.0}


def _atomic_write_json(path: str, data: dict[str, Any]) -> None:
    """tmp+fsync+rename — readers (CLI status, top) see old-or-new,
    never torn (the registry store's idiom)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def read_json_file(path: str) -> dict[str, Any] | None:
    """Best-effort JSON read: missing / torn / non-dict → None. Control
    and status files are poll-read; a torn read is just 'try next tick'."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def write_control(
    dir_path: str, *, paused: bool | None = None, trigger: bool = False
) -> dict[str, Any]:
    """CLI-side helper: merge a pause flip and/or a trigger bump into the
    control file (read-modify-write; the single writer is the operator)."""
    path = os.path.join(dir_path, CONTROL_FILE)
    data = read_json_file(path) or {}
    if paused is not None:
        data["paused"] = bool(paused)
    if trigger:
        data["trigger"] = int(data.get("trigger", 0)) + 1
    os.makedirs(dir_path, exist_ok=True)
    _atomic_write_json(path, data)
    return data


class LifecycleController:
    """Ticks the policy and executes its decisions.

    ``tune(resume)`` runs the retune (production wiring: the eval grid on
    nice'd cpu-fallback workers, publishing its winner as a registry
    CANDIDATE) and returns the staged version string ("" when the grid
    produced no publishable winner). It executes on a daemon thread the
    controller owns; the policy sees it as ``grid_state`` =
    running/done/failed. ``warm(version)`` replays bounded queries into
    the new stable's result cache and returns counts. Both are injected
    so the unit matrix runs the whole episode with fakes and a fake
    clock."""

    def __init__(
        self,
        policy: LifecyclePolicy,
        *,
        state_dir: str,
        engine_id: str = "",
        registry_dir: str = "",
        tune: Callable[[bool], str] | None = None,
        warm: Callable[[str], dict[str, int]] | None = None,
        rollout_probe: Callable[[], bool] | None = None,
        ring: Any | None = None,  # obs.tsring.TelemetryRing
        incidents: Any | None = None,  # obs.incidents.IncidentRecorder
        metrics: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.policy = policy
        self.state_dir = state_dir
        self.engine_id = engine_id
        self.registry_dir = registry_dir
        self._tune = tune
        self._warm = warm
        self._rollout_probe = rollout_probe
        self.ring = ring
        self.incidents = incidents
        self._clock = clock
        self.metrics = metrics or MetricsRegistry()
        self._m = register_lifecycle_metrics(self.metrics)
        self._store: Any = None  # lazy ArtifactStore
        # background grid thread state (written by the thread, read by
        # ticks; the GIL + single writer make the simple fields safe)
        self._grid_thread: threading.Thread | None = None
        self._grid_state = GRID_NONE
        self._grid_version = ""
        self._grid_error = ""
        os.makedirs(state_dir, exist_ok=True)
        self._restore()

    # ----------------------------------------------------------- durability
    @property
    def state_path(self) -> str:
        return os.path.join(self.state_dir, STATE_FILE)

    def _restore(self) -> None:
        """Resume after a crash: the persisted policy episode is the
        truth. A controller killed mid-TUNING relaunches the grid with
        ``resume=True`` on its first tick — the grid's ledger skips every
        finished cell, so the SIGKILL costs at most one cell of work."""
        data = read_json_file(self.state_path)
        if not data:
            return
        policy_data = data.get("policy")
        if isinstance(policy_data, dict):
            self.policy = LifecyclePolicy.from_json_dict(
                policy_data, self.policy.config
            )
        if self.policy.state == STATE_TUNING:
            logger.info(
                "lifecycle: resuming interrupted tuning episode "
                "(grid relaunches with resume=True)"
            )
            self._launch_grid(resume=True)

    def _persist(self, decision: LifecycleDecision | None = None) -> None:
        snap: dict[str, Any] = {
            "engine": self.engine_id,
            "policy": self.policy.to_json_dict(),
            "grid": {
                "state": self._grid_state,
                "stagedVersion": self._grid_version,
                "error": self._grid_error,
            },
            "paused": bool(self._control().get("paused", False)),
            "updatedAt": self._clock(),
        }
        if decision is not None:
            snap["lastDecision"] = decision.to_json_dict()
        _atomic_write_json(self.state_path, snap)

    def _control(self) -> dict[str, Any]:
        return read_json_file(os.path.join(self.state_dir, CONTROL_FILE)) or {}

    # ------------------------------------------------------------ telemetry
    def _record(self, event: str, decision: LifecycleDecision, **extra: Any) -> None:
        """Lifecycle transitions are telemetry: appended to the SAME ring
        the drift sensor writes, so `pio top`, incident bundles, and the
        next operator see the whole loop in one timeline."""
        self._m["last_transition_unix"].set(self._clock())
        if self.ring is None:
            return
        record = {
            "kind": "lifecycle",
            "event": event,
            "engine": self.engine_id,
            "state": self.policy.state,
            "decision": decision.to_json_dict(),
        }
        record.update(extra)
        self.ring.append(record)

    # ----------------------------------------------------------- grid seam
    def _launch_grid(self, resume: bool) -> None:
        if self._tune is None:
            self._grid_state = GRID_FAILED
            self._grid_error = "no tune runner wired"
            return
        self._grid_state = GRID_RUNNING
        self._grid_version = ""
        self._grid_error = ""

        def runner() -> None:
            try:
                version = self._tune(resume)
            except Exception as exc:  # the policy aborts the episode
                logger.exception("lifecycle: grid run failed")
                self._grid_error = str(exc)
                self._grid_state = GRID_FAILED
                return
            self._grid_version = str(version or "")
            self._grid_state = GRID_DONE

        self._grid_thread = threading.Thread(
            target=runner, name="lifecycle-grid", daemon=True
        )
        self._grid_thread.start()

    def _forget_grid(self) -> None:
        # an abandoned thread (timeout) keeps running but its result is
        # discarded; the ledger it wrote still speeds up the next episode
        self._grid_thread = None
        self._grid_state = GRID_NONE
        self._grid_version = ""
        self._grid_error = ""

    # ------------------------------------------------------------- registry
    def _registry_state(self) -> tuple[str, str, str]:
        """(stable, candidate, mode) for our engine — '' / 'off' without
        a registry (the policy then resolves bakes on rollout_active)."""
        if not self.registry_dir or not self.engine_id:
            return "", "", "off"
        if self._store is None:
            from predictionio_tpu_torch.registry.store import ArtifactStore

            self._store = ArtifactStore(self.registry_dir)
        st = self._store.get_state(self.engine_id)
        return st.stable, st.candidate, st.mode

    def rollout_active(self) -> bool:
        # raises on an unreadable registry: this tick must not launch a
        # grid on unknown rollout state (run() counts the error, retries)
        if self._rollout_probe is None:
            return False
        return bool(self._rollout_probe())

    def _unstage_timed_out_bake(self) -> None:
        if self._store is None or not self.engine_id:
            return
        try:
            self._store.unstage(self.engine_id, reason="lifecycle-bake-timeout")
        except Exception:
            logger.exception("lifecycle: unstage after bake-timeout failed")

    # ----------------------------------------------------------------- tick
    def inputs(self) -> LifecycleInputs:
        control = self._control()
        stable, candidate, mode = self._registry_state()
        records: list[dict[str, Any]] = []
        if self.ring is not None:
            records = self.ring.window(self.policy.config.drift_window_s)
        return LifecycleInputs(
            records=records,
            rollout_active=self.rollout_active(),
            paused=bool(control.get("paused", False)),
            manual_token=int(control.get("trigger", 0)),
            grid_state=self._grid_state,
            grid_staged_version=self._grid_version,
            registry_stable=stable,
            registry_candidate=candidate,
            registry_mode=mode,
        )

    def tick(self) -> LifecycleDecision:
        """One control pass: assemble inputs, decide, execute, persist.
        Exceptions propagate (run() counts them); a failed execution never
        advances the episode — note_* only fires after the action lands."""
        self._m["ticks"].inc()
        now = self._clock()
        inp = self.inputs()
        self._m["paused"].set(1.0 if inp.paused else 0.0)
        decision = self.policy.decide(inp, now)
        self._apply(decision, inp, now)
        self._m["state"].set(_STATE_GAUGE.get(self.policy.state, 0.0))
        return decision

    def _apply(
        self, decision: LifecycleDecision, inp: LifecycleInputs, now: float
    ) -> None:
        if decision.action == HOLD:
            return
        if decision.action == TRIGGER:
            self.policy.note_triggered(decision.reason, inp, now)
            self._m["triggers"].inc(reason=decision.reason)
            self._m["transitions"].inc(to="triggered")
            self._record("triggered", decision)
            logger.info("lifecycle: retune triggered (%s)", decision.reason)
        elif decision.action == DEFER:
            self.policy.note_deferred()
            self._m["deferred"].inc()
            self._record("deferred", decision)
            logger.info("lifecycle: retune deferred (%s)", decision.reason)
        elif decision.action == START_TUNE:
            self._launch_grid(resume=False)
            self.policy.note_tuning(now)
            self._m["transitions"].inc(to="tuning")
            self._record("tuning", decision)
            logger.info("lifecycle: grid launched (%s)", decision.reason)
        elif decision.action == BAKE:
            version = inp.grid_staged_version
            self._forget_grid()
            self.policy.note_baking(version, now)
            self._m["transitions"].inc(to="baking")
            self._record("baking", decision, version=version)
            logger.info("lifecycle: candidate %s baking", version)
        elif decision.action == WARM:
            # promote observed: warm BEFORE closing the episode so a
            # crash mid-warm resumes as 'baking' and re-runs the warm
            # (idempotent — warming is cache fills)
            self._run_warm(decision, inp.registry_stable)
            self._finish(decision, now)
        elif decision.action == FINISH:
            if decision.reason == "bake-timeout":
                self._unstage_timed_out_bake()
            was_tuning = self.policy.state == STATE_TUNING
            self._finish(decision, now)
            if was_tuning:
                self._forget_grid()
        self._persist(decision)

    def _run_warm(self, decision: LifecycleDecision, version: str) -> None:
        if self._warm is None or self.policy.config.warm_limit <= 0:
            return
        try:
            counts = self._warm(version)
        except Exception:
            # warming is best-effort: a failed warm never rolls back a
            # good promote (the cache fills organically instead)
            logger.exception("lifecycle: cache warm failed")
            self._m["warm_queries"].inc(result="error")
            return
        for result, n in (counts or {}).items():
            self._m["warm_queries"].inc(float(n), result=result)
        logger.info("lifecycle: cache warmed for %s: %s", version, counts)

    def _finish(self, decision: LifecycleDecision, now: float) -> None:
        outcome = decision.outcome
        self.policy.note_finished(outcome, now)
        self._m["runs"].inc(outcome=outcome)
        self._m["transitions"].inc(to=outcome)
        self._record(
            "finished", decision, outcome=outcome, error=self._grid_error
        )
        logger.info(
            "lifecycle: episode finished %s (%s)", outcome, decision.reason
        )
        if outcome in (OUTCOME_ABORTED, OUTCOME_ROLLED_BACK):
            # the bundle carries the ring tail: the drift that triggered,
            # the grid's fate, and the bake verdict, in one timeline
            if self.incidents is not None:
                self.incidents.trigger(
                    f"lifecycle-{outcome}",
                    context={
                        "engine": self.engine_id,
                        "reason": decision.reason,
                        "gridError": self._grid_error,
                    },
                )

    # ----------------------------------------------------------------- run
    async def run(self) -> None:
        """Asyncio loop: tick forever at the configured cadence; a
        failing tick is counted and retried next interval ('controller
        dead' is a failure-matrix row, not a serving outage — serving
        never depends on this loop). Ticks run on an executor thread,
        never the serving event loop: a tick walks the on-disk ring and
        reads registry state files (the autoscaler's rule)."""
        interval = self.policy.config.tick_interval_s
        loop = asyncio.get_running_loop()
        while True:
            try:
                await loop.run_in_executor(None, self.tick)
            except asyncio.CancelledError:
                raise
            except Exception:
                self._m["errors"].inc()
                logger.exception("lifecycle tick failed")
            await asyncio.sleep(interval)


__all__ = [
    "CONTROL_FILE",
    "STATE_FILE",
    "LifecycleController",
    "read_json_file",
    "register_lifecycle_metrics",
    "write_control",
]
