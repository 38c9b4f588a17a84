"""SLO-driven elasticity: the fleet sizes itself from the telemetry ring.

Port of ``predictionio_tpu/fleet/autoscaler.py``: :class:`ScalingPolicy`
is the reference's pure decision engine, unchanged; the
:class:`Autoscaler`'s asyncio driver becomes :meth:`Autoscaler.run`, a
blocking loop on a thread of its own.

The burn-rate engine, the supervisor and the durable telemetry ring
that connects them exist; this module closes the loop. A
traffic spike used to end in load-shed 503s until a human resized the
fleet — now a control loop inside ``pio deploy --fleet`` READS the ring
(fleet SLO burn rates, per-replica queue-depth/inflight/shed snapshots,
appended by the gateway every telemetry tick) and drives the supervisor
and the gateway's membership funnel:

- **Scale out** on fast-window SLO burn or sustained queue depth (and
  immediately on observed sheds — the thing the loop exists to prevent).
  New device-class replicas first; when the device envelope is
  exhausted, cheap ``cpu-fallback`` replicas absorb overflow (the
  CPU-serverless-vs-accelerator cost shape: slower answers beat sheds,
  and a CPU replica costs a fraction of a device one).
- **Scale in** on sustained idleness, via the existing graceful drain:
  the gateway stops routing to the victim FIRST (membership funnel),
  then the supervisor SIGTERMs it (the worker answers its in-flight
  queries and exits) — provably 5xx-free, chaos-asserted.
- **Never flap.** Signals must hold across consecutive ring records
  (probe noise is one record), scale-out and scale-in each have their
  own cooldown, and the out/in thresholds are split (hysteresis).
- **Never resize mid-bake.** The registry rollout state is consulted
  every tick; a resize wanted while a candidate bakes is DEFERRED and
  fires after the promote/rollback lands.
- **Bounded.** A min/max replica envelope per class; wanting to scale
  past it is an incident (``autoscaler-saturated``), not a surprise.

The decision engine (:class:`ScalingPolicy`) is a pure unit — fake
clock + fake ring records drive every branch without a process — in the
same injectable style as the supervisor's restart policy. The
:class:`Autoscaler` wraps it with the ring/registry/supervisor/gateway
plumbing, appends each decision back to the ring (``kind="scaling"`` —
``pio top --history`` renders them as markers) and exports the
``pio_autoscaler_*`` family (docs/observability.md).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

from predictionio_tpu_torch.fleet.gateway import Gateway
from predictionio_tpu_torch.fleet.supervisor import (
    REPLICA_CLASS_CPU,
    REPLICA_CLASS_DEVICE,
    Supervisor,
    WorkerSpec,
)
from predictionio_tpu_torch.obs.metrics import MetricsRegistry

logger = logging.getLogger(__name__)

# decision actions
SCALE_OUT = "scale-out"
SCALE_IN = "scale-in"
HOLD = "hold"
DEFER = "defer"


@dataclasses.dataclass
class AutoscalerConfig:
    # device-class envelope; cpu_fallback_max bounds the overflow class
    # (0 disables heterogeneous replicas entirely)
    min_replicas: int = 1
    max_replicas: int = 4
    cpu_fallback_max: int = 0
    tick_interval_s: float = 5.0
    # how much ring history one decision reads
    lookback_s: float = 600.0
    # scale-out: any fleet SLO's FAST-window burn at/over this rate...
    burn_threshold: float = 1.0
    # ...or queue depth per healthy replica at/over this...
    queue_depth_high: float = 8.0
    # ...or gateway in-flight per healthy replica at/over this (the
    # tier-above view: a worker can drain its own queue fast while the
    # fleet still runs hot on concurrency; reads the per-tick PEAK when
    # the snapshot carries one — instant samples alias under bursty
    # event-loop scheduling)...
    inflight_high_per_replica: float = 16.0
    # fraction of confirm-window records that must show pressure (>= 2
    # records regardless): all-records was brittle — one aliased cold
    # sample inside an otherwise hot window vetoed a needed scale-out
    confirm_fraction: float = 0.8
    # ...held across EVERY record in this trailing window (>= 2 records:
    # one pressured snapshot is probe noise, not a trend). Sheds inside
    # the window trigger regardless — a shed is never noise.
    confirm_s: float = 10.0
    # scale-in: every record across this window idle (queue below the
    # LOW watermark — split from the high one: hysteresis — inflight per
    # replica low, burn cold, zero sheds)
    idle_sustain_s: float = 120.0
    queue_depth_low: float = 0.5
    idle_inflight_per_replica: float = 1.0
    idle_burn_max: float = 0.25
    # flap damping: no second scale-out/in sooner than this after any
    # applied resize
    scale_out_cooldown_s: float = 30.0
    scale_in_cooldown_s: float = 120.0
    # replicas added/retired per decision
    scale_step: int = 1


@dataclasses.dataclass(frozen=True)
class FleetShape:
    """Live capacity by class (parked and retiring workers excluded)."""

    device: int = 0
    cpu: int = 0

    @property
    def total(self) -> int:
        return self.device + self.cpu


@dataclasses.dataclass(frozen=True)
class Decision:
    """One tick's verdict. ``action`` is scale-out/scale-in/hold/defer;
    ``reason`` is the triggering signal (burn/queue/shed/idle/cooldown/
    mid-bake/saturated/at-floor/...); ``replica_class`` names which class
    resizes; ``deferred`` marks a resumed mid-bake deferral."""

    action: str
    reason: str
    replica_class: str | None = None
    step: int = 0
    deferred: bool = False

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "action": self.action,
            "reason": self.reason,
            "class": self.replica_class,
            "step": self.step,
            "deferred": self.deferred,
        }


def _fast_burn(record: dict[str, Any]) -> float:
    """The hottest FAST-window burn across the record's fleet SLOs (the
    fast window is the smallest one — same rule ``pio top --history``
    renders)."""
    worst = 0.0
    for state in (record.get("slo") or {}).values():
        burn = state.get("burn") or {}
        if not burn:
            continue
        fast = min(burn, key=float)
        worst = max(worst, float(burn.get(fast, 0.0)))
    return worst


def _healthy_count(record: dict[str, Any]) -> int:
    return sum(
        1
        for rep in (record.get("replicas") or {}).values()
        if rep.get("healthy")
    )


def _shed_total(record: dict[str, Any]) -> float:
    counters = record.get("counters") or {}
    return float(counters.get("no_replica", 0.0)) + float(
        counters.get("load_shed", 0.0)
    )


class ScalingPolicy:
    """The pure decision engine: ring records in, :class:`Decision` out.

    Stateful only in what elasticity needs — last applied resize (for
    cooldowns) and the pending mid-bake deferral — and every method takes
    an explicit ``now`` so tests drive it with a fake clock and
    hand-built records. The caller MUST confirm an applied resize via
    :meth:`note_applied`; a decision that could not be executed leaves
    the cooldown clock untouched."""

    def __init__(self, config: AutoscalerConfig | None = None):
        self.config = config or AutoscalerConfig()
        self._last_out_at: float | None = None
        self._last_in_at: float | None = None
        self.pending: Decision | None = None

    # ------------------------------------------------------------- signals
    def _window(
        self, records: list[dict[str, Any]], now: float, seconds: float
    ) -> list[dict[str, Any]]:
        cutoff = now - seconds
        return [
            r
            for r in records
            if r.get("kind", "fleet") == "fleet"
            and float(r.get("t", 0.0)) >= cutoff
        ]

    def _pressure_reason(self, record: dict[str, Any]) -> str | None:
        cfg = self.config
        if _fast_burn(record) >= cfg.burn_threshold:
            return "burn"
        healthy = max(1, _healthy_count(record))
        gauges = record.get("gauges") or {}
        if float(gauges.get("queue_depth", 0.0)) / healthy >= cfg.queue_depth_high:
            return "queue-depth"
        inflight = max(
            float(gauges.get("inflight", 0.0)),
            float(gauges.get("inflight_peak", 0.0)),
        )
        if inflight / healthy >= cfg.inflight_high_per_replica:
            return "inflight"
        return None

    def _pressured(self, record: dict[str, Any]) -> bool:
        return self._pressure_reason(record) is not None

    def wants_scale_out(
        self, records: list[dict[str, Any]], now: float
    ) -> str | None:
        """Pressure reason when the trailing confirm window demands more
        capacity, else None. Sheds anywhere in the window trigger even a
        single-record signal — by the time a shed is in the ring, users
        already saw 503s."""
        recent = self._window(records, now, self.config.confirm_s)
        if not recent:
            return None
        # shed DELTA across the confirm window: baseline = the newest
        # record just OUTSIDE it, so a shed from minutes ago can never
        # re-trigger once traffic recovered (counters are cumulative;
        # replica restarts can lower federated sums, hence the clamp)
        before = [
            r
            for r in self._window(records, now, self.config.lookback_s)
            if float(r.get("t", 0.0)) < now - self.config.confirm_s
        ]
        baseline = _shed_total(before[-1]) if before else _shed_total(recent[0])
        shed_delta = max(0.0, _shed_total(recent[-1]) - baseline)
        if shed_delta > 0:
            # a fresh shed triggers ALONE: users already saw 503s, and
            # the newest record sampling calm (clients backing off, the
            # peak gauge just consumed) must not veto the response
            return "shed"
        if len(recent) < 2:
            return None
        pressured = [r for r in recent if self._pressured(r)]
        if len(pressured) / len(recent) >= self.config.confirm_fraction:
            return self._pressure_reason(pressured[-1])
        return None

    def wants_scale_in(
        self, records: list[dict[str, Any]], now: float, shape: FleetShape
    ) -> bool:
        """True when the whole idle_sustain window shows a cold fleet.
        The window must actually be COVERED (oldest record near its far
        edge) — two records ten seconds apart must not vouch for two
        minutes of idleness."""
        cfg = self.config
        # select 25% past the sustain window: the record that PROVES
        # coverage sits near the window edge and must not fall off it
        # between being written and being read (idleness slightly older
        # than the window is still idleness)
        recent = self._window(records, now, cfg.idle_sustain_s * 1.25)
        if len(recent) < 2:
            return False
        oldest_t = float(recent[0].get("t", now))
        if now - oldest_t < cfg.idle_sustain_s * 0.8:
            return False
        sheds = _shed_total(recent[-1]) - _shed_total(recent[0])
        if sheds > 0:
            return False
        per_replica = max(1, shape.total)
        for r in recent:
            gauges = r.get("gauges") or {}
            if float(gauges.get("queue_depth", 0.0)) > cfg.queue_depth_low:
                return False
            # idle means PEAK concurrency stayed low, not that the tick
            # happened to sample an idle instant
            inflight = max(
                float(gauges.get("inflight", 0.0)),
                float(gauges.get("inflight_peak", 0.0)),
            )
            if inflight / per_replica > cfg.idle_inflight_per_replica:
                return False
            if _fast_burn(r) > cfg.idle_burn_max:
                return False
        return True

    # ------------------------------------------------------------ clamping
    def _clamp_out(self, shape: FleetShape, reason: str) -> Decision:
        cfg = self.config
        if shape.device < cfg.max_replicas:
            return Decision(SCALE_OUT, reason, REPLICA_CLASS_DEVICE, cfg.scale_step)
        if shape.cpu < cfg.cpu_fallback_max:
            # device envelope exhausted: cheap overflow capacity
            return Decision(SCALE_OUT, reason, REPLICA_CLASS_CPU, cfg.scale_step)
        return Decision(HOLD, "saturated")

    def _clamp_in(self, shape: FleetShape) -> Decision:
        cfg = self.config
        if shape.cpu > 0:
            # retire overflow capacity first: it is the slow class, and
            # dropping it restores the homogeneous fast-path fleet
            return Decision(SCALE_IN, "idle", REPLICA_CLASS_CPU, cfg.scale_step)
        if shape.device > cfg.min_replicas:
            return Decision(SCALE_IN, "idle", REPLICA_CLASS_DEVICE, cfg.scale_step)
        return Decision(HOLD, "at-floor")

    # ------------------------------------------------------------- deciding
    def decide(
        self,
        records: list[dict[str, Any]],
        shape: FleetShape,
        rollout_active: bool,
        now: float,
    ) -> Decision:
        """One tick: evaluate signals over the ring records (oldest
        first), apply hysteresis/cooldowns/clamps/rollout-awareness."""
        cfg = self.config
        # a deferred resize fires as soon as the bake ends — re-clamped
        # against the CURRENT shape (which may have drifted: crash/park)
        # and re-validated against the CURRENT signal: the world moved
        # while the bake ran, and a deferred scale-in applied into a
        # fresh spike would retire capacity at peak load (the 503s this
        # loop exists to prevent). A contradicted deferral dissolves; a
        # merely-stale one (signal neutral) still fires, as promised.
        if self.pending is not None and not rollout_active:
            pend = self.pending
            contradicted = (
                self.wants_scale_in(records, now, shape)
                if pend.action == SCALE_OUT
                else self.wants_scale_out(records, now) is not None
            )
            if contradicted:
                self.pending = None
                return Decision(HOLD, f"deferred-{pend.action}-contradicted")
            if pend.action == SCALE_OUT:
                resumed = self._clamp_out(shape, pend.reason)
            else:
                resumed = self._clamp_in(shape)
            if resumed.action in (SCALE_OUT, SCALE_IN):
                return dataclasses.replace(resumed, deferred=True)
            self.pending = None  # clamp says the resize no longer applies
            return resumed
        out_reason = self.wants_scale_out(records, now)
        if out_reason is not None:
            decision = self._clamp_out(shape, out_reason)
            if decision.action != SCALE_OUT:
                return decision  # saturated
            if rollout_active:
                return self._defer(decision, f"mid-bake:{out_reason}")
            if (
                self._last_out_at is not None
                and now - self._last_out_at < cfg.scale_out_cooldown_s
            ):
                return Decision(HOLD, "cooldown-out")
            return decision
        if self.wants_scale_in(records, now, shape):
            decision = self._clamp_in(shape)
            if decision.action != SCALE_IN:
                return decision  # at-floor
            if rollout_active:
                return self._defer(decision, "mid-bake:idle")
            last_any = max(
                (t for t in (self._last_out_at, self._last_in_at) if t is not None),
                default=None,
            )
            if last_any is not None and now - last_any < cfg.scale_in_cooldown_s:
                return Decision(HOLD, "cooldown-in")
            return decision
        return Decision(HOLD, "steady")

    def _defer(self, decision: Decision, reason: str) -> Decision:
        """Remember one resize for after the bake. DEFER is an EPISODE:
        the same resize re-wanted on later ticks of the same bake updates
        the pending slot silently (HOLD) so the deferred counter counts
        resizes deferred, not ticks spent baking, and the bounded ring
        gets one scaling record per deferral, not one per tick."""
        already = self.pending is not None and (
            self.pending.action,
            self.pending.replica_class,
        ) == (decision.action, decision.replica_class)
        self.pending = decision
        if already:
            return Decision(HOLD, "mid-bake-pending", decision.replica_class)
        return Decision(DEFER, reason, decision.replica_class)

    def note_applied(self, decision: Decision, now: float) -> None:
        """The caller executed the resize: start its cooldown and clear
        any pending deferral it satisfied."""
        if decision.action == SCALE_OUT:
            self._last_out_at = now
        elif decision.action == SCALE_IN:
            self._last_in_at = now
        if decision.deferred:
            self.pending = None


class Autoscaler:
    """The control loop: ring -> :class:`ScalingPolicy` -> supervisor +
    gateway membership funnel, with every decision appended back to the
    ring and exported as ``pio_autoscaler_*``.

    ``spec_factory(worker_class)`` allocates the next
    :class:`~predictionio_tpu_torch.fleet.supervisor.WorkerSpec` (name + port)
    for a scale-out — port allocation lives with the launcher, which
    knows the fleet's port range. ``rollout_probe`` returns True while
    any engine's rollout is mid-bake (the launcher wires it to the
    registry; None means "no registry, never defer")."""

    def __init__(
        self,
        policy: ScalingPolicy,
        supervisor: Supervisor,
        gateway: Gateway,
        spec_factory: Callable[[str], WorkerSpec],
        ring: Any | None = None,  # obs.tsring.TelemetryRing
        rollout_probe: Callable[[], bool] | None = None,
        metrics: MetricsRegistry | None = None,
        incidents: Any | None = None,  # obs.incidents.IncidentRecorder
        clock: Callable[[], float] = time.time,
    ):
        self.policy = policy
        self.supervisor = supervisor
        self.gateway = gateway
        self.ring = ring
        self._spec_factory = spec_factory
        self._rollout_probe = rollout_probe
        self.incidents = incidents
        self._clock = clock
        self._was_saturated = False
        m = metrics or MetricsRegistry()
        self.metrics = m
        cfg = policy.config
        self._m_ticks = m.counter(
            "pio_autoscaler_ticks_total", "autoscaler control-loop passes"
        )
        self._m_errors = m.counter(
            "pio_autoscaler_errors_total",
            "autoscaler ticks that failed (ring read, registry probe, or "
            "resize execution)",
        )
        self._m_outs = m.counter(
            "pio_autoscaler_scale_outs_total",
            "replicas added by the autoscaler, by class",
            labelnames=("worker_class",),
        )
        self._m_ins = m.counter(
            "pio_autoscaler_scale_ins_total",
            "replicas retired (drain-based) by the autoscaler, by class",
            labelnames=("worker_class",),
        )
        self._m_deferred = m.counter(
            "pio_autoscaler_deferred_total",
            "resizes deferred because a rollout was mid-bake (applied "
            "after promote/rollback)",
        )
        self._m_saturated = m.counter(
            "pio_autoscaler_saturated_total",
            "ticks that wanted capacity past the whole envelope "
            "(device max + cpu-fallback max) — each saturation episode "
            "also snapshots an incident bundle",
        )
        self._m_replicas = m.gauge(
            "pio_autoscaler_replicas",
            "live fleet shape as the autoscaler sees it, by class "
            "(parked/retiring workers excluded)",
            labelnames=("worker_class",),
        )
        self._m_min = m.gauge(
            "pio_autoscaler_replicas_min", "device-class envelope floor"
        )
        self._m_max = m.gauge(
            "pio_autoscaler_replicas_max", "device-class envelope ceiling"
        )
        self._m_cpu_max = m.gauge(
            "pio_autoscaler_cpu_fallback_max",
            "cpu-fallback (overflow) class ceiling; 0 = class disabled",
        )
        self._m_last_scale_unix = m.gauge(
            "pio_autoscaler_last_scale_unix",
            "unix time of the last applied resize (0 = never)",
        )
        self._m_min.set(float(cfg.min_replicas))
        self._m_max.set(float(cfg.max_replicas))
        self._m_cpu_max.set(float(cfg.cpu_fallback_max))
        m.register_collector(self._collect)

    # ------------------------------------------------------------- plumbing
    def _collect(self) -> None:
        shape = self.shape()
        self._m_replicas.set(float(shape.device), worker_class=REPLICA_CLASS_DEVICE)
        self._m_replicas.set(float(shape.cpu), worker_class=REPLICA_CLASS_CPU)

    def shape(self) -> FleetShape:
        device = cpu = 0
        for spec in self.supervisor.live_specs():
            if spec.worker_class == REPLICA_CLASS_CPU:
                cpu += 1
            else:
                device += 1
        return FleetShape(device=device, cpu=cpu)

    def rollout_active(self) -> bool:
        # raises on an unreadable registry: this tick must not resize on
        # unknown rollout state (run() counts the error and retries)
        if self._rollout_probe is None:
            return False
        return bool(self._rollout_probe())

    def _ring_records(self) -> list[dict[str, Any]]:
        if self.ring is None:
            return []
        records = self.ring.window(self.policy.config.lookback_s)
        # multi-gateway tier: every peer writes fleet snapshots into the
        # shared ring (namespaced segments). The policy's windows assume
        # one snapshot per tick, so scale off the PRIMARY gateway's view
        # — conservative under a balancer that splits traffic evenly,
        # and correct for membership because resizes fan out to peers.
        gw_id = getattr(
            getattr(self.gateway, "config", None), "gateway_id", None
        )
        if gw_id:
            records = [
                r for r in records if r.get("gateway") in (None, gw_id)
            ]
        return records

    def _record_decision(self, decision: Decision, shape: FleetShape) -> None:
        """Scaling decisions are telemetry: appended to the SAME ring the
        policy reads, so `pio top --history`, incident bundles, and the
        next operator all see why the fleet is the size it is."""
        if self.ring is None:
            return
        self.ring.append(
            {
                "kind": "scaling",
                "decision": decision.to_json_dict(),
                "shape": {"device": shape.device, "cpu": shape.cpu},
            }
        )

    # ---------------------------------------------------------------- tick
    def tick(self) -> Decision:
        """One control pass: read the ring, decide, execute. Exceptions
        propagate to the caller (:meth:`run` counts them); a failed
        resize never marks the policy's cooldown."""
        self._m_ticks.inc()
        now = self._clock()
        records = self._ring_records()
        shape = self.shape()
        decision = self.policy.decide(
            records, shape, self.rollout_active(), now
        )
        self.apply(decision, shape, now)
        return decision

    def apply(
        self,
        decision: Decision,
        shape: FleetShape | None = None,
        now: float | None = None,
    ) -> None:
        """Execute one decision through the membership funnel (also the
        CI smoke's entry point for a deterministic scale cycle)."""
        shape = self.shape() if shape is None else shape
        now = self._clock() if now is None else now
        if decision.action == SCALE_OUT:
            self._scale_out(decision, shape, now)
        elif decision.action == SCALE_IN:
            self._scale_in(decision, shape, now)
        elif decision.action == DEFER:
            self._m_deferred.inc()
            self._record_decision(decision, shape)
            logger.info("autoscaler: resize deferred (%s)", decision.reason)
        elif decision.reason == "saturated":
            self._m_saturated.inc()
            if not self._was_saturated:
                # episode transition, not a per-tick spam: the bundle
                # carries the ring tail that shows the unmet pressure
                self._record_decision(decision, shape)
                if self.incidents is not None:
                    self.incidents.trigger(
                        "autoscaler-saturated",
                        context={
                            "shape": {"device": shape.device, "cpu": shape.cpu},
                            "maxReplicas": self.policy.config.max_replicas,
                            "cpuFallbackMax": self.policy.config.cpu_fallback_max,
                        },
                    )
            self._was_saturated = True
        if decision.reason != "saturated":
            self._was_saturated = False

    def _scale_out(self, decision: Decision, shape: FleetShape, now: float) -> None:
        for _ in range(max(1, decision.step)):
            spec = self._spec_factory(decision.replica_class or REPLICA_CLASS_DEVICE)
            self.supervisor.add_worker(spec)
            self.gateway.add_replica(spec.url, spec.worker_class)
            self._m_outs.inc(worker_class=spec.worker_class)
            logger.info(
                "autoscaler: scale-out %s (%s, port %d) on %s",
                spec.name,
                spec.worker_class,
                spec.port,
                decision.reason,
            )
        self._m_last_scale_unix.set(now)
        self.policy.note_applied(decision, now)
        self._record_decision(decision, self.shape())

    def _scale_in(self, decision: Decision, shape: FleetShape, now: float) -> None:
        cls = decision.replica_class or REPLICA_CLASS_DEVICE
        victims = [s for s in self.supervisor.live_specs() if s.worker_class == cls]
        if not victims:
            logger.warning("autoscaler: no %s worker left to retire", cls)
            return
        retired = 0
        for spec in reversed(victims[-max(1, decision.step):]):
            # routing stops FIRST (membership funnel), the process drains
            # second — the ordering that keeps scale-in 5xx-free
            self.gateway.retire_replica(spec.url)
            self.supervisor.retire_worker(spec.name)
            self._m_ins.inc(worker_class=spec.worker_class)
            retired += 1
            logger.info(
                "autoscaler: scale-in %s (%s) on %s",
                spec.name,
                spec.worker_class,
                decision.reason,
            )
        if retired:
            self._m_last_scale_unix.set(now)
            self.policy.note_applied(decision, now)
            self._record_decision(decision, self.shape())

    # ----------------------------------------------------------------- run
    def run(self, stop: threading.Event) -> None:
        """Blocking driver: tick at the configured cadence until ``stop``
        is set; a failing tick is counted and retried next interval (an
        autoscaler crash-looping out of existence is exactly the
        'autoscaler dead' failure-matrix row).

        The launcher runs it on a thread of its own, never one that
        answers requests: a tick walks the on-disk ring, reads registry
        state files, and (on a resize) spawns a process. The pieces a
        tick touches are thread-safe: the gateway's membership funnel
        and the supervisor each hold their own lock, and the ring read is
        file-level."""
        interval = self.policy.config.tick_interval_s
        while not stop.is_set():
            try:
                self.tick()
            except Exception:
                self._m_errors.inc()
                logger.exception("autoscaler tick failed")
            stop.wait(interval)


# The never-act-mid-bake probe lives in the registry package so the
# autoscaler and the lifecycle controller share ONE definition of
# "rollout active"; re-exported here as the reference does.
from predictionio_tpu_torch.registry.probe import registry_rollout_probe  # noqa: E402

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "Decision",
    "FleetShape",
    "ScalingPolicy",
    "registry_rollout_probe",
]
