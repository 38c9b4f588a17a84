"""The port's autoscaler (``predictionio_tpu_torch/fleet/autoscaler.py``)
held to the JAX package's: every ``ScalingPolicy`` script of
``tests/test_autoscaler.py`` gives equal decisions in both packages, the
supervisor's elasticity scripts equal snapshots, one scripted control loop
(ring → policy → supervisor and gateway membership) equal resizes, and
``build_autoscaler`` the same envelopes and refusals."""

from __future__ import annotations

import threading
import time
import types

import pytest

import predictionio_tpu.fleet.autoscaler as jax_autoscaler
import predictionio_tpu.fleet.gateway as jax_gateway
import predictionio_tpu.fleet.launch as jax_launch
import predictionio_tpu.fleet.supervisor as jax_supervisor
import predictionio_tpu_torch.fleet.autoscaler as pt_autoscaler
import predictionio_tpu_torch.fleet.gateway as pt_gateway
import predictionio_tpu_torch.fleet.launch as pt_launch
import predictionio_tpu_torch.fleet.supervisor as pt_supervisor
import tests.test_autoscaler as ref
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from predictionio_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry
from tests.test_fleet import FakeProc
from tests.test_torch_fleet import PACKAGES, metrics_lines, run_reference, supervisor_names, reference_tests

MODULES = {
    "jax": (jax_autoscaler, jax_gateway, jax_supervisor, jax_launch, JaxRegistry),
    "port": (pt_autoscaler, pt_gateway, pt_supervisor, pt_launch, PortRegistry),
}
_CONSTANTS = ("SCALE_OUT", "SCALE_IN", "HOLD", "DEFER")


def recording_policy(base, trace: list):
    class RecordingPolicy(base):
        def decide(self, records, shape, rollout_active, now):
            d = super().decide(records, shape, rollout_active, now)
            trace.append(("decide", now, (shape.device, shape.cpu), rollout_active, d.to_json_dict(),
                          None if self.pending is None else self.pending.to_json_dict()))
            return d

        def note_applied(self, decision, now):
            super().note_applied(decision, now)
            trace.append(("applied", now, decision.to_json_dict()))

    return RecordingPolicy


def policy_names(which: str, trace: list) -> dict:
    mod = MODULES[which][0]
    names = {
        "ScalingPolicy": recording_policy(mod.ScalingPolicy, trace),
        "AutoscalerConfig": mod.AutoscalerConfig,
        "FleetShape": mod.FleetShape,
        "Decision": mod.Decision,
        "REPLICA_CLASS_CPU": mod.REPLICA_CLASS_CPU,
        "REPLICA_CLASS_DEVICE": mod.REPLICA_CLASS_DEVICE,
    }
    names.update({c: getattr(mod, c) for c in _CONSTANTS})
    return names


@pytest.mark.parametrize("cls_name,test_name", reference_tests(ref, "TestScalingPolicy"))
def test_scaling_policy_decides_as_the_reference(cls_name, test_name, monkeypatch, tmp_path):
    """Every ScalingPolicy script of the reference suite (fake clock,
    hand-built ring records): the same decision, pending deferral and
    applied cooldown after each call, and the reference's assertions hold
    for the port."""
    got = {}
    for which in PACKAGES:
        trace: list = []
        run_reference(monkeypatch, ref, policy_names(which, trace), cls_name, test_name, tmp_path)
        got[which] = trace
    assert got["port"] == got["jax"]
    assert any(t[0] == "decide" for t in got["port"])


@pytest.mark.parametrize("cls_name,test_name", reference_tests(ref, "TestSupervisorElasticity"))
def test_supervisor_elasticity_equals_the_reference(cls_name, test_name, monkeypatch, tmp_path):
    """add_worker / retire_worker / live_specs scripts: the same snapshot and
    exposition after every step (retire escalating to SIGKILL, retired
    gauges dropping, parked and retiring workers out of the shape)."""
    got = {}
    for which in PACKAGES:
        trace: list = []
        base = tmp_path / which
        base.mkdir()
        names = supervisor_names(which, trace, str(base))
        names["REPLICA_CLASS_CPU"] = MODULES[which][2].REPLICA_CLASS_CPU
        run_reference(monkeypatch, ref, names, cls_name, test_name, base)
        got[which] = trace
    assert got["port"] == got["jax"]
    assert got["port"]


def _loop_rig(which: str, **policy_kw):
    auto_mod, gw_mod, sup_mod, _, registry_cls = MODULES[which]
    metrics = registry_cls()
    spawned: list = []

    def spawn(spec):
        spawned.append(FakeProc())
        return spawned[-1]

    sup = sup_mod.Supervisor(spawn, [sup_mod.WorkerSpec("w0", 9100)], sup_mod.SupervisorConfig(), metrics=metrics)
    gw = gw_mod.Gateway(gw_mod.GatewayConfig(replica_urls=("http://127.0.0.1:9100",)), metrics=metrics)
    slot = [1]

    def spec_factory(worker_class):
        i = slot[0]
        slot[0] += 1
        return sup_mod.WorkerSpec(f"{'c' if worker_class == 'cpu-fallback' else 'w'}{i}", 9100 + i, worker_class)

    clock = types.SimpleNamespace(now=ref.NOW)
    ring, incidents = ref.FakeRing(), ref.FakeIncidents()
    policy_kw.setdefault("min_replicas", 1)
    policy_kw.setdefault("max_replicas", 2)
    policy_kw.setdefault("cpu_fallback_max", 1)
    policy_kw.setdefault("confirm_s", 10.0)
    policy_kw.setdefault("idle_sustain_s", 20.0)
    policy_kw.setdefault("scale_out_cooldown_s", 0.0)
    policy_kw.setdefault("scale_in_cooldown_s", 0.0)
    rollout = [False]
    auto = auto_mod.Autoscaler(
        auto_mod.ScalingPolicy(auto_mod.AutoscalerConfig(**policy_kw)), sup, gw, spec_factory,
        ring=ring, rollout_probe=lambda: rollout[0], metrics=metrics, incidents=incidents,
        clock=lambda: clock.now,
    )
    sup.start()
    return auto, ring, incidents, gw, sup, clock, rollout


def test_the_control_loop_resizes_as_the_reference(monkeypatch):
    """One scripted episode through the real funnels of each package
    (supervisor with fake processes, a gateway that is not serving):
    pressure scales out the device class to its max, then the
    cpu-fallback class, then saturates (one incident); a resize wanted
    mid-bake is deferred and fires after it; idleness retires the
    cpu-fallback replica first, then the device one, gateway before
    supervisor. Decisions, gateway replicas, supervisor snapshots, the
    ring's scaling records, incidents and the exposition are equal."""
    # the reference FakeRing stamps records with the wall clock; the
    # script's records carry their own times
    got = {}
    for which in PACKAGES:
        auto, ring, incidents, gw, sup, clock, rollout = _loop_rig(which)
        steps = []

        def feed(n, step=1.0, **kw):
            for i in range(n):
                ring.append(ref._rec(clock.now - step * (n - i), **kw))

        def tick(label):
            monkeypatch.setattr(time, "time", lambda: clock.now)
            d = auto.tick()
            steps.append((label, d.to_json_dict(), [(r.name, r.worker_class, r.healthy) for r in gw.replicas],
                          [{k: v for k, v in s.items() if k != "pid"} for s in sup.snapshot()]))
            monkeypatch.undo()
            clock.now += 5.0

        feed(3, burn=3.0)
        tick("burn -> device out")
        feed(3, burn=3.0)
        tick("burn -> cpu out")
        feed(3, burn=3.0)
        tick("saturated")
        feed(3, burn=3.0)
        tick("saturated again")
        clock.now += 40.0
        feed(8, step=3.0, burn=0.0)
        rollout[0] = True
        tick("idle mid-bake -> defer")
        rollout[0] = False
        tick("deferred scale-in fires")
        clock.now += 40.0
        feed(8, step=3.0, burn=0.0)
        tick("idle -> device in")
        for _ in range(3):
            sup.tick()
        got[which] = (steps, [{k: v for k, v in r.items() if k not in ("t", "seq")} for r in ring.records()
                              if r.get("kind") == "scaling"],
                      [k for k, _ in incidents.triggers],
                      [ln for ln in metrics_lines(auto.metrics) if ln.startswith("pio_autoscaler_")
                       or ln.startswith("pio_fleet_")])
    assert got["port"] == got["jax"]
    actions = [s[1]["action"] for s in got["port"][0]]
    assert actions.count("scale-out") == 2 and "defer" in actions and actions.count("scale-in") == 2


def test_run_ticks_on_its_thread_and_counts_errors():
    """The port's Autoscaler.run is a blocking loop: a failing tick is
    counted and retried, and the loop ends when its event is set."""
    auto, ring, *_ = _loop_rig("port")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("registry unreadable")
        return None

    auto.tick = flaky
    auto.policy.config.tick_interval_s = 0.01
    stop = threading.Event()
    t = threading.Thread(target=auto.run, args=(stop,), daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while len(calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive() and len(calls) >= 3
    assert auto._m_errors.value() == 1


BUILD_ARGS = [
    dict(fleet=3),
    dict(fleet=2, fleet_min=2, fleet_max=5, cpu_fallback_max=1, autoscale_interval=0.5),
    dict(fleet=2, fleet_min=0),
    dict(fleet=2, autoscale_interval=0),
    dict(fleet=4, fleet_max=2),
    dict(fleet=2, fleet_min=5, fleet_max=3),
    dict(fleet=2, cpu_fallback_max=-1),
]


@pytest.mark.parametrize("kw", BUILD_ARGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_build_autoscaler_envelopes_and_refusals_equal_the_reference(kw, tmp_path):
    got = {}
    for which in PACKAGES:
        auto_mod, gw_mod, sup_mod, launch, registry_cls = MODULES[which]
        args = types.SimpleNamespace(**{**dict(fleet_min=None, fleet_max=None, cpu_fallback_max=None,
                                               autoscale_interval=None, registry_dir=str(tmp_path)), **kw})
        metrics = registry_cls()
        sup = sup_mod.Supervisor(lambda spec: FakeProc(), [sup_mod.WorkerSpec("w0", 9000)],
                                 sup_mod.SupervisorConfig(), metrics=metrics)
        gw = gw_mod.Gateway(gw_mod.GatewayConfig(replica_urls=("http://127.0.0.1:9000",)), metrics=registry_cls())
        try:
            auto = launch.build_autoscaler(args, sup, gw, lambda cls: sup_mod.WorkerSpec("w9", 9009, cls),
                                           ref.FakeRing(), metrics, {})
            got[which] = ("ok", vars(auto.policy.config), auto.rollout_active())
        except ValueError as exc:
            got[which] = ("refused", str(exc))
    assert got["port"] == got["jax"]
