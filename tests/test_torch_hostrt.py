"""The port's host runtime (``predictionio_tpu_torch/fleet/hostrt.py``) and
the supervisor's host supervision held to the JAX package's: inventory
parsing and placement give equal results (and equal refusals), the ssh and
container drivers build equal command lines with ``subprocess``
monkeypatched, the reference's host-death and placement scripts give equal
snapshots and notifications, and a ``FakeHostDriver.kill_host`` over real
processes folds into one host-death transition in both packages."""

from __future__ import annotations

import dataclasses
import signal
import subprocess
import sys
import time

import pytest

import predictionio_tpu.fleet.hostrt as jax_hostrt
import predictionio_tpu.fleet.supervisor as jax_supervisor
import predictionio_tpu_torch.fleet.hostrt as pt_hostrt
import predictionio_tpu_torch.fleet.supervisor as pt_supervisor
import tests.test_hostrt as ref
from tests.test_torch_fleet import PACKAGES, recording_supervisor, reference_tests, run_reference

HOSTRT = {"jax": jax_hostrt, "port": pt_hostrt}
SUPERVISOR = {"jax": jax_supervisor, "port": pt_supervisor}

INVENTORIES = [
    "box:2",
    "local:2, ssh@node1:4 ,container@pio-img:1,fake@b:3",
    "ssh@deploy@node1:4",
    "container@pio-worker:2",
    "a:1,,b:2",
    "box", "box:none", "box:0", "warp@box:2", "a:1,a:2", "@:2", "", "ssh@:1",
]


def _outcome(fn, *args, **kw):
    try:
        out = fn(*args, **kw)
    except (ValueError, KeyError) as exc:
        return ("raised", type(exc).__name__, str(exc))
    return ("ok", [dataclasses.asdict(o) if dataclasses.is_dataclass(o) else o for o in out])


@pytest.mark.parametrize("spec", INVENTORIES)
def test_parse_hosts_equals_the_reference(spec):
    got = {w: _outcome(HOSTRT[w].parse_hosts, spec) for w in PACKAGES}
    assert got["port"] == got["jax"]


ASSIGNMENTS = [
    (6, (("a", 2), ("b", 2), ("c", 4)), None),
    (2, (("a", 2), ("b", 2), ("c", 4)), {"a": 2, "b": 2}),
    (9, (("a", 2), ("b", 2), ("c", 4)), None),
    (5, (("x", 3), ("b", 1), ("a", 3)), {"zz": 1, "x": 1}),
    (0, (("a", 1),), None),
]


@pytest.mark.parametrize("n,hosts,taken", ASSIGNMENTS)
def test_assign_hosts_equals_the_reference(n, hosts, taken):
    got = {}
    for w in PACKAGES:
        specs = [HOSTRT[w].HostSpec(name, slots) for name, slots in hosts]
        got[w] = _outcome(HOSTRT[w].assign_hosts, n, specs, taken)
    assert got["port"] == got["jax"]


def hostrt_names(which: str) -> dict:
    mod = HOSTRT[which]
    return {name: getattr(mod, name) for name in (
        "DRIVER_CONTAINER", "DRIVER_FAKE", "DRIVER_LOCAL", "DRIVER_SSH", "ContainerHostDriver",
        "FakeHostDriver", "HostDriver", "HostRuntime", "HostSpec", "LocalHostDriver", "SshHostDriver",
        "assign_hosts", "make_driver", "parse_hosts")}


@pytest.mark.parametrize("cls_name,test_name", [
    *reference_tests(ref, "TestParseHosts", skip=("test_malformed_entries_raise",)),
    *reference_tests(ref, "TestAssignHosts"), *reference_tests(ref, "TestSshDriver"),
    *reference_tests(ref, "TestContainerDriver"), *reference_tests(ref, "TestHostRuntime"),
    *reference_tests(ref, "TestLocalDriver"),
])
def test_the_reference_host_runtime_cases_hold_for_the_port(cls_name, test_name, monkeypatch, tmp_path):
    run_reference(monkeypatch, ref, hostrt_names("port"), cls_name, test_name, tmp_path)


def _driver_calls(which: str, monkeypatch, logbook_dir) -> list:
    """Every subprocess call the ssh and container drivers make for one
    script: spawn with and without env, TERM and KILL, probe, log tail."""
    mod = HOSTRT[which]
    calls: list = []

    class Done:
        returncode = 0
        stdout = b"out"
        stderr = b""

    def fake_popen(argv, **kw):
        calls.append(("popen", list(argv), sorted(kw)))
        proc = ref.FakeProc()
        proc.send_signal = lambda sig: calls.append(("send_signal", int(sig)))
        return proc

    def fake_run(argv, **kw):
        calls.append(("run", list(argv), sorted(kw)))
        return Done()

    with monkeypatch.context() as m:
        m.setattr(subprocess, "Popen", fake_popen)
        m.setattr(subprocess, "run", fake_run)
        book = mod.WorkerLogBook(str(logbook_dir)) if logbook_dir else None
        for driver, host in (
            (mod.SshHostDriver(book), mod.HostSpec("node1", 2, driver=mod.DRIVER_SSH, address="u@node1",
                                                    connect_ip="node1")),
            (mod.ContainerHostDriver(book, engine="podman"),
             mod.HostSpec("pio-img", 1, driver=mod.DRIVER_CONTAINER, address="pio-img")),
        ):
            for env in (None, {"CUDA_VISIBLE_DEVICES": "", "A": "x y"}):
                handle = driver.spawn(host, "w0", ["python", "-m", "pio", "deploy", "--port", "8001"], env)
            for sig in (signal.SIGTERM, signal.SIGKILL, signal.SIGINT):
                driver.signal(host, "w0", handle, sig)
            calls.append(("probe", driver.probe(host)))
            calls.append(("tail", driver.fetch_log_tail(host, "w0", 16)))
    return calls


@pytest.mark.parametrize("logbook", [False, True], ids=["no-logbook", "logbook"])
def test_driver_command_lines_equal_the_reference(logbook, monkeypatch, tmp_path):
    got = {}
    for which in PACKAGES:
        book = tmp_path / which if logbook else None
        got[which] = _driver_calls(which, monkeypatch, book)
    assert got["port"] == got["jax"]
    assert any(c[0] == "run" and c[1][-1] == "pkill -TERM -f PIO_WORKER_NAME=w0" for c in got["port"])


def host_names(which: str, trace: list, tmp: str) -> dict:
    sup, host = SUPERVISOR[which], HOSTRT[which]
    return {
        "Supervisor": recording_supervisor(sup.Supervisor, trace, tmp),
        "SupervisorConfig": sup.SupervisorConfig,
        "WorkerSpec": sup.WorkerSpec,
        "HostRuntime": host.HostRuntime,
        "HostSpec": host.HostSpec,
    }


@pytest.mark.parametrize("cls_name,test_name", [
    *reference_tests(ref, "TestSupervisorHostDeath"), *reference_tests(ref, "TestSupervisorHostPlacement")])
def test_host_supervision_equals_the_reference(cls_name, test_name, monkeypatch, tmp_path):
    """The reference's host-death and placement scripts (switchable
    probes, fake processes, fake clock): the same snapshots, exposition
    and on_host_down / on_crash notifications after every step."""
    got = {}
    for which in PACKAGES:
        trace: list = []
        base = tmp_path / which
        base.mkdir()
        run_reference(monkeypatch, ref, host_names(which, trace, str(base)), cls_name, test_name, base)
        got[which] = trace
    assert got["port"] == got["jax"]
    assert got["port"]


def test_kill_host_folds_into_one_host_death_in_both_packages(tmp_path):
    """Real sleeping processes on two fake hosts, spawned through each
    package's HostRuntime: kill_host("ha") SIGKILLs both of ha's residents
    and the next tick files ONE host-death notification naming both,
    no worker crash, and leaves hb's worker running."""
    got = {}
    for which in PACKAGES:
        host, sup_mod = HOSTRT[which], SUPERVISOR[which]
        book = host.WorkerLogBook(str(tmp_path / which / "logs"))
        driver = host.FakeHostDriver(book)
        runtime = host.HostRuntime([host.HostSpec("ha", 2, driver=host.DRIVER_FAKE),
                                    host.HostSpec("hb", 2, driver=host.DRIVER_FAKE)],
                                   logbook=book, drivers={host.DRIVER_FAKE: driver})
        argv = [sys.executable, "-c", "import sys, time; print('up', flush=True); time.sleep(60)"]
        deaths, crashes = [], []
        clock = ref.FakeClock()
        sup = sup_mod.Supervisor(
            lambda spec: runtime.spawn_worker(spec.host, spec.name, argv),
            [sup_mod.WorkerSpec(f"w{i}", 9000 + i, host=h) for i, h in enumerate(("ha", "ha", "hb"))],
            sup_mod.SupervisorConfig(host_probe_interval_s=5.0), clock=clock, runtime=runtime,
            logbook=book, on_crash=crashes.append, on_host_down=deaths.append,
        )
        try:
            sup.start()
            procs = [w.proc for w in sup._workers]
            deadline = time.monotonic() + 20
            while not all("up" in book.tail(f"w{i}") for i in range(3)):
                assert time.monotonic() < deadline, "workers never started"
                time.sleep(0.02)
            assert driver.kill_host("ha") == 2
            for p in procs[:2]:
                p.wait(timeout=10)
            clock.advance(0.1)
            sup.tick()
            snap = [{k: v for k, v in s.items() if k not in ("pid", "logPath")} for s in sup.snapshot()]
            got[which] = (
                [{**d, "workers": sorted(({**w, "logTail": w["logTail"].strip()} for w in d["workers"]),
                                         key=lambda w: w["replica"])} for d in deaths],
                crashes, snap, sup.host_census(), procs[2].poll(),
            )
        finally:
            sup.stop()
    assert got["port"] == got["jax"]
    deaths, crashes, snap, census, alive = got["port"]
    assert len(deaths) == 1 and [w["replica"] for w in deaths[0]["workers"]] == ["w0", "w1"]
    assert all(w["rc"] == -signal.SIGKILL and w["logTail"] == "up" for w in deaths[0]["workers"])
    assert crashes == [] and not census["ha"]["up"] and census["hb"]["up"] and alive is None
