"""Worker supervision: spawn N QueryServer processes, restart crashes.

Port of ``predictionio_tpu/fleet/supervisor.py``: the restart ladder,
crash-loop parking, host-aware placement, scale-in retirement and the
SIGTERM-then-SIGKILL stop are the reference's. Its asyncio driver becomes
:meth:`Supervisor.run`, a blocking loop the fleet launcher runs on a
thread of its own, as the port's servers run their loops; one lock
serialises a tick with the autoscaler's ``add_worker``/``retire_worker``
and with ``stop``.

The reference PredictionIO leans on Spark's driver/executor supervision
for fault tolerance; here the serving fleet gets the same property
directly: a :class:`Supervisor` owns N worker processes on a port range,
polls their liveness, and restarts a crashed worker with exponential
backoff. A worker that crash-loops (more than ``crash_loop_budget``
exits inside ``crash_loop_window_s``) is *parked* — restarting a worker
that dies on startup forever only burns CPU and log volume; the parked
state is visible in metrics (``pio_fleet_worker_parked``) and the
gateway simply keeps routing around the missing replica.

The process handle and the clock are injectable so the restart policy is
unit-testable without real processes or real sleeping; production use
passes a ``subprocess.Popen`` factory (see ``fleet/launch.py``).

With a :class:`~predictionio_tpu_torch.fleet.worklog.WorkerLogBook` attached,
every crash captures the worker's stderr/stdout tail (the spawn factory
routes the child's fds into the logbook — see ``worklog.spawn_with_log``)
and hands it to the ``on_crash`` hook, which the fleet launcher wires to
the incident flight recorder: a SIGKILLed or crash-looping replica
leaves an inspectable bundle, not a silent restart counter.
"""

from __future__ import annotations

import dataclasses
import logging
import signal as _signal
import threading
import time
from typing import Any, Callable, Protocol

from predictionio_tpu_torch.fleet.hostrt import HostRuntime
from predictionio_tpu_torch.fleet.worklog import WorkerLogBook
from predictionio_tpu_torch.obs.metrics import MetricsRegistry

logger = logging.getLogger(__name__)


class ProcessHandle(Protocol):
    """The slice of ``subprocess.Popen`` the supervisor needs."""

    pid: int

    def poll(self) -> int | None: ...

    def terminate(self) -> None: ...

    def kill(self) -> None: ...


REPLICA_CLASS_DEVICE = "device"
REPLICA_CLASS_CPU = "cpu-fallback"


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """One replica slot: a stable name (metric label, restart identity),
    the port its QueryServer binds, and its replica class — ``device``
    (accelerator-bound, the latency path) or ``cpu-fallback`` (cheap
    overflow capacity the gateway routes to only when the device class
    is saturated; docs/fleet.md §Autoscaling). ``host`` is the worker's
    home in the fleet inventory (``--hosts``; the default single-box
    deploy puts everything on ``local``) and ``addr`` is where the
    gateway dials it — loopback unless the host lives elsewhere."""

    name: str
    port: int
    worker_class: str = REPLICA_CLASS_DEVICE
    host: str = "local"
    addr: str = "127.0.0.1"

    @property
    def url(self) -> str:
        return f"http://{self.addr}:{self.port}"


@dataclasses.dataclass
class SupervisorConfig:
    poll_interval_s: float = 0.5
    # exponential restart backoff: crash k (consecutive) waits
    # min(base * mult**k, max) before the respawn
    backoff_base_s: float = 0.5
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 30.0
    # a worker alive this long resets its consecutive-crash count (the
    # backoff ladder is for crash *loops*, not for a crash a week apart)
    healthy_reset_s: float = 30.0
    # crash-loop budget: more than this many exits inside the window
    # parks the worker instead of restarting it again
    crash_loop_window_s: float = 60.0
    crash_loop_budget: int = 5
    # graceful stop: SIGTERM (workers drain), wait this long, then SIGKILL
    term_grace_s: float = 15.0
    # multi-host: host liveness probe cadence and how many consecutive
    # probe failures declare the host dead (every resident worker marked
    # crashed in ONE transition; docs/fleet.md §Multi-host)
    host_probe_interval_s: float = 5.0
    host_probe_failures: int = 1


class _Worker:
    __slots__ = (
        "spec",
        "proc",
        "started_at",
        "consecutive_crashes",
        "crash_times",
        "next_restart_at",
        "parked",
        "restarts",
        "retiring",
        "retire_deadline",
    )

    def __init__(self, spec: WorkerSpec):
        self.spec = spec
        self.proc: ProcessHandle | None = None
        self.started_at = 0.0
        self.consecutive_crashes = 0
        self.crash_times: list[float] = []
        self.next_restart_at = 0.0
        self.parked = False
        self.restarts = 0  # respawns after a crash (not the initial spawn)
        # scale-in state: a retiring worker was SIGTERMed to drain; its
        # exit is a completion, not a crash, and it is never respawned
        self.retiring = False
        self.retire_deadline = 0.0


class _Host:
    """Per-host supervision state: the liveness verdict and the host's
    own crash ladder (host DEATHS back off like worker crashes do — a
    box that flaps shouldn't get its whole worker complement respawned
    at full speed every time the probe blips back)."""

    __slots__ = (
        "name",
        "up",
        "deaths",
        "probe_failures",
        "last_probe_at",
        "down_since",
    )

    def __init__(self, name: str):
        self.name = name
        self.up = True
        self.deaths = 0  # up->down transitions (the host crash ladder)
        self.probe_failures = 0  # consecutive
        self.last_probe_at = 0.0
        self.down_since = 0.0


class Supervisor:
    """Spawn, watch, restart. ``tick()`` is the whole policy — drive it
    from a thread (:meth:`run`) or directly from tests with a fake
    clock."""

    def __init__(
        self,
        spawn: Callable[[WorkerSpec], ProcessHandle],
        specs: list[WorkerSpec],
        config: SupervisorConfig | None = None,
        metrics: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
        logbook: WorkerLogBook | None = None,
        on_crash: Callable[[dict[str, Any]], None] | None = None,
        runtime: HostRuntime | None = None,
        on_host_down: Callable[[dict[str, Any]], None] | None = None,
    ):
        self._spawn = spawn
        self.config = config or SupervisorConfig()
        self._clock = clock
        self._workers = [_Worker(spec) for spec in specs]
        self._stopping = False
        # a tick, a runtime add/retire and the start of a stop never
        # interleave: a respawn racing the stop would orphan a worker
        self._lock = threading.RLock()
        self._wake = threading.Event()
        # crash evidence plumbing: the logbook tails the dead worker's
        # captured output, on_crash (the incident-recorder hook) gets one
        # dict per exit with the tail attached
        self.logbook = logbook
        self._on_crash = on_crash
        # multi-host: the runtime carries the inventory + drivers; None
        # means the classic single-box deploy (every spec homes on
        # "local", no probes, the single-box behavior)
        self._runtime = runtime
        self._on_host_down = on_host_down
        self._hosts: dict[str, _Host] = {}
        if runtime is not None:
            self._hosts = {h.name: _Host(h.name) for h in runtime.hosts()}
        m = metrics or MetricsRegistry()
        self.metrics = m
        self._m_restarts = m.counter(
            "pio_fleet_restarts_total",
            "supervisor respawns of crashed workers, by replica",
            labelnames=("replica",),
        )
        self._m_crash_loops = m.counter(
            "pio_fleet_crash_loops_total",
            "workers parked for exceeding the crash-loop budget",
            labelnames=("replica",),
        )
        self._m_up = m.gauge(
            "pio_fleet_worker_up",
            "1 when the supervised worker process is running",
            labelnames=("replica",),
        )
        self._m_parked = m.gauge(
            "pio_fleet_worker_parked",
            "1 when the worker exceeded its crash-loop budget and was parked",
            labelnames=("replica",),
        )
        self._m_last_crash = m.gauge(
            "pio_fleet_worker_last_crash_unix",
            "unix time of the worker's most recent exit (0 = never crashed)",
            labelnames=("replica",),
        )
        self._m_log_info = m.gauge(
            "pio_fleet_worker_log_info",
            "1 per worker whose output is captured; the `path` label is "
            "where the rotating tail lives (`pio top --fleet` shows it "
            "for crashed workers)",
            labelnames=("replica", "path"),
        )
        self._m_retired = m.counter(
            "pio_fleet_retired_total",
            "workers retired by a scale-in (graceful SIGTERM drain, never "
            "respawned), by replica class",
            labelnames=("worker_class",),
        )
        self._m_host_up = m.gauge(
            "pio_fleet_host_up",
            "1 while the host's liveness probe passes; 0 marks a host "
            "death (every resident worker crashed in one transition)",
            labelnames=("host",),
        )
        self._m_host_slots = m.gauge(
            "pio_fleet_host_slots",
            "worker slots the host offers in the --hosts inventory",
            labelnames=("host",),
        )
        self._m_host_deaths = m.counter(
            "pio_fleet_host_deaths_total",
            "host up->down transitions (probe failed / all residents "
            "gone); one incident bundle each, not one per worker",
            labelnames=("host",),
        )
        self._m_worker_host = m.gauge(
            "pio_fleet_worker_host_info",
            "1 per supervised worker; the `host` label is its home in "
            "the fleet inventory (`pio top --fleet` groups by it)",
            labelnames=("replica", "host"),
        )
        if runtime is not None:
            for h in runtime.hosts():
                self._m_host_up.set(1.0, host=h.name)
                self._m_host_slots.set(float(h.slots), host=h.name)
        for w in self._workers:
            self._m_worker_host.set(
                1.0, replica=w.spec.name, host=w.spec.host
            )
        if self.logbook is not None:
            for w in self._workers:
                self._m_log_info.set(
                    1.0,
                    replica=w.spec.name,
                    path=self.logbook.path(w.spec.name),
                )
        m.register_collector(self._collect)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Initial spawn of every worker."""
        for w in self._workers:
            self._start_worker(w)

    def _start_worker(self, w: _Worker) -> None:
        try:
            w.proc = self._spawn(w.spec)
        except Exception:
            # a failed spawn is accounted exactly like an instant crash so
            # the backoff/park machinery bounds it too
            logger.exception("spawn failed for worker %s", w.spec.name)
            w.proc = None
            self._record_crash(w)
            return
        w.started_at = self._clock()
        logger.info(
            "worker %s up (pid %s, port %d)",
            w.spec.name,
            getattr(w.proc, "pid", "?"),
            w.spec.port,
        )

    def tick(self) -> None:
        """One supervision pass: probe host liveness, reap exits,
        schedule/execute restarts, escalate and reap retiring (scale-in)
        workers. Runs on an executor thread in production (:meth:`run`)
        — host probes and remote spawns block."""
        with self._lock:
            self._tick()

    def _tick(self) -> None:
        if self._stopping:
            return
        now = self._clock()
        self._probe_hosts(now)
        exited_by_host: dict[str, list[tuple[_Worker, int | None]]] = {}
        for w in list(self._workers):
            if w.retiring:
                self._tick_retiring(w, now)
                continue
            if w.parked:
                continue
            host = self._hosts.get(w.spec.host)
            if host is not None and not host.up:
                # residents of a dead host wait for the probe to pass
                # again; their restart clock starts at revival
                continue
            if w.proc is None:
                if now >= w.next_restart_at:
                    w.restarts += 1
                    self._m_restarts.inc(replica=w.spec.name)
                    self._start_worker(w)
                continue
            rc = w.proc.poll()
            if rc is None:
                if (
                    w.consecutive_crashes
                    and now - w.started_at >= self.config.healthy_reset_s
                ):
                    w.consecutive_crashes = 0
                continue
            logger.warning(
                "worker %s (port %d) exited rc=%s", w.spec.name, w.spec.port, rc
            )
            w.proc = None
            if host is not None:
                # defer the crash verdict: simultaneous exits on one box
                # smell like a host death, and a host death must be ONE
                # transition, not N worker crashes
                exited_by_host.setdefault(w.spec.host, []).append((w, rc))
            else:
                self._record_crash(w, rc=rc)
        self._judge_exits(exited_by_host, now)

    # -------------------------------------------------------------- hosts
    def _judge_exits(
        self,
        exited_by_host: dict[str, list[tuple[_Worker, int | None]]],
        now: float,
    ) -> None:
        """Exits observed this pass, grouped by host: any resident dying
        triggers an immediate liveness probe; a failed probe converts
        the whole group (plus anything still resident) into one
        host-death transition — even when the dying residents straddled
        two poll ticks, the first lone exit already flips the verdict.
        A passing probe means the workers really did crash
        individually."""
        for host_name, group in exited_by_host.items():
            host = self._hosts[host_name]
            if group and not self._probe_once(host, now):
                self._host_down(host, now, exited=group)
                continue
            for w, rc in group:
                self._record_crash(w, rc=rc)

    def _probe_once(self, host: _Host, now: float) -> bool:
        ok = self._runtime.probe(host.name)
        host.last_probe_at = now
        if ok:
            host.probe_failures = 0
        else:
            host.probe_failures += 1
        return ok

    def _probe_hosts(self, now: float) -> None:
        """Periodic host liveness: a host failing
        ``host_probe_failures`` consecutive probes is declared dead; a
        dead host whose probe passes again is readmitted and its
        residents respawn up the host's backoff ladder."""
        if self._runtime is None:
            return
        for host in self._hosts.values():
            if now - host.last_probe_at < self.config.host_probe_interval_s:
                continue
            ok = self._probe_once(host, now)
            if host.up and not ok:
                if host.probe_failures >= self.config.host_probe_failures:
                    self._host_down(host, now)
            elif not host.up and ok:
                self._host_up(host, now)

    def _host_down(
        self,
        host: _Host,
        now: float,
        exited: list[tuple[_Worker, int | None]] | None = None,
    ) -> None:
        """The host-death transition: every resident worker is marked
        crashed HERE, in one pass — one `on_host_down` notification (one
        incident bundle) carrying every dead worker's log tail, instead
        of N interleaved worker-crash bundles. Residents do NOT climb
        their own crash ladders (the box died, not their code); the
        ladder that moves is the host's."""
        if not host.up:
            return
        host.up = False
        host.deaths += 1
        host.down_since = now
        self._m_host_up.set(0.0, host=host.name)
        self._m_host_deaths.inc(host=host.name)
        dead: list[dict[str, Any]] = []
        exited_names = {w.spec.name for w, _ in (exited or [])}
        for w, rc in exited or []:
            dead.append(self._host_death_entry(w, rc))
        for w in self._workers:
            if (
                w.spec.host != host.name
                or w.retiring
                or w.parked
                or w.spec.name in exited_names
            ):
                continue
            rc = None
            if w.proc is not None:
                # best-effort reap/kill of whatever handle survives (an
                # ssh client to a dead box, a local proc on a fake host)
                try:
                    rc = w.proc.poll()
                    if rc is None:
                        w.proc.kill()
                except (OSError, ValueError):
                    pass
                w.proc = None
            dead.append(self._host_death_entry(w, rc))
        # restart clock: residents become eligible once the host probe
        # passes again, after the host's own backoff ladder
        backoff = min(
            self.config.backoff_max_s,
            self.config.backoff_base_s
            * self.config.backoff_multiplier ** max(0, host.deaths - 1),
        )
        for w in self._workers:
            if w.spec.host == host.name and not w.retiring and not w.parked:
                w.next_restart_at = now + backoff
                self._m_last_crash.set(time.time(), replica=w.spec.name)
        logger.error(
            "host %s DOWN: %d resident workers marked crashed in one "
            "transition (host death #%d)",
            host.name,
            len(dead),
            host.deaths,
        )
        if self._on_host_down is not None:
            info = {
                "host": host.name,
                "deaths": host.deaths,
                "workers": dead,
            }
            try:
                self._on_host_down(info)
            except Exception:
                logger.exception("on_host_down hook failed for %s", host.name)

    def _host_death_entry(
        self, w: _Worker, rc: int | None
    ) -> dict[str, Any]:
        entry: dict[str, Any] = {
            "replica": w.spec.name,
            "port": w.spec.port,
            "workerClass": w.spec.worker_class,
            "rc": rc,
        }
        if self._runtime is not None:
            try:
                entry["logTail"] = self._runtime.log_tail(
                    w.spec.host, w.spec.name
                )
            except Exception:
                entry["logTail"] = ""
        return entry

    def _host_up(self, host: _Host, now: float) -> None:
        host.up = True
        host.down_since = 0.0
        self._m_host_up.set(1.0, host=host.name)
        logger.warning(
            "host %s readmitted after probe recovery; residents respawn "
            "on their restart clocks",
            host.name,
        )

    def host_census(self) -> dict[str, dict[str, Any]]:
        """Inventory view for placement and `pio top`: per host, the
        declared slots, liveness, death count, and resident workers
        (parked included — they hold a slot until retired)."""
        if self._runtime is None:
            return {}
        out: dict[str, dict[str, Any]] = {}
        for h in self._runtime.hosts():
            st = self._hosts[h.name]
            resident = [
                w.spec.name
                for w in self._workers
                if w.spec.host == h.name and not w.retiring
            ]
            out[h.name] = {
                "slots": h.slots,
                "driver": h.driver,
                "up": st.up,
                "deaths": st.deaths,
                "resident": resident,
            }
        return out

    def pick_host(self) -> str | None:
        """Host-aware placement for scale-out: the UP host with the most
        free slot headroom (ties by name). None when every live host is
        full — the autoscaler's envelope should treat that as saturated.
        Without a runtime there is no inventory and placement is the
        caller's 'local' default."""
        if self._runtime is None:
            return None
        best: tuple[float, str] | None = None
        for name, info in self.host_census().items():
            if not info["up"]:
                continue
            free = info["slots"] - len(info["resident"])
            if free <= 0:
                continue
            score = (len(info["resident"]) / info["slots"], name)
            if best is None or score < best:
                best = score
        return best[1] if best else None

    def _tick_retiring(self, w: _Worker, now: float) -> None:
        """Drive one retiring worker: already gone -> reap; past the
        drain grace -> SIGKILL (reaped on a later tick)."""
        rc = w.proc.poll() if w.proc is not None else 0
        if w.proc is None or rc is not None:
            self._reap_retired(w, rc)
            return
        if now >= w.retire_deadline:
            logger.warning(
                "retiring worker %s ignored SIGTERM for %.0fs; killing",
                w.spec.name,
                self.config.term_grace_s,
            )
            self._deliver(w, _signal.SIGKILL)
            # one more grace slice for the SIGKILL to be reaped
            w.retire_deadline = now + self.config.poll_interval_s

    def _reap_retired(self, w: _Worker, rc: int | None) -> None:
        self._workers = [x for x in self._workers if x is not w]
        self._prune_series()
        logger.info(
            "worker %s retired (rc=%s); %d workers remain",
            w.spec.name,
            rc,
            len(self._workers),
        )

    # ------------------------------------------------------------ elasticity
    def add_worker(self, spec: WorkerSpec) -> None:
        """Scale-out entry: register + spawn one new worker at runtime.
        The restart/park policy covers it exactly like a boot-time
        worker."""
        with self._lock:
            self._add_worker(spec)

    def _add_worker(self, spec: WorkerSpec) -> None:
        if any(w.spec.name == spec.name for w in self._workers):
            raise ValueError(f"worker {spec.name!r} already supervised")
        if spec.host not in self._hosts and self._runtime is not None:
            raise ValueError(
                f"worker {spec.name!r} homed on unknown host {spec.host!r}"
            )
        w = _Worker(spec)
        self._workers.append(w)
        self._m_worker_host.set(1.0, replica=spec.name, host=spec.host)
        if self.logbook is not None:
            self._m_log_info.set(
                1.0, replica=spec.name, path=self.logbook.path(spec.name)
            )
        self._start_worker(w)

    def retire_worker(self, name: str) -> bool:
        """Scale-in entry: SIGTERM the worker (it drains via the
        ``create_server`` drain path — in-flight answered, listener
        closed) and stop restarting it. The exit is reaped by
        :meth:`tick`, which drops the worker and its per-replica gauges.
        Returns False when no such worker exists. The caller must stop
        routing to the replica BEFORE retiring it (gateway membership
        first, process second) — that ordering is what makes scale-in
        5xx-free."""
        with self._lock:
            return self._retire_worker(name)

    def _retire_worker(self, name: str) -> bool:
        for w in self._workers:
            if w.spec.name != name or w.retiring:
                continue
            w.retiring = True
            # the retire DECISION is the telemetry event (the reap is
            # mechanics); counted here so the scale-in timeline in the
            # exposition matches the moment routing stopped
            self._m_retired.inc(worker_class=w.spec.worker_class)
            w.retire_deadline = self._clock() + self.config.term_grace_s
            if w.proc is not None and w.proc.poll() is None:
                self._deliver(w, _signal.SIGTERM)
            else:
                # nothing running (crashed/parked): reap immediately
                self._reap_retired(w, None)
            return True
        return False

    def live_specs(self) -> list[WorkerSpec]:
        """Workers that count toward fleet capacity: not parked, not
        retiring — the shape the autoscaler's envelope clamps."""
        return [
            w.spec for w in self._workers if not w.parked and not w.retiring
        ]

    def _prune_series(self) -> None:
        """Reconcile per-replica gauges against the live worker set: a
        retired worker's ``pio_fleet_worker_up``/``parked``/crash/log
        series must drop from the exposition, not render as a live-but-
        down replica forever. Counters (restarts, crash loops) stay —
        they are monotonic history, not live-set claims."""
        live = [w.spec.name for w in self._workers]
        for gauge in (
            self._m_up,
            self._m_parked,
            self._m_last_crash,
            self._m_log_info,
            self._m_worker_host,
        ):
            gauge.prune("replica", live)

    def _record_crash(self, w: _Worker, rc: int | None = None) -> None:
        now = self._clock()
        w.crash_times.append(now)
        cutoff = now - self.config.crash_loop_window_s
        w.crash_times = [t for t in w.crash_times if t >= cutoff]
        self._m_last_crash.set(time.time(), replica=w.spec.name)
        if len(w.crash_times) > self.config.crash_loop_budget:
            w.parked = True
            self._m_crash_loops.inc(replica=w.spec.name)
            logger.error(
                "worker %s parked: %d exits inside %.0fs (budget %d) — "
                "not restarting; fix the crash and redeploy",
                w.spec.name,
                len(w.crash_times),
                self.config.crash_loop_window_s,
                self.config.crash_loop_budget,
            )
            self._notify_crash(w, rc, parked=True)
            return
        backoff = min(
            self.config.backoff_max_s,
            self.config.backoff_base_s
            * self.config.backoff_multiplier**w.consecutive_crashes,
        )
        w.consecutive_crashes += 1
        w.next_restart_at = now + backoff
        logger.info(
            "worker %s restart in %.2fs (consecutive crash %d)",
            w.spec.name,
            backoff,
            w.consecutive_crashes,
        )
        self._notify_crash(w, rc, parked=False)

    def _notify_crash(self, w: _Worker, rc: int | None, parked: bool) -> None:
        """Hand the crash (with the dead worker's captured stderr tail)
        to the on_crash hook — the incident-recorder wiring. Guarded: the
        flight recorder failing must never stall the restart policy."""
        if self._on_crash is None:
            return
        info: dict[str, Any] = {
            "replica": w.spec.name,
            "port": w.spec.port,
            "rc": rc,
            "parked": parked,
            "restarts": w.restarts,
            "consecutiveCrashes": w.consecutive_crashes,
            "crashesInWindow": len(w.crash_times),
        }
        if self.logbook is not None:
            info["logPath"] = self.logbook.path(w.spec.name)
            info["stderrTail"] = self.logbook.tail(w.spec.name)
        try:
            self._on_crash(info)
        except Exception:
            logger.exception("on_crash hook failed for %s", w.spec.name)

    def _deliver(self, w: _Worker, sig: int) -> None:
        """Route a signal through the worker's host driver: a remote
        worker needs the FAR side signalled (ssh pkill, container kill),
        not just its local client handle."""
        if w.proc is None:
            return
        try:
            if self._runtime is not None:
                self._runtime.signal_worker(
                    w.spec.host, w.spec.name, w.proc, sig
                )
            elif sig == _signal.SIGKILL:
                w.proc.kill()
            else:
                w.proc.terminate()
        except (OSError, ValueError):
            pass

    def run(self) -> None:
        """Blocking driver for :meth:`tick`, one pass every
        ``poll_interval_s`` until :meth:`stop` begins. The launcher runs
        it on a thread of its own: a multi-host tick blocks (ssh probes,
        container spawns), and even the local driver's spawn is a fork —
        none of it belongs on a thread that answers requests. A failing
        pass is logged and the next one runs."""
        while not self._stopping:
            try:
                self.tick()
            except Exception:
                logger.exception("supervisor tick failed")
            self._wake.wait(self.config.poll_interval_s)

    def stop(self) -> None:
        """Graceful fleet stop: SIGTERM every worker (they drain), wait
        ``term_grace_s``, SIGKILL stragglers. Blocking — call from a
        thread, never one that answers requests."""
        with self._lock:
            self._stopping = True
            self._wake.set()
            live = [w for w in self._workers if w.proc is not None]
            for w in live:
                self._deliver(w, _signal.SIGTERM)
        deadline = self._clock() + self.config.term_grace_s
        while self._clock() < deadline:
            if all(w.proc is None or w.proc.poll() is not None for w in live):
                break
            time.sleep(0.05)
        for w in live:
            if w.proc is not None and w.proc.poll() is None:
                logger.warning(
                    "worker %s ignored SIGTERM for %.0fs; killing",
                    w.spec.name,
                    self.config.term_grace_s,
                )
                self._deliver(w, _signal.SIGKILL)

    # ------------------------------------------------------------- queries
    def _collect(self) -> None:
        for w in self._workers:
            up = w.proc is not None and w.proc.poll() is None
            self._m_up.set(1.0 if up else 0.0, replica=w.spec.name)
            self._m_parked.set(1.0 if w.parked else 0.0, replica=w.spec.name)

    def snapshot(self) -> list[dict[str, Any]]:
        return [
            {
                "name": w.spec.name,
                "port": w.spec.port,
                "host": w.spec.host,
                "pid": getattr(w.proc, "pid", None) if w.proc else None,
                "up": w.proc is not None and w.proc.poll() is None,
                "parked": w.parked,
                "retiring": w.retiring,
                "workerClass": w.spec.worker_class,
                "restarts": w.restarts,
                "consecutiveCrashes": w.consecutive_crashes,
                "logPath": (
                    self.logbook.path(w.spec.name)
                    if self.logbook is not None
                    else None
                ),
            }
            for w in self._workers
        ]

    @property
    def workers(self) -> list[WorkerSpec]:
        return [w.spec for w in self._workers]


def terminate_gracefully(proc: ProcessHandle) -> None:
    """SIGTERM spelled portably (Popen.terminate is SIGTERM on POSIX)."""
    try:
        proc.terminate()
    except (OSError, ValueError):
        pass


__all__ = [
    "ProcessHandle",
    "REPLICA_CLASS_CPU",
    "REPLICA_CLASS_DEVICE",
    "Supervisor",
    "SupervisorConfig",
    "WorkerSpec",
    "terminate_gracefully",
]
