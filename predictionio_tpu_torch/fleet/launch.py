"""``pio deploy --fleet N`` glue: supervisor + gateway in one process.

Port of ``predictionio_tpu/fleet/launch.py``. Topology: the gateway binds
the requested ``--port``; worker i is a child ``pio deploy`` process of
the port's CLI on ``port + 1 + i`` bound to localhost (only the gateway
faces traffic). Workers inherit every deploy flag the operator passed
except the fleet's own, and get a registry sync interval so rollout state
changes propagate fleet-wide. A device-class worker serves on the card
(``--device`` as the operator passed it, ``cuda`` by default) and exits
non-zero when it cannot get one; a cpu-fallback worker sees no card
(``CUDA_VISIBLE_DEVICES=""``) and serves with ``--device cpu``.

SIGTERM to the parent (or ``POST /stop`` on the gateway) is a
zero-downtime stop: every gateway drains (listener closed, in-flight
answered), then the supervisor SIGTERMs the workers — which drain too —
escalating to SIGKILL only past the grace window. The supervisor, the
autoscaler and the lifecycle controller each tick on a thread of their
own.

The fleet observability plane (``--obs-dir``, default ``pio_obs``) also
lives here: worker stderr/stdout captured into per-replica rotating tail
files (:mod:`.worklog`), a durable telemetry ring the gateway appends
fleet snapshots into (:mod:`obs.tsring`), and the incident flight
recorder (:mod:`obs.incidents`) whose sources — merged traces, ring
tail, supervisor ladder, registry state — are wired up so a worker
crash, breaker trip, or fleet SLO alert leaves an inspectable bundle
(``pio incidents list``).
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
from typing import Any, Callable

from predictionio_tpu_torch.fleet.gateway import Gateway, GatewayConfig, GatewayGroup
from predictionio_tpu_torch.fleet.hostrt import (
    DRIVER_CONTAINER,
    DRIVER_SSH,
    HostRuntime,
    assign_hosts,
    parse_hosts,
)
from predictionio_tpu_torch.fleet.supervisor import (
    REPLICA_CLASS_CPU,
    REPLICA_CLASS_DEVICE,
    Supervisor,
    SupervisorConfig,
    WorkerSpec,
)
from predictionio_tpu_torch.fleet.worklog import WorkerLogBook, spawn_with_log
from predictionio_tpu_torch.obs.incidents import IncidentRecorder
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.obs.tsring import TelemetryRing

logger = logging.getLogger(__name__)

# flags that must not leak from the operator's command line into worker
# argv: the fleet topology flags (value-taking unless noted)
_STRIP_FLAGS = {
    "--fleet": True,
    "--port": True,
    "--ip": True,
    "--fleet-probe-interval": True,
    "--registry-sync-interval": True,
    "--obs-dir": True,
    # elasticity flags are parent-only too (a worker recursively
    # autoscaling would be a fork bomb with extra steps)
    "--autoscale": False,
    "--fleet-min": True,
    "--fleet-max": True,
    "--cpu-fallback-max": True,
    "--autoscale-interval": True,
    # multi-host / multi-gateway topology flags are parent-only too
    "--hosts": True,
    "--gateways": True,
    # the lifecycle controller lives in the fleet parent only (a worker
    # running its own retune loop would grid-search once per replica)
    "--lifecycle": True,
    "--lifecycle-cadence": True,
    "--lifecycle-cooldown": True,
    "--lifecycle-workers": True,
    "--lifecycle-nice": True,
    "--lifecycle-warm-limit": True,
    "--lifecycle-app": True,
}

# the cpu-fallback class also drops the operator's --device: it serves on
# the CPU whatever the device class serves on
_CPU_STRIP_FLAGS = {**_STRIP_FLAGS, "--device": True}

# what hides every card from a cpu-fallback worker (the grid workers'
# convention, tuning/runner.py)
CPU_FALLBACK_ENV = {"CUDA_VISIBLE_DEVICES": ""}


def worker_argv(
    cli_argv: list[str],
    port: int,
    sync_interval_s: float,
    bind_ip: str = "127.0.0.1",
    worker_class: str = REPLICA_CLASS_DEVICE,
) -> list[str]:
    """Child process argv for one worker, derived from the parent's CLI
    argv (everything after the program name). Strips the fleet/port flags
    (both ``--flag value`` and ``--flag=value`` spellings) and appends the
    worker's own port + registry sync cadence. Workers on a REMOTE host
    bind all interfaces (the gateway dials them across the wire);
    same-box workers stay loopback-only. A cpu-fallback worker's argv
    also loses any ``--device`` and ends with ``--device cpu``."""
    cpu = worker_class == REPLICA_CLASS_CPU
    strip = _CPU_STRIP_FLAGS if cpu else _STRIP_FLAGS
    out: list[str] = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli"]
    skip = False
    for arg in cli_argv:
        if skip:
            skip = False
            continue
        flag = arg.split("=", 1)[0]
        if flag in strip:
            skip = strip[flag] and "=" not in arg
            continue
        out.append(arg)
    out += [
        "--ip",
        bind_ip,
        "--port",
        str(port),
        "--registry-sync-interval",
        str(sync_interval_s),
    ]
    if cpu:
        out += ["--device", "cpu"]
    return out


def _run_every(
    name: str,
    interval_s: float,
    tick: Callable[[], Any],
    stop: threading.Event,
    on_error: Callable[[], None],
) -> threading.Thread:
    """A thread that calls ``tick`` every ``interval_s`` until ``stop``;
    a failing tick is counted through ``on_error`` and retried."""

    def loop() -> None:
        while not stop.is_set():
            try:
                tick()
            except Exception:
                on_error()
                logger.exception("%s tick failed", name)
            stop.wait(interval_s)

    t = threading.Thread(target=loop, name=name, daemon=True)
    t.start()
    return t


def run_fleet(
    args,
    cli_argv: list[str],
    *,
    wait: Callable[[threading.Event], int | None],
    storage: Callable[[], Any] | None = None,
) -> int:
    """Blocking fleet entry point for ``cmd_deploy``. ``cli_argv`` is the
    raw CLI argument vector the workers are derived from; ``wait`` blocks
    until SIGINT, SIGTERM or the given event (the gateway's ``POST
    /stop``) and returns the signal (None for the event); ``storage``
    returns the store the lifecycle's cells and warm queries read."""
    n = int(args.fleet)
    if n < 1:
        raise ValueError("--fleet needs at least 1 replica")
    if getattr(args, "ssl_certfile", None) or getattr(args, "ssl_keyfile", None):
        # workers would inherit the TLS flags and serve HTTPS, but the
        # gateway probes/forwards plain HTTP on loopback — every replica
        # would fail its handshake and the fleet would serve nothing.
        # Terminate TLS in front of the gateway instead.
        raise ValueError(
            "--fleet does not support --ssl-certfile/--ssl-keyfile: workers "
            "bind loopback behind the plain-HTTP gateway; terminate TLS at a "
            "front proxy"
        )
    # None = flag unset (fleet workers default to 1 s); an EXPLICIT 0
    # disables the sync loop, exactly as the help text promises
    sync_arg = getattr(args, "registry_sync_interval", None)
    sync_s = 1.0 if sync_arg is None else float(sync_arg)
    n_gateways = int(getattr(args, "gateways", 1) or 1)
    if n_gateways < 1:
        raise ValueError("--gateways needs at least 1 gateway")
    metrics = MetricsRegistry()
    obs = build_obs_plane(
        getattr(args, "obs_dir", "pio_obs"),
        metrics,
        registry_dir=getattr(args, "registry_dir", None),
    )
    logbook = obs.get("logbook")

    # host inventory (--hosts): the declared boxes workers place across;
    # unset collapses to the classic single-box deploy (no runtime, no
    # probes)
    hosts_arg = getattr(args, "hosts", None)
    runtime = None
    if hosts_arg:
        host_specs = parse_hosts(hosts_arg)
        runtime = HostRuntime(host_specs, logbook=logbook)
        placement = assign_hosts(n, host_specs)
        specs = [
            WorkerSpec(
                name=f"w{i}",
                port=args.port + n_gateways + i,
                host=placement[i],
                addr=runtime.host(placement[i]).connect_ip,
            )
            for i in range(n)
        ]
    else:
        # gateways occupy ports base..base+G-1; workers follow. With the
        # default single gateway that is exactly the port+1+i scheme.
        specs = [
            WorkerSpec(name=f"w{i}", port=args.port + n_gateways + i)
            for i in range(n)
        ]

    def spawn(spec: WorkerSpec):
        cpu = spec.worker_class == REPLICA_CLASS_CPU
        if runtime is not None:
            host = runtime.host(spec.host)
            remote = host.driver in (DRIVER_SSH, DRIVER_CONTAINER)
            argv = worker_argv(
                cli_argv,
                spec.port,
                sync_s,
                bind_ip="0.0.0.0" if remote else "127.0.0.1",
                worker_class=spec.worker_class,
            )
            if remote:
                # remote spawns export ONLY what the worker needs; the
                # parent's whole environment does not belong on the wire
                env = dict(CPU_FALLBACK_ENV) if cpu else None
            else:
                env = {**os.environ, **CPU_FALLBACK_ENV} if cpu else None
            return runtime.spawn_worker(spec.host, spec.name, argv, env)
        argv = worker_argv(cli_argv, spec.port, sync_s, worker_class=spec.worker_class)
        env = None
        if cpu:
            # the cpu-fallback class IS the cheap tier: same server
            # stack, no card — overflow degrades to slower answers
            # instead of competing for the accelerator
            env = {**os.environ, **CPU_FALLBACK_ENV}
        if logbook is not None:
            return spawn_with_log(argv, logbook, spec.name, env=env)
        return subprocess.Popen(argv, env=env)

    def on_host_down(info: dict) -> None:
        # ONE bundle per host death (the supervisor already folded every
        # resident worker into this single transition); each dead
        # worker's log tail lands as its own text part
        incidents = obs.get("incidents")
        if incidents is None:
            return
        texts = {}
        for winfo in info.get("workers", []):
            tail = winfo.pop("logTail", "")
            if tail:
                texts[f"log_tail_{winfo['replica']}"] = tail
        incidents.trigger("host-death", context=info, texts=texts)

    supervisor = Supervisor(
        spawn=spawn,
        specs=specs,
        config=SupervisorConfig(),
        metrics=metrics,
        logbook=logbook,
        on_crash=obs.get("on_crash"),
        runtime=runtime,
        on_host_down=on_host_down,
    )

    # scale-out slot allocator: names/ports after the boot-time range,
    # monotonic so a retired slot is never reused while its old process
    # could still be draining. Placement is host-aware: the supervisor
    # picks the UP host with the most free slots.
    next_slot = [n]
    slot_lock = threading.Lock()

    def spec_factory(worker_class: str) -> WorkerSpec:
        with slot_lock:
            i = next_slot[0]
            next_slot[0] += 1
        prefix = "c" if worker_class == REPLICA_CLASS_CPU else "w"
        kw = {}
        if runtime is not None:
            host = supervisor.pick_host()
            if host is None:
                raise RuntimeError(
                    "scale-out wanted but no live host has a free slot "
                    "(grow --hosts)"
                )
            kw = {"host": host, "addr": runtime.host(host).connect_ip}
        return WorkerSpec(
            name=f"{prefix}{i}",
            port=args.port + n_gateways + i,
            worker_class=worker_class,
            **kw,
        )

    gateways: list[Gateway] = []
    rings = [obs.get("telemetry")]
    for g in range(n_gateways):
        if g == 0:
            ring_g = obs.get("telemetry")
        elif obs.get("dir"):
            # peer gateways write the SAME ring directory under their own
            # writer namespace — never interleaving a segment file
            ring_g = TelemetryRing(
                os.path.join(obs["dir"], "telemetry"), writer_id=f"g{g}"
            )
            rings.append(ring_g)
        else:
            ring_g = None
        gateways.append(
            Gateway(
                GatewayConfig(
                    ip=args.ip,
                    port=args.port + g,
                    replica_urls=tuple(s.url for s in specs),
                    probe_interval_s=getattr(args, "fleet_probe_interval", 1.0),
                    request_timeout_s=args.request_timeout,
                    breaker_threshold=args.breaker_threshold,
                    breaker_recovery_s=args.breaker_recovery,
                    sticky_key_field=args.sticky_key,
                    drain_grace_s=args.drain_grace,
                    gateway_id=f"g{g}",
                    peer_urls=tuple(
                        f"http://127.0.0.1:{args.port + p}"
                        for p in range(n_gateways)
                        if p != g
                    ),
                ),
                # one registry for the primary: supervisor counters
                # federate through it. Peers are shared-nothing — their
                # own registries, their own /metrics.
                metrics=metrics if g == 0 else MetricsRegistry(),
                telemetry=ring_g,
                incidents=obs.get("incidents") if g == 0 else None,
            )
        )
    gateway = gateways[0]
    wire_incident_sources(obs.get("incidents"), gateway, supervisor)

    autoscaler = None
    if getattr(args, "autoscale", False):
        ring = obs.get("telemetry")
        if ring is None:
            raise ValueError(
                "--autoscale reads the telemetry ring; it cannot run with "
                "the flight recorder disabled (--obs-dir '')"
            )
        # membership changes (add/retire) must land on EVERY gateway —
        # the group fans those two calls out and reads from the primary
        scale_target = (
            GatewayGroup(gateways) if len(gateways) > 1 else gateway
        )
        autoscaler = build_autoscaler(
            args, supervisor, scale_target, spec_factory, ring, metrics, obs
        )

    lifecycle = None
    if getattr(args, "lifecycle", None):
        if obs.get("telemetry") is None:
            raise ValueError(
                "--lifecycle reads drift signals off the telemetry ring; "
                "it cannot run with the flight recorder disabled "
                "(--obs-dir '')"
            )
        lifecycle = build_lifecycle(
            args, metrics, obs, serve_url=f"http://127.0.0.1:{args.port}",
            storage=storage,
        )
        # the controller's transitions and warm counts go to stderr, as
        # `pio lifecycle run` logs them
        logging.getLogger("predictionio_tpu_torch.lifecycle").setLevel(logging.INFO)

    if n_gateways > 1:
        print(
            f"Fleet gateways starting on {args.ip}:{args.port}-"
            f"{args.port + n_gateways - 1} ({n_gateways} shared-nothing "
            f"listeners; put any TCP balancer in front) "
            f"({n} workers on ports {specs[0].port}-{specs[-1].port}) ...",
            flush=True,
        )
    else:
        print(
            f"Fleet gateway starting on {args.ip}:{args.port} "
            f"({n} workers on ports {specs[0].port}-{specs[-1].port}) ...",
            flush=True,
        )
    if runtime is not None:
        census = ", ".join(
            f"{h.name}[{h.driver}]x{h.slots}" for h in runtime.hosts()
        )
        print(f"Host inventory: {census}", flush=True)
    if obs.get("dir"):
        print(
            f"Fleet flight recorder in {obs['dir']} "
            "(telemetry ring, worker logs, incident bundles; "
            "`pio incidents list`, `pio top --history`)",
            flush=True,
        )
    if autoscaler is not None:
        cfg = autoscaler.policy.config
        print(
            f"Autoscaler on: device envelope [{cfg.min_replicas}.."
            f"{cfg.max_replicas}], cpu-fallback max {cfg.cpu_fallback_max}, "
            f"tick {cfg.tick_interval_s:g}s",
            flush=True,
        )
    if lifecycle is not None:
        lcfg = lifecycle.policy.config
        triggers = (
            f"drift + cadence {lcfg.cadence_s:g}s"
            if lcfg.cadence_s
            else "drift/manual"
        )
        print(
            f"Lifecycle controller on: {triggers}, state "
            f"{lifecycle.state_dir} (`pio lifecycle status`)",
            flush=True,
        )

    stop_loops = threading.Event()
    threads: list[threading.Thread] = []
    try:
        supervisor.start()
        sup_thread = threading.Thread(target=supervisor.run, name="pio-fleet-supervisor", daemon=True)
        sup_thread.start()
        threads.append(sup_thread)
        if autoscaler is not None:
            t = threading.Thread(
                target=autoscaler.run, args=(stop_loops,), name="pio-fleet-autoscaler", daemon=True
            )
            t.start()
            threads.append(t)
        if lifecycle is not None:
            from predictionio_tpu_torch.lifecycle.controller import register_lifecycle_metrics

            errors = register_lifecycle_metrics(metrics)["errors"]
            threads.append(_run_every(
                "pio-fleet-lifecycle", lifecycle.policy.config.tick_interval_s,
                lifecycle.tick, stop_loops, errors.inc,
            ))
        # peers first (g1..gN-1 on port+1..), then the primary; each peer
        # is its own shared-nothing listener over the identical replica set
        for gw in gateways[1:]:
            gw.start()
        gateway.start()
        got = wait(gateway.stop_requested)
        if got != signal.SIGINT:
            # SIGTERM or POST /stop: a zero-downtime stop — every gateway
            # drains side by side, each bounded by its grace
            drains = [threading.Thread(target=gw.drain, name="pio-gateway-drain") for gw in gateways]
            for t in drains:
                t.start()
            for t in drains:
                t.join()
    finally:
        stop_loops.set()
        for gw in gateways:
            try:
                gw.stop()
            except Exception:  # noqa: BLE001 - best-effort teardown
                logger.exception("gateway stop failed")
        # workers drain on SIGTERM (create_server drain path); the
        # supervisor escalates to SIGKILL only past the grace window
        supervisor.stop()
        for t in threads:
            t.join(timeout=10)
        for ring in rings:
            if ring is not None:
                ring.close()
    return 0


def build_autoscaler(
    args,
    supervisor: Supervisor,
    gateway: Gateway,
    spec_factory,
    ring,
    metrics: MetricsRegistry,
    obs: dict,
):
    """Assemble the elasticity loop from the deploy flags: policy
    envelope (``--fleet-min/--fleet-max/--cpu-fallback-max``), the
    telemetry ring as the single signal path, the registry as the
    mid-bake gate, and the incident recorder for envelope saturation."""
    from predictionio_tpu_torch.fleet.autoscaler import (
        Autoscaler,
        AutoscalerConfig,
        ScalingPolicy,
        registry_rollout_probe,
    )

    n = int(args.fleet)

    def flag(name, default, cast):
        # None = unset -> default; an EXPLICIT value is honored verbatim
        # and validated below (`or` would silently turn an explicit 0
        # into the default)
        value = getattr(args, name, None)
        return default if value is None else cast(value)

    config = AutoscalerConfig(
        min_replicas=flag("fleet_min", 1, int),
        # default headroom: twice the boot size (an envelope equal to N
        # would make --autoscale a no-op outward)
        max_replicas=flag("fleet_max", max(1, 2 * n), int),
        cpu_fallback_max=flag("cpu_fallback_max", 0, int),
        tick_interval_s=flag("autoscale_interval", 5.0, float),
    )
    if config.min_replicas < 1:
        raise ValueError("--fleet-min must be >= 1 (0 would drain the fleet)")
    if config.min_replicas > config.max_replicas:
        raise ValueError("--fleet-min cannot exceed --fleet-max")
    if config.max_replicas < n:
        # booting above the ceiling would pin every pressured tick on
        # "saturated" (bundle spam) while the operator believes the
        # envelope bounds the fleet
        raise ValueError(
            f"--fleet-max ({config.max_replicas}) must be >= the --fleet "
            f"boot size ({n})"
        )
    if config.cpu_fallback_max < 0:
        raise ValueError("--cpu-fallback-max must be >= 0")
    if config.tick_interval_s <= 0:
        raise ValueError("--autoscale-interval must be > 0")
    registry_dir = getattr(args, "registry_dir", None)
    return Autoscaler(
        ScalingPolicy(config),
        supervisor,
        gateway,
        spec_factory,
        ring=ring,
        rollout_probe=(
            registry_rollout_probe(registry_dir) if registry_dir else None
        ),
        metrics=metrics,
        incidents=obs.get("incidents"),
    )


def build_lifecycle(
    args,
    metrics: MetricsRegistry,
    obs: dict,
    serve_url: str,
    storage: Callable[[], Any] | None = None,
):
    """Assemble the lifecycle controller from the deploy flags: the
    fleet's own telemetry ring is the drift sensor AND the transition
    log, its incident recorder snapshots aborts/rollbacks, its metrics
    registry exports ``pio_lifecycle_*`` through the gateway's federated
    /metrics, and the gateway itself is the cache-warm target (warm
    queries take the same least-loaded route production traffic does).
    The retune's cells run on the CPU (the cpu-fallback class);
    ``storage`` returns the store the cells train on and the warm
    queries come from."""
    from predictionio_tpu_torch.lifecycle import (
        LifecycleConfig,
        LifecycleController,
        LifecyclePolicy,
        build_grid_tuner,
        build_warmer,
    )
    from predictionio_tpu_torch.registry.probe import registry_rollout_probe
    from predictionio_tpu_torch.workflow.engine_loader import load_manifest

    registry_dir = getattr(args, "registry_dir", None) or os.environ.get(
        "PIO_REGISTRY_DIR"
    )
    if not registry_dir:
        raise ValueError(
            "--lifecycle stages and promotes through the registry; it "
            "needs --registry-dir (or $PIO_REGISTRY_DIR)"
        )
    manifest = load_manifest(
        getattr(args, "engine_dir", "."), getattr(args, "variant", None)
    )

    def flag(name, default, cast):
        value = getattr(args, name, None)
        return default if value is None else cast(value)

    config = LifecycleConfig(
        cadence_s=flag("lifecycle_cadence", 0.0, float),
        cooldown_s=flag("lifecycle_cooldown", 600.0, float),
        warm_limit=flag("lifecycle_warm_limit", 256, int),
    )
    state_dir = os.path.join(obs["dir"], "lifecycle")
    cwd = os.getcwd()
    if cwd not in sys.path:
        sys.path.insert(0, cwd)
    env = {k: v for k, v in os.environ.items() if k.startswith("PIO_")}
    if getattr(args, "home", None):
        env["PIO_FS_BASEDIR"] = os.path.abspath(args.home)
    tuner = build_grid_tuner(
        args.lifecycle,
        workdir=os.path.join(state_dir, "grid"),
        engine_manifest=manifest,
        registry_dir=registry_dir,
        storage=storage() if storage is not None else None,
        workers=flag("lifecycle_workers", 2, int),
        nice=flag("lifecycle_nice", 10, int),
        cwd=cwd,
        env=env,
    )
    warmer = None
    app_name = getattr(args, "lifecycle_app", None)
    if app_name and config.warm_limit > 0:
        from predictionio_tpu_torch.lifecycle.warm import event_store_queries

        def query_source():
            # storage resolves lazily at warm time: the event store may
            # not even exist when the fleet boots
            from predictionio_tpu_torch.data.storage.registry import Storage
            from predictionio_tpu_torch.data.store.event_store import resolve_app

            store = storage() if storage is not None else Storage.instance()
            app_id, _ = resolve_app(store, app_name, None)
            return event_store_queries(store, app_id, limit=config.warm_limit)

        warmer = build_warmer(serve_url, query_source, limit=config.warm_limit)
    return LifecycleController(
        LifecyclePolicy(config),
        state_dir=state_dir,
        engine_id=manifest.engine_id,
        registry_dir=registry_dir,
        tune=tuner,
        warm=warmer,
        rollout_probe=registry_rollout_probe(registry_dir),
        # the SHARED ring object: drift records written by replicas/obs
        # plane land where the controller reads, and its transitions land
        # where `pio top --history` renders
        ring=obs.get("telemetry"),
        incidents=obs.get("incidents"),
        metrics=metrics,
    )


def build_obs_plane(
    obs_dir: str | None,
    metrics: MetricsRegistry,
    registry_dir: str | None = None,
) -> dict:
    """The fleet flight-recorder wiring: worker logbook, telemetry ring,
    incident recorder (all under ``obs_dir``; empty/None disables).
    Returns the pieces keyed by role plus the supervisor ``on_crash``
    hook. Split out of :func:`run_fleet` so tests can assemble the
    identical plane around in-process fleets."""
    if not obs_dir:
        return {}
    obs_dir = os.path.abspath(obs_dir)
    logbook = WorkerLogBook(os.path.join(obs_dir, "logs"))
    telemetry = TelemetryRing(os.path.join(obs_dir, "telemetry"))
    incidents = IncidentRecorder(
        os.path.join(obs_dir, "incidents"), metrics=metrics
    )
    if registry_dir:

        def registry_state() -> dict:
            # lazy import: the launcher must not pay the registry import
            # unless an incident actually captures
            from predictionio_tpu_torch.registry.store import ArtifactStore

            store = ArtifactStore(registry_dir)
            out: dict = {}
            for engine_key in store.engines():
                state = store.state_by_key(engine_key)
                out[engine_key] = {
                    "generation": state.generation,
                    "stable": state.stable,
                    "candidate": state.candidate,
                    "mode": state.mode,
                    "fraction": state.fraction,
                }
            return out

        incidents.add_source("registry", registry_state)
    incidents.add_source(
        "telemetry", lambda: telemetry.tail(120)
    )

    def on_crash(info: dict) -> None:
        texts = {}
        tail = info.pop("stderrTail", None)
        if tail:
            texts["stderr_tail"] = tail
        incidents.trigger(
            "worker-park" if info.get("parked") else "worker-crash",
            context=info,
            texts=texts,
        )

    return {
        "dir": obs_dir,
        "logbook": logbook,
        "telemetry": telemetry,
        "incidents": incidents,
        "on_crash": on_crash,
    }


def wire_incident_sources(
    incidents, gateway: Gateway, supervisor: Supervisor
) -> None:
    """Attach the live-state evidence sources once both tiers exist: the
    gateway's merged trace snapshot (its own ring + the per-tick replica
    caches — a SIGKILLed worker's final spans survive in the cache) and
    the supervisor's restart ladder."""
    if incidents is None:
        return
    incidents.add_source("traces", lambda: gateway.cached_spans()[:400])
    incidents.add_source("fleet", gateway.fleet_snapshot)
    incidents.add_source("supervisor", supervisor.snapshot)
    # profile-on-alert: every incident kind — not just the gateway's own
    # slo-alert path — carries the gateway host-stack view
    incidents.add_source("hoststacks", gateway.sampler.snapshot)


__all__ = [
    "CPU_FALLBACK_ENV",
    "build_autoscaler",
    "build_lifecycle",
    "build_obs_plane",
    "run_fleet",
    "wire_incident_sources",
    "worker_argv",
]
