"""Command line of the port: ``python -m predictionio_tpu_torch.tools.cli``.

Verbs, modelled on ``predictionio_tpu/tools/cli.py``::

    app new NAME [--id N] [--description D] [--access-key KEY]
    app list | show NAME | delete NAME -f | data-delete NAME [--channel C] -f
    app channel-new APP CHANNEL | channel-delete APP CHANNEL -f
    accesskey new APP [--key KEY] [--event NAME ...] | list [APP] | delete KEY
    eventserver [--ip IP] [--port N] [--stats] [--ssl-certfile F --ssl-keyfile F]
                [--storage-retries N] [--breaker-threshold N] [--breaker-recovery S]
    import --appname NAME --input FILE [--channel C]
    export --appname NAME --output FILE [--channel C] [--format json|parquet|npz]
    train  --engine-dir DIR [--variant FILE] [--device cuda|cpu]
           [--registry-dir R] [--keep-versions N] [--follow --app-name A ...]
    stream --engine-dir DIR --app-name A [--registry-dir R] [--cycles N]
           [--interval S] [--batch-limit N] [--publish-min-events N]
           [--mode canary|shadow] [--fraction F] [--notify-url URL] ...
    deploy --engine-dir DIR [--variant FILE] [--ip IP] [--port N] [--device cuda|cpu]
           [--accesskey K] [--feedback --event-server-url U --feedback-access-key K]
           [--ssl-certfile F --ssl-keyfile F] [--log-url U] [--log-prefix P]
           [--request-timeout S] [--queue-high-water N] [--breaker-threshold N]
           [--breaker-recovery S] [--drain-grace S]
           [--registry-dir R] [--registry-sync-interval S] [--bake-window S] ...
           [--result-cache-size N] [--result-cache-ttl S] [--slo-* ...]
           [--profile-dir D] [--sampler-period S] [--no-profile-on-alert] ...
           [--bandit epsilon|thompson --bandit-app-name A [--bandit-epsilon E]
            [--bandit-min-pulls N] [--bandit-reward-event reward,purchase]]
    lifecycle run EVALUATION [--engine-dir DIR] [--registry-dir R] [--obs-dir D]
                  [--workers N] [--serve-url U --app-name A] [--warm-limit N] ...
            | status [--json] | trigger | pause | resume   [--obs-dir D] [--state-dir S]
    top [--url U] [--once] [--json] [--interval S] [-n N] [--metrics-url U ...]
        [--hotspots] [--fleet] | --history [--history-window S] [--obs-dir D]
        | --eval STATUS_FILE | --batchpredict STATUS_FILE | --lifecycle STATE_FILE
    adminserver [--ip IP] [--port N] [--registry-dir R]
    dashboard [--ip IP] [--port N] [--metrics-url U ...]
    profile serve --url U [--ms N] | train [--profile-dir D] -- TRAIN ARGS
            | list | show BUNDLE [--json] | export BUNDLE DEST
    incidents list | show BUNDLE [--json] | export BUNDLE DEST  [--obs-dir D]
    doctor [--capacity USERS ITEMS K [--ann C,P] [--hbm-bytes B] [--dtype f32|bf16]
           [--gather-dtype f32|bf16] [--mesh data=N,model=M] [--nnz N]] [--registry-dir R]
           [--roofline [--families F]] [--device cuda|cpu]
    models list | show [V] | promote [V] | rollback | stage V --url U | diff A B
    undeploy [--ip IP] [--port N] [--ssl]
    batchpredict --engine-dir DIR [--input FILE | --from-events] [--output FILE]
                 [--to-events] [--app-name A] [--batch N] [--device cuda|cpu] ...
    eval EVALUATION [--workers N] [--folds K] [--workdir W] [--resume]
         [--batch-size N] [--status-file F] [--out F] [--device cuda|cpu] ...
    version | upgrade | status | template list | template get NAME [DIR]
    run MAIN [ARGS ...]
    lint [PATHS ...] [--format text|json|sarif] [--strict] [--rule ID ...] [--list-rules]
         [--show-suppressed] [--changed] [--report-suppressions]
    build | unregister  --engine-dir DIR [--variant FILE]
    shell [--device cuda|cpu]
    start-all [--eventserver-port N] [--adminserver-port N] [--dashboard-port N] | stop-all

Apps, access keys, channels, events, engine instances and models live in
the storage the ``PIO_STORAGE_*`` environment names, as in the JAX package;
without it, one sqlite file ``pio.db`` under the basedir (``--home``, else
``$PIO_FS_BASEDIR``, else ``$PIO_TORCH_HOME``, else ``~/.pio_torch``).
``--device`` defaults to ``cuda``; without a card, train, deploy, stream,
batchpredict and eval fail unless ``--device cpu``. The model registry is
``--registry-dir``, else ``$PIO_REGISTRY_DIR``, else ``registry/`` under
the basedir; ``pio stream`` keeps its cursors under ``--cursor-dir``, else
``$PIO_STREAM_DIR``, else ``stream/`` under the basedir. ``pio stream
--obs-dir D`` appends drift signals to the telemetry ring under
``D/telemetry`` and writes incident bundles under ``D/incidents``, which
``pio incidents`` reads. ``pio profile`` and ``pio doctor`` read bundles
and the card without importing anything of JAX. ``pio lifecycle run``
reads that ring for drift, retunes through the eval grid (cpu-fallback
cells, on the CPU), stages the winner as a canary and warms the result
cache after the promote; its state lives under ``<obs-dir>/lifecycle``.
``pio adminserver`` and ``pio dashboard`` are standard-library HTTP
servers; ``pio top`` polls ``/metrics``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import signal
import sys

import predictionio_tpu_torch

# stdlib AST walking only (no torch, no numpy): safe to pull in for every verb
from predictionio_tpu_torch.analysis.cli import add_lint_arguments, run_lint
from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError, default_basedir
from predictionio_tpu_torch.utils.platform import wait_for_signal as _wait_for_signal


# the locator of this invocation: ``--home`` builds one on that basedir,
# else the process-wide ``Storage.instance()``
_STORAGE: Storage | None = None


def _storage() -> Storage:
    return _STORAGE or Storage.instance()


def _die(msg: str, code: int = 1) -> int:
    print(f"[ERROR] {msg}", file=sys.stderr)
    return code


# ---------------------------------------------------------------------------
# app / accesskey / channel management (ref commands/App.scala)
# ---------------------------------------------------------------------------


def cmd_app_new(args) -> int:
    storage = _storage()
    apps = storage.get_meta_data_apps()
    if apps.get_by_name(args.name):
        return _die(f"App {args.name} already exists.")
    app_id = apps.insert(App(args.id or 0, args.name, args.description))
    if app_id is None:
        return _die(f"Unable to create app {args.name}.")
    storage.get_l_events().init(app_id)
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(args.access_key or "", app_id, ())
    )
    if key is None:
        return _die(
            f"App {args.name} created (ID {app_id}) but access key "
            f"{args.access_key!r} already exists; create one with `accesskey new`."
        )
    print("Created a new app:")
    print(f"      Name: {args.name}")
    print(f"        ID: {app_id}")
    print(f"Access Key: {key}")
    return 0


def cmd_app_list(args) -> int:
    storage = _storage()
    keys = storage.get_meta_data_access_keys()
    print(f"{'Name':<20} | {'ID':>4} | Access Key")
    for app in storage.get_meta_data_apps().get_all():
        app_keys = keys.get_by_app_id(app.id)
        first = app_keys[0].key if app_keys else ""
        print(f"{app.name:<20} | {app.id:>4} | {first}")
    return 0


def cmd_app_show(args) -> int:
    storage = _storage()
    app = storage.get_meta_data_apps().get_by_name(args.name)
    if app is None:
        return _die(f"App {args.name} does not exist.")
    print(f"    App Name: {app.name}")
    print(f"      App ID: {app.id}")
    print(f" Description: {app.description or ''}")
    for k in storage.get_meta_data_access_keys().get_by_app_id(app.id):
        events = ",".join(k.events) if k.events else "(all)"
        print(f"  Access Key: {k.key} | {events}")
    for c in storage.get_meta_data_channels().get_by_app_id(app.id):
        print(f"     Channel: {c.name} (ID {c.id})")
    return 0


def cmd_app_delete(args) -> int:
    storage = _storage()
    apps = storage.get_meta_data_apps()
    app = apps.get_by_name(args.name)
    if app is None:
        return _die(f"App {args.name} does not exist.")
    if not args.force:
        return _die("Refusing to delete without --force (destructive).")
    for c in storage.get_meta_data_channels().get_by_app_id(app.id):
        storage.get_l_events().remove(app.id, c.id)
        storage.get_meta_data_channels().delete(c.id)
    storage.get_l_events().remove(app.id)
    for k in storage.get_meta_data_access_keys().get_by_app_id(app.id):
        storage.get_meta_data_access_keys().delete(k.key)
    apps.delete(app.id)
    print(f"Deleted app {args.name}.")
    return 0


def cmd_app_data_delete(args) -> int:
    storage = _storage()
    app = storage.get_meta_data_apps().get_by_name(args.name)
    if app is None:
        return _die(f"App {args.name} does not exist.")
    if not args.force:
        return _die("Refusing to delete data without --force (destructive).")
    channel_id = None
    if args.channel:
        channels = storage.get_meta_data_channels().get_by_app_id(app.id)
        ch = next((c for c in channels if c.name == args.channel), None)
        if ch is None:
            return _die(f"Channel {args.channel} does not exist.")
        channel_id = ch.id
    storage.get_l_events().remove(app.id, channel_id)
    storage.get_l_events().init(app.id, channel_id)
    print(f"Deleted data of app {args.name}.")
    return 0


def cmd_channel_new(args) -> int:
    storage = _storage()
    app = storage.get_meta_data_apps().get_by_name(args.app_name)
    if app is None:
        return _die(f"App {args.app_name} does not exist.")
    cid = storage.get_meta_data_channels().insert(Channel(0, args.channel, app.id))
    if cid is None:
        return _die(
            f"Unable to create channel {args.channel} "
            "(name must match ^[a-zA-Z0-9-]{1,16}$)."
        )
    storage.get_l_events().init(app.id, cid)
    print(f"Created channel {args.channel} (ID {cid}) for app {args.app_name}.")
    return 0


def cmd_channel_delete(args) -> int:
    storage = _storage()
    app = storage.get_meta_data_apps().get_by_name(args.app_name)
    if app is None:
        return _die(f"App {args.app_name} does not exist.")
    channels = storage.get_meta_data_channels().get_by_app_id(app.id)
    ch = next((c for c in channels if c.name == args.channel), None)
    if ch is None:
        return _die(f"Channel {args.channel} does not exist.")
    if not args.force:
        return _die("Refusing to delete without --force (destructive).")
    storage.get_l_events().remove(app.id, ch.id)
    storage.get_meta_data_channels().delete(ch.id)
    print(f"Deleted channel {args.channel}.")
    return 0


def cmd_accesskey_new(args) -> int:
    storage = _storage()
    app = storage.get_meta_data_apps().get_by_name(args.app_name)
    if app is None:
        return _die(f"App {args.app_name} does not exist.")
    key = storage.get_meta_data_access_keys().insert(
        AccessKey(args.key or "", app.id, tuple(args.event or ()))
    )
    if key is None:
        return _die(f"Access key {args.key!r} already exists.")
    print(f"Created new access key: {key}")
    return 0


def cmd_accesskey_list(args) -> int:
    storage = _storage()
    keys = storage.get_meta_data_access_keys()
    if args.app_name:
        app = storage.get_meta_data_apps().get_by_name(args.app_name)
        if app is None:
            return _die(f"App {args.app_name} does not exist.")
        listing = keys.get_by_app_id(app.id)
    else:
        listing = keys.get_all()
    print(f"{'Access Key':<66} | {'App ID':>6} | Allowed Events")
    for k in listing:
        events = ",".join(k.events) if k.events else "(all)"
        print(f"{k.key:<66} | {k.appid:>6} | {events}")
    return 0


def cmd_accesskey_delete(args) -> int:
    _storage().get_meta_data_access_keys().delete(args.key)
    print(f"Deleted access key {args.key}.")
    return 0


# ---------------------------------------------------------------------------
# data and the event server
# ---------------------------------------------------------------------------


def cmd_eventserver(args) -> int:
    from predictionio_tpu_torch.data.api.event_server import EventServer, EventServerConfig

    server = EventServer(
        storage=_storage(),
        config=EventServerConfig(
            ip=args.ip,
            port=args.port,
            stats=args.stats,
            ssl_certfile=args.ssl_certfile,
            ssl_keyfile=args.ssl_keyfile,
            storage_retries=args.storage_retries,
            breaker_threshold=args.breaker_threshold,
            breaker_recovery_s=args.breaker_recovery,
        ),
    )
    port = server.start()
    print(f"Event server started on {args.ip}:{port}", flush=True)
    _wait_for_signal()
    server.shutdown()
    return 0


def cmd_import(args) -> int:
    from predictionio_tpu_torch.tools.import_export import import_events

    try:
        n = import_events(args.input, args.app_name, args.channel, storage=_storage())
    except (OSError, ValueError) as exc:
        # the parse or storage error with its file:line, not a bare exit code
        return _die(f"import failed: {exc}")
    print(f"Imported {n} events.")
    return 0


def cmd_export(args) -> int:
    from predictionio_tpu_torch.tools.import_export import export_events

    n = export_events(
        args.output, args.app_name, args.channel, storage=_storage(), format=args.format
    )
    print(f"Exported {n} events.")
    return 0


# ---------------------------------------------------------------------------
# train and deploy
# ---------------------------------------------------------------------------


def _basedir(args) -> str | None:
    return os.path.abspath(args.home) if getattr(args, "home", None) else None


def _registry_dir(args) -> str:
    """``--registry-dir``, else ``$PIO_REGISTRY_DIR``, else ``registry/``
    under ``--home`` or the default basedir."""
    from predictionio_tpu_torch.registry.store import default_registry_dir

    if getattr(args, "registry_dir", None):
        return args.registry_dir
    if not os.environ.get("PIO_REGISTRY_DIR") and _basedir(args):
        return os.path.join(_basedir(args), "registry")
    return default_registry_dir()


def _strip_launcher_flags(argv: list[str]) -> list[str]:
    """Drop --num-hosts/--hosts (and their values) so workers don't
    recursively launch fleets."""
    out: list[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--num-hosts", "--hosts"):
            skip = True
            continue
        if a.startswith("--num-hosts=") or a.startswith("--hosts="):
            continue
        out.append(a)
    return out


def cmd_build(args) -> int:
    """No compilation step exists (Python); build = validate that the engine
    directory loads and its variant parses (ref `pio build` sbt packaging).
    The kernels build on first use, on the card."""
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    manifest, engine = load_engine(args.engine_dir, args.variant)
    engine.engine_params_from_variant(manifest.variant_json)
    print(f"Engine {manifest.engine_id} is ready (factory {manifest.engine_factory}).")
    return 0


def cmd_unregister(args) -> int:
    """Compatibility verb (ref ``Console.scala:172-177``): engines are plain
    directories, never registered anywhere, so there is nothing to undo."""
    print(
        "Nothing to unregister: engines are not registered. An engine is "
        f"just its directory ({args.engine_dir}); remove the directory (or "
        "its trained instances via the metadata store) instead."
    )
    return 0


def cmd_train(args) -> int:
    from predictionio_tpu_torch.controller.engine import TrainOptions
    from predictionio_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device, shutdown
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    if args.follow and not args.app_name:
        # fail BEFORE the train, not after it
        return _die("pio train --follow requires --app-name")
    hosts = [h for h in (args.hosts or "").split(",") if h]
    if (args.num_hosts > 1 or hosts) and "PIO_PROCESS_ID" not in os.environ:
        # launcher role: one worker per rank running this same train
        # command (the argv main() parsed, not this process's sys.argv);
        # they join through the PIO_COORDINATOR contract and this process
        # supervises them
        from predictionio_tpu_torch.parallel.launcher import launch_cli_multihost

        return launch_cli_multihost(
            _strip_launcher_flags(args.cli_argv), num_hosts=args.num_hosts, hosts=hosts or None
        )
    maybe_initialize_distributed(args.device)
    manifest, engine = load_engine(args.engine_dir, args.variant)
    engine_params = engine.engine_params_from_variant(manifest.variant_json)
    ctx = WorkflowContext(mode="training", device=rank_device(args.device), _storage=_storage())
    registry_dir = args.registry_dir or (_registry_dir(args) if args.follow else None)
    options = TrainOptions(
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
    )
    instance_id = run_train(
        engine,
        manifest,
        engine_params,
        ctx,
        batch=args.batch or "",
        registry_dir=registry_dir,
        keep_versions=args.keep_versions,
        options=options,
    )
    shutdown()  # a joined job's ranks leave together, once the coordinator has persisted
    if not instance_id:
        print(f"Rank finished on {ctx.device}; the coordinator persists the model")
        return 0
    print(f"Training completed. Engine instance {instance_id} on {ctx.device}")
    if args.follow:
        # the batch train just published the stable: keep tailing the event
        # store and publishing candidates (the speed layer)
        print("Entering follow mode (speed layer)...", flush=True)
        args.registry_dir = registry_dir
        return _run_stream(args, manifest)
    return 0


def _http_json(url: str, method: str = "GET", payload=None, timeout: float = 30.0):
    import urllib.error
    import urllib.request

    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method=method, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        body = exc.read().decode(errors="replace")
        try:
            message = json.loads(body).get("message", body)
        except ValueError:
            message = body
        raise RuntimeError(f"{method} {url} -> {exc.code}: {message}") from exc


def _run_stream(args, manifest) -> int:
    """Build and run the speed-layer pipeline (``pio stream`` and ``pio
    train --follow``): fold-in solves on ``--device``."""
    from predictionio_tpu_torch.data.store.event_store import resolve_app
    from predictionio_tpu_torch.registry import ArtifactStore
    from predictionio_tpu_torch.stream import (
        CursorStore,
        EventTailer,
        StreamConfig,
        StreamInstruments,
        StreamPipeline,
        serve_metrics,
        trainer_for_models,
    )
    from predictionio_tpu_torch.workflow import model_io

    if not args.app_name:
        return _die("--app-name is required to tail an event store")
    storage = _storage()
    app_id, channel_id = resolve_app(storage, args.app_name, args.channel or None)
    store = ArtifactStore(_registry_dir(args))
    state = store.get_state(manifest.engine_id)
    if not state.stable:
        return _die(
            f"no stable model in registry {store.base_dir} for engine "
            f"{manifest.engine_id}; run `train --registry-dir ...` first"
        )
    models = model_io.deserialize_models(store.load_blob(manifest.engine_id, state.stable))
    trainer = trainer_for_models(models, device=args.device)
    tailer = EventTailer(
        storage.get_l_events(),
        app_id,
        channel_id,
        batch_limit=args.batch_limit,
        safety_lag_s=args.safety_lag,
    )
    cursor_dir = args.cursor_dir
    if not cursor_dir and not os.environ.get("PIO_STREAM_DIR") and _basedir(args):
        cursor_dir = os.path.join(_basedir(args), "stream")
    cursors = CursorStore(cursor_dir)
    cursor = cursors.load(app_id, channel_id)
    if cursor.position is None and not args.from_beginning:
        # fresh cursor: the stable already covers history — start at the
        # store head so only NEW events fold in (--from-beginning replays)
        head = tailer.head_position()
        if head is not None:
            cursor.seed(head)
            cursors.save(cursor)
    config = StreamConfig(
        engine_id=manifest.engine_id,
        engine_version=manifest.version,
        engine_variant=manifest.variant,
        engine_factory=manifest.engine_factory,
        mode=args.mode,
        fraction=args.fraction,
        publish_min_events=args.publish_min_events,
        interval_s=args.interval,
    )
    stage_hook = None
    if args.notify_url:

        def stage_hook(version, mode, fraction, _url=args.notify_url):
            _http_json(
                f"{_url}/models/candidate",
                method="POST",
                payload={"version": version, "mode": mode, "fraction": fraction},
            )

    instruments = StreamInstruments()
    # --obs-dir: drift breaches land on the telemetry ring (kind=drift)
    # and snapshot rate-limited incident bundles
    ring = incidents = None
    if getattr(args, "obs_dir", None):
        from predictionio_tpu_torch.obs.incidents import IncidentRecorder
        from predictionio_tpu_torch.obs.tsring import TelemetryRing

        ring = TelemetryRing(os.path.join(args.obs_dir, "telemetry"), writer_id="stream")
        incidents = IncidentRecorder(os.path.join(args.obs_dir, "incidents"), metrics=instruments.registry)
        incidents.add_source("telemetry-ring", lambda: ring.tail(200))
    pipeline = StreamPipeline(
        tailer, trainer, cursors, store, config, instruments=instruments, stage_hook=stage_hook,
        ring=ring, incidents=incidents,
    )
    metrics_server = None
    if args.metrics_port:
        metrics_server = serve_metrics(instruments.registry, args.metrics_port)
        print(f"Metrics on http://0.0.0.0:{args.metrics_port}/metrics")
    print(
        f"Streaming app {args.app_name} (id {app_id}) -> registry {store.base_dir} "
        f"[{trainer.name}, {config.mode}@{config.fraction:g}, {args.device}]",
        flush=True,
    )
    try:
        pipeline.run_forever(max_cycles=args.cycles)
    except KeyboardInterrupt:
        pass
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
    print(
        f"Stream stopped: {pipeline.cursor.events_read} events read, "
        f"{pipeline.cursor.publishes} published, last {pipeline.cursor.last_published_version or '-'}",
        flush=True,
    )
    return 0


def cmd_stream(args) -> int:
    """Speed layer: tail the event store, fold events into the stable
    model, publish registry candidates."""
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    manifest, _ = load_engine(args.engine_dir, args.variant)
    return _run_stream(args, manifest)


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server

    if args.autoscale and not args.fleet:
        # silently ignoring elasticity flags would leave the operator
        # believing the fleet sizes itself when nothing is running
        return _die(
            "--autoscale requires --fleet N (the autoscaler drives the "
            "fleet supervisor; docs/fleet.md §Autoscaling)"
        )
    if args.hosts and not args.fleet:
        return _die(
            "--hosts requires --fleet N (host placement is the fleet "
            "supervisor's job; docs/fleet.md §Multi-host)"
        )
    if args.lifecycle and not args.fleet:
        return _die(
            "--lifecycle requires --fleet N (the controller rides the "
            "fleet parent's obs plane; for a single server run "
            "`pio lifecycle run` alongside it; docs/lifecycle.md)"
        )
    if args.gateways != 1 and not args.fleet:
        return _die(
            "--gateways requires --fleet N (peer gateways front the "
            "fleet's replica set; docs/fleet.md §Gateway tier)"
        )
    if args.fleet:
        # N supervised worker processes of this CLI behind a gateway: the
        # gateway takes --port, workers take port+1..port+N and get a
        # registry sync interval so rollouts propagate fleet-wide
        from predictionio_tpu_torch.fleet.launch import run_fleet

        try:
            return run_fleet(args, args.cli_argv, wait=_wait_for_signal, storage=_storage)
        except ValueError as exc:
            return _die(str(exc))

    from predictionio_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device

    maybe_initialize_distributed(args.device)
    ctx = WorkflowContext(mode="serving", device=rank_device(args.device), _storage=_storage())
    config = ServerConfig(
        ip=args.ip,
        port=args.port,
        accesskey=args.accesskey,
        feedback=args.feedback,
        event_server_url=args.event_server_url,
        feedback_access_key=args.feedback_access_key,
        ssl_certfile=args.ssl_certfile,
        ssl_keyfile=args.ssl_keyfile,
        log_url=args.log_url,
        log_prefix=args.log_prefix or "",
        request_timeout_s=args.request_timeout,
        queue_high_water=args.queue_high_water,
        breaker_threshold=args.breaker_threshold,
        breaker_recovery_s=args.breaker_recovery,
        drain_grace_s=args.drain_grace,
        registry_dir=args.registry_dir,
        sticky_key_field=args.sticky_key,
        candidate_breaker_threshold=args.candidate_breaker_threshold,
        bake_window_s=args.bake_window,
        bake_min_requests=args.bake_min_requests,
        auto_promote=not args.no_auto_promote,
        registry_sync_interval_s=args.registry_sync_interval or 0.0,
        slo_latency_threshold_s=args.slo_latency_threshold,
        slo_latency_objective=args.slo_latency_objective,
        slo_availability_objective=args.slo_availability_objective,
        slo_shed_objective=args.slo_shed_objective,
        result_cache_size=args.result_cache_size,
        result_cache_ttl_s=args.result_cache_ttl,
        profile_dir=args.profile_dir,
        profile_max_bundles=args.profile_max_bundles,
        profile_default_ms=args.profile_default_ms,
        profile_max_ms=args.profile_max_ms,
        sampler_period_s=args.sampler_period,
        profile_on_alert=not args.no_profile_on_alert,
        profile_alert_min_interval_s=args.profile_alert_min_interval,
        profile_alert_trace_ms=args.profile_alert_trace_ms,
        bandit_policy=args.bandit,
        bandit_epsilon=args.bandit_epsilon,
        bandit_min_pulls=args.bandit_min_pulls,
        bandit_app_name=args.bandit_app_name,
        bandit_reward_events=tuple(
            name.strip() for name in (args.bandit_reward_event or "reward").split(",") if name.strip()
        ),
    )
    server = create_query_server(args.engine_dir, ctx, config, args.variant)
    port = server.start()
    scheme = "https" if args.ssl_certfile else "http"
    print(
        f"Engine instance {server.instance_id} (model {server.model_version}) deployed at "
        f"{scheme}://{args.ip}:{port} on {ctx.device}",
        flush=True,
    )
    # SIGTERM drains (a supervised restart answers what it accepted);
    # SIGINT and POST /stop stop at once
    if _wait_for_signal(server.stop_requested) == signal.SIGTERM:
        server.drain()
    server.shutdown()
    return 0


def cmd_adminserver(args) -> int:
    from predictionio_tpu_torch.tools.admin_api import AdminServer

    server = AdminServer(storage=_storage(), registry_dir=_registry_dir(args))
    port = server.start(args.ip, args.port)
    print(f"Admin server started on {args.ip}:{port}", flush=True)
    _wait_for_signal()
    server.shutdown()
    return 0


def cmd_dashboard(args) -> int:
    from predictionio_tpu_torch.tools.dashboard import Dashboard

    server = Dashboard(storage=_storage(), metrics_urls=args.metrics_url or ())
    port = server.start(args.ip, args.port)
    print(f"Dashboard started on {args.ip}:{port}", flush=True)
    _wait_for_signal()
    server.shutdown()
    return 0


_TOP_DEFAULT_URL = "http://127.0.0.1:8000"


def cmd_top(args) -> int:
    """Live one-screen summary of a running server's /metrics (qps, p95,
    waterfall, SLO burn, shed rate, breaker states, the bandit line).
    ``--fleet`` points it at a gateway's federated /metrics; repeated
    ``--metrics-url`` polls several endpoints per refresh. ``--history``
    renders the telemetry ring (over HTTP, or off ``--obs-dir``);
    ``--eval``, ``--batchpredict`` and ``--lifecycle`` render a status
    file."""
    from predictionio_tpu_torch.tools.top import (
        run_batchpredict_top,
        run_evalgrid_top,
        run_history,
        run_lifecycle_top,
        run_top,
    )

    iterations = 1 if args.once else args.iterations
    for path, run in ((args.lifecycle, run_lifecycle_top), (args.eval, run_evalgrid_top),
                      (args.batchpredict, run_batchpredict_top)):
        if path:
            return run(path, interval_s=args.interval, iterations=iterations, json_mode=args.json)
    if args.history:
        url = args.url if (args.fleet or args.url != _TOP_DEFAULT_URL) else None
        if args.obs_dir is None and url is None:
            url = args.url  # the default address is still worth a try
        return run_history(url=url, obs_dir=args.obs_dir, window_s=args.history_window, json_mode=args.json)
    # --metrics-url endpoints poll in addition to a --url the operator set
    # (first in each refresh); an untouched default --url is not polled
    urls = list(args.metrics_url or [])
    url_given = args.fleet or args.url != _TOP_DEFAULT_URL
    if urls and url_given and args.url not in urls:
        urls.insert(0, args.url)
    elif args.fleet and not urls:
        urls = [args.url]
    return run_top(
        args.url,
        interval_s=args.interval,
        iterations=iterations,
        clear_screen=False if args.once else None,
        json_mode=args.json,
        urls=urls or None,
        hotspots=args.hotspots,
    )


def _lifecycle_state_dir(args) -> str:
    return args.state_dir or os.path.join(args.obs_dir, "lifecycle")


def cmd_lifecycle_run(args) -> int:
    """The standalone lifecycle controller: watch the obs dir's telemetry
    ring for drift (plus cadence and manual triggers), retune on
    cpu-fallback grid cells, stage the winner, watch the bake, warm the
    result cache on promote. It runs against an already-running server."""
    import asyncio

    from predictionio_tpu_torch.lifecycle import (
        LifecycleConfig,
        LifecycleController,
        LifecyclePolicy,
        build_grid_tuner,
        build_warmer,
    )
    from predictionio_tpu_torch.lifecycle.warm import event_store_queries
    from predictionio_tpu_torch.obs.incidents import IncidentRecorder
    from predictionio_tpu_torch.obs.tsring import TelemetryRing
    from predictionio_tpu_torch.registry import registry_rollout_probe
    from predictionio_tpu_torch.workflow.engine_loader import load_manifest

    manifest = load_manifest(args.engine_dir, args.variant)
    registry_dir = args.registry_dir or os.environ.get("PIO_REGISTRY_DIR")
    if not registry_dir:
        return _die("the lifecycle controller needs a registry (--registry-dir or $PIO_REGISTRY_DIR)")
    state_dir = _lifecycle_state_dir(args)
    config = LifecycleConfig(
        cadence_s=args.cadence,
        drift_window_s=args.drift_window,
        min_drift_records=args.min_drift_records,
        cooldown_s=args.cooldown,
        tune_timeout_s=args.tune_timeout,
        bake_timeout_s=args.bake_timeout,
        tick_interval_s=args.tick_interval,
        warm_limit=args.warm_limit,
    )
    ring = TelemetryRing(os.path.join(args.obs_dir, "telemetry"), writer_id="lifecycle")
    incidents = IncidentRecorder(os.path.join(args.obs_dir, "incidents"))
    incidents.add_source("telemetry-ring", lambda: ring.tail(200))
    # user evaluations live in the engine project's cwd
    cwd = os.getcwd()
    if cwd not in sys.path:
        sys.path.insert(0, cwd)
    env = {k: v for k, v in os.environ.items() if k.startswith("PIO_")}
    if args.home:
        env["PIO_FS_BASEDIR"] = os.path.abspath(args.home)
    storage = _storage()
    tuner = build_grid_tuner(
        args.evaluation,
        workdir=args.workdir or os.path.join(state_dir, "grid"),
        engine_manifest=manifest,
        registry_dir=registry_dir,
        storage=storage,
        workers=args.workers,
        nice=args.nice,
        folds=args.folds,
        stage_mode=args.stage_mode,
        stage_fraction=args.stage_fraction,
        cwd=cwd,
        env=env,
    )
    warmer = None
    if args.serve_url and args.app_name:
        from predictionio_tpu_torch.data.store.event_store import resolve_app

        app_id, _ = resolve_app(storage, args.app_name, None)
        warmer = build_warmer(
            args.serve_url,
            lambda: event_store_queries(storage, app_id, limit=args.warm_limit),
            limit=args.warm_limit,
        )
    controller = LifecycleController(
        LifecyclePolicy(config),
        state_dir=state_dir,
        engine_id=manifest.engine_id,
        registry_dir=registry_dir,
        tune=tuner,
        warm=warmer,
        rollout_probe=registry_rollout_probe(registry_dir),
        ring=ring,
        incidents=incidents,
    )
    # the controller's transitions and warm counts go to stderr, as the JAX
    # CLI logs them
    logging.getLogger("predictionio_tpu_torch.lifecycle").setLevel(logging.INFO)
    print(
        f"Lifecycle controller for {manifest.engine_id}: state {state_dir}, "
        f"registry {registry_dir}, "
        f"triggers {'cadence %gs' % args.cadence if args.cadence else 'drift/manual'}",
        flush=True,
    )
    try:
        asyncio.run(controller.run())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_lifecycle_status(args) -> int:
    """One status line (or JSON) from the controller's durable state
    file, whether or not the controller is alive."""
    from predictionio_tpu_torch.lifecycle import read_json_file
    from predictionio_tpu_torch.lifecycle.controller import STATE_FILE
    from predictionio_tpu_torch.tools.top import render_lifecycle

    path = os.path.join(_lifecycle_state_dir(args), STATE_FILE)
    status = read_json_file(path)
    if status is None:
        return _die(
            f"no lifecycle state at {path} (is a controller running with this --obs-dir/--state-dir?)"
        )
    print(json.dumps(status, indent=2, sort_keys=True) if args.json else render_lifecycle(status))
    return 0


def cmd_lifecycle_trigger(args) -> int:
    """Queue one manual retune: bumps the control file's trigger token;
    the controller consumes it on its next tick (bypassing the cooldown,
    never an in-flight episode or a live bake)."""
    from predictionio_tpu_torch.lifecycle import write_control

    data = write_control(_lifecycle_state_dir(args), trigger=True)
    print(
        f"Retune queued (trigger token {data['trigger']}); the controller "
        "starts it on its next tick unless an episode is already running."
    )
    return 0


def cmd_lifecycle_pause(args) -> int:
    """Turn automatic triggers off or on; an in-flight episode always runs
    to its outcome."""
    from predictionio_tpu_torch.lifecycle import write_control

    paused = args.subcommand == "pause"
    write_control(_lifecycle_state_dir(args), paused=paused)
    print(
        "Lifecycle paused (automatic triggers off; `pio lifecycle resume` "
        "re-enables, manual `trigger` still works)."
        if paused
        else "Lifecycle resumed (automatic triggers back on)."
    )
    return 0


def cmd_undeploy(args) -> int:
    """POST /stop to a running engine server (ref commands/Engine.scala:244-267)."""
    import ssl
    import urllib.request

    scheme = "https" if args.ssl else "http"
    url = f"{scheme}://{args.ip}:{args.port}/stop"
    context = ssl._create_unverified_context() if args.ssl else None
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=10, context=context
        ) as resp:
            print(resp.read().decode())
        return 0
    except Exception as exc:
        return _die(f"undeploy failed: {exc}")


def cmd_batchpredict(args) -> int:
    """Offline mega-batch prediction: stream queries from a file or off the
    event store, dispatch batches through the engines' kernels
    (double-buffered), and write the results to a file (atomic) and/or the
    event store. Nonzero exit only when setup fails or every query line
    failed; a malformed line becomes a line-aligned error object."""
    from predictionio_tpu_torch.workflow.batch_predict import run_batch_predict

    if args.from_events and args.input is not None:
        return _die("--from-events and --input are mutually exclusive")
    input_path = None if args.from_events else (args.input or "batchpredict-input.json")
    try:
        report = run_batch_predict(
            args.engine_dir,
            input_path,
            args.output,
            variant_path=args.variant,
            storage=_storage(),
            device=args.device,
            from_events=args.from_events,
            app_name=args.app_name,
            channel=args.channel,
            query_num=args.query_num,
            to_events=args.to_events,
            batch_size=args.batch,
            limit=args.limit,
            status_path=args.status_file,
        )
    except (RuntimeError, OSError) as exc:
        return _die(f"batchpredict failed: {exc}")
    sinks = ([args.output] if args.output else []) + (["event store"] if args.to_events else [])
    print(
        f"Batch predict completed: {report.queries} queries "
        f"({report.ok} ok, {report.errors} errors) in {report.wall_s:.2f}s "
        f"({report.qps:.0f} q/s) -> {', '.join(sinks)}"
    )
    if report.all_failed:
        return _die("batch predict: every query line failed")
    return 0


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def cmd_eval(args) -> int:
    """Hyperparameter search as the evaluation grid: fold×params cells
    trained in parallel workers, scored through the offline mega-batch
    path, finished cells persisted to a durable ledger (``--resume``
    retrains zero finished cells). A FakeRun evaluation runs as is."""
    import importlib
    import tempfile

    from predictionio_tpu_torch.tuning.cells import resolve_evaluation
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import (
        run_evaluation,
        run_grid_evaluation,
    )

    # user evaluations live in the engine project's cwd
    cwd = os.getcwd()
    if cwd not in sys.path:
        sys.path.insert(0, cwd)
    if args.publish and args.no_publish:
        return _die("--publish and --no-publish are mutually exclusive")
    engine_manifest = None
    if args.engine_dir:
        from predictionio_tpu_torch.workflow.engine_loader import load_manifest

        engine_manifest = load_manifest(args.engine_dir, args.variant)
    registry_dir = args.registry_dir or os.environ.get("PIO_REGISTRY_DIR")
    # publish when the pieces are in place (engine identity and registry);
    # --publish forces (and fails on a missing piece), --no-publish wins
    publish = False if args.no_publish else (args.publish or bool(engine_manifest and registry_dir))
    if args.resume and not args.workdir:
        return _die("--resume needs the --workdir of the run to resume (the trial ledger lives there)")
    probe = resolve_evaluation(args.evaluation)
    device = "cpu" if args.worker_class == "cpu-fallback" else args.device
    ctx = WorkflowContext(
        mode="evaluation", device=device, _storage=_storage(), batch=args.batch or ""
    )
    if (
        getattr(probe, "engine", None) is None or getattr(probe, "metric", None) is None
    ) and hasattr(probe, "run"):
        # FakeRun-style: no grid to search
        instance_id, result = run_evaluation(probe, ctx)
        print(result.one_liner())
        print(f"Evaluation instance ID: {instance_id}")
        return 0
    source = args.evaluation
    if args.engine_params_generator:
        if args.workers > 0:
            return _die(
                "an explicit engine_params_generator cannot ride to process "
                "workers (they rebuild the evaluation by its dotted path); set "
                "engine_params_generator on the Evaluation itself, or use --workers 0"
            )
        module_name, _, attr = args.engine_params_generator.rpartition(".")
        generator = getattr(importlib.import_module(module_name), attr)
        probe.engine_params_generator = generator() if isinstance(generator, type) else generator
        source = probe
    workdir = args.workdir or tempfile.mkdtemp(prefix="pio_eval_grid_")
    env = {"PIO_FS_BASEDIR": os.path.abspath(args.home)} if args.home else None
    try:
        instance_id, report = run_grid_evaluation(
            source,
            ctx,
            evaluation=probe,
            workdir=workdir,
            workers=args.workers,
            folds=args.folds,
            resume=args.resume,
            batch_size=args.batch_size,
            publish=publish,
            registry_dir=registry_dir,
            engine_manifest=engine_manifest,
            stage_mode=args.stage_mode,
            stage_fraction=args.stage_fraction,
            status_path=args.status_file,
            cwd=cwd,
            env=env,
            nice=args.nice,
            worker_class=args.worker_class,
        )
    except ValueError as exc:
        return _die(str(exc))
    print(report.one_liner())
    if report.published_version:
        print(
            f"Winner published to registry as candidate {report.published_version} "
            f"(evidence: {report.cells_total} cells, ledger sha {report.ledger_sha256[:12]})"
        )
    print(f"Trial ledger: {report.ledger_path}")
    print(f"Evaluation instance ID: {instance_id}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report.to_json_dict(), fh, indent=1, sort_keys=True)
        print(f"Grid report written to {args.out}")
    return 0


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------


def _models_store(args):
    from predictionio_tpu_torch.registry import ArtifactStore

    return ArtifactStore(_registry_dir(args))


def _models_engine_id(args) -> str:
    if args.engine_id:
        return args.engine_id
    from predictionio_tpu_torch.workflow.engine_loader import load_manifest

    return load_manifest(args.engine_dir, args.variant).engine_id


def cmd_models_list(args) -> int:
    store = _models_store(args)
    engine_id = _models_engine_id(args)
    state = store.get_state(engine_id)
    versions = store.list_versions(engine_id)
    if not versions:
        print(
            f"No versions in registry {store.base_dir} for engine {engine_id} "
            f"(key {store.engine_key(engine_id)}). Train with --registry-dir."
        )
        return 0
    print(f"Registry: {store.base_dir} (engine key {store.engine_key(engine_id)})")
    print(f"{'Version':<10} | {'Role':<10} | {'Created':<26} | {'Bytes':>9} | Instance")
    for m in versions:
        role = ""
        if m.version == state.stable:
            role = "stable"
        elif m.version == state.candidate:
            role = f"candidate ({state.mode} {state.fraction:g})"
        print(f"{m.version:<10} | {role:<10} | {(m.created_at or '')[:26]:<26} | {m.blob_size:>9} | {m.instance_id}")
    return 0


def cmd_models_show(args) -> int:
    if args.url:
        data = _http_json(f"{args.url}/models")
        if not args.version:
            print(json.dumps(data, indent=2))
            return 0
        out = {"version": args.version}
        for role in ("stable", "candidate"):
            lane = data.get(role)
            if lane and lane.get("version") == args.version:
                out["role"] = role
                out["live"] = lane
        row = next(
            (v for v in (data.get("registry") or {}).get("versions", ()) if v.get("version") == args.version),
            None,
        )
        if row is not None:
            out["registry"] = row
        if "live" not in out and row is None:
            return _die(f"version {args.version} is not known to the server at {args.url}")
        print(json.dumps(out, indent=2))
        return 0
    store = _models_store(args)
    engine_id = _models_engine_id(args)
    state = store.get_state(engine_id)
    version = args.version or state.stable
    if not version:
        return _die("no version given and no stable recorded; see `models list`")
    manifest = store.get_manifest(engine_id, version)
    if manifest is None:
        return _die(f"unknown version {version}; see `models list`")
    print(json.dumps({"manifest": manifest.to_json_dict(), "rollout": state.to_json_dict()}, indent=2))
    return 0


def cmd_models_promote(args) -> int:
    if args.url:
        # an explicit version is a guard: the server refuses (409) unless
        # it is the staged candidate
        payload = {"version": args.version} if args.version else {}
        out = _http_json(f"{args.url}/models/promote", method="POST", payload=payload)
        print(f"Promoted {out.get('version')} (instance {out.get('instanceId')}).")
        return 0
    state = _models_store(args).promote(_models_engine_id(args), args.version or None)
    print(f"Promoted {state.stable} to stable (previous: {state.previous_stable or '-'}).")
    return 0


def cmd_models_rollback(args) -> int:
    if args.url:
        out = _http_json(f"{args.url}/models/rollback", method="POST", payload={})
        print(f"Rolled back candidate {out.get('version')}.")
        return 0
    state = _models_store(args).rollback(_models_engine_id(args), reason="manual (cli)")
    print(f"Rolled back; stable is {state.stable or '-'}.")
    return 0


def cmd_models_stage(args) -> int:
    """Stage a candidate on a RUNNING server (sticky canary or shadow)."""
    out = _http_json(
        f"{args.url}/models/candidate",
        method="POST",
        payload={"version": args.version, "mode": args.mode, "fraction": args.fraction},
    )
    print(f"Staged {out.get('version')} as {out.get('mode')} candidate (fraction {out.get('fraction')}).")
    return 0


def cmd_models_diff(args) -> int:
    store = _models_store(args)
    engine_id = _models_engine_id(args)
    a = store.get_manifest(engine_id, args.version_a)
    b = store.get_manifest(engine_id, args.version_b)
    if a is None or b is None:
        return _die(f"unknown version {args.version_a if a is None else args.version_b}; see `models list`")
    da, db = a.to_json_dict(), b.to_json_dict()
    # the train profiles are compared as a wall-clock delta, not dumped
    pa, pb = da.pop("train_profile", None) or {}, db.pop("train_profile", None) or {}
    for d in (da, db):
        stream = d.get("data_span", {}).get("stream")
        if isinstance(stream, dict):
            stream.pop("profile", None)
    same = True
    for key in sorted(set(da) | set(db)):
        va, vb = da.get(key), db.get(key)
        if va != vb:
            same = False
            print(f"{key}:")
            print(f"  - {args.version_a}: {va}")
            print(f"  + {args.version_b}: {vb}")
    if pa or pb:
        wa, wb = pa.get("wallClockS"), pb.get("wallClockS")
        print(f"train_profile ({args.version_a} -> {args.version_b}):")
        print(f"  wall clock: {wa}s -> {wb}s")
        same = same and pa == pb
    if same:
        print(f"{args.version_a} and {args.version_b} are identical.")
    elif a.params_hash == b.params_hash:
        print("(same engine params; differs only in data/lineage)")
    return 0


# ---------------------------------------------------------------------------
# status, version, templates, run
# ---------------------------------------------------------------------------

# the card probe runs in a bounded subprocess: a wedged CUDA init must not hang `status`
_CUDA_PROBE = (
    "import json, torch; n = torch.cuda.device_count() if torch.cuda.is_available() else 0; "
    "print('PIO-TORCH ' + json.dumps({'torch': torch.__version__, 'cuda': torch.version.cuda, "
    "'count': n, 'names': [torch.cuda.get_device_name(i) for i in range(n)]}))"
)


def cmd_status(args) -> int:
    """ref commands/Management.status + Storage.verifyAllDataObjects."""
    import subprocess

    print(f"predictionio_tpu_torch {predictionio_tpu_torch.__version__}")
    try:
        storage = _storage()
    except Exception as exc:
        return _die(f"storage configuration invalid: {exc}")
    failures = storage.verify_all_data_objects()
    if failures:
        for f in failures:
            print(f"  [FAILED] {f}")
        return _die("storage verification failed")
    print("  storage: all data objects verified")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__)))
    env = {**os.environ, "PYTHONPATH": pkg_root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    try:
        probe = subprocess.run(
            [sys.executable, "-c", _CUDA_PROBE],
            capture_output=True,
            timeout=45,
            text=True,
            env=env,
        )
        line = next(
            (ln for ln in probe.stdout.splitlines() if ln.startswith("PIO-TORCH ")), None
        )
        if probe.returncode == 0 and line:
            info = json.loads(line[len("PIO-TORCH "):])
            names = ", ".join(info["names"]) or "none"
            print(
                f"  torch {info['torch']} (CUDA {info['cuda']}); "
                f"cards: {info['count']} ({names})"
            )
        else:
            err = probe.stderr.strip().splitlines()
            print(f"  cards unavailable: {err[-1] if err else 'unknown'}")
    except subprocess.TimeoutExpired:
        print("  cards unavailable: CUDA init timed out after 45s")
    print("(sleeping)   <- your engine is ready to train")
    return 0


def cmd_upgrade(args) -> int:
    """Storage-format check (ref Console.scala 'upgrade'): every repository
    is verified and the event store's identity reported."""
    storage = _storage()
    errors = storage.verify_all_data_objects()
    if errors:
        for e in errors:
            print(f"[ERROR] {e}")
        return 1
    print("All storage repositories verified; data formats are current.")
    stamp = storage.get_p_events().store_identity()
    if stamp:
        print(f"Event store identity: {stamp}")
    print("No migration necessary.")
    return 0


def cmd_shell(args) -> int:
    from predictionio_tpu_torch.tools.shell import run_shell

    run_shell(args.device, storage=_storage())
    return 0


_PIDFILE = "pio-services.pid"


def _pidfile(args) -> str:
    base = _basedir(args) or default_basedir()
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, _PIDFILE)


def cmd_start_all(args) -> int:
    """Start the event server, the admin server and the dashboard as
    background processes of this CLI on this storage (ref
    bin/pio-start-all); their pids go to ``pio-services.pid`` under the
    basedir, which stop-all reads."""
    import subprocess

    pidfile = _pidfile(args)
    if os.path.exists(pidfile):
        return _die(f"{pidfile} exists; run stop-all first")
    home = ["--home", args.home] if args.home else []
    specs = [
        ("eventserver", ["eventserver", "--port", str(args.eventserver_port)]),
        ("adminserver", ["adminserver", "--port", str(args.adminserver_port)]),
        ("dashboard", ["dashboard", "--port", str(args.dashboard_port)]),
    ]
    pids = []
    for name, argv in specs:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *home, *argv],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        pids.append(f"{name}:{proc.pid}")
        print(f"started {name} (pid {proc.pid})")
    with open(pidfile, "w") as f:
        f.write("\n".join(pids))
    return 0


def cmd_stop_all(args) -> int:
    """Stop the services start-all started (ref bin/pio-stop-all)."""
    pidfile = _pidfile(args)
    if not os.path.exists(pidfile):
        return _die(f"no {_PIDFILE}; nothing to stop")
    with open(pidfile) as f:
        entries = [line.strip() for line in f if line.strip()]
    for entry in entries:
        name, _, pid = entry.partition(":")
        try:
            os.kill(int(pid), signal.SIGTERM)
            print(f"stopped {name} (pid {pid})")
        except ProcessLookupError:
            print(f"{name} (pid {pid}) already gone")
    os.remove(pidfile)
    return 0


def cmd_version(args) -> int:
    print(predictionio_tpu_torch.__version__)
    return 0


def cmd_lint(args) -> int:
    return run_lint(args)


def _templates_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(predictionio_tpu_torch.__file__)), "models")


def _template_names() -> list[str]:
    base = _templates_dir()
    return sorted(
        name for name in os.listdir(base) if os.path.isfile(os.path.join(base, name, "engine.json"))
    )


def cmd_template_list(args) -> int:
    for name in _template_names():
        print(f"  {name}")
    return 0


def cmd_template_get(args) -> int:
    """Copy a template's engine.json into a new engine dir."""
    if args.name not in _template_names():
        return _die(f"unknown template {args.name}; see `template list`")
    dst = args.directory or args.name
    if os.path.exists(dst) and os.listdir(dst):
        return _die(f"directory {dst} exists and is not empty")
    os.makedirs(dst, exist_ok=True)
    shutil.copy(
        os.path.join(_templates_dir(), args.name, "engine.json"), os.path.join(dst, "engine.json")
    )
    with open(os.path.join(dst, "template.json"), "w") as f:
        json.dump({"pio": {"version": {"min": "0.1.0"}}}, f)
    print(f"Engine template {args.name} created at {dst}/")
    print("Edit engine.json (appName, algorithm params) and run `train`.")
    return 0


def cmd_run(args) -> int:
    """Run a python main with the framework importable (ref `pio run`)."""
    import runpy

    sys.argv = [args.main] + (args.args or [])
    runpy.run_path(args.main, run_name="__main__")
    return 0


# ---------------------------------------------------------------------------
# observability verbs: profile, incidents, doctor
# ---------------------------------------------------------------------------


def _print_bundles(directory: str, title: str, noun: str, empty_hint: str) -> int:
    import time as _time

    from predictionio_tpu_torch.obs.incidents import list_bundles

    refs = list_bundles(directory)
    if not refs:
        print(f"No {noun} bundles under {directory} ({empty_hint})")
        return 0
    print(f"{title}: {directory}")
    print(f"{'Bundle':<30} | {'Trigger':<14} | Captured")
    for ref in refs:
        when = _time.strftime("%Y-%m-%d %H:%M:%S", _time.localtime(ref.captured_at))
        print(f"{ref.bundle_id:<30} | {ref.trigger:<14} | {when}")
    return 0


def _show_bundle(directory: str, args, tail_lines: int = 0) -> dict | None:
    """Print one bundle's manifest, parts and texts (the JAX layout);
    returns it, or None after printing the whole JSON (``--json``)."""
    from predictionio_tpu_torch.obs.incidents import load_bundle

    bundle = load_bundle(directory, args.bundle)
    if args.json:
        print(json.dumps(bundle, indent=2, sort_keys=True, default=repr))
        return None
    manifest = bundle["manifest"]
    print(f"trigger   {manifest.get('trigger')}")
    print(f"captured  {manifest.get('capturedAt')}")
    print(f"sha256    {manifest.get('sha256')}")
    context = manifest.get("context") or {}
    if context:
        print("context   " + json.dumps(context, sort_keys=True))
    for name, part in sorted(bundle["parts"].items()):
        print(f"part      {name}.json ({len(json.dumps(part))} bytes)")
    for name, text in sorted(bundle["texts"].items()):
        print(f"text      {name}.txt ({len(text)} bytes)")
        for line in (text.strip().splitlines()[-tail_lines:] if tail_lines > 0 else []):
            print(f"  | {line}")
    return bundle


def _export_bundle(directory: str, args) -> int:
    from predictionio_tpu_torch.obs.incidents import export_bundle

    try:
        dest = export_bundle(directory, args.bundle, args.dest)
    except (FileNotFoundError, ValueError, OSError) as exc:
        return _die(str(exc))
    print(f"Exported to {dest}")
    return 0


def _incidents_dir(args) -> str:
    return os.path.join(args.obs_dir, "incidents")


def cmd_incidents_list(args) -> int:
    return _print_bundles(_incidents_dir(args), "Incidents", "incident",
                          "pio stream --obs-dir writes them on a drift breach; --obs-dir points elsewhere")


def cmd_incidents_show(args) -> int:
    try:
        _show_bundle(_incidents_dir(args), args, tail_lines=args.tail_lines)
    except (FileNotFoundError, ValueError) as exc:
        return _die(str(exc))
    return 0


def cmd_incidents_export(args) -> int:
    return _export_bundle(_incidents_dir(args), args)


def _profile_dir(args) -> str:
    # the flag, else PIO_PROFILE_DIR (the training gate), else the deploy default
    return args.profile_dir or os.environ.get("PIO_PROFILE_DIR") or "pio_obs/profiles"


def cmd_profile_serve(args) -> int:
    """``POST /profile/capture?ms=`` on a running server; the bundle lands
    in the server's own store (``pio profile list --profile-dir``)."""
    import urllib.error
    import urllib.request

    target = args.url.rstrip("/") + f"/profile/capture?ms={args.ms}"
    req = urllib.request.Request(target, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            body = json.loads(resp.read().decode("utf-8", errors="replace"))
    except urllib.error.HTTPError as exc:
        detail = exc.read().decode("utf-8", errors="replace")[:400]
        if exc.code == 409:
            return _die(f"capture already in flight on {args.url}: {detail}")
        return _die(f"capture failed ({exc.code}): {detail}")
    except OSError as exc:
        return _die(f"server unreachable at {args.url}: {exc}")
    print(json.dumps(body, indent=2, sort_keys=True))
    return 0


def cmd_profile_train(args) -> int:
    """``pio train`` under the device tracer: sets ``PIO_PROFILE_DIR`` and
    runs the train verb with the remaining arguments."""
    rest = list(args.train_args)
    if rest and rest[0] == "--":
        rest = rest[1:]
    os.environ["PIO_PROFILE_DIR"] = _profile_dir(args)
    return main((["--home", args.home] if args.home else []) + ["train", *rest])


def cmd_profile_list(args) -> int:
    return _print_bundles(_profile_dir(args), "Profiles", "profile",
                          "POST /profile/capture, `pio profile serve|train` or profile-on-alert "
                          "write them; --profile-dir points elsewhere")


def cmd_profile_show(args) -> int:
    from predictionio_tpu_torch.obs.incidents import resolve_bundle
    from predictionio_tpu_torch.obs.profiler import trace_kernels

    directory = _profile_dir(args)
    try:
        bundle = _show_bundle(directory, args)
    except (FileNotFoundError, ValueError) as exc:
        return _die(str(exc))
    if bundle is None:
        return 0
    for entry in bundle["manifest"].get("trace") or []:
        print(f"trace     {entry.get('name')} ({entry.get('bytes')} bytes, "
              f"sha256 {str(entry.get('sha256'))[:12]})")
    trace_dir = os.path.join(resolve_bundle(directory, args.bundle), "trace")
    if os.path.isdir(trace_dir):
        for name, n in sorted(trace_kernels(trace_dir).items(), key=lambda kv: -kv[1]):
            print(f"kernel    {n:>8}  {name}")
    return 0


def cmd_profile_export(args) -> int:
    return _export_bundle(_profile_dir(args), args)


def _parse_bytes(text: str) -> int:
    """'16e9', '16000000000', '16GB', '16GiB' -> bytes."""
    t = text.strip().lower()
    for suffix, mult in (("gib", 1 << 30), ("mib", 1 << 20), ("kib", 1 << 10),
                         ("gb", 10**9), ("mb", 10**6), ("kb", 10**3), ("b", 1)):
        if t.endswith(suffix):
            return int(float(t[: -len(suffix)]) * mult)
    return int(float(t))


def _doctor_roofline(args) -> int:
    """``pio doctor --roofline``: the analytic roofline (obs/costmodel) of
    every family, the three CUDA kernels at the main paths' shapes
    included, against the card's data-sheet peaks."""
    from predictionio_tpu_torch.obs import costmodel

    families = [f.strip() for f in args.families.split(",") if f.strip()] if args.families else None
    try:
        report = costmodel.analyze(families=families)
    except ValueError as exc:
        return _die(str(exc))
    print(json.dumps(report, indent=2, sort_keys=True))
    for cost in report["families"].get("kernels", {}).get("kernels", []):
        ms, what, _ = costmodel.bound_ms(cost)
        print(f"bound     {cost['kernel']:<16} {json.dumps(cost['shape'], sort_keys=True)}  "
              f"{ms:.6g} ms, {what}  ({cost.get('label', '')})")
    return 0


def _doctor_inventory(device: str) -> None:
    """The card: name, memory and the allocator's readings (xray)."""
    import torch

    from predictionio_tpu_torch.obs import xray

    if device == "cpu":
        print("device: cpu (no card asked for)")
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (pass --device cpu for the planner alone)")
    n = torch.cuda.device_count()
    print(f"backend: cuda {torch.version.cuda}  torch {torch.__version__}  devices: {n}")
    for i in range(n):
        free, total = torch.cuda.mem_get_info(i)
        print(f"  cuda:{i}  {torch.cuda.get_device_name(i)}  memory {total} B  free {free} B")
    stats = xray.device_memory_stats()
    if stats:
        print("  busiest: " + json.dumps(stats, sort_keys=True))


def _doctor_ann_inventory(registry_dir: str | None) -> None:
    """Every ANN index pinned on a registry-stable version."""
    registry_dir = registry_dir or os.environ.get("PIO_REGISTRY_DIR")
    if not registry_dir or not os.path.isdir(registry_dir):
        return
    from predictionio_tpu_torch.registry import ArtifactStore

    store = ArtifactStore(registry_dir)
    lines = []
    for key in store.engines():
        state = store.state_by_key(key)
        if not state.stable:
            continue
        manifest = {m.version: m for m in store.versions_by_key(key)}.get(state.stable)
        if manifest is None or not manifest.ann_index:
            continue
        a = manifest.ann_index
        lines.append(
            f"  {key} {state.stable}: {a.get('items', '?')} items, {a.get('clusters', '?')} clusters "
            f"x cap {a.get('bucketCap', '?')}, nprobe {a.get('nprobe', '?')}, "
            f"{a.get('hbmBytes', 0)} B" + (" (int8)" if a.get("quantized") else "")
        )
    if lines:
        print("ann indexes (registry-pinned stable):")
        for line in lines:
            print(line)


def cmd_doctor(args) -> int:
    """Preflight diagnostics. ``--capacity USERS ITEMS K`` prices an ALS
    train's card memory (``xray.estimate_factors``), ``--ann C,P`` an ANN
    index beside it; exit 1 past ``--hbm-bytes``. ``--roofline``: the
    analytic roofline. Otherwise the inventory: the card and the indexes
    pinned in the registry."""
    from predictionio_tpu_torch.obs import xray

    if args.roofline:
        return _doctor_roofline(args)
    if args.ann and not args.capacity:
        return _die("--ann needs --capacity USERS ITEMS K (ITEMS and K size the index)")
    if args.capacity:
        users, items, k = (int(v) for v in args.capacity)
        est = xray.estimate_factors(users, items, k, dtype=args.dtype, mesh=args.mesh or None, nnz=args.nnz,
                                    gather_dtype=args.gather_dtype)
        budget = _parse_bytes(args.hbm_bytes) if args.hbm_bytes else None
        need = est.per_device_bytes
        ann_est = None
        if args.ann:
            try:
                clusters_s, _, nprobe_s = args.ann.partition(",")
                clusters, nprobe = int(clusters_s or 0), int(nprobe_s or 0)
            except ValueError:
                return _die(f"--ann expects 'clusters,nprobe' (0 = auto), got {args.ann!r}")
            ann_est = xray.estimate_ann(items, k, clusters, nprobe, quantize_int8=args.ann_int8)
            need += ann_est["perDeviceBytes"]
        print(json.dumps({
            "capacity": est.to_json_dict(),
            "ann": ann_est,
            "perDeviceBytesTotal": need,
            "hbmBudgetBytes": budget,
            "fits": (need <= budget) if budget is not None else None,
        }, indent=2))
        if budget is not None:
            if need > budget:
                print(f"EXCEEDS BUDGET: {need / 1e9:.2f} GB/device needed vs {budget / 1e9:.2f} GB "
                      f"budget — shard wider (--mesh), lower k, bf16 the tables"
                      + (", or --ann-int8 / fewer clusters for the index" if ann_est else ""), file=sys.stderr)
                return 1
            print(f"fits: {need / 1e9:.2f} GB/device of {budget / 1e9:.2f} GB budget "
                  f"({100.0 * need / budget:.1f}%)")
        return 0
    _doctor_inventory(args.device)
    _doctor_ann_inventory(args.registry_dir)
    return 0


def _add_obs_verbs(sub) -> None:
    prof = sub.add_parser(
        "profile", help="on-demand torch.profiler captures of a live server, a traced train, "
                        "and profile bundle inspection"
    ).add_subparsers(dest="subcommand", required=True)

    def profile_dir_arg(x):
        x.add_argument("--profile-dir", default=None,
                       help="profile bundle directory (default $PIO_PROFILE_DIR, else "
                            "pio_obs/profiles, the deploy default)")

    x = prof.add_parser("serve", help="POST /profile/capture?ms= on a running server")
    x.add_argument("--url", default="http://127.0.0.1:8000")
    x.add_argument("--ms", type=int, default=500,
                   help="device-trace length (clamped server-side; 0 = host-only bundle)")
    x.add_argument("--timeout", type=float, default=30.0)
    x.set_defaults(fn=cmd_profile_serve)
    x = prof.add_parser("train", help="run `train ...` under the device tracer; the trace "
                                      "lands as a bundle under --profile-dir")
    profile_dir_arg(x)
    x.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments of `train` (prefix with --)")
    x.set_defaults(fn=cmd_profile_train)
    x = prof.add_parser("list", help="bundles oldest first")
    profile_dir_arg(x)
    x.set_defaults(fn=cmd_profile_list)
    x = prof.add_parser("show", help="manifest, parts, trace inventory and kernel launches of one bundle")
    x.add_argument("bundle", help="bundle id (unique prefix accepted)")
    profile_dir_arg(x)
    x.add_argument("--json", action="store_true", help="full bundle as JSON")
    x.set_defaults(fn=cmd_profile_show)
    x = prof.add_parser("export", help="copy one bundle somewhere shippable")
    x.add_argument("bundle")
    x.add_argument("dest")
    profile_dir_arg(x)
    x.set_defaults(fn=cmd_profile_export)

    inc = sub.add_parser("incidents", help="incident bundles (pio stream --obs-dir writes them "
                                           "on a drift breach)").add_subparsers(dest="subcommand", required=True)
    x = inc.add_parser("list", help="bundles oldest first")
    x.add_argument("--obs-dir", default="pio_obs")
    x.set_defaults(fn=cmd_incidents_list)
    x = inc.add_parser("show", help="manifest, parts and text tails of one bundle")
    x.add_argument("bundle", help="bundle id (unique prefix accepted)")
    x.add_argument("--obs-dir", default="pio_obs")
    x.add_argument("--json", action="store_true", help="full bundle as JSON")
    x.add_argument("--tail-lines", type=int, default=20)
    x.set_defaults(fn=cmd_incidents_show)
    x = inc.add_parser("export", help="copy one bundle somewhere shippable")
    x.add_argument("bundle")
    x.add_argument("dest")
    x.add_argument("--obs-dir", default="pio_obs")
    x.set_defaults(fn=cmd_incidents_export)

    x = sub.add_parser("doctor", help="preflight diagnostics: the card, capacity planning "
                                      "(--capacity USERS ITEMS K) and the analytic roofline")
    x.add_argument("--capacity", nargs=3, metavar=("USERS", "ITEMS", "K"),
                   help="predict the card memory of an ALS train of this shape")
    x.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    x.add_argument("--gather-dtype", choices=["f32", "bf16"], default="f32",
                   help="solver gather dtype (bf16 adds half-size table copies)")
    x.add_argument("--mesh", help="mesh axis sizes, e.g. data=8,model=2 (explicit sizes only)")
    x.add_argument("--nnz", type=int, help="rating count (adds the rating tables)")
    x.add_argument("--ann", metavar="CLUSTERS,NPROBE",
                   help="price an ANN index (ITEMS items, dim K) beside the factor tables")
    x.add_argument("--ann-int8", action="store_true", help="price the int8 index layout")
    x.add_argument("--hbm-bytes", help="card memory budget (16e9 / 16GB / 16GiB); exit 1 past it")
    x.add_argument("--registry-dir", help="registry to inventory pinned ANN indexes from "
                                          "(default $PIO_REGISTRY_DIR)")
    x.add_argument("--roofline", action="store_true",
                   help="analytic roofline: operations, bytes, intensity and the floor of "
                        "each family's kernels, the CUDA kernels' bounds included")
    x.add_argument("--families", help="comma list for --roofline (default: all of "
                                      "topk,ann,als,twotower,kernels)")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the inventory's device (cpu: no card read)")
    x.set_defaults(fn=cmd_doctor)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pio-torch", description=__doc__.split("\n")[0])
    p.add_argument(
        "--home",
        default=None,
        help="storage basedir, the same as $PIO_FS_BASEDIR "
        "(default $PIO_FS_BASEDIR, else $PIO_TORCH_HOME, else ~/.pio_torch)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version").set_defaults(fn=cmd_version)
    sub.add_parser("upgrade", help="verify storage formats").set_defaults(fn=cmd_upgrade)
    sub.add_parser("status").set_defaults(fn=cmd_status)
    x = sub.add_parser("shell", help="a REPL with the event stores bound")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the shell's device (cpu: the card stays hidden from it)")
    x.set_defaults(fn=cmd_shell)

    x = sub.add_parser("start-all")
    x.add_argument("--eventserver-port", type=int, default=7070)
    x.add_argument("--adminserver-port", type=int, default=7071)
    x.add_argument("--dashboard-port", type=int, default=9000)
    x.set_defaults(fn=cmd_start_all)
    sub.add_parser("stop-all").set_defaults(fn=cmd_stop_all)

    app = sub.add_parser("app").add_subparsers(dest="subcommand", required=True)
    x = app.add_parser("new")
    x.add_argument("name")
    x.add_argument("--id", type=int, default=0)
    x.add_argument("--description")
    x.add_argument("--access-key", default="")
    x.set_defaults(fn=cmd_app_new)
    app.add_parser("list").set_defaults(fn=cmd_app_list)
    x = app.add_parser("show")
    x.add_argument("name")
    x.set_defaults(fn=cmd_app_show)
    x = app.add_parser("delete")
    x.add_argument("name")
    x.add_argument("-f", "--force", action="store_true")
    x.set_defaults(fn=cmd_app_delete)
    x = app.add_parser("data-delete")
    x.add_argument("name")
    x.add_argument("--channel")
    x.add_argument("-f", "--force", action="store_true")
    x.set_defaults(fn=cmd_app_data_delete)
    x = app.add_parser("channel-new")
    x.add_argument("app_name")
    x.add_argument("channel")
    x.set_defaults(fn=cmd_channel_new)
    x = app.add_parser("channel-delete")
    x.add_argument("app_name")
    x.add_argument("channel")
    x.add_argument("-f", "--force", action="store_true")
    x.set_defaults(fn=cmd_channel_delete)

    ak = sub.add_parser("accesskey").add_subparsers(dest="subcommand", required=True)
    x = ak.add_parser("new")
    x.add_argument("app_name")
    x.add_argument("--key", default="")
    x.add_argument("--event", action="append")
    x.set_defaults(fn=cmd_accesskey_new)
    x = ak.add_parser("list")
    x.add_argument("app_name", nargs="?")
    x.set_defaults(fn=cmd_accesskey_list)
    x = ak.add_parser("delete")
    x.add_argument("key")
    x.set_defaults(fn=cmd_accesskey_delete)

    x = sub.add_parser("eventserver")
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=7070)
    x.add_argument("--stats", action="store_true")
    x.add_argument("--ssl-certfile")
    x.add_argument("--ssl-keyfile")
    x.add_argument("--storage-retries", type=int, default=3,
                   help="attempts per storage call for transient failures (<= 1 disables)")
    x.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive storage failures that open the circuit breaker "
                        "(requests then answer 503 'storage unavailable')")
    x.add_argument("--breaker-recovery", type=float, default=5.0,
                   help="seconds an open storage breaker waits before probing again")
    x.set_defaults(fn=cmd_eventserver)

    x = sub.add_parser("import")
    x.add_argument("--appname", dest="app_name", required=True)
    x.add_argument("--input", required=True)
    x.add_argument("--channel")
    x.set_defaults(fn=cmd_import)

    x = sub.add_parser("export")
    x.add_argument("--appname", dest="app_name", required=True)
    x.add_argument("--output", required=True)
    x.add_argument("--channel")
    x.add_argument("--format", default="json", choices=["json", "parquet", "npz"])
    x.set_defaults(fn=cmd_export)

    def engine_args(x):
        x.add_argument("--engine-dir", default=".")
        x.add_argument("--variant")
        x.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    def stream_args(x, require_app: bool):
        """Speed-layer flags of `stream` and `train --follow`."""
        x.add_argument("--app-name", required=require_app, default=None if require_app else "",
                       help="app whose event store to tail")
        x.add_argument("--channel", default="", help="channel name (optional)")
        x.add_argument("--interval", type=float, default=5.0, help="seconds between cycles")
        x.add_argument("--batch-limit", type=int, default=500,
                       help="events per drain micro-batch (the backpressure unit)")
        x.add_argument("--safety-lag", type=float, default=0.5,
                       help="seconds the drain stays behind the wall clock, so a concurrently "
                            "committing insert cannot land behind the cursor (0 disables)")
        x.add_argument("--publish-min-events", type=int, default=1,
                       help="publish a candidate once this many new events folded in")
        x.add_argument("--mode", choices=("canary", "shadow"), default="canary",
                       help="rollout mode published candidates are staged with")
        x.add_argument("--fraction", type=float, default=0.1, help="canary fraction")
        x.add_argument("--from-beginning", action="store_true",
                       help="a fresh cursor replays the whole store instead of starting at the head")
        x.add_argument("--cursor-dir", help="cursor state dir (default: $PIO_STREAM_DIR)")
        x.add_argument("--cycles", type=int, default=None,
                       help="stop after N cycles (default: run until interrupted)")
        x.add_argument("--notify-url",
                       help="POST staged candidates to this query server's /models/candidate "
                            "instead of writing registry rollout state directly")
        x.add_argument("--metrics-port", type=int, default=0,
                       help="serve the pipeline's pio_stream_* metrics at :PORT/metrics; 0 disables")
        x.add_argument("--obs-dir", help="observability dir: drift-guard breaches land on its "
                                         "telemetry ring (kind=drift) and snapshot rate-limited "
                                         "incident bundles")

    x = sub.add_parser("build")
    engine_args(x)
    x.set_defaults(fn=cmd_build)

    x = sub.add_parser("unregister")
    engine_args(x)
    x.set_defaults(fn=cmd_unregister)

    x = sub.add_parser("train")
    engine_args(x)
    x.add_argument("--batch", default="")
    x.add_argument("--skip-sanity-check", action="store_true")
    x.add_argument("--stop-after-read", action="store_true")
    x.add_argument("--stop-after-prepare", action="store_true")
    x.add_argument("--num-hosts", type=int, default=1,
                   help="launch N local worker processes joined via torch.distributed "
                        "(ref Runner.runOnSpark)")
    x.add_argument("--hosts", default="",
                   help="comma-separated remote hosts; one ssh-launched worker each")
    x.add_argument("--registry-dir",
                   help="publish the trained model into this artifact registry "
                        "(default: $PIO_REGISTRY_DIR when set, else no registry publish)")
    x.add_argument("--keep-versions", type=int, default=5,
                   help="registry GC: keep this many versions (stable/candidate always kept)")
    x.add_argument("--follow", action="store_true",
                   help="after training, keep tailing the event store and publish registry "
                        "candidates (the speed layer; needs --app-name)")
    stream_args(x, require_app=False)
    x.set_defaults(fn=cmd_train)

    x = sub.add_parser("stream", help="speed layer: tail the event store, fold events into "
                                      "the stable model, publish registry candidates")
    engine_args(x)
    x.add_argument("--registry-dir", help="registry holding the stable model and receiving "
                                          "candidates (default: $PIO_REGISTRY_DIR)")
    stream_args(x, require_app=True)
    x.set_defaults(fn=cmd_stream)

    x = sub.add_parser("deploy")
    engine_args(x)
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--accesskey", help="access key /queries.json requires "
                                       "(accessKey parameter or Authorization: Bearer)")
    x.add_argument("--feedback", action="store_true",
                   help="POST a predict event per answered query to the event server")
    x.add_argument("--event-server-url", help="event server receiving feedback, e.g. http://localhost:7070")
    x.add_argument("--feedback-access-key", help="access key of the app receiving feedback")
    x.add_argument("--ssl-certfile")
    x.add_argument("--ssl-keyfile")
    x.add_argument("--log-url", help="POST serving errors to this collector URL")
    x.add_argument("--log-prefix", help="prefix prepended to each remote log body")
    x.add_argument("--request-timeout", type=float, default=10.0,
                   help="per-request deadline in seconds for /queries.json "
                        "(503 instead of hanging; <= 0 disables)")
    x.add_argument("--queue-high-water", type=int, default=256,
                   help="shed load with 503 + Retry-After when this many queries are "
                        "already queued (0 = unbounded)")
    x.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive deadline-blown device calls that open the "
                        "dispatch circuit breaker")
    x.add_argument("--breaker-recovery", type=float, default=5.0,
                   help="seconds an open dispatch breaker waits before probing again")
    x.add_argument("--drain-grace", type=float, default=15.0,
                   help="seconds a SIGTERM'd server waits for in-flight queries to "
                        "answer after closing its listener (graceful drain)")
    x.add_argument("--registry-dir",
                   help="serve the registry's stable version and expose the /models rollout "
                        "routes (default: registry disabled)")
    x.add_argument("--registry-sync-interval", type=float, default=None,
                   help="seconds between polls of the registry's rollout state: adopt "
                        "stage/promote/rollback made by other processes (fleet workers "
                        "default to 1.0; 0 disables)")
    x.add_argument("--sticky-key", default="user",
                   help="query field that pins a user to one lane for a whole bake")
    x.add_argument("--candidate-breaker-threshold", type=int, default=3,
                   help="consecutive candidate failures that force an instant rollback")
    x.add_argument("--bake-window", type=float, default=60.0,
                   help="seconds a candidate bakes before the promotion gates run")
    x.add_argument("--bake-min-requests", type=int, default=20,
                   help="canary queries (shadow: scored queries) before any verdict")
    x.add_argument("--no-auto-promote", action="store_true",
                   help="gates report ready; an operator promotes")
    x.add_argument("--result-cache-size", type=int, default=1024,
                   help="version-keyed result cache entries (0 disables); hits answer "
                        "before micro-batch admission")
    x.add_argument("--result-cache-ttl", type=float, default=10.0,
                   help="result-cache entry TTL seconds: the staleness bound for serving "
                        "components reading live state outside the model")
    x.add_argument("--slo-latency-threshold", type=float, default=0.010,
                   help="latency SLO threshold in seconds (keep it on a histogram bucket bound)")
    x.add_argument("--slo-latency-objective", type=float, default=0.50,
                   help="fraction of /queries.json answers within the threshold")
    x.add_argument("--slo-availability-objective", type=float, default=0.999,
                   help="non-5xx fraction of /queries.json answers")
    x.add_argument("--slo-shed-objective", type=float, default=0.99,
                   help="fraction of arrivals not shed by admission control")
    x.add_argument("--profile-dir", default="pio_obs/profiles",
                   help="profile bundle store of POST /profile/capture and profile-on-alert")
    x.add_argument("--profile-max-bundles", type=int, default=20)
    x.add_argument("--profile-default-ms", type=int, default=500,
                   help="capture length when POST /profile/capture gives no ?ms=")
    x.add_argument("--profile-max-ms", type=int, default=10_000, help="the clamp of ?ms=")
    x.add_argument("--sampler-period", type=float, default=0.05,
                   help="host stack sampler period in seconds (<= 0 disables sampling)")
    x.add_argument("--no-profile-on-alert", action="store_true",
                   help="no bundle on SLO-alert transitions and candidate-breaker trips")
    x.add_argument("--profile-alert-min-interval", type=float, default=60.0,
                   help="seconds between two alert bundles of one trigger kind")
    x.add_argument("--profile-alert-trace-ms", type=int, default=0,
                   help="device trace length of an alert bundle (0: host stacks only)")
    x.add_argument("--bandit", choices=("epsilon", "thompson"),
                   help="steer staged candidates with a bandit policy: the arms are the stable and "
                        "candidate lanes, the reward is feedback events matched to served answers "
                        "by trace id, and the bake gate doubles as reward accounting")
    x.add_argument("--bandit-epsilon", type=float, default=0.1,
                   help="explore share of the epsilon policy (thompson's cold-start fraction)")
    x.add_argument("--bandit-min-pulls", type=int, default=20,
                   help="answers per arm before the reward posterior may promote or retire")
    x.add_argument("--bandit-app-name", help="app whose events carry the rewards (needed with --bandit)")
    x.add_argument("--bandit-reward-event",
                   help="comma-separated event names credited as rewards (default: reward)")
    x.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="deploy N supervised QueryServer worker processes (ports PORT+1..PORT+N) "
                        "behind a gateway on PORT: least-loaded routing, /healthz ejection, crash "
                        "restart, one-retry failover, federated /metrics")
    x.add_argument("--fleet-probe-interval", type=float, default=1.0,
                   help="gateway /healthz probe cadence in seconds (bounds how fast a dead "
                        "replica is ejected)")
    x.add_argument("--autoscale", action="store_true",
                   help="size the fleet from the telemetry ring: scale out on fast-window SLO "
                        "burn / sustained queue depth, scale in (graceful drain) on sustained "
                        "idle; never resizes mid-bake; needs the flight recorder (--obs-dir)")
    x.add_argument("--fleet-min", type=int, default=None, metavar="N",
                   help="autoscaler device-class floor (default 1)")
    x.add_argument("--fleet-max", type=int, default=None, metavar="N",
                   help="autoscaler device-class ceiling (default 2x the --fleet boot size); "
                        "wanting capacity past the whole envelope snapshots an "
                        "autoscaler-saturated incident bundle")
    x.add_argument("--cpu-fallback-max", type=int, default=None, metavar="N",
                   help="max cheap cpu-fallback replicas (workers that see no card and serve "
                        "with --device cpu) added once the device envelope is exhausted; the "
                        "gateway routes them overflow-first so spikes degrade to slower answers "
                        "instead of sheds (default 0 = disabled)")
    x.add_argument("--autoscale-interval", type=float, default=None,
                   help="autoscaler control-loop cadence in seconds (default 5)")
    x.add_argument("--hosts", default=None, metavar="SPEC",
                   help="multi-host worker placement: comma list of [driver@]host:slots entries "
                        "(drivers: local, ssh, container; e.g. 'local:4,ssh@gpu-2:8'); workers "
                        "spread across the inventory and a dead host's capacity respawns on "
                        "survivors")
    x.add_argument("--gateways", type=int, default=1, metavar="N",
                   help="run N shared-nothing gateways on ports PORT..PORT+N-1 over the same "
                        "replica set (put any TCP balancer in front); each peer serves its own "
                        "/metrics, /traces/recent and /slo fan in across peers (default 1)")
    x.add_argument("--obs-dir", default="pio_obs",
                   help="fleet flight-recorder directory: worker log tails, the durable "
                        "telemetry ring (`pio top --history`), and incident bundles (`pio "
                        "incidents list`); '' disables")
    x.add_argument("--lifecycle", default=None, metavar="EVALUATION",
                   help="run the lifecycle controller in the fleet parent: drift on the "
                        "telemetry ring (or --lifecycle-cadence) triggers a background retune "
                        "of this dotted Evaluation on nice'd cpu-fallback grid workers, the "
                        "winner bakes through the rollout gates, promotes warm the result "
                        "cache; needs --registry-dir and --obs-dir")
    x.add_argument("--lifecycle-cadence", type=float, default=None,
                   help="also retune every N seconds (default 0 = drift/manual only)")
    x.add_argument("--lifecycle-cooldown", type=float, default=None,
                   help="seconds after an episode before auto triggers re-arm (default 600)")
    x.add_argument("--lifecycle-workers", type=int, default=None,
                   help="grid worker processes for lifecycle retunes (default 2; always the "
                        "cpu-fallback class)")
    x.add_argument("--lifecycle-nice", type=int, default=None,
                   help="re-nice lifecycle grid workers (default 10)")
    x.add_argument("--lifecycle-warm-limit", type=int, default=None,
                   help="max queries replayed per post-promote cache warm (default 256; 0 "
                        "disables)")
    x.add_argument("--lifecycle-app", default=None, metavar="APP_NAME",
                   help="app whose event store supplies warm-up queries (distinct users); "
                        "unset disables cache warming")
    x.set_defaults(fn=cmd_deploy)

    x = sub.add_parser("adminserver")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=7071)
    x.add_argument("--registry-dir", help="model registry served at /cmd/models (default: "
                                          "$PIO_REGISTRY_DIR, else registry/ under the basedir)")
    x.set_defaults(fn=cmd_adminserver)

    x = sub.add_parser("dashboard")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=9000)
    x.add_argument("--metrics-url", action="append",
                   help="a server base URL whose /metrics shows as a panel (repeatable)")
    x.set_defaults(fn=cmd_dashboard)

    x = sub.add_parser("top", help="live terminal summary of a running server's /metrics")
    x.add_argument("--url", default=_TOP_DEFAULT_URL, help="server base URL (query or event server)")
    x.add_argument("--interval", type=float, default=2.0)
    x.add_argument("-n", "--iterations", type=int, default=None,
                   help="stop after N refreshes (default: run until Ctrl-C)")
    x.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (rates need two samples and show as '-')")
    x.add_argument("--json", action="store_true", help="one JSON snapshot per line")
    x.add_argument("--metrics-url", action="append",
                   help="poll this endpoint too (repeatable); a --url that was set is polled first")
    x.add_argument("--fleet", action="store_true", help="--url is a fleet gateway")
    x.add_argument("--history", action="store_true",
                   help="render the telemetry ring's series (one shot), over HTTP or off --obs-dir")
    x.add_argument("--history-window", type=float, default=600.0, metavar="S",
                   help="trailing seconds of telemetry to render")
    x.add_argument("--obs-dir", default=None, help="read the telemetry ring from this directory")
    x.add_argument("--batchpredict", default=None, metavar="STATUS_FILE",
                   help="the progress line of a batchpredict --status-file")
    x.add_argument("--eval", default=None, metavar="STATUS_FILE",
                   help="the grid line of an eval --status-file")
    x.add_argument("--lifecycle", default=None, metavar="STATE_FILE",
                   help="the lifecycle controller's episode line from <state-dir>/lifecycle.json")
    x.add_argument("--hotspots", action="store_true",
                   help="append the host sampler's hotspots from /profile/stacks")
    x.set_defaults(fn=cmd_top)

    lc = sub.add_parser("lifecycle", help="the model lifecycle: drift -> retune -> bake -> promote "
                                          "-> warm").add_subparsers(dest="subcommand", required=True)

    def lifecycle_dir_args(x):
        x.add_argument("--obs-dir", default="pio_obs",
                       help="observability directory (state under <obs-dir>/lifecycle)")
        x.add_argument("--state-dir", default=None, help="state directory (default <obs-dir>/lifecycle)")

    x = lc.add_parser("run", help="run the controller against an already-deployed server")
    x.add_argument("evaluation", help="dotted path to the retune Evaluation")
    x.add_argument("--engine-dir", default=".")
    x.add_argument("--variant")
    x.add_argument("--registry-dir", help="registry the loop stages through (default: $PIO_REGISTRY_DIR)")
    lifecycle_dir_args(x)
    x.add_argument("--cadence", type=float, default=0.0,
                   help="scheduled retune every N seconds (0 = drift/manual only)")
    x.add_argument("--drift-window", type=float, default=600.0,
                   help="trailing seconds of drift records that count as a live signal")
    x.add_argument("--min-drift-records", type=int, default=1,
                   help="drift records inside the window needed to trigger")
    x.add_argument("--cooldown", type=float, default=600.0,
                   help="seconds after an episode before drift or cadence can retrigger")
    x.add_argument("--tune-timeout", type=float, default=7200.0, help="abandon a grid run older than this")
    x.add_argument("--bake-timeout", type=float, default=3600.0,
                   help="unstage a candidate no server resolves within this")
    x.add_argument("--tick-interval", type=float, default=2.0, help="control-loop cadence")
    x.add_argument("--workers", type=int, default=2,
                   help="grid worker processes (cpu-fallback class: no card, at most 4)")
    x.add_argument("--nice", type=int, default=10, help="re-nice grid workers")
    x.add_argument("--folds", type=int, default=None)
    x.add_argument("--workdir", default=None,
                   help="grid workdir root, one run-NNNN per episode (default <state-dir>/grid)")
    x.add_argument("--stage-mode", choices=["canary", "shadow"], default="canary")
    x.add_argument("--stage-fraction", type=float, default=0.1)
    x.add_argument("--serve-url", default=None,
                   help="server base URL; a promoted model's cache warms by replaying queries here")
    x.add_argument("--app-name", default=None, help="app whose event store supplies warm-up queries")
    x.add_argument("--warm-limit", type=int, default=256,
                   help="max queries replayed per post-promote warm (0 disables)")
    x.set_defaults(fn=cmd_lifecycle_run)
    x = lc.add_parser("status", help="episode state from the controller's durable file")
    lifecycle_dir_args(x)
    x.add_argument("--json", action="store_true")
    x.set_defaults(fn=cmd_lifecycle_status)
    x = lc.add_parser("trigger", help="queue one manual retune")
    lifecycle_dir_args(x)
    x.set_defaults(fn=cmd_lifecycle_trigger)
    x = lc.add_parser("pause", help="stop automatic triggers")
    lifecycle_dir_args(x)
    x.set_defaults(fn=cmd_lifecycle_pause)
    x = lc.add_parser("resume", help="re-enable automatic triggers")
    lifecycle_dir_args(x)
    x.set_defaults(fn=cmd_lifecycle_pause)

    _add_obs_verbs(sub)

    mdl = sub.add_parser("models", help="model registry: versions, canary/shadow rollout, "
                                        "promote/rollback").add_subparsers(dest="subcommand", required=True)

    def models_args(x):
        x.add_argument("--engine-dir", default=".")
        x.add_argument("--variant")
        x.add_argument("--engine-id", help="registry engine id (skips resolving it from --engine-dir)")
        x.add_argument("--registry-dir", help="registry base dir (default: $PIO_REGISTRY_DIR, "
                                              "else registry/ under the basedir)")

    x = mdl.add_parser("list")
    models_args(x)
    x.set_defaults(fn=cmd_models_list)
    x = mdl.add_parser("show")
    models_args(x)
    x.add_argument("version", nargs="?", help="default: the stable version")
    x.add_argument("--url", help="show a RUNNING server's /models instead")
    x.set_defaults(fn=cmd_models_show)
    x = mdl.add_parser("promote")
    models_args(x)
    x.add_argument("version", nargs="?", help="default: the staged candidate")
    x.add_argument("--url", help="promote on a RUNNING server (lanes swap live)")
    x.set_defaults(fn=cmd_models_promote)
    x = mdl.add_parser("rollback")
    models_args(x)
    x.add_argument("--url", help="roll back on a RUNNING server")
    x.set_defaults(fn=cmd_models_rollback)
    x = mdl.add_parser("stage")
    models_args(x)
    x.add_argument("version")
    x.add_argument("--url", required=True, help="running server base URL")
    x.add_argument("--mode", choices=["canary", "shadow"], default="canary")
    x.add_argument("--fraction", type=float, default=0.1)
    x.set_defaults(fn=cmd_models_stage)
    x = mdl.add_parser("diff")
    models_args(x)
    x.add_argument("version_a")
    x.add_argument("version_b")
    x.set_defaults(fn=cmd_models_diff)

    x = sub.add_parser("undeploy")
    x.add_argument("--ip", default="127.0.0.1")
    x.add_argument("--port", type=int, default=8000)
    x.add_argument("--ssl", action="store_true", help="server was deployed with TLS")
    x.set_defaults(fn=cmd_undeploy)

    x = sub.add_parser("batchpredict", help="offline mega-batch prediction")
    engine_args(x)
    x.add_argument("--input", default=None, help="multi-line JSON query file (default "
                   "batchpredict-input.json; exclusive with --from-events)")
    x.add_argument("--output", default="batchpredict-output.json",
                   help="line-aligned JSONL predictions, written atomically; '' disables")
    x.add_argument("--from-events", action="store_true",
                   help="stream distinct users off the app's event store")
    x.add_argument("--app-name", default="",
                   help="app of --from-events/--to-events (default: the variant's appName)")
    x.add_argument("--channel", default="")
    x.add_argument("--query-num", type=int, default=10,
                   help="top-k per --from-events query (default 10)")
    x.add_argument("--batch", type=int, default=512, help="mega-batch size (default 512)")
    x.add_argument("--to-events", action="store_true",
                   help="also write the results into the event store (batchpredict.result)")
    x.add_argument("--limit", type=int, default=0, help="cap the queries (0 = all)")
    x.add_argument("--status-file", default=None, help="throttled atomic progress snapshots")
    x.set_defaults(fn=cmd_batchpredict)

    x = sub.add_parser("eval", help="parallel, resumable fold×params evaluation grid")
    x.add_argument("evaluation", help="dotted path to an Evaluation")
    x.add_argument("engine_params_generator", nargs="?")
    x.add_argument("--batch", default="")
    x.add_argument("--workers", type=int, default=0,
                   help="cell worker processes (0 = in-process; workers rebuild the "
                        "evaluation from its dotted path)")
    x.add_argument("--folds", type=int, default=None,
                   help="fold count (default: what the data source's read_eval yields)")
    x.add_argument("--workdir", default=None,
                   help="grid directory holding the trial ledger (default: a fresh temp dir)")
    x.add_argument("--resume", action="store_true",
                   help="resume from --workdir's ledger: finished cells are never retrained")
    x.add_argument("--batch-size", type=int, default=512,
                   help="held-out scoring mega-batch (default 512)")
    x.add_argument("--engine-dir", default=None,
                   help="engine project directory: the registry identity the winner publishes under")
    x.add_argument("--variant", help="engine.json variant (with --engine-dir)")
    x.add_argument("--registry-dir", help="registry receiving the winning refit as a candidate "
                                          "(default: $PIO_REGISTRY_DIR)")
    x.add_argument("--publish", action="store_true",
                   help="force winner publication (default: publish when --engine-dir and a "
                        "registry dir are both given)")
    x.add_argument("--no-publish", action="store_true", help="never publish the winner")
    x.add_argument("--stage-mode", choices=["canary", "shadow"], default="canary",
                   help="rollout mode the winner is staged under")
    x.add_argument("--stage-fraction", type=float, default=0.1,
                   help="canary fraction of the staged winner")
    x.add_argument("--status-file", default=None, help="throttled atomic progress snapshots")
    x.add_argument("--nice", type=int, default=0, help="re-nice grid workers by this amount")
    x.add_argument("--worker-class", choices=["", "cpu-fallback"], default="",
                   help="cpu-fallback: workers see no card and run on the CPU, at most 4")
    x.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    x.add_argument("--out", default=None, help="write the grid report JSON here")
    x.set_defaults(fn=cmd_eval)

    tpl = sub.add_parser("template").add_subparsers(dest="subcommand", required=True)
    tpl.add_parser("list").set_defaults(fn=cmd_template_list)
    x = tpl.add_parser("get")
    x.add_argument("name")
    x.add_argument("directory", nargs="?")
    x.set_defaults(fn=cmd_template_get)

    x = sub.add_parser(
        "lint",
        help="static analysis: staging safety, recompile hazards, host-sync "
        "stalls, concurrency, storage contracts",
    )
    add_lint_arguments(x)
    x.set_defaults(fn=cmd_lint)

    x = sub.add_parser("run")
    x.add_argument("main")
    x.add_argument("args", nargs="*")
    x.set_defaults(fn=cmd_run)
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.cli_argv = argv  # what `deploy --fleet` derives its workers' command lines from
    logging.basicConfig(
        level=logging.WARNING, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    global _STORAGE
    _STORAGE = None
    try:
        if args.home is not None:
            _STORAGE = Storage(env={**os.environ, "PIO_FS_BASEDIR": os.path.abspath(args.home)})
        return args.fn(args)
    except (StorageError, ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
