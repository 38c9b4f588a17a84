"""Command line of the port: ``python -m predictionio_tpu_torch.tools.cli``.

Verbs, modelled on ``predictionio_tpu/tools/cli.py``::

    app new NAME [--id N] [--description D] [--access-key KEY]
    app list | show NAME | delete NAME -f | data-delete NAME [--channel C] -f
    app channel-new APP CHANNEL | channel-delete APP CHANNEL -f
    accesskey new APP [--key KEY] [--event NAME ...] | list [APP] | delete KEY
    eventserver [--ip IP] [--port N] [--stats] [--ssl-certfile F --ssl-keyfile F]
    import --appname NAME --input FILE [--channel C]
    export --appname NAME --output FILE [--channel C] [--format json|parquet|npz]
    train  --engine-dir DIR [--variant FILE] [--device cuda|cpu]
    deploy --engine-dir DIR [--variant FILE] [--ip IP] [--port N] [--device cuda|cpu]

Apps, access keys, channels, events, engine instances and models live in
the storage the ``PIO_STORAGE_*`` environment names, as in the JAX package;
without it, one sqlite file ``pio.db`` under the basedir (``--home``, else
``$PIO_FS_BASEDIR``, else ``$PIO_TORCH_HOME``, else ``~/.pio_torch``).
``--device`` defaults to ``cuda``; without a card, train and deploy fail
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError


# the locator of this invocation: ``--home`` builds one on that basedir,
# else the process-wide ``Storage.instance()``
_STORAGE: Storage | None = None


def _storage() -> Storage:
    return _STORAGE or Storage.instance()


def _die(msg: str, code: int = 1) -> int:
    print(f"[ERROR] {msg}", file=sys.stderr)
    return code


def _wait_for_signal() -> None:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()


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


def cmd_train(args) -> int:
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    manifest, engine = load_engine(args.engine_dir, args.variant)
    engine_params = engine.engine_params_from_variant(manifest.variant_json)
    ctx = WorkflowContext(mode="training", device=args.device, _storage=_storage())
    instance_id = run_train(engine, manifest, engine_params, ctx)
    print(f"Training completed. Engine instance {instance_id} on {ctx.device}")
    return 0


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server

    ctx = WorkflowContext(mode="serving", device=args.device, _storage=_storage())
    server = create_query_server(
        args.engine_dir, ctx, ServerConfig(ip=args.ip, port=args.port), args.variant
    )
    port = server.start()
    print(
        f"Engine instance {server.instance_id} deployed at http://{args.ip}:{port} "
        f"on {ctx.device}",
        flush=True,
    )
    _wait_for_signal()
    server.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pio-torch", description=__doc__.split("\n")[0])
    p.add_argument(
        "--home",
        default=None,
        help="storage basedir, the same as $PIO_FS_BASEDIR "
        "(default $PIO_FS_BASEDIR, else $PIO_TORCH_HOME, else ~/.pio_torch)",
    )
    sub = p.add_subparsers(dest="command", required=True)

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

    x = sub.add_parser("train")
    engine_args(x)
    x.set_defaults(fn=cmd_train)

    x = sub.add_parser("deploy")
    engine_args(x)
    x.add_argument("--ip", default="0.0.0.0")
    x.add_argument("--port", type=int, default=8000)
    x.set_defaults(fn=cmd_deploy)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
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
