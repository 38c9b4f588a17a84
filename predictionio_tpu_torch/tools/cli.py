"""Command line of the port: ``python -m predictionio_tpu_torch.tools.cli``.

Verbs of the recommendation main path::

    app new NAME
    import --appname NAME --input FILE.jsonl
    train  --engine-dir DIR [--variant FILE] [--device cuda|cpu]
    deploy --engine-dir DIR [--variant FILE] [--ip IP] [--port N] [--device cuda|cpu]

Data, engine instances and models live under ``--home`` (default
``$PIO_TORCH_HOME``, else ``~/.pio_torch``). ``--device`` defaults to
``cuda``; without a card, train and deploy fail unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from predictionio_tpu_torch.data.store import LocalStore, StoreError


def _store(args) -> LocalStore:
    return LocalStore(args.home)


def cmd_app_new(args) -> int:
    app_id = _store(args).create_app(args.name)
    print(f"App {args.name} created with id {app_id}")
    return 0


def cmd_import(args) -> int:
    n = _store(args).import_file(args.app_name, args.input)
    print(f"Imported {n} events into app {args.app_name}")
    return 0


def cmd_train(args) -> int:
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import load_engine

    manifest, engine = load_engine(args.engine_dir, args.variant)
    engine_params = engine.engine_params_from_variant(manifest.variant_json)
    ctx = WorkflowContext(mode="training", device=args.device, store=_store(args))
    instance_id = run_train(engine, manifest, engine_params, ctx)
    print(f"Training completed. Engine instance {instance_id} on {ctx.device}")
    return 0


def cmd_deploy(args) -> int:
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server

    ctx = WorkflowContext(mode="serving", device=args.device, store=_store(args))
    server = create_query_server(
        args.engine_dir, ctx, ServerConfig(ip=args.ip, port=args.port), args.variant
    )
    port = server.start()
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    print(
        f"Engine instance {server.instance_id} deployed at http://{args.ip}:{port} "
        f"on {ctx.device}",
        flush=True,
    )
    stop.wait()
    server.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pio-torch", description=__doc__.split("\n")[0])
    p.add_argument("--home", default=None, help="store root (default $PIO_TORCH_HOME or ~/.pio_torch)")
    sub = p.add_subparsers(dest="command", required=True)

    app = sub.add_parser("app").add_subparsers(dest="subcommand", required=True)
    x = app.add_parser("new")
    x.add_argument("name")
    x.set_defaults(fn=cmd_app_new)

    x = sub.add_parser("import")
    x.add_argument("--appname", dest="app_name", required=True)
    x.add_argument("--input", required=True)
    x.set_defaults(fn=cmd_import)

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
    try:
        return args.fn(args)
    except (StoreError, ValueError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
