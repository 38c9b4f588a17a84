"""The query server: ``GET /`` and ``POST /queries.json`` over the standard
library's ``ThreadingHTTPServer``, with a micro-batcher.

Port of the serving core of ``predictionio_tpu/workflow/create_server.py``
(``_MicroBatcher`` and ``_dispatch_query_batch``) without rollout lanes,
result cache, resilience and observability, which later slices add. Each
handler thread submits its query to the batcher and waits. One dispatch
thread takes everything queued (up to ``max_batch``), decodes and
supplements it, and calls every algorithm's ``predict_batch_dispatch``,
which launches the device work without waiting; the returned finalize runs
on a fetch thread, so batch n+1 dispatches while batch n is fetched.
Batching is adaptive: a solo request dispatches at once, and arrivals
during a busy dispatch form the next batch.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from predictionio_tpu_torch.controller.engine import Engine, EngineParams
from predictionio_tpu_torch.workflow import model_io
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.workflow.engine_loader import load_engine

logger = logging.getLogger(__name__)


MAX_INFLIGHT = 4  # batches dispatched but not yet fetched
REQUEST_TIMEOUT_S = 10.0  # a query not answered by then gets 503
MAX_PAYLOAD_BYTES = 1 << 20


@dataclasses.dataclass
class ServerConfig:
    ip: str = "0.0.0.0"
    port: int = 8000
    max_batch: int = 64


class BadQuery(ValueError):
    """The payload did not decode into the engine's query (HTTP 400)."""


class _MicroBatcher:
    def __init__(self, server: "QueryServer", max_batch: int, max_inflight: int):
        self._server = server
        self.max_batch = max(1, max_batch)
        self._queue: queue.Queue = queue.Queue()
        self._inflight = threading.Semaphore(max(1, max_inflight))
        self._fetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, max_inflight), thread_name_prefix="pio-fetch"
        )
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="pio-dispatch", daemon=True)
        self._thread.start()
        self.batches_dispatched = 0
        self.queries_dispatched = 0
        self.largest_batch = 0

    def submit(self, payload: Any) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._closed:
            fut.set_exception(RuntimeError("server is shutting down"))
            return fut
        self._queue.put((payload, fut))
        return fut

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            stop = False
            while len(batch) < self.max_batch:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._inflight.acquire()
            try:
                finalize = self._server.dispatch_batch([p for p, _ in batch])
            except Exception as exc:  # the whole batch failed to dispatch
                logger.exception("micro-batch dispatch failed")
                self._inflight.release()
                for _, fut in batch:
                    fut.set_exception(exc)
            else:
                self.batches_dispatched += 1
                self.queries_dispatched += len(batch)
                self.largest_batch = max(self.largest_batch, len(batch))
                fetch = self._fetch_pool.submit(finalize)
                fetch.add_done_callback(lambda f, batch=batch: self._finish(batch, f))
            if stop:
                return

    def _finish(self, batch, fetch: concurrent.futures.Future) -> None:
        self._inflight.release()
        try:
            outs = fetch.result()
        except Exception as exc:
            logger.exception("micro-batch finalize failed")
            outs = [exc] * len(batch)
        for (_, fut), out in zip(batch, outs):
            if isinstance(out, BaseException):
                fut.set_exception(out)
            else:
                fut.set_result(out)

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=10)
        self._fetch_pool.shutdown(wait=True)
        while True:  # anything queued behind the stop marker
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].set_exception(RuntimeError("server is shutting down"))


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 256  # a burst of new connections must not overflow the backlog


class QueryServer:
    def __init__(
        self,
        engine: Engine,
        engine_params: EngineParams,
        models: list[Any],
        ctx: WorkflowContext,
        config: ServerConfig | None = None,
        instance_id: str = "",
    ):
        self.engine = engine
        self.config = config or ServerConfig()
        self.ctx = ctx
        self.instance_id = instance_id
        _, _, self.algorithms, self.serving = engine.make_components(engine_params)
        self.models = models
        for algo, model in zip(self.algorithms, self.models):
            algo.warmup_serving(model, self.config.max_batch)
        self.batcher = _MicroBatcher(self, self.config.max_batch, MAX_INFLIGHT)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- the serving pipeline ------------------------------------------------
    def dispatch_batch(self, payloads: list[Any]):
        """Decode and supplement each payload, launch every algorithm's
        device work, and return the finalize that fetches, serves and
        encodes one result (or exception) per payload."""
        n = len(payloads)
        outs: list[Any] = [None] * n
        queries: list[Any] = [None] * n
        ok: list[int] = []
        for i, payload in enumerate(payloads):
            try:
                queries[i] = self.serving.supplement(self.engine.decode_query(payload))
                ok.append(i)
            except (AttributeError, KeyError, TypeError, ValueError) as exc:
                # a payload of the wrong JSON type (a list, null) fails alone
                outs[i] = BadQuery(f"bad query: {exc!r}")
        sup = [queries[i] for i in ok]
        fins = [
            algo.predict_batch_dispatch(model, sup) if sup else None
            for algo, model in zip(self.algorithms, self.models)
        ]

        def finalize() -> list[Any]:
            if not sup:
                return outs
            preds_per_algo = [
                fin() if fin is not None else algo.predict_batch(model, sup)
                for algo, model, fin in zip(self.algorithms, self.models, fins)
            ]
            for row, i in enumerate(ok):
                try:
                    outs[i] = self.engine.encode_result(
                        self.serving.serve(queries[i], [p[row] for p in preds_per_algo])
                    )
                except Exception as exc:  # isolate one query's failure
                    logger.exception("serving a query failed")
                    outs[i] = exc
            return outs

        return finalize

    def status(self) -> dict[str, Any]:
        return {
            "status": "alive",
            "engineInstanceId": self.instance_id,
            "device": str(self.ctx.device),
            "batches": self.batcher.batches_dispatched,
            "queries": self.batcher.queries_dispatched,
            "largestBatch": self.batcher.largest_batch,
        }

    # -- HTTP ------------------------------------------------------------------
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet: one line per request is noise
                logger.debug("%s " + fmt, self.address_string(), *args)

            def _reply(self, code: int, body: Any) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path.split("?")[0] == "/":
                    self._reply(200, server.status())
                else:
                    self._reply(404, {"message": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                if length > MAX_PAYLOAD_BYTES:
                    self.close_connection = True
                    self._reply(413, {"message": "payload too large"})
                    return
                body = self.rfile.read(length)
                if self.path.split("?")[0] != "/queries.json":
                    self._reply(404, {"message": "not found"})
                    return
                try:
                    payload = json.loads(body or b"null")
                except ValueError as exc:
                    self._reply(400, {"message": f"invalid JSON: {exc}"})
                    return
                fut = server.batcher.submit(payload)
                try:
                    out = fut.result(timeout=REQUEST_TIMEOUT_S)
                except concurrent.futures.TimeoutError:
                    self._reply(503, {"message": "query deadline exceeded"})
                except BadQuery as exc:
                    self._reply(400, {"message": str(exc)})
                except Exception as exc:
                    self._reply(500, {"message": f"{type(exc).__name__}: {exc}"})
                else:
                    self._reply(200, out)

        return Handler

    def start(self) -> int:
        """Bind and serve on a background thread; returns the bound port."""
        self._httpd = _HTTPServer((self.config.ip, self.config.port), self._handler())
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pio-http", daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None
        self.batcher.close()


def create_query_server(
    engine_dir: str,
    ctx: WorkflowContext,
    config: ServerConfig | None = None,
    variant_path: str | None = None,
) -> QueryServer:
    """Load the engine, its latest completed instance and that instance's
    model blob, lay the models out on ``ctx.device`` and build the server."""
    manifest, engine = load_engine(engine_dir, variant_path)
    store = ctx.store
    record = store.latest_completed(manifest.engine_id)
    if record is None:
        raise RuntimeError(
            f"no completed training of engine {manifest.engine_id!r}; run train first"
        )
    engine_params = engine.engine_params_from_variant(record["variant"])
    persisted = model_io.deserialize_models(store.get_model(record["id"]))
    models = engine.prepare_deploy(ctx, engine_params, persisted)
    return QueryServer(engine, engine_params, models, ctx, config, record["id"])
