"""Elasticsearch storage driver (REST, no client library).

Reference parity: ``storage/elasticsearch/`` (5.x low-level REST driver) —
meta DAOs + events L+P + an ``ESSequences`` id generator
(``storage/elasticsearch/src/main/scala/.../ESApps.scala`` etc.; query DSL
construction in ``ESUtils.scala``). The reference's Spark-side
``ESPEvents`` reads via the elasticsearch-hadoop input format; here the
bulk path is the same filtered ``_search`` scan feeding the shared
``to_columnar`` dictionary-encoder (the training feed).

Transport is stdlib ``urllib`` against one or more ``http(s)://host:port``
endpoints; no Elasticsearch client package is required. Config keys
(``PIO_STORAGE_SOURCES_<NAME>_*``): ``HOSTS`` (comma-sep), ``PORTS``
(comma-sep, default 9200), ``SCHEMES`` (default http), or a single ``URL``;
``INDEX_PREFIX`` (default ``pio``); ``USERNAME``/``PASSWORD`` for basic
auth. Writes use ``?refresh=true`` so reads are immediately consistent —
the reference does the same (``ESUtils.scala`` index requests with
RefreshPolicy).

The port's own copy of ``predictionio_tpu/data/storage/elasticsearch.py``:
the same requests, index layout and documents, so an index written by
either package reads the same in the other.
"""

from __future__ import annotations

import base64
import datetime as _dt
import dataclasses
import json
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import Any, Iterable, Iterator, Sequence

from predictionio_tpu_torch.data.event import Event, format_event_time, parse_event_time
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
)

UTC = _dt.timezone.utc


class ESError(RuntimeError):
    """Transport/application error from the ES driver.

    Bulk-insert partial failures attach ``indexed_ids`` (documents that DID
    land) and ``attempted_ids`` (the full batch's ids, in order) — see
    ``ESLEvents.insert_batch`` for the retry contract. ``transient`` is
    True when EVERY endpoint failed at the connection level (the cluster
    may come back; outer retry policies may replay).
    """

    transient = False
    indexed_ids: list[str] = []
    attempted_ids: list[str] = []


def _all_endpoints_failed(last: Exception | None) -> ESError:
    from predictionio_tpu_torch.resilience import mark_transient

    return mark_transient(ESError(f"all elasticsearch endpoints failed: {last}"))


class _ESTransport:
    """Minimal JSON-over-HTTP transport with host rotation.

    ``retries`` > 1 adds full-rotation passes with exponential backoff: one
    pass tries every endpoint once (the original failover), later passes
    give a briefly-unreachable cluster time to come back before the driver
    reports it down."""

    def __init__(
        self,
        urls: list[str],
        auth: str | None = None,
        timeout: float = 10.0,
        retries: int = 1,
        retry_backoff_s: float = 0.2,
    ):
        if not urls:
            raise ESError("elasticsearch driver needs at least one endpoint")
        self.urls = urls
        self.auth = auth
        self.timeout = timeout
        from predictionio_tpu_torch.resilience import RetryPolicy

        self._retry = RetryPolicy(
            max_attempts=max(1, retries), backoff_base_s=retry_backoff_s
        )

    def request(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        params: dict[str, str] | None = None,
        ok_statuses: tuple[int, ...] = (),
    ) -> dict[str, Any]:
        return self._retry.call(
            self._request_pass, method, path, body, params, ok_statuses
        )

    def _request_pass(
        self,
        method: str,
        path: str,
        body: dict | None = None,
        params: dict[str, str] | None = None,
        ok_statuses: tuple[int, ...] = (),
    ) -> dict[str, Any]:
        q = f"?{urllib.parse.urlencode(params)}" if params else ""
        data = json.dumps(body).encode() if body is not None else None
        last: Exception | None = None
        for url in self.urls:
            req = urllib.request.Request(
                url.rstrip("/") + path + q, data=data, method=method
            )
            req.add_header("Content-Type", "application/json")
            if self.auth:
                req.add_header("Authorization", f"Basic {self.auth}")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    payload = resp.read()
                    return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as exc:
                if exc.code in ok_statuses:
                    try:
                        return json.loads(exc.read() or b"{}")
                    except Exception:
                        return {}
                # HTTP error from a live node is an application error, not a
                # transport failure: report it as such (and don't retry other
                # endpoints — they'd return the same thing)
                raise ESError(
                    f"{method} {path}: HTTP {exc.code}: {exc.read()[:200]!r}"
                ) from exc
            except (urllib.error.URLError, OSError) as exc:
                if not _retry_safe(method, path, exc):
                    # the request may have been APPLIED before the connection
                    # died; replaying a non-idempotent op on another endpoint
                    # double-executes it (_update double-increments a
                    # sequence; a replayed _create 409s and orphans its
                    # sentinel). Surface the ambiguity instead — and tell
                    # outer retry policies not to replay either.
                    raise ESError(
                        f"{method} {path}: connection failed after send and "
                        f"the operation is not idempotent — not retried on "
                        f"another endpoint: {exc}"
                    ) from exc
                last = exc  # node down: try the next endpoint
        raise _all_endpoints_failed(last) from last

    def bulk(self, lines: list[dict], params: dict[str, str] | None = None) -> dict:
        """POST newline-delimited JSON to ``/_bulk``."""
        return self._retry.call(self._bulk_pass, lines, params)

    def _bulk_pass(
        self, lines: list[dict], params: dict[str, str] | None = None
    ) -> dict:
        q = f"?{urllib.parse.urlencode(params)}" if params else ""
        data = ("\n".join(json.dumps(line) for line in lines) + "\n").encode()
        last: Exception | None = None
        for url in self.urls:
            req = urllib.request.Request(
                url.rstrip("/") + "/_bulk" + q, data=data, method="POST"
            )
            req.add_header("Content-Type", "application/x-ndjson")
            if self.auth:
                req.add_header("Authorization", f"Basic {self.auth}")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as exc:
                raise ESError(
                    f"_bulk: HTTP {exc.code}: {exc.read()[:200]!r}"
                ) from exc
            except (urllib.error.URLError, OSError) as exc:
                # bulk bodies here carry only explicit-_id index/delete
                # actions (idempotent overwrite/delete), so cross-endpoint
                # replay after an ambiguous failure is safe
                last = exc
        raise _all_endpoints_failed(last) from last


def _retry_safe(method: str, path: str, exc: Exception) -> bool:
    """May this failed request be replayed on another endpoint?

    Everything except the two genuinely non-idempotent operations:
    ``_update`` scripts (a replay re-applies the script — a sequence
    counter would double-increment) and ``_create`` (a replay 409s and
    the caller misreads "already taken"). POST reads (_search, _count,
    scroll) and addressed-document PUT/DELETE writes are idempotent and
    keep the multi-endpoint failover a dead node depends on. A refused
    connection never reached the server and is always safe.
    """
    reason = getattr(exc, "reason", exc)
    if isinstance(reason, ConnectionRefusedError):
        return True
    return "/_update/" not in path and "/_create/" not in path


def _iso(ts: _dt.datetime | None) -> str | None:
    return ts.isoformat() if ts is not None else None


def _parse_iso(s: str | None) -> _dt.datetime | None:
    return _dt.datetime.fromisoformat(s) if s else None


# Dynamic mapping would analyze strings as text, so term queries on values
# like "$set" or "MyApp1" would match nothing on a real server (the mock does
# exact equality and can't catch this). Every index is created with string
# fields mapped to keyword and *Time fields to date. The explicit
# ``properties`` exist because dynamic templates only materialize mappings
# as documents arrive: a sorted query against an EMPTY index 400s on a real
# server ("No mapping found for [eventTime] in order to sort on") unless the
# sorted fields are mapped at creation — which broke every fresh-app read,
# version stamp, and first-deploy instance lookup.
_INDEX_MAPPINGS = {
    "mappings": {
        "dynamic_templates": [
            {
                "times_as_dates": {
                    "match": "*Time",
                    "mapping": {"type": "date"},
                }
            },
            {
                "strings_as_keywords": {
                    "match_mapping_type": "string",
                    "mapping": {"type": "keyword"},
                }
            },
        ],
        # every field any DAO sorts on, shared across index types (an
        # unused mapping is harmless; an unmapped sort field is a 400)
        "properties": {
            "eventTime": {"type": "date"},
            "creationTime": {"type": "date"},
            "eventId": {"type": "keyword"},
            "startTime": {"type": "date"},
            "endTime": {"type": "date"},
        },
    }
}


def _ensure_index(transport: _ESTransport, index: str) -> None:
    out = transport.request(
        "PUT", f"/{index}", body=_INDEX_MAPPINGS, ok_statuses=(400,)
    )
    err = out.get("error")
    if err is None:
        return
    # only "already exists" may be swallowed: any other 400 (invalid index
    # name, rejected mapping body) would otherwise let the first write
    # auto-create the index with analyzed-text dynamic mappings, where every
    # term query silently matches nothing. Real ES wraps the type in a dict;
    # the protocol mock reports it as a bare string.
    etype = err.get("type") if isinstance(err, dict) else err
    if "resource_already_exists" not in str(etype):
        raise ESError(f"index create {index} failed: {err}")


# ---------------------------------------------------------------------------
# Sequences (ref ESSequences.scala — atomic id generator)
# ---------------------------------------------------------------------------


class ESSequences:
    def __init__(self, transport: _ESTransport, index: str):
        self._t = transport
        self._index = index

    def gen_next(self, name: str) -> int:
        out = self._t.request(
            "POST",
            f"/{self._index}/_update/{urllib.parse.quote(name)}",
            body={
                "script": {"source": "ctx._source.n += 1", "lang": "painless"},
                "upsert": {"n": 1},
            },
            params={"refresh": "true", "_source": "true"},
        )
        try:
            return int(out["get"]["_source"]["n"])
        except KeyError as exc:  # pragma: no cover - malformed server reply
            raise ESError(f"sequence response missing counter: {out}") from exc


# ---------------------------------------------------------------------------
# Generic doc-store helpers for the metadata DAOs
# ---------------------------------------------------------------------------


class _ESDocs:
    def __init__(self, transport: _ESTransport, index: str):
        self._t = transport
        self._index = index

    def put(self, doc_id: str, doc: dict) -> None:
        self._t.request(
            "PUT",
            f"/{self._index}/_doc/{urllib.parse.quote(str(doc_id))}",
            body=doc,
            params={"refresh": "true"},
        )

    def create(self, doc_id: str, doc: dict) -> bool:
        """Atomic create-if-absent (``_create`` endpoint); False on 409.
        The check-then-put alternative races under concurrent writers."""
        out = self._t.request(
            "PUT",
            f"/{self._index}/_create/{urllib.parse.quote(str(doc_id))}",
            body=doc,
            params={"refresh": "true"},
            ok_statuses=(409,),
        )
        return out.get("result") == "created"

    def get(self, doc_id: str) -> dict | None:
        out = self._t.request(
            "GET",
            f"/{self._index}/_doc/{urllib.parse.quote(str(doc_id))}",
            ok_statuses=(404,),
        )
        return out.get("_source") if out.get("found") else None

    def delete(self, doc_id: str) -> bool:
        out = self._t.request(
            "DELETE",
            f"/{self._index}/_doc/{urllib.parse.quote(str(doc_id))}",
            params={"refresh": "true"},
            ok_statuses=(404,),
        )
        return out.get("result") == "deleted"

    def search(
        self,
        query: dict,
        size: int = 10_000,
        sort: list | None = None,
        search_after: list | None = None,
    ) -> list[dict]:
        body: dict[str, Any] = {"query": query, "size": size}
        if sort:
            body["sort"] = sort
        if search_after is not None:
            body["search_after"] = search_after
        out = self._t.request(
            "POST", f"/{self._index}/_search", body=body, ok_statuses=(404,)
        )
        hits = out.get("hits", {}).get("hits", [])
        return [h["_source"] for h in hits]

    def scan(
        self, query: dict, sort: list[dict], page_size: int = 5_000
    ) -> Iterator[dict]:
        """Deep pagination via search_after (a plain size cap dies at ES's
        10k index.max_result_window). ``sort`` fields must exist in every
        document so the cursor tuple is well-defined."""
        fields = [next(iter(s)) for s in sort]
        cursor: list | None = None
        while True:
            page = self.search(query, size=page_size, sort=sort, search_after=cursor)
            yield from page
            if len(page) < page_size:
                return
            cursor = [page[-1][f] for f in fields]

    def scan_sliced(
        self,
        query: dict,
        slice_id: int,
        n_slices: int,
        page_size: int = 5_000,
    ) -> Iterator[dict]:
        """One slice of a sliced scroll (the official ES parallel-scan
        protocol: ``"slice": {"id": i, "max": n}`` on a scroll search).
        The n slices partition the index disjointly, so n concurrent
        scanners cover it exactly once — the ES answer to HBase
        region-split parallel scans (ref ``HBPEvents.scala:63-95``) and
        what elasticsearch-hadoop does per input split
        (ref ``ESPEvents.scala:44-100``)."""
        body: dict[str, Any] = {"query": query, "size": page_size}
        if n_slices > 1:
            body["slice"] = {"id": slice_id, "max": n_slices}
        out = self._t.request(
            "POST",
            f"/{self._index}/_search",
            body=body,
            params={"scroll": "5m"},
            ok_statuses=(404,),
        )
        scroll_id = out.get("_scroll_id")
        try:
            while True:
                hits = out.get("hits", {}).get("hits", [])
                if not hits:
                    return
                for h in hits:
                    yield h["_source"]
                if scroll_id is None:
                    return
                out = self._t.request(
                    "POST",
                    "/_search/scroll",
                    body={"scroll": "5m", "scroll_id": scroll_id},
                )
                scroll_id = out.get("_scroll_id", scroll_id)
        finally:
            if scroll_id is not None:
                # best-effort release of the server-side scroll context — a
                # cleanup flake must not turn an already-complete scan into
                # a failure (the context expires server-side regardless)
                try:
                    self._t.request(
                        "DELETE",
                        "/_search/scroll",
                        body={"scroll_id": [scroll_id]},
                        ok_statuses=(404,),
                    )
                except (ESError, OSError):
                    pass

    def delete_by_query(self, query: dict) -> None:
        self._t.request(
            "POST",
            f"/{self._index}/_delete_by_query",
            body={"query": query},
            params={"refresh": "true"},
            ok_statuses=(404,),
        )


# ---------------------------------------------------------------------------
# Metadata DAOs (ref ESApps/ESAccessKeys/ESChannels/ESEngineInstances/
# ESEvaluationInstances)
# ---------------------------------------------------------------------------


class ESApps(base.Apps):
    def __init__(self, docs: _ESDocs, names: _ESDocs, seq: ESSequences):
        self._docs = docs
        self._seq = seq
        # Name-uniqueness sentinels live in a sibling index keyed by name and
        # are created via the atomic ``_create`` endpoint, so two concurrent
        # inserts with the same name cannot both succeed (a check-then-put on
        # the search index races; cf. ESAccessKeys which is naturally keyed).
        # Index creation/memoization is the factory's job (``_meta_docs``).
        self._names = names

    def insert(self, app: App) -> int | None:
        # search-index guard first: protects names of apps created before the
        # sentinel index existed (they have no sentinel doc to collide with)
        if self.get_by_name(app.name) is not None:
            return None  # names are unique (ref Apps.scala)
        app_id = app.id or self._seq.gen_next("apps")
        if not self._names.create(app.name, {"app_id": app_id}):
            return None
        try:
            created = self._docs.create(
                str(app_id),
                {"id": app_id, "name": app.name, "description": app.description},
            )
        except ESError:
            self._names.delete(app.name)  # don't orphan the name sentinel
            raise
        if not created:
            self._names.delete(app.name)  # id collision: roll back sentinel
            return None
        return app_id

    def get(self, app_id: int) -> App | None:
        d = self._docs.get(str(app_id))
        return App(d["id"], d["name"], d.get("description")) if d else None

    def get_by_name(self, name: str) -> App | None:
        hits = self._docs.search({"term": {"name": name}}, size=1)
        if not hits:
            return None
        d = hits[0]
        return App(d["id"], d["name"], d.get("description"))

    def get_all(self) -> list[App]:
        return [
            App(d["id"], d["name"], d.get("description"))
            for d in self._docs.search({"match_all": {}})
        ]

    def update(self, app: App) -> None:
        old = self.get(app.id)
        renaming = old is not None and old.name != app.name
        if renaming:
            # claim the new name before touching the doc; refuse the rename
            # if another app holds it (otherwise two apps would share a name
            # and the later sentinel cleanup would corrupt uniqueness)
            other = self.get_by_name(app.name)
            if other is not None and other.id != app.id:
                raise ESError(f"app name already in use: {app.name!r}")
            if not self._names.create(app.name, {"app_id": app.id}):
                sent = self._names.get(app.name)
                if not (sent and sent.get("app_id") == app.id):
                    raise ESError(f"app name already in use: {app.name!r}")
                # else: our own claim from an interrupted rename — proceed
        try:
            self._docs.put(
                str(app.id),
                {"id": app.id, "name": app.name, "description": app.description},
            )
        except ESError:
            if renaming:
                self._names.delete(app.name)  # release the claimed name
            raise
        if renaming:
            self._names.delete(old.name)

    def delete(self, app_id: int) -> None:
        app = self.get(app_id)
        # sentinel first: if the doc delete then fails, the app is still
        # findable by name and insert()'s get_by_name guard keeps uniqueness;
        # the reverse order would orphan the sentinel and block the name
        if app is not None:
            self._names.delete(app.name)
        self._docs.delete(str(app_id))


class ESAccessKeys(base.AccessKeys):
    def __init__(self, docs: _ESDocs):
        self._docs = docs

    def insert(self, k: AccessKey) -> str | None:
        key = k.key or base.generate_access_key()
        created = self._docs.create(
            key, {"key": key, "appid": k.appid, "events": list(k.events)}
        )
        # atomic create: a concurrent writer can never rebind a credential
        return key if created else None

    def get(self, key: str) -> AccessKey | None:
        d = self._docs.get(key)
        return AccessKey(d["key"], d["appid"], tuple(d["events"])) if d else None

    def get_all(self) -> list[AccessKey]:
        return [
            AccessKey(d["key"], d["appid"], tuple(d["events"]))
            for d in self._docs.search({"match_all": {}})
        ]

    def get_by_app_id(self, app_id: int) -> list[AccessKey]:
        return [
            AccessKey(d["key"], d["appid"], tuple(d["events"]))
            for d in self._docs.search({"term": {"appid": app_id}})
        ]

    def update(self, k: AccessKey) -> None:
        self._docs.put(
            k.key, {"key": k.key, "appid": k.appid, "events": list(k.events)}
        )

    def delete(self, key: str) -> None:
        self._docs.delete(key)


class ESChannels(base.Channels):
    def __init__(self, docs: _ESDocs, seq: ESSequences):
        self._docs = docs
        self._seq = seq

    def insert(self, channel: Channel) -> int | None:
        if not Channel.is_valid_name(channel.name):
            return None
        channel_id = channel.id or self._seq.gen_next("channels")
        if self._docs.get(str(channel_id)) is not None:
            return None  # explicit id collision
        self._docs.put(
            str(channel_id),
            {"id": channel_id, "name": channel.name, "appid": channel.appid},
        )
        return channel_id

    def get(self, channel_id: int) -> Channel | None:
        d = self._docs.get(str(channel_id))
        return Channel(d["id"], d["name"], d["appid"]) if d else None

    def get_by_app_id(self, app_id: int) -> list[Channel]:
        return [
            Channel(d["id"], d["name"], d["appid"])
            for d in self._docs.search({"term": {"appid": app_id}})
        ]

    def delete(self, channel_id: int) -> None:
        self._docs.delete(str(channel_id))


def _instance_to_doc(i: EngineInstance) -> dict:
    return {
        "id": i.id,
        "status": i.status,
        "startTime": _iso(i.start_time),
        "endTime": _iso(i.end_time),
        "engineId": i.engine_id,
        "engineVersion": i.engine_version,
        "engineVariant": i.engine_variant,
        "engineFactory": i.engine_factory,
        "batch": i.batch,
        "env": i.env,
        "sparkConf": i.spark_conf,
        "dataSourceParams": i.data_source_params,
        "preparatorParams": i.preparator_params,
        "algorithmsParams": i.algorithms_params,
        "servingParams": i.serving_params,
    }


def _doc_to_instance(d: dict) -> EngineInstance:
    return EngineInstance(
        id=d["id"],
        status=d["status"],
        start_time=_parse_iso(d.get("startTime")),
        end_time=_parse_iso(d.get("endTime")),
        engine_id=d.get("engineId", ""),
        engine_version=d.get("engineVersion", ""),
        engine_variant=d.get("engineVariant", ""),
        engine_factory=d.get("engineFactory", ""),
        batch=d.get("batch", ""),
        env=d.get("env", {}),
        spark_conf=d.get("sparkConf", {}),
        data_source_params=d.get("dataSourceParams", ""),
        preparator_params=d.get("preparatorParams", ""),
        algorithms_params=d.get("algorithmsParams", ""),
        serving_params=d.get("servingParams", ""),
    )


class ESEngineInstances(base.EngineInstances):
    def __init__(self, docs: _ESDocs):
        self._docs = docs

    def insert(self, instance: EngineInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        instance.id = instance_id
        self._docs.put(instance_id, _instance_to_doc(instance))
        return instance_id

    def get(self, instance_id: str) -> EngineInstance | None:
        d = self._docs.get(instance_id)
        return _doc_to_instance(d) if d else None

    def get_all(self) -> list[EngineInstance]:
        return [_doc_to_instance(d) for d in self._docs.search({"match_all": {}})]

    def get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        hits = self._docs.search(
            {
                "bool": {
                    "filter": [
                        {"term": {"status": "COMPLETED"}},
                        {"term": {"engineId": engine_id}},
                        {"term": {"engineVersion": engine_version}},
                        {"term": {"engineVariant": engine_variant}},
                    ]
                }
            },
            sort=[{"startTime": {"order": "desc", "unmapped_type": "date"}}],
        )
        return [_doc_to_instance(d) for d in hits]

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> EngineInstance | None:
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, instance: EngineInstance) -> None:
        self._docs.put(instance.id, _instance_to_doc(instance))

    def delete(self, instance_id: str) -> None:
        self._docs.delete(instance_id)


def _eval_to_doc(i: EvaluationInstance) -> dict:
    return {
        "id": i.id,
        "status": i.status,
        "startTime": _iso(i.start_time),
        "endTime": _iso(i.end_time),
        "evaluationClass": i.evaluation_class,
        "engineParamsGeneratorClass": i.engine_params_generator_class,
        "batch": i.batch,
        "env": i.env,
        "sparkConf": i.spark_conf,
        "evaluatorResults": i.evaluator_results,
        "evaluatorResultsHTML": i.evaluator_results_html,
        "evaluatorResultsJSON": i.evaluator_results_json,
    }


def _doc_to_eval(d: dict) -> EvaluationInstance:
    return EvaluationInstance(
        id=d["id"],
        status=d["status"],
        start_time=_parse_iso(d.get("startTime")),
        end_time=_parse_iso(d.get("endTime")),
        evaluation_class=d.get("evaluationClass", ""),
        engine_params_generator_class=d.get("engineParamsGeneratorClass", ""),
        batch=d.get("batch", ""),
        env=d.get("env", {}),
        spark_conf=d.get("sparkConf", {}),
        evaluator_results=d.get("evaluatorResults", ""),
        evaluator_results_html=d.get("evaluatorResultsHTML", ""),
        evaluator_results_json=d.get("evaluatorResultsJSON", ""),
    )


class ESEvaluationInstances(base.EvaluationInstances):
    def __init__(self, docs: _ESDocs):
        self._docs = docs

    def insert(self, instance: EvaluationInstance) -> str:
        instance_id = instance.id or uuid.uuid4().hex
        instance.id = instance_id
        self._docs.put(instance_id, _eval_to_doc(instance))
        return instance_id

    def get(self, instance_id: str) -> EvaluationInstance | None:
        d = self._docs.get(instance_id)
        return _doc_to_eval(d) if d else None

    def get_all(self) -> list[EvaluationInstance]:
        return [_doc_to_eval(d) for d in self._docs.search({"match_all": {}})]

    def get_completed(self) -> list[EvaluationInstance]:
        hits = self._docs.search(
            {"term": {"status": "EVALCOMPLETED"}},
            sort=[{"startTime": {"order": "desc", "unmapped_type": "date"}}],
        )
        return [_doc_to_eval(d) for d in hits]

    def update(self, instance: EvaluationInstance) -> None:
        self._docs.put(instance.id, _eval_to_doc(instance))

    def delete(self, instance_id: str) -> None:
        self._docs.delete(instance_id)


class ESModels(base.Models):
    """Model blobs as base64 documents (the reference's JSON serializer for
    ``Model`` base64-encodes the blob the same way, ``Models.scala:60-80``;
    the reference ES driver itself delegates models elsewhere, but a
    same-source models repo keeps single-source deployments possible)."""

    def __init__(self, docs: _ESDocs):
        self._docs = docs

    def insert(self, model: base.Model) -> None:
        self._docs.put(
            model.id,
            {"id": model.id, "models": base64.b64encode(model.models).decode()},
        )

    def get(self, model_id: str) -> base.Model | None:
        d = self._docs.get(model_id)
        if d is None:
            return None
        return base.Model(d["id"], base64.b64decode(d["models"]))

    def delete(self, model_id: str) -> None:
        self._docs.delete(model_id)


# ---------------------------------------------------------------------------
# Events (ref ESLEvents / ESPEvents; query DSL per ESUtils.createEventQuery)
# ---------------------------------------------------------------------------


class ESLEvents(base.LEvents):
    def __init__(self, transport: _ESTransport, prefix: str):
        self._t = transport
        self._prefix = prefix
        self._ensured: set[str] = set()

    def _index(self, app_id: int, channel_id: int | None) -> str:
        suffix = f"_{channel_id}" if channel_id is not None else ""
        return f"{self._prefix}_event_{app_id}{suffix}"

    def _docs(self, app_id: int, channel_id: int | None) -> _ESDocs:
        index = self._index(app_id, channel_id)
        if index not in self._ensured:
            _ensure_index(self._t, index)  # keyword/date mappings, not dynamic
            self._ensured.add(index)
        return _ESDocs(self._t, index)

    def init(self, app_id: int, channel_id: int | None = None) -> bool:
        _ensure_index(self._t, self._index(app_id, channel_id))
        return True

    def remove(self, app_id: int, channel_id: int | None = None) -> bool:
        index = self._index(app_id, channel_id)
        self._t.request("DELETE", f"/{index}", ok_statuses=(404,))
        self._ensured.discard(index)
        return True

    def close(self) -> None:
        pass

    def insert(self, event: Event, app_id: int, channel_id: int | None = None) -> str:
        event_id = event.event_id or uuid.uuid4().hex
        doc = event.to_json_dict(with_creation_time=True)
        doc["eventId"] = event_id
        self._docs(app_id, channel_id).put(event_id, doc)
        return event_id

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: int | None = None
    ) -> list[str]:
        """One ``_bulk`` request + one refresh for the whole batch (a
        per-event loop would pay an HTTP round trip and an index refresh
        per document).

        Partial-failure contract: ``_bulk`` is non-atomic, so on rejection
        the raised :class:`ESError` carries ``indexed_ids`` (the documents
        that DID land, in batch order). All documents are written with
        explicit ``_id``s, so retrying with the same event ids (pass events
        whose ``event_id`` is already set, e.g. from the error's
        ``attempted_ids``) is an idempotent overwrite, never a duplicate.
        """
        if not events:
            return []
        index = self._docs(app_id, channel_id)._index  # ensures mappings
        lines: list[dict] = []
        ids: list[str] = []
        for event in events:
            event_id = event.event_id or uuid.uuid4().hex
            doc = event.to_json_dict(with_creation_time=True)
            doc["eventId"] = event_id
            lines.append({"index": {"_index": index, "_id": event_id}})
            lines.append(doc)
            ids.append(event_id)
        out = self._t.bulk(lines, params={"refresh": "true"})
        if out.get("errors"):
            items = out.get("items", [])
            failed = [
                item["index"] for item in items if item.get("index", {}).get("error")
            ]
            indexed = [
                item["index"]["_id"]
                for item in items
                if not item.get("index", {}).get("error")
                and item.get("index", {}).get("_id")
            ]
            exc = ESError(
                f"_bulk rejected {len(failed)} of {len(ids)} event(s) "
                f"({len(indexed)} were indexed; retry with the same ids to "
                f"overwrite, not duplicate): {failed[:3]}"
            )
            exc.indexed_ids = indexed
            exc.attempted_ids = ids
            raise exc
        return ids

    def get(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> Event | None:
        d = self._docs(app_id, channel_id).get(event_id)
        return _doc_to_event(d) if d else None

    def delete(
        self, event_id: str, app_id: int, channel_id: int | None = None
    ) -> bool:
        return self._docs(app_id, channel_id).delete(event_id)

    @staticmethod
    def _query(
        start_time,
        until_time,
        entity_type,
        entity_id,
        event_names,
        target_entity_type,
        target_entity_id,
    ) -> dict:
        """Bool-filter query mirroring ``ESUtils.createEventQuery``."""
        filters: list[dict] = []
        must_not: list[dict] = []
        if start_time is not None or until_time is not None:
            # bounds use the exact wire format documents carry so string
            # comparison (mock) and date parsing (real ES) both order right
            rng: dict[str, str] = {}
            if start_time is not None:
                rng["gte"] = format_event_time(start_time)
            if until_time is not None:
                rng["lt"] = format_event_time(until_time)
            filters.append({"range": {"eventTime": rng}})
        if entity_type is not None:
            filters.append({"term": {"entityType": entity_type}})
        if entity_id is not None:
            filters.append({"term": {"entityId": entity_id}})
        if event_names:
            filters.append({"terms": {"event": list(event_names)}})
        if target_entity_type is None:
            must_not.append({"exists": {"field": "targetEntityType"}})
        elif target_entity_type is not ...:
            filters.append({"term": {"targetEntityType": target_entity_type}})
        if target_entity_id is None:
            must_not.append({"exists": {"field": "targetEntityId"}})
        elif target_entity_id is not ...:
            filters.append({"term": {"targetEntityId": target_entity_id}})
        if not filters and not must_not:
            return {"match_all": {}}
        return {"bool": {"filter": filters, "must_not": must_not}}

    def find(
        self,
        app_id: int,
        channel_id: int | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None | type(...) = ...,
        target_entity_id: str | None | type(...) = ...,
        limit: int | None = None,
        reversed: bool = False,
    ) -> Iterator[Event]:
        if limit is not None and limit < 0:
            limit = None  # the reference treats limit=-1 as "no cap"
        query = self._query(
            start_time,
            until_time,
            entity_type,
            entity_id,
            event_names,
            target_entity_type,
            target_entity_id,
        )
        order = "desc" if reversed else "asc"
        # eventId tiebreak makes the search_after cursor total-ordered
        sort = [
            {"eventTime": {"order": order, "unmapped_type": "date"}},
            {"eventId": {"order": order, "unmapped_type": "keyword"}},
        ]
        docs = self._docs(app_id, channel_id)
        if limit is not None and limit <= 10_000:
            hits: Iterable[dict] = docs.search(query, size=limit, sort=sort)
        else:  # unlimited or beyond index.max_result_window: paginate
            hits = docs.scan(query, sort=sort)
            if limit is not None:
                import itertools

                hits = itertools.islice(hits, limit)
        for d in hits:
            yield _doc_to_event(d)


def _doc_to_event(d: dict) -> Event:
    """Stored doc -> Event, restoring the fields the REST decoder
    deliberately ignores (the API disables ``creationTime``, but the
    STORED doc carries it and the tail-read ordering contract —
    ``base.event_seq_key`` — depends on it round-tripping; without this,
    every scan re-minted creation_time = now() and a ``find_after``
    cursor could never pass a row)."""
    e = Event.from_json_dict(d)
    raw_ct = d.get("creationTime")
    if raw_ct:
        e = dataclasses.replace(e, creation_time=parse_event_time(raw_ct))
    return e


class ESPEvents(base.PEvents):
    """Bulk scan over the same indices (the reference reads through
    elasticsearch-hadoop's EsInputFormat, ``ESPEvents.scala:44-100``; the
    training feed is the shared dictionary-encoder in ``base.PEvents``).

    This driver is the framework's SCALE-OUT event store (the HBase-class
    role — see docs/DECISIONS.md): bulk training scans fan out over ES
    sliced scrolls, one concurrent scanner per slice, the REST analog of
    the reference's HBase region-split parallel scan
    (``HBPEvents.scala:63-95``). ``scan_slices`` comes from the storage
    source config (``PIO_STORAGE_SOURCES_<name>_SCAN_SLICES``, default 4 —
    the same default as ``JDBCPEvents`` partitions, ``JDBCPEvents.scala:53``).
    """

    def __init__(
        self,
        transport: _ESTransport,
        prefix: str,
        levents: ESLEvents,
        scan_slices: int = 4,
    ):
        self._t = transport
        self._prefix = prefix
        self._levents = levents
        self._scan_slices = max(1, int(scan_slices))

    def find(self, app_id: int, channel_id: int | None = None, **kw) -> Iterator[Event]:
        return self._levents.find(app_id=app_id, channel_id=channel_id, **kw)

    _SLICE_FILTERS = frozenset(
        (
            "start_time",
            "until_time",
            "entity_type",
            "entity_id",
            "event_names",
            "target_entity_type",
            "target_entity_id",
        )
    )

    def find_sliced(
        self,
        app_id: int,
        channel_id: int | None = None,
        n_slices: int | None = None,
        **filters: Any,
    ) -> list[Iterator[Event]]:
        """Disjoint slice iterators jointly covering the filtered scan.
        Each iterator is independently consumable (own scroll context), so
        callers can hand one per worker thread/process."""
        unknown = set(filters) - self._SLICE_FILTERS
        if unknown:
            # silently ignoring a typo'd (or unsliceable, e.g. limit/
            # reversed) filter would return the wrong row set
            raise TypeError(f"find_sliced: unsupported filter(s) {sorted(unknown)}")
        n = n_slices or self._scan_slices
        query = ESLEvents._query(
            filters.get("start_time"),
            filters.get("until_time"),
            filters.get("entity_type"),
            filters.get("entity_id"),
            filters.get("event_names"),
            filters.get("target_entity_type", ...),
            filters.get("target_entity_id", ...),
        )
        docs = self._levents._docs(app_id, channel_id)

        def one(i: int) -> Iterator[Event]:
            for d in docs.scan_sliced(query, i, n):
                yield _doc_to_event(d)

        return [one(i) for i in range(n)]

    def find_parallel(
        self,
        app_id: int,
        channel_id: int | None = None,
        n_slices: int | None = None,
        **filters: Any,
    ) -> Iterator[Event]:
        """Merge the slices through a bounded queue, one thread per slice
        (shared merge: ``base.merge_parallel_scans``). Yields in
        nondeterministic order (bulk consumers — columnar encode,
        aggregation — are order-free)."""
        slices = self.find_sliced(app_id, channel_id, n_slices, **filters)
        return base.merge_parallel_scans(slices)

    _COLUMNAR_OWN_KW = frozenset(("rating_key", "entity_vocab", "target_vocab", "events"))

    def to_columnar(self, app_id: int, channel_id: int | None = None, **kw):
        """Columnar ingest reads through the sliced parallel scan — the
        training feed overlaps N scroll streams instead of paying one
        serial deep-pagination walk. Falls back to the serial scan when the
        call carries find() kwargs slices can't honor (limit, reversed, …)
        so semantics never silently diverge from the other drivers."""
        filters = {k: v for k, v in kw.items() if k in self._SLICE_FILTERS}
        unsliceable = set(kw) - self._SLICE_FILTERS - self._COLUMNAR_OWN_KW
        if self._scan_slices > 1 and "events" not in kw and not unsliceable:
            kw = {k: v for k, v in kw.items() if k not in self._SLICE_FILTERS}
            kw["events"] = self.find_parallel(app_id, channel_id, **filters)
            # erase the slice-merge nondeterminism (row order AND the
            # scan-encounter dictionary encoding) so direct consumers —
            # exports, multi-host ingest, golden tests — are reproducible
            return base.canonical_order(
                super().to_columnar(app_id, channel_id, **kw),
                frozen_entity_vocab=kw.get("entity_vocab") is not None,
                frozen_target_vocab=kw.get("target_vocab") is not None,
            )
        return super().to_columnar(app_id, channel_id, **kw)

    def write(
        self, events: Iterable[Event], app_id: int, channel_id: int | None = None
    ) -> None:
        batch: list[Event] = []
        for e in events:
            batch.append(e)
            if len(batch) >= 1_000:
                self._levents.insert_batch(batch, app_id, channel_id)
                batch = []
        if batch:
            self._levents.insert_batch(batch, app_id, channel_id)

    def delete(
        self, event_ids: Iterable[str], app_id: int, channel_id: int | None = None
    ) -> None:
        # _bulk delete actions: the per-event loop paid one HTTP round trip
        # AND one forced index refresh per document (minutes for a 100k-event
        # self-cleaning pass); one refresh per 1000-doc chunk instead
        index = self._levents._index(app_id, channel_id)
        chunk: list[dict] = []
        for event_id in event_ids:
            chunk.append({"delete": {"_index": index, "_id": event_id}})
            if len(chunk) >= 1_000:
                self._t.bulk(chunk, params={"refresh": "true"})
                chunk = []
        if chunk:
            self._t.bulk(chunk, params={"refresh": "true"})

    def version_stamp(self, app_id: int, channel_id: int | None = None) -> str | None:
        index = self._levents._index(app_id, channel_id)
        out = self._t.request(
            "POST", f"/{index}/_count", body={}, ok_statuses=(404,)
        )
        count = out.get("count")
        if count is None:
            return None
        # count alone misses delete+insert pairs; include the max eventTime
        hits = _ESDocs(self._t, index).search(
            {"match_all": {}},
            size=1,
            sort=[{"eventTime": {"order": "desc", "unmapped_type": "date"}}],
        )
        latest = hits[0].get("eventTime", "") if hits else ""
        return f"{count}:{latest}"

    def store_identity(self) -> str | None:
        return f"es:{self._t.urls[0]}/{self._prefix}"


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class ESStorageClient:
    """Backend entry point (type name: ``elasticsearch``)."""

    def __init__(self, config: dict | None = None):
        self.config = {k.upper(): v for k, v in (config or {}).items()}
        url = self.config.get("URL")
        if url:
            urls = [u.strip() for u in url.split(",") if u.strip()]
        else:
            hosts = [
                h.strip()
                for h in self.config.get("HOSTS", "localhost").split(",")
            ]
            ports = [
                p.strip() for p in str(self.config.get("PORTS", "9200")).split(",")
            ]
            schemes = [
                s.strip() for s in self.config.get("SCHEMES", "http").split(",")
            ]
            urls = []
            for i, host in enumerate(hosts):
                port = ports[min(i, len(ports) - 1)]
                scheme = schemes[min(i, len(schemes) - 1)]
                urls.append(f"{scheme}://{host}:{port}")
        auth = None
        if self.config.get("USERNAME"):
            cred = f"{self.config['USERNAME']}:{self.config.get('PASSWORD', '')}"
            auth = base64.b64encode(cred.encode()).decode()
        self._transport = _ESTransport(
            urls,
            auth=auth,
            timeout=float(self.config.get("TIMEOUT", 10.0)),
            retries=int(self.config.get("RETRIES", 1)),
            retry_backoff_s=float(self.config.get("RETRY_BACKOFF_S", 0.2)),
        )
        self._prefix = self.config.get("INDEX_PREFIX", "pio")
        self._ensured_meta: set[str] = set()
        self._seq = ESSequences(self._transport, f"{self._prefix}_meta_sequences")
        self._levents = ESLEvents(self._transport, self._prefix)

    def _meta_docs(self, kind: str) -> _ESDocs:
        index = f"{self._prefix}_meta_{kind}"
        if index not in self._ensured_meta:
            _ensure_index(self._transport, index)
            self._ensured_meta.add(index)
        return _ESDocs(self._transport, index)

    def l_events(self) -> ESLEvents:
        return self._levents

    def p_events(self) -> ESPEvents:
        return ESPEvents(
            self._transport,
            self._prefix,
            self._levents,
            scan_slices=int(self.config.get("SCAN_SLICES", 4)),
        )

    def apps(self) -> ESApps:
        return ESApps(
            self._meta_docs("apps"), self._meta_docs("apps_names"), self._seq
        )

    def access_keys(self) -> ESAccessKeys:
        return ESAccessKeys(self._meta_docs("accesskeys"))

    def channels(self) -> ESChannels:
        return ESChannels(self._meta_docs("channels"), self._seq)

    def engine_instances(self) -> ESEngineInstances:
        return ESEngineInstances(self._meta_docs("engineinstances"))

    def evaluation_instances(self) -> ESEvaluationInstances:
        return ESEvaluationInstances(self._meta_docs("evaluationinstances"))

    def models(self) -> ESModels:
        index = f"{self._prefix}_model"
        if index not in self._ensured_meta:
            _ensure_index(self._transport, index)
            self._ensured_meta.add(index)
        return ESModels(_ESDocs(self._transport, index))
