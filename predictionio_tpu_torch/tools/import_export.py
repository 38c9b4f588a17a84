"""Bulk import/export between files and the event store.

Reference parity: ``tools/.../imprt/FileToEvents.scala:45-120`` (JSON lines
-> PEvents.write) and ``tools/.../export/EventsToFile.scala:85-95`` (the
json-or-parquet switch: ``--format parquet`` wrote the events DataFrame via
Spark SQL). Formats here:

- ``json`` — wire-format JSON lines, byte-compatible with the event API;
- ``parquet`` — one row per event with wire-named columns (``eventId``,
  ``event``, ``entityType``, ..., ``eventTime`` as a tz-aware timestamp);
  ``properties`` is a JSON-encoded string column rather than the
  reference's Spark struct (schema-free properties don't fit a fixed
  arrow struct; every consumer that reads the reference's output can
  json-decode the column). Import accepts both layouts' common columns.
- ``npz`` — dense columnar arrays (this framework's training feed).

The port's own copy of ``predictionio_tpu/tools/import_export.py``. Parquet
needs ``pyarrow``; where it is not installed a parquet import or export
raises ``ValueError`` naming it, and nothing falls back to another format.
A JSON-lines row's ``creationTime``, which ``export`` writes, is kept on
import, so an export and re-import keeps the store's tail order.
"""

from __future__ import annotations

import json
import logging

import numpy as np

from predictionio_tpu_torch.data.event import Event, parse_event_time
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.store.event_store import resolve_app

logger = logging.getLogger(__name__)


def import_events(
    input_path: str,
    app_name: str,
    channel_name: str | None = None,
    storage: Storage | None = None,
    batch_size: int = 10000,
) -> int:
    """JSON-lines or parquet file -> event store. Returns number imported.
    Parquet is selected by a ``.parquet`` extension."""
    storage = storage or Storage.instance()
    app_id, channel_id = resolve_app(storage, app_name, channel_name)
    levents = storage.get_l_events()
    levents.init(app_id, channel_id)
    count = 0
    batch: list[Event] = []

    def flush():
        nonlocal count, batch
        if batch:
            levents.insert_batch(batch, app_id, channel_id)
            count += len(batch)
            batch = []

    if input_path.endswith(".parquet"):
        for ev in _iter_parquet_events(input_path):
            batch.append(ev)
            if len(batch) >= batch_size:
                flush()
    else:
        with open(input_path) as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    batch.append(Event.from_json_dict(json.loads(line)))
                except Exception as exc:
                    raise ValueError(f"{input_path}:{line_no}: {exc}") from exc
                if len(batch) >= batch_size:
                    flush()
    flush()
    logger.info("imported %d events into app %s", count, app_name)
    return count


def _pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as exc:
        raise ValueError(
            "parquet import and export need the pyarrow package, which is not "
            "installed; use the json format"
        ) from exc
    return pyarrow, pyarrow.parquet


def _iter_parquet_events(path: str):
    """Yield Events from a parquet file with wire-named columns (the layout
    ``export_events(format="parquet")`` writes; extra columns ignored)."""
    _, pq = _pyarrow()

    pf = pq.ParquetFile(path)
    row_no = 0
    for rb in pf.iter_batches():
        for row in rb.to_pylist():
            row_no += 1
            try:
                d = {k: v for k, v in row.items() if v is not None}
                props = d.get("properties")
                if isinstance(props, str):
                    d["properties"] = json.loads(props)
                for key in ("eventTime", "creationTime"):
                    ts = d.get(key)
                    if ts is not None and not isinstance(ts, str):
                        d[key] = ts.isoformat()
                yield Event.from_json_dict(d)
            except Exception as exc:
                # same operator-facing contract as the JSON-lines path:
                # file:row: cause (and a ValueError cmd_import will catch)
                raise ValueError(f"{path}:{row_no}: {exc}") from exc


def export_events(
    output_path: str,
    app_name: str,
    channel_name: str | None = None,
    storage: Storage | None = None,
    format: str = "json",
) -> int:
    """Event store -> file. format=json (wire rows), parquet (wire-named
    columns, ref EventsToFile.scala:85-95), or npz (columnar)."""
    storage = storage or Storage.instance()
    app_id, channel_id = resolve_app(storage, app_name, channel_name)
    pevents = storage.get_p_events()
    if format == "parquet":
        pa, pq = _pyarrow()

        # real timestamp columns (the reference's Spark schema types
        # eventTime/creationTime as TimestampType, EventsToFile.scala) and
        # a streaming writer: the whole store must never be materialized
        # as one python list at ML-20M scale
        schema = pa.schema(
            [
                ("eventId", pa.string()),
                ("event", pa.string()),
                ("entityType", pa.string()),
                ("entityId", pa.string()),
                ("targetEntityType", pa.string()),
                ("targetEntityId", pa.string()),
                ("properties", pa.string()),
                ("prId", pa.string()),
                ("eventTime", pa.timestamp("us", tz="UTC")),
                ("creationTime", pa.timestamp("us", tz="UTC")),
            ]
        )

        def row(e: Event) -> dict:
            d = e.to_json_dict(with_creation_time=True)
            props = d.get("properties")
            return {
                "eventId": d.get("eventId"),
                "event": d["event"],
                "entityType": d["entityType"],
                "entityId": d["entityId"],
                "targetEntityType": d.get("targetEntityType"),
                "targetEntityId": d.get("targetEntityId"),
                "properties": json.dumps(props, sort_keys=True)
                if props
                else None,
                "prId": d.get("prId"),
                "eventTime": parse_event_time(d["eventTime"]),
                "creationTime": parse_event_time(d["creationTime"])
                if d.get("creationTime")
                else None,
            }

        count = 0
        batch: list[dict] = []
        with pq.ParquetWriter(output_path, schema) as writer:
            for e in pevents.find(app_id, channel_id):
                batch.append(row(e))
                if len(batch) >= 10000:
                    writer.write_batch(
                        pa.RecordBatch.from_pylist(batch, schema=schema)
                    )
                    count += len(batch)
                    batch = []
            if batch:
                writer.write_batch(
                    pa.RecordBatch.from_pylist(batch, schema=schema)
                )
                count += len(batch)
        return count
    if format == "json":
        count = 0
        with open(output_path, "w") as f:
            for e in pevents.find(app_id, channel_id):
                f.write(
                    json.dumps(e.to_json_dict(with_creation_time=True), sort_keys=True)
                    + "\n"
                )
                count += 1
        return count
    if format == "npz":
        col = pevents.to_columnar(app_id, channel_id)
        np.savez_compressed(
            output_path,
            entity_ids=col.entity_ids,
            target_ids=col.target_ids,
            event_codes=col.event_codes,
            timestamps=col.timestamps,
            ratings=col.ratings,
            entity_vocab=np.array(col.entity_vocab, dtype=object),
            target_vocab=np.array(col.target_vocab, dtype=object),
            event_vocab=np.array(col.event_vocab, dtype=object),
        )
        return len(col)
    raise ValueError(f"unknown export format {format!r} (json|parquet|npz)")
