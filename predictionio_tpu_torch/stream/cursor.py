"""Durable stream cursors: checkpointed positions into the event store.

One cursor file per tailed (app, channel), JSON under a base directory
(default ``$PIO_STREAM_DIR``, else ``stream/`` under the port's base
directory: ``$PIO_FS_BASEDIR``, else ``$PIO_TORCH_HOME``, else
``~/.pio_torch``). Every write is atomic (tmp file + ``os.replace`` in
the same directory, fsync'd) so a crashed pipeline can never leave a
half-written cursor — restart resumes from the last complete checkpoint.

The position is the event store's documented ordering contract
(:func:`predictionio_tpu_torch.data.storage.base.event_seq_key`): a
``(creation_time_micros, event_id)`` pair, exclusive. Reads are
at-least-once by design (a crash between fold-in and checkpoint re-reads
the last drain); exactly-once applies to *publish* — the pipeline derives
a deterministic span id from the cursor interval a publish covers and the
registry is consulted for that span id before publishing, so a replayed
interval can never produce a second candidate.

Own copy of ``predictionio_tpu/stream/cursor.py``: the same cursor files.
Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import os
import tempfile
import threading
from typing import Any

logger = logging.getLogger(__name__)

Position = tuple[int, str]  # (creation_time micros, event_id), exclusive

_UTC = _dt.timezone.utc


def _now_iso() -> str:
    return _dt.datetime.now(tz=_UTC).isoformat()


def default_stream_dir() -> str:
    """Resolution order: ``PIO_STREAM_DIR``, else ``stream/`` under
    ``PIO_FS_BASEDIR``, else under ``PIO_TORCH_HOME`` or ``~/.pio_torch``."""
    explicit = os.environ.get("PIO_STREAM_DIR")
    if explicit:
        return explicit
    base = (
        os.environ.get("PIO_FS_BASEDIR")
        or os.environ.get("PIO_TORCH_HOME")
        or os.path.join(os.path.expanduser("~"), ".pio_torch")
    )
    return os.path.join(base, "stream")


def position_str(position: Position | None) -> str:
    return "start" if position is None else f"{position[0]}:{position[1]}"


def span_id_of(frm: Position | None, to: Position) -> str:
    """Deterministic identity of one publish's cursor interval. Replaying
    the same interval (at-least-once reads after a crash) derives the same
    span id, which is how the registry-side dedup recognizes an already
    published candidate."""
    return f"{position_str(frm)}..{position_str(to)}"


@dataclasses.dataclass
class StreamCursor:
    """Checkpointed tail state for one (app, channel)."""

    app_id: int
    channel_id: int | None = None
    # [creation_time_micros, event_id]; None = start of the store
    position: list | None = None
    # position covered by the last PUBLISH (or the initial seed). On
    # restart the pipeline rewinds `position` back to this: events that
    # were folded and checkpointed but never made it into a published
    # candidate are re-read into the fresh trainer instead of silently
    # vanishing from the speed layer until the next batch train.
    published_position: list | None = None
    events_read: int = 0
    drains: int = 0
    publishes: int = 0
    last_published_version: str = ""
    last_published_span: str = ""  # span_id_of(...) of the last publish
    last_published_at: str = ""
    updated_at: str = ""

    @staticmethod
    def _pos(raw: list | None) -> Position | None:
        if not raw:
            return None
        return (int(raw[0]), str(raw[1]))

    def pos(self) -> Position | None:
        return self._pos(self.position)

    def published_pos(self) -> Position | None:
        return self._pos(self.published_position)

    def seed(self, position: Position | None) -> None:
        """Set the starting point of a FRESH cursor (e.g. the store head).
        Recorded as both the read position and the publish floor, so a
        crash before the first publish rewinds here, not to the store's
        beginning."""
        raw = [int(position[0]), str(position[1])] if position else None
        self.position = list(raw) if raw else None
        self.published_position = list(raw) if raw else None

    def advance(self, position: Position, n_events: int) -> None:
        self.position = [int(position[0]), str(position[1])]
        self.events_read += n_events
        self.drains += 1

    def record_publish(self, version: str, span_id: str, position: Position) -> None:
        self.publishes += 1
        self.published_position = [int(position[0]), str(position[1])]
        self.last_published_version = version
        self.last_published_span = span_id
        self.last_published_at = _now_iso()

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, data: dict[str, Any]) -> "StreamCursor":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename in the destination directory: readers (and the
    restarted pipeline) see either the old complete file or the new
    complete file, never a prefix."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CursorStore:
    """Per-(app, channel) cursor files under one base directory."""

    def __init__(self, base_dir: str | None = None):
        self.base_dir = os.path.abspath(base_dir or default_stream_dir())
        self._lock = threading.Lock()

    def path(self, app_id: int, channel_id: int | None = None) -> str:
        name = (
            f"cursor_{app_id}.json"
            if channel_id is None
            else f"cursor_{app_id}_{channel_id}.json"
        )
        return os.path.join(self.base_dir, name)

    def load(self, app_id: int, channel_id: int | None = None) -> StreamCursor:
        path = self.path(app_id, channel_id)
        if not os.path.exists(path):
            return StreamCursor(app_id=app_id, channel_id=channel_id)
        try:
            with open(path, encoding="utf-8") as fh:
                cursor = StreamCursor.from_json_dict(json.load(fh))
        except (OSError, ValueError, TypeError):
            logger.warning(
                "unreadable cursor file %s; starting from the beginning", path
            )
            return StreamCursor(app_id=app_id, channel_id=channel_id)
        cursor.app_id = app_id
        cursor.channel_id = channel_id
        return cursor

    def save(self, cursor: StreamCursor) -> None:
        cursor.updated_at = _now_iso()
        with self._lock:
            _atomic_write(
                self.path(cursor.app_id, cursor.channel_id),
                json.dumps(cursor.to_json_dict(), indent=1).encode("utf-8"),
            )
