"""LEventStore / PEventStore — what engine code calls to read events.

Reference parity: ``data/.../store/LEventStore.scala:33-143`` (blocking
row-level reads by app *name*, used at predict time by e-commerce-style
algorithms), ``PEventStore.scala:35-119`` (bulk reads for training),
``Common.scala`` (name->id resolution with channel validation).

The P store's ``to_columnar`` is the device on-ramp: one bulk scan,
dictionary-encoded to dense int32/float32 numpy columns that a trainer
copies to the card.

The port's own copy of ``predictionio_tpu/data/store/event_store.py``.
"""

from __future__ import annotations

import datetime as _dt
from typing import Iterator, Sequence

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import ColumnarEvents
from predictionio_tpu_torch.data.storage.registry import Storage, StorageError, default_basedir


def resolve_app(
    storage: Storage, app_name: str, channel_name: str | None = None
) -> tuple[int, int | None]:
    """appName -> (appId, channelId) (ref Common.appNameToId)."""
    app = storage.get_meta_data_apps().get_by_name(app_name)
    if app is None:
        raise StorageError(f"App {app_name!r} does not exist.")
    if channel_name is None:
        return app.id, None
    channels = storage.get_meta_data_channels().get_by_app_id(app.id)
    for c in channels:
        if c.name == channel_name:
            return app.id, c.id
    raise StorageError(
        f"Channel {channel_name!r} does not exist for app {app_name!r}."
    )


class LEventStore:
    """Blocking row-level reads, safe to call on the serving hot path."""

    def __init__(self, storage: Storage | None = None):
        self._storage = storage or Storage.instance()

    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        limit: int | None = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        app_id, channel_id = resolve_app(self._storage, app_name, channel_name)
        return self._storage.get_l_events().find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=latest,
        )

    def find_by_entity(
        self,
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        """ref LEventStore.findByEntity — newest-first by default."""
        return self.find(
            app_name=app_name,
            channel_name=channel_name,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            latest=latest,
        )


class PEventStore:
    """Bulk reads for training; mirror of ``PEventStore.scala``."""

    def __init__(self, storage: Storage | None = None):
        self._storage = storage or Storage.instance()

    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
        **kwargs,
    ) -> Iterator[Event]:
        app_id, channel_id = resolve_app(self._storage, app_name, channel_name)
        return self._storage.get_p_events().find(
            app_id=app_id, channel_id=channel_id, **kwargs
        )

    def aggregate_properties(
        self,
        app_name: str,
        entity_type: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: Sequence[str] | None = None,
    ) -> dict[str, PropertyMap]:
        app_id, channel_id = resolve_app(self._storage, app_name, channel_name)
        return self._storage.get_p_events().aggregate_properties(
            app_id=app_id,
            channel_id=channel_id,
            entity_type=entity_type,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )

    def to_columnar(
        self,
        app_name: str,
        channel_name: str | None = None,
        **kwargs,
    ) -> ColumnarEvents:
        app_id, channel_id = resolve_app(self._storage, app_name, channel_name)
        return self._storage.get_p_events().to_columnar(
            app_id=app_id, channel_id=channel_id, **kwargs
        )

    def to_columnar_cached(
        self,
        app_name: str,
        channel_name: str | None = None,
        snapshot_dir: str | None = None,
        host_index: int = 0,
        host_count: int = 1,
        refresh: bool = False,
        **kwargs,
    ) -> ColumnarEvents:
        """``to_columnar`` through the sharded snapshot cache
        (``data/store/snapshot.py``) — the replacement for the reference's
        partitioned storage scans (``JDBCPEvents.scala:91-121``): train runs
        hit the columnar shards, not the row store, unless events changed.

        ``snapshot_dir`` defaults to ``$PIO_SNAPSHOT_DIR``, else
        ``snapshots`` under the storage's basedir (its ``PIO_FS_BASEDIR``,
        else ``$PIO_TORCH_HOME``, else ``~/.pio_torch``).
        Multi-host callers pass their ``host_index``/``host_count`` for a
        deterministic disjoint shard set. Set ``PIO_SNAPSHOT_DISABLE=1`` to
        force every train back to the row store.
        """
        import os

        from predictionio_tpu_torch.data.store.snapshot import (
            SnapshotCache,
            canonical_order,
            take_host_blocks,
        )

        if os.environ.get("PIO_SNAPSHOT_DISABLE", "").lower() in ("1", "true", "yes", "on"):
            cols = self.to_columnar(app_name, channel_name, **kwargs)
            if host_count > 1:
                # the bypass must keep the multi-host contract: each host
                # still gets its disjoint block subset of the SAME canonical
                # row order AND the same canonical dictionary encoding (each
                # host built its own vocab in scan-encounter order here),
                # exactly as the cached path computes them
                cols = take_host_blocks(
                    canonical_order(
                        cols,
                        frozen_entity_vocab=kwargs.get("entity_vocab") is not None,
                        frozen_target_vocab=kwargs.get("target_vocab") is not None,
                    ),
                    host_index,
                    host_count,
                )
            return cols
        snapshot_dir = (
            snapshot_dir
            or os.environ.get("PIO_SNAPSHOT_DIR")
            or os.path.join(default_basedir(self._storage.env), "snapshots")
        )
        app_id, channel_id = resolve_app(self._storage, app_name, channel_name)
        cache = SnapshotCache(snapshot_dir)
        return cache.columnar(
            self._storage.get_p_events(),
            app_id,
            channel_id,
            host_index=host_index,
            host_count=host_count,
            refresh=refresh,
            **kwargs,
        )
