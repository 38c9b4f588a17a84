"""Storage locator: env-var driven backend discovery + repository accessors.

Reference parity: ``data/.../storage/Storage.scala:146-466`` — sources are
declared via ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ arbitrary per-source
config keys), repositories bind the three roles to sources via
``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,SOURCE}``,
and DAOs are instantiated by naming convention. The reference reflects on
JVM class names (``Storage.scala:310-337``); here the convention is a backend
module registered under its type name exposing a ``*StorageClient`` class
with DAO accessor methods (``l_events()``, ``apps()``, ...).

Defaults (no env set): metadata/eventdata/modeldata all on one SQLite file
under ``$PIO_FS_BASEDIR``, else the port's own home, ``$PIO_TORCH_HOME`` or
``~/.pio_torch`` (see :func:`default_basedir`) — never the JAX package's
``~/.pio_store``, so a deploy of either package cannot pick up the other's
engine instances.

Port of ``predictionio_tpu/data/storage/registry.py`` with every backend
type of the JAX package, under the same client class names.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from predictionio_tpu_torch.data.storage import base


class StorageError(RuntimeError):
    pass


def default_basedir(env: dict[str, str] | None = None) -> str:
    """``$PIO_FS_BASEDIR``, else ``$PIO_TORCH_HOME``, else ``~/.pio_torch``."""
    env = os.environ if env is None else env
    return (
        env.get("PIO_FS_BASEDIR")
        or env.get("PIO_TORCH_HOME")
        or os.path.join(os.path.expanduser("~"), ".pio_torch")
    )


# type name -> module path, client class name
_BACKENDS: dict[str, tuple[str, str]] = {
    "memory": ("predictionio_tpu_torch.data.storage.memory", "MemoryStorageClient"),
    "sqlite": ("predictionio_tpu_torch.data.storage.sqlite", "SQLiteStorageClient"),
    "localfs": ("predictionio_tpu_torch.data.storage.localfs", "LocalFSStorageClient"),
    "jsonl": ("predictionio_tpu_torch.data.storage.jsonl", "JSONLStorageClient"),
    # client/server SQL databases over DB-API; the driver module is imported
    # at connect time, and a missing one raises StorageError naming it
    "postgres": ("predictionio_tpu_torch.data.storage.sql", "PostgresStorageClient"),
    "mysql": ("predictionio_tpu_torch.data.storage.sql", "MySQLStorageClient"),
    "sql": ("predictionio_tpu_torch.data.storage.sql", "SQLStorageClient"),
    # REST drivers on the standard library, no client packages
    "elasticsearch": ("predictionio_tpu_torch.data.storage.elasticsearch", "ESStorageClient"),
    "s3": ("predictionio_tpu_torch.data.storage.s3", "S3StorageClient"),
    "hdfs": ("predictionio_tpu_torch.data.storage.hdfs", "HDFSStorageClient"),
}

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

# guards _BACKENDS: registration may run from a plugin thread while another
# thread resolves a client class
_backends_lock = threading.Lock()


def register_backend(type_name: str, module: str, class_name: str) -> None:
    """Third-party backends plug in here (the reference's equivalent is
    dropping a jar with conventionally-named classes on the classpath)."""
    with _backends_lock:
        _BACKENDS[type_name] = (module, class_name)


class Storage:
    """Process-wide storage locator. ``Storage.instance()`` reads the
    environment once; tests construct isolated instances directly."""

    _singleton: "Storage | None" = None
    _singleton_lock = threading.Lock()

    def __init__(self, env: dict[str, str] | None = None):
        self.env = dict(env if env is not None else os.environ)
        self._clients: dict[str, Any] = {}
        self._lock = threading.RLock()
        self._sources = self._parse_sources()
        self._repositories = self._parse_repositories()

    # -- singleton ----------------------------------------------------------
    @classmethod
    def instance(cls) -> "Storage":
        with cls._singleton_lock:
            if cls._singleton is None:
                cls._singleton = Storage()
            return cls._singleton

    @classmethod
    def reset(cls) -> None:
        with cls._singleton_lock:
            cls._singleton = None

    # -- env parsing (ref Storage.scala:158-223) ----------------------------
    def _parse_sources(self) -> dict[str, dict[str, str]]:
        sources: dict[str, dict[str, str]] = {}
        prefix = "PIO_STORAGE_SOURCES_"
        for key, value in self.env.items():
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            name, _, prop = rest.partition("_")
            if not prop:
                continue
            sources.setdefault(name, {})[prop] = value
        for name, cfg in sources.items():
            if "TYPE" not in cfg:
                raise StorageError(
                    f"storage source {name} declared without "
                    f"PIO_STORAGE_SOURCES_{name}_TYPE"
                )
        return sources

    def _default_basedir(self) -> str:
        return default_basedir(self.env)

    def _parse_repositories(self) -> dict[str, str]:
        repos: dict[str, str] = {}
        env_declared_sources = bool(self._sources)
        for repo in REPOSITORIES:
            source = self.env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if source is None:
                if env_declared_sources:
                    raise StorageError(
                        f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE is not set but "
                        "storage sources are configured"
                    )
                # zero-config default: one sqlite db for everything
                basedir = self._default_basedir()
                os.makedirs(basedir, exist_ok=True)
                self._sources.setdefault(
                    "DEFAULT",
                    {
                        "TYPE": "sqlite",
                        "PATH": os.path.join(basedir, "pio.db"),
                    },
                )
                source = "DEFAULT"
            elif source not in self._sources:
                raise StorageError(
                    f"repository {repo} references undeclared source {source}"
                )
            repos[repo] = source
        return repos

    # -- client / DAO instantiation -----------------------------------------
    def _client(self, source_name: str) -> Any:
        with self._lock:
            if source_name in self._clients:
                return self._clients[source_name]
            cfg = self._sources.get(source_name)
            if cfg is None:
                raise StorageError(f"undeclared storage source {source_name}")
            type_name = cfg["TYPE"].lower()
            with _backends_lock:
                entry = _BACKENDS.get(type_name)
                known = sorted(_BACKENDS)
            if entry is None:
                raise StorageError(
                    f"unknown storage backend type {type_name!r}; "
                    f"known: {known}"
                )
            module_name, class_name = entry
            import importlib

            module = importlib.import_module(module_name)
            client = getattr(module, class_name)(cfg)
            self._clients[source_name] = client
            return client

    def _dao(self, repo: str, accessor: str) -> Any:
        client = self._client(self._repositories[repo])
        fn: Callable[[], Any] | None = getattr(client, accessor, None)
        if fn is None:
            raise StorageError(
                f"storage source {self._repositories[repo]} "
                f"({type(client).__name__}) does not provide {accessor}"
            )
        return fn()

    # -- repository accessors (ref Storage.scala:401-454) --------------------
    def get_l_events(self) -> base.LEvents:
        return self._dao("EVENTDATA", "l_events")

    def get_p_events(self) -> base.PEvents:
        return self._dao("EVENTDATA", "p_events")

    def get_meta_data_apps(self) -> base.Apps:
        return self._dao("METADATA", "apps")

    def get_meta_data_access_keys(self) -> base.AccessKeys:
        return self._dao("METADATA", "access_keys")

    def get_meta_data_channels(self) -> base.Channels:
        return self._dao("METADATA", "channels")

    def get_meta_data_engine_instances(self) -> base.EngineInstances:
        return self._dao("METADATA", "engine_instances")

    def get_meta_data_evaluation_instances(self) -> base.EvaluationInstances:
        return self._dao("METADATA", "evaluation_instances")

    def get_model_data_models(self) -> base.Models:
        return self._dao("MODELDATA", "models")

    # -- health check (ref Storage.verifyAllDataObjects, used by `pio status`)
    def verify_all_data_objects(self) -> list[str]:
        """Instantiate every repository DAO; return a list of failures."""
        failures = []
        checks = [
            ("EVENTDATA l_events", self.get_l_events),
            ("EVENTDATA p_events", self.get_p_events),
            ("METADATA apps", self.get_meta_data_apps),
            ("METADATA access_keys", self.get_meta_data_access_keys),
            ("METADATA channels", self.get_meta_data_channels),
            ("METADATA engine_instances", self.get_meta_data_engine_instances),
            ("METADATA evaluation_instances", self.get_meta_data_evaluation_instances),
            ("MODELDATA models", self.get_model_data_models),
        ]
        for name, fn in checks:
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 — health check reports all
                failures.append(f"{name}: {exc}")
        return failures
