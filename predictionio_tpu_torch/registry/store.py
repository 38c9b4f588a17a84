"""Content-addressed artifact store + rollout state machine.

Layout under one base directory (default ``$PIO_REGISTRY_DIR``, else
``$PIO_FS_BASEDIR/registry``)::

    <base>/<engine_key>/
        versions/v000001.json     one ModelManifest per published version
        blobs/<sha256>            the artifact bytes, content-addressed
        state.json                RolloutState (stable/candidate/history)

``engine_key`` is a filesystem-safe digest of the engine id (engine ids
may be absolute directory paths). Every write is atomic (tmp file +
``os.replace`` in the same directory) so a crashed publish can never leave
a half-written manifest that a concurrent deploy would trust. Blob reads
re-verify the manifest's sha256 — a truncated or bit-flipped artifact
surfaces as :class:`ArtifactIntegrityError`, never as a pickle of garbage.

GC keeps the last N versions plus anything the rollout state still
references (stable, candidate, previous stable); blobs are deleted only
once no surviving manifest references them (two manifests may share one
blob: re-publishing identical bytes is deduplicated by content address).

The registry is the source of truth for "what serves"; the metadata
store's EngineInstances table remains the training ledger the manifests
point back into (docs/DECISIONS.md).

(Own copy of ``predictionio_tpu/registry/store.py``. The on-disk layout
and every JSON file are the reference's byte for byte: a registry one
package writes, the other reads. Only the default base directory differs,
as the storage layer's does: ``$PIO_FS_BASEDIR``, else ``$PIO_TORCH_HOME``,
else ``~/.pio_torch``.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Any

try:
    import fcntl
except ImportError:  # non-POSIX: in-process serialization only
    fcntl = None  # type: ignore[assignment]

from predictionio_tpu_torch.registry import lease as lease_mod
from predictionio_tpu_torch.registry.manifest import ModelManifest

logger = logging.getLogger(__name__)

MODE_OFF = "off"
MODE_CANARY = "canary"
MODE_SHADOW = "shadow"

_VERSION_RE = re.compile(r"^v(\d{6,})$")
_HISTORY_LIMIT = 50


class ArtifactIntegrityError(RuntimeError):
    """An artifact failed its checksum/length verification — the bytes on
    disk are not the bytes that were published."""


def default_registry_dir() -> str:
    """Resolution order: ``PIO_REGISTRY_DIR``, else ``registry/`` under
    ``PIO_FS_BASEDIR``, else under ``PIO_TORCH_HOME`` or ``~/.pio_torch``
    (the storage layer's base directory)."""
    explicit = os.environ.get("PIO_REGISTRY_DIR")
    if explicit:
        return explicit
    base = (
        os.environ.get("PIO_FS_BASEDIR")
        or os.environ.get("PIO_TORCH_HOME")
        or os.path.join(os.path.expanduser("~"), ".pio_torch")
    )
    return os.path.join(base, "registry")


@dataclasses.dataclass
class RolloutState:
    """The rollout state machine for one engine.

    ``stable`` serves pinned traffic; ``candidate`` (when set) takes the
    configured canary fraction or shadow traffic while baking. ``history``
    is an append-only (bounded) trail of publish/stage/promote/rollback
    events — the audit log ``pio models show`` prints.
    """

    stable: str = ""
    candidate: str = ""
    mode: str = MODE_OFF  # off | canary | shadow
    fraction: float = 0.0
    previous_stable: str = ""  # rollback target after a promote
    staged_at: str = ""  # when the current candidate was staged
    updated_at: str = ""
    # monotonic change counter, bumped on EVERY persisted transition
    # (publish/stage/promote/unstage/rollback). Fleet replicas poll
    # :meth:`ArtifactStore.state_generation` and reconcile only when it
    # moved — one small-file read instead of a manifest-directory scan.
    generation: int = 0
    history: list[dict[str, Any]] = dataclasses.field(default_factory=list)

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, data: dict[str, Any]) -> "RolloutState":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename in the destination directory: readers see either
    the old complete file or the new complete file, never a prefix."""
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


class ArtifactStore:
    """Versioned model artifacts + rollout state for any number of engines.

    Thread-safe within one process (one lock serializes version allocation
    and state transitions) AND across processes: every state transition is
    a read-modify-write held under an advisory ``flock`` on the engine's
    ``state.lock``, because a serving fleet makes every worker a registry
    writer (each runs its own bake gate and candidate breaker — two
    simultaneous transitions must not lose one or collide on the same
    generation number).
    """

    def __init__(self, base_dir: str | None = None):
        self.base_dir = os.path.abspath(base_dir or default_registry_dir())
        self._lock = threading.RLock()
        # reentrancy bookkeeping for the cross-process transition lock
        # (rollback nests unstage); guarded by self._lock
        self._flock_depth: dict[str, int] = {}
        self._flock_fd: dict[str, int] = {}
        # cross-HOST transition lock (lease.py); one mutex per engine,
        # acquired under the flock so same-host processes never contend
        # on it. Guarded by self._lock.
        self._leases: dict[str, "lease_mod.LeaseMutex"] = {}
        # highest rollout generation this store instance has ever read or
        # written, per engine key — the floor state_generation() reports
        # when a concurrent tmp+rename makes the state file momentarily
        # unreadable (a spurious 0 would make every fleet worker reload)
        self._gen_seen: dict[str, int] = {}

    # ------------------------------------------------------------- layout
    @staticmethod
    def engine_key(engine_id: str) -> str:
        """Filesystem-safe directory name for an engine id. Engine ids may
        be absolute paths; keep a readable slug plus a collision-proof
        digest."""
        slug = re.sub(r"[^A-Za-z0-9_-]+", "-", os.path.basename(str(engine_id)))
        slug = slug.strip("-") or "engine"
        digest = hashlib.sha256(str(engine_id).encode("utf-8")).hexdigest()[:10]
        return f"{slug[:40]}-{digest}"

    def _engine_dir(self, engine_id: str) -> str:
        return os.path.join(self.base_dir, self.engine_key(engine_id))

    def _manifest_path(self, engine_id: str, version: str) -> str:
        return os.path.join(self._engine_dir(engine_id), "versions", f"{version}.json")

    def _blob_path(self, engine_id: str, sha256: str) -> str:
        return os.path.join(self._engine_dir(engine_id), "blobs", sha256)

    def _state_path(self, engine_id: str) -> str:
        return os.path.join(self._engine_dir(engine_id), "state.json")

    def _lease_for(self, engine_id: str) -> "lease_mod.LeaseMutex":
        key = self.engine_key(engine_id)
        with self._lock:
            mx = self._leases.get(key)
            if mx is None:
                mx = lease_mod.LeaseMutex(
                    os.path.join(self._engine_dir(engine_id), "state.lease"),
                    ttl_s=lease_mod.lease_ttl_s(),
                )
                self._leases[key] = mx
            return mx

    @contextlib.contextmanager
    def _state_mutex(self, engine_id: str):
        """Cross-process AND cross-host transition lock, held for the
        whole read-modify-write. Two layers:

        - Same-host fast path: an advisory ``flock`` on the engine's
          ``state.lock`` — kernel-speed, zero polling, auto-released on
          holder death. Fleet workers on one box are concurrent registry
          writers (bake gates, breaker rollbacks, the CLI); without
          this, two simultaneous transitions read the same state, one
          write is lost, and both land on the same generation number.
        - Cross-host layer: a lease file with TTL expiry + fencing
          tokens (:mod:`~predictionio_tpu_torch.registry.lease`), acquired
          UNDER the flock so only one process per host ever contends on
          it. ``flock`` is host-bound (and a no-op on many network
          mounts), so a registry on shared storage needs the lease for
          hosts the way it needs the flock for processes.
          ``PIO_REGISTRY_LEASE=0`` disables this layer.

        The in-process RLock (always held around this) serializes
        threads. Reentrant per store (``rollback`` nests ``unstage``) —
        both layers acquire at depth 0 only."""
        key = self.engine_key(engine_id)
        with self._lock:
            depth = self._flock_depth.get(key, 0)
            if depth == 0 and fcntl is not None:
                path = os.path.join(self._engine_dir(engine_id), "state.lock")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
                # blocking acquire: transitions are millisecond-scale
                fcntl.flock(fd, fcntl.LOCK_EX)
                self._flock_fd[key] = fd
            self._flock_depth[key] = depth + 1
        lease_held = False
        try:
            if depth == 0 and lease_mod.lease_enabled():
                mx = self._lease_for(engine_id)
                mx.acquire(timeout_s=max(60.0, 2.0 * mx.ttl_s))
                lease_held = True
            yield
        finally:
            if lease_held:
                try:
                    self._leases[key].release()
                except OSError:
                    logger.exception("lease release failed for %s", key)
            with self._lock:
                self._flock_depth[key] -= 1
                if self._flock_depth[key] == 0:
                    del self._flock_depth[key]
                    fd2 = self._flock_fd.pop(key, None)
                    if fd2 is not None:
                        try:
                            fcntl.flock(fd2, fcntl.LOCK_UN)
                        finally:
                            os.close(fd2)

    def engines(self) -> list[str]:
        """Engine keys present in the registry (directory names; the
        original engine id is recorded in each manifest)."""
        if not os.path.isdir(self.base_dir):
            return []
        return sorted(
            d
            for d in os.listdir(self.base_dir)
            if os.path.isdir(os.path.join(self.base_dir, d, "versions"))
        )

    # ------------------------------------------------------------ versions
    def list_versions(self, engine_id: str) -> list[ModelManifest]:
        return self.versions_by_key(self.engine_key(engine_id))

    def versions_by_key(self, engine_key: str) -> list[ModelManifest]:
        """Same listing keyed by the on-disk directory name (the admin API
        enumerates engines by key; only manifests know the original id)."""
        vdir = os.path.join(self.base_dir, engine_key, "versions")
        if not os.path.isdir(vdir):
            return []
        out: list[ModelManifest] = []
        for name in sorted(os.listdir(vdir)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(vdir, name), encoding="utf-8") as fh:
                    out.append(ModelManifest.from_json_dict(json.load(fh)))
            except (OSError, ValueError, TypeError):
                logger.warning("unreadable manifest %s (skipped)", name)
        out.sort(key=lambda m: m.version)
        return out

    def get_manifest(self, engine_id: str, version: str) -> ModelManifest | None:
        path = self._manifest_path(engine_id, version)
        if not os.path.exists(path):
            return None
        with open(path, encoding="utf-8") as fh:
            return ModelManifest.from_json_dict(json.load(fh))

    def _next_version(self, engine_id: str) -> str:
        highest = 0
        for m in self.list_versions(engine_id):
            match = _VERSION_RE.match(m.version)
            if match:
                highest = max(highest, int(match.group(1)))
        return f"v{highest + 1:06d}"

    def publish(
        self,
        manifest: ModelManifest,
        blob: bytes,
        keep_last: int | None = None,
        timing: dict[str, float] | None = None,
    ) -> ModelManifest:
        """Write the blob (content-addressed) and its manifest atomically;
        assign the next version id if the manifest doesn't carry one. The
        first published version becomes stable automatically — there is
        nothing to canary against yet. ``timing``, when given, receives the
        seconds of the blob's sha256 (``sha256_s``) and of the writes,
        state and GC included (``write_s``)."""
        with self._lock, self._state_mutex(manifest.engine_id):
            engine_id = manifest.engine_id
            state = self.get_state(engine_id)
            if not manifest.version:
                manifest.version = self._next_version(engine_id)
            if not manifest.created_at:
                manifest.created_at = ModelManifest.now_iso()
            if not manifest.parent_version:
                manifest.parent_version = state.stable
            t0 = time.perf_counter()
            manifest.blob_sha256 = hashlib.sha256(blob).hexdigest()
            t1 = time.perf_counter()
            manifest.blob_size = len(blob)
            blob_path = self._blob_path(engine_id, manifest.blob_sha256)
            if not os.path.exists(blob_path):  # dedupe by content address
                _atomic_write(blob_path, blob)
            _atomic_write(
                self._manifest_path(engine_id, manifest.version),
                json.dumps(manifest.to_json_dict(), indent=1).encode("utf-8"),
            )
            self._record(state, "publish", version=manifest.version)
            if not state.stable:
                state.stable = manifest.version
                self._record(state, "auto-stable", version=manifest.version)
            self._save_state(engine_id, state)
            if keep_last:
                self.gc(engine_id, keep_last)
            if timing is not None:
                timing["sha256_s"] = t1 - t0
                timing["write_s"] = time.perf_counter() - t1
            logger.info(
                "published %s %s (%d bytes, sha %s)",
                self.engine_key(engine_id),
                manifest.version,
                manifest.blob_size,
                manifest.blob_sha256[:12],
            )
            return manifest

    def load_blob(self, engine_id: str, version: str) -> bytes:
        """Read and *verify* one version's artifact bytes."""
        manifest = self.get_manifest(engine_id, version)
        if manifest is None:
            raise ArtifactIntegrityError(
                f"no manifest for version {version!r} of {engine_id!r}"
            )
        path = self._blob_path(engine_id, manifest.blob_sha256)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError as exc:
            raise ArtifactIntegrityError(
                f"artifact blob missing for {version}: {exc}"
            ) from exc
        if len(blob) != manifest.blob_size:
            raise ArtifactIntegrityError(
                f"artifact {version} length mismatch: manifest says "
                f"{manifest.blob_size} bytes, blob is {len(blob)}"
            )
        digest = hashlib.sha256(blob).hexdigest()
        if digest != manifest.blob_sha256:
            raise ArtifactIntegrityError(
                f"artifact {version} checksum mismatch: manifest says "
                f"{manifest.blob_sha256[:12]}…, blob hashes to {digest[:12]}…"
            )
        return blob

    def attach_ann_index(
        self,
        engine_id: str,
        version: str,
        blob: bytes,
        meta: dict[str, Any],
    ) -> ModelManifest:
        """Pin an ANN index artifact on an existing version: write the
        blob content-addressed into the engine's blob store and record it
        (sha256 + layout metadata) in the version's manifest under
        ``ann_index``. Atomic manifest rewrite under the transition lock —
        a lane loader reads either the manifest without the index or with
        the complete one, never a half-written entry."""
        with self._lock, self._state_mutex(engine_id):
            manifest = self.get_manifest(engine_id, version)
            if manifest is None:
                raise ValueError(f"unknown version {version!r}")
            sha = hashlib.sha256(blob).hexdigest()
            blob_path = self._blob_path(engine_id, sha)
            if not os.path.exists(blob_path):  # dedupe by content address
                _atomic_write(blob_path, blob)
            manifest.ann_index = {
                **meta,
                "sha256": sha,
                "bytes": len(blob),
                "attachedAt": ModelManifest.now_iso(),
            }
            _atomic_write(
                self._manifest_path(engine_id, version),
                json.dumps(manifest.to_json_dict(), indent=1).encode("utf-8"),
            )
            logger.info(
                "ann index attached to %s %s (%d bytes, sha %s)",
                self.engine_key(engine_id),
                version,
                len(blob),
                sha[:12],
            )
            return manifest

    def save_bandit_state(self, engine_id: str, state: dict[str, Any]) -> str:
        """Persist per-arm bandit posterior state in the artifact grammar:
        the canonical JSON payload is written content-addressed into the
        engine's blob store, and ``bandit.json`` becomes an atomically
        replaced pointer ``{sha256, bytes, updatedAt}`` — readers see
        either the previous complete posterior or the new one, never a
        torn write. The superseded blob is unlinked (no manifest ever
        references it, so GC would otherwise never reap it). Returns the
        new content address."""
        with self._lock, self._state_mutex(engine_id):
            blob = json.dumps(state, sort_keys=True).encode("utf-8")
            sha = hashlib.sha256(blob).hexdigest()
            pointer_path = os.path.join(
                self._engine_dir(engine_id), "bandit.json"
            )
            old_sha = ""
            try:
                with open(pointer_path, "rb") as fh:
                    old_sha = str(json.loads(fh.read()).get("sha256", ""))
            except (OSError, ValueError):
                pass
            blob_path = self._blob_path(engine_id, sha)
            if not os.path.exists(blob_path):  # dedupe by content address
                _atomic_write(blob_path, blob)
            _atomic_write(
                pointer_path,
                json.dumps(
                    {
                        "sha256": sha,
                        "bytes": len(blob),
                        "updatedAt": ModelManifest.now_iso(),
                    },
                    indent=1,
                ).encode("utf-8"),
            )
            if old_sha and old_sha != sha:
                try:
                    os.unlink(self._blob_path(engine_id, old_sha))
                except OSError:
                    pass
            return sha

    def load_bandit_state(self, engine_id: str) -> dict[str, Any] | None:
        """Read the bandit posterior back through its pointer; a missing,
        torn, or digest-mismatched artifact reads as None (the bandit
        restarts with fresh priors rather than trusting corrupt reward
        history)."""
        pointer_path = os.path.join(self._engine_dir(engine_id), "bandit.json")
        try:
            with open(pointer_path, "rb") as fh:
                pointer = json.loads(fh.read().decode("utf-8"))
            sha = str(pointer["sha256"])
            with open(self._blob_path(engine_id, sha), "rb") as fh:
                blob = fh.read()
            if hashlib.sha256(blob).hexdigest() != sha:
                return None
            return json.loads(blob.decode("utf-8"))
        except (OSError, ValueError, KeyError):
            return None

    def attach_eval_evidence(
        self, engine_id: str, version: str, evidence: dict[str, Any]
    ) -> ModelManifest:
        """Record an evaluation grid's evidence block on an existing
        version's manifest (the winning refit of a ``pio eval`` search —
        docs/evaluation.md). Atomic manifest rewrite under the transition
        lock, the ``attach_ann_index`` idiom: a lane loader reads either
        the manifest without the evidence or with the complete block,
        never a torn one."""
        with self._lock, self._state_mutex(engine_id):
            manifest = self.get_manifest(engine_id, version)
            if manifest is None:
                raise ValueError(f"unknown version {version!r}")
            manifest.eval_evidence = dict(evidence)
            _atomic_write(
                self._manifest_path(engine_id, version),
                json.dumps(manifest.to_json_dict(), indent=1).encode("utf-8"),
            )
            logger.info(
                "eval evidence attached to %s %s (metric %s, best %s)",
                self.engine_key(engine_id),
                version,
                evidence.get("metric"),
                evidence.get("bestScore"),
            )
            return manifest

    def load_ann_blob(
        self, engine_id: str, version: str
    ) -> tuple[bytes, dict[str, Any]] | None:
        """Read and *verify* the version's ANN index artifact. None when
        the version pins no index; :class:`ArtifactIntegrityError` when it
        does but the bytes on disk are not the bytes that were attached."""
        manifest = self.get_manifest(engine_id, version)
        if manifest is None or not manifest.ann_index:
            return None
        meta = manifest.ann_index
        sha = meta.get("sha256", "")
        path = self._blob_path(engine_id, sha)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError as exc:
            raise ArtifactIntegrityError(
                f"ann index blob missing for {version}: {exc}"
            ) from exc
        if len(blob) != int(meta.get("bytes", -1)):
            raise ArtifactIntegrityError(
                f"ann index for {version} length mismatch: manifest says "
                f"{meta.get('bytes')} bytes, blob is {len(blob)}"
            )
        digest = hashlib.sha256(blob).hexdigest()
        if digest != sha:
            raise ArtifactIntegrityError(
                f"ann index for {version} checksum mismatch: manifest says "
                f"{sha[:12]}…, blob hashes to {digest[:12]}…"
            )
        return blob, meta

    @staticmethod
    def _blob_shas_of(manifest: ModelManifest) -> set[str]:
        """Every blob a manifest pins: the model artifact plus its ANN
        index (GC must treat both as referenced)."""
        shas = {manifest.blob_sha256}
        ann_sha = (manifest.ann_index or {}).get("sha256")
        if ann_sha:
            shas.add(ann_sha)
        return shas - {""}

    def gc(self, engine_id: str, keep_last: int) -> list[str]:
        """Drop all but the newest ``keep_last`` versions, never dropping
        a version the rollout state still references. Returns the removed
        version ids."""
        with self._lock, self._state_mutex(engine_id):
            state = self.get_state(engine_id)
            pinned = {state.stable, state.candidate, state.previous_stable} - {""}
            versions = self.list_versions(engine_id)
            # keep = newest N plus everything pinned — pins must not eat
            # into the newest-N budget, or a publish with pinned count >=
            # keep_last would delete the very version it just wrote
            keep = {m.version for m in versions[-max(1, keep_last):]} | pinned
            removed: list[str] = []
            for m in versions:
                if m.version in keep:
                    continue
                try:
                    os.unlink(self._manifest_path(engine_id, m.version))
                except OSError:
                    continue
                removed.append(m.version)
            if removed:
                # delete blobs no surviving manifest references (model
                # artifacts AND ann index artifacts both count)
                live_shas: set[str] = set()
                for m in self.list_versions(engine_id):
                    live_shas |= self._blob_shas_of(m)
                for m in versions:
                    if m.version not in removed:
                        continue
                    for sha in self._blob_shas_of(m) - live_shas:
                        try:
                            os.unlink(self._blob_path(engine_id, sha))
                        except OSError:
                            pass
                logger.info(
                    "gc %s: removed %s", self.engine_key(engine_id), removed
                )
            return removed

    # --------------------------------------------------------------- state
    def get_state(self, engine_id: str) -> RolloutState:
        return self.state_by_key(self.engine_key(engine_id))

    def state_by_key(self, engine_key: str) -> RolloutState:
        """Unlocked read of the persisted rollout state. A concurrent
        writer is mid-``tmp+rename`` at any moment, so a torn or
        momentarily-missing read is expected operation, not corruption:
        retry once after a beat before concluding anything. Only a state
        file that stays unreadable is treated as fresh."""
        path = os.path.join(self.base_dir, engine_key, "state.json")
        for attempt in (0, 1):
            try:
                with open(path, encoding="utf-8") as fh:
                    state = RolloutState.from_json_dict(json.load(fh))
                with self._lock:
                    if state.generation > self._gen_seen.get(engine_key, 0):
                        self._gen_seen[engine_key] = state.generation
                return state
            except FileNotFoundError:
                # genuinely absent (fresh engine) unless this store has
                # already seen state here — then it's the rename window
                with self._lock:
                    seen = self._gen_seen.get(engine_key, 0)
                if not seen or attempt:
                    return RolloutState()
            except (OSError, ValueError, TypeError):
                if attempt:
                    logger.warning(
                        "unreadable rollout state for %s; starting fresh",
                        engine_key,
                    )
                    return RolloutState()
            time.sleep(0.01)
        return RolloutState()

    def state_generation(self, engine_id: str) -> int:
        """Cheap monotonic change detector for cross-process coordination:
        the ``generation`` counter of the persisted rollout state (0 when
        no state exists yet). One state-file read — callers poll this and
        only pay :meth:`get_state` + reconciliation when it moved.

        Never goes backwards within a store instance: when a concurrent
        transition makes the file momentarily unreadable, the last
        generation this store saw is the answer — a spurious 0 here
        would make every fleet worker's sync loop reload at once."""
        key = self.engine_key(engine_id)
        gen = self.state_by_key(key).generation
        with self._lock:
            floor = self._gen_seen.get(key, 0)
            if gen >= floor:
                self._gen_seen[key] = gen
                return gen
            return floor

    def _save_state(self, engine_id: str, state: RolloutState) -> None:
        key = self.engine_key(engine_id)
        with self._lock:
            mx = self._leases.get(key)
        if mx is not None and mx.held:
            # fencing: a holder whose lease expired mid-transition must
            # NOT persist — a newer token exists and its owner may have
            # already written. Raises LeaseLostError before any mutation.
            mx.verify()
        state.updated_at = ModelManifest.now_iso()
        state.generation += 1
        state.history = state.history[-_HISTORY_LIMIT:]
        _atomic_write(
            self._state_path(engine_id),
            json.dumps(state.to_json_dict(), indent=1).encode("utf-8"),
        )
        with self._lock:
            if state.generation > self._gen_seen.get(key, 0):
                self._gen_seen[key] = state.generation

    @staticmethod
    def _record(state: RolloutState, action: str, **fields: Any) -> None:
        state.history.append(
            {"at": ModelManifest.now_iso(), "action": action, **fields}
        )

    def stage_candidate(
        self,
        engine_id: str,
        version: str,
        mode: str = MODE_CANARY,
        fraction: float = 0.1,
    ) -> RolloutState:
        """Begin a progressive rollout: ``version`` starts taking the
        canary fraction (or shadow traffic) next to the pinned stable."""
        if mode not in (MODE_CANARY, MODE_SHADOW):
            raise ValueError(f"mode must be canary|shadow, got {mode!r}")
        if self.get_manifest(engine_id, version) is None:
            raise ValueError(f"unknown version {version!r}")
        with self._lock, self._state_mutex(engine_id):
            state = self.get_state(engine_id)
            if version == state.stable:
                raise ValueError(f"{version} is already stable")
            state.candidate = version
            state.mode = mode
            state.fraction = max(0.0, min(1.0, float(fraction)))
            state.staged_at = ModelManifest.now_iso()
            self._record(
                state, "stage", version=version, mode=mode, fraction=state.fraction
            )
            self._save_state(engine_id, state)
            return state

    def promote(self, engine_id: str, version: str | None = None) -> RolloutState:
        """Candidate (or an explicit version) becomes stable; the old
        stable is retained as the rollback target."""
        with self._lock, self._state_mutex(engine_id):
            state = self.get_state(engine_id)
            target = version or state.candidate
            if not target:
                raise ValueError("nothing to promote: no candidate staged")
            if self.get_manifest(engine_id, target) is None:
                raise ValueError(f"unknown version {target!r}")
            if target == state.stable:
                raise ValueError(f"{target} is already stable")
            state.previous_stable = state.stable
            state.stable = target
            if state.candidate and state.candidate != target:
                # promoting PAST a staged candidate obsoletes that rollout:
                # leaving it staged would report a canary no server is
                # baking and pin the orphan against GC forever
                self._record(
                    state, "unstage", version=state.candidate, reason="superseded"
                )
            state.candidate = ""
            state.mode = MODE_OFF
            state.fraction = 0.0
            self._record(
                state, "promote", version=target, from_=state.previous_stable
            )
            self._save_state(engine_id, state)
            return state

    def unstage(self, engine_id: str, reason: str = "") -> RolloutState:
        """Drop a staged candidate ONLY — the stable pin is never touched.
        A no-op when nothing is staged. This is the serving-side rollback
        primitive: the server must not inherit :meth:`rollback`'s
        previous-stable revert, or a breaker trip after a swallowed stage
        write would silently flip the registry to an older model than the
        one actually serving."""
        with self._lock, self._state_mutex(engine_id):
            state = self.get_state(engine_id)
            if state.candidate:
                dropped = state.candidate
                state.candidate = ""
                state.mode = MODE_OFF
                state.fraction = 0.0
                self._record(state, "rollback", version=dropped, reason=reason)
                self._save_state(engine_id, state)
            return state

    def rollback(self, engine_id: str, reason: str = "manual") -> RolloutState:
        """Back out: drop a staged candidate if one exists, else revert
        stable to the previous stable (post-promote regret)."""
        with self._lock, self._state_mutex(engine_id):
            state = self.get_state(engine_id)
            if state.candidate:
                return self.unstage(engine_id, reason=reason)
            if state.previous_stable:
                reverted_from = state.stable
                state.stable = state.previous_stable
                state.previous_stable = ""
                self._record(
                    state,
                    "rollback",
                    version=reverted_from,
                    to=state.stable,
                    reason=reason,
                )
            else:
                raise ValueError(
                    "nothing to roll back: no candidate staged and no "
                    "previous stable recorded"
                )
            self._save_state(engine_id, state)
            return state
