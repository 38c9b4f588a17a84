"""Lease-based mutex for registry state on shared storage.

An advisory ``flock`` on a lock file alone is
correct on one box, useless the moment two hosts mount the registry over
NFS/SMB (many network filesystems map ``flock`` to a no-op, and even
where mapped, the lock dies with the NFS client, not the holder). The
multi-host fleet needs the classic distributed-lease shape instead:

- The lease is a small JSON file next to the state it guards, paired
  with an ``O_EXCL`` **claim file** that is the actual exclusion
  primitive: exactly one process can create it, and only the claimant
  writes the lease record (tmp+rename, atomic on POSIX). Rename+re-read
  alone is NOT mutual exclusion — two racers can each confirm on their
  own re-read before the other's rename lands (the two-process hammer
  reproduces this) — so the claim gates the write and the post-write
  re-read stays as a cheap second check for the steal-vs-steal edge.
- ``generation`` is the **fencing token**: monotonic across owners,
  bumped on every acquisition, *including* steals, and never reset —
  release writes an ``owner=""`` tombstone that keeps the counter, so a
  token can never be handed out twice. ``ArtifactStore._save_state`` re-checks
  the token before persisting a transition; a holder that lost its lease
  mid-critical-section gets :class:`LeaseLostError` instead of
  clobbering the thief's writes (Lamport's fencing discipline).
- Liveness: a holder that dies keeps the lease until its **TTL**
  expires, then any waiter steals it. Same-host deaths are detected
  faster: the lease records ``host:pid``, and a waiter on the same host
  whose kill-0 shows the pid gone steals immediately — preserving the
  instant-recovery property ``flock`` gave single-box deploys.

The ``flock`` fast path **stays**: ``_state_mutex`` takes the flock
first (serializing same-host processes at kernel speed, zero polling),
then the lease (serializing hosts). ``PIO_REGISTRY_LEASE=0`` disables
the lease layer entirely for strictly-local deployments.

Clock injectable; the TTL/steal machinery is unit-tested on a fake
clock and hammered across two real processes (tests/test_lease.py).

(Own copy of ``predictionio_tpu/registry/lease.py``; the same lease
files, so a JAX writer and a port writer exclude each other.)
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import socket
import tempfile
import threading
import time
import uuid
from typing import Any, Callable

logger = logging.getLogger(__name__)

DEFAULT_TTL_S = 30.0


class LeaseLostError(RuntimeError):
    """The held lease expired (or was stolen) mid-critical-section; the
    transition MUST NOT persist — a newer fencing token exists."""


class LeaseTimeoutError(TimeoutError):
    """Could not acquire the lease inside the wait budget."""


# module-level telemetry: sampled by register_lease_metrics collectors so
# every store instance in the process feeds one exposition
_COUNTS = {
    "acquires": 0,
    "steals": 0,
    "lost": 0,
    "waits": 0,
}
_GENERATIONS: dict[str, int] = {}  # lease path -> last token seen here
_COUNTS_LOCK = threading.Lock()


def _bump(key: str, n: int = 1) -> None:
    with _COUNTS_LOCK:
        _COUNTS[key] += n


@dataclasses.dataclass
class LeaseRecord:
    owner: str
    generation: int
    acquired_at: float  # wall clock (cross-host comparable enough for TTLs)
    ttl_s: float
    host: str = ""
    pid: int = 0

    def expired(self, now: float) -> bool:
        return bool(self.owner) and now >= self.acquired_at + self.ttl_s

    def free(self) -> bool:
        return not self.owner

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "LeaseRecord":
        return cls(
            owner=str(obj.get("owner", "")),
            generation=int(obj.get("generation", 0)),
            acquired_at=float(obj.get("acquired_at", 0.0)),
            ttl_s=float(obj.get("ttl_s", DEFAULT_TTL_S)),
            host=str(obj.get("host", "")),
            pid=int(obj.get("pid", 0)),
        )


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # EPERM etc: it exists
    return True


class LeaseMutex:
    """One lease file. NOT reentrant and NOT thread-safe by itself — the
    store holds its own process-level locks above this (flock serializes
    same-host processes; ``ArtifactStore._lock`` serializes threads)."""

    def __init__(
        self,
        path: str,
        owner: str | None = None,
        ttl_s: float = DEFAULT_TTL_S,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        poll_interval_s: float | None = None,
    ):
        self.path = path
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.owner = owner or f"{self.host}:{self.pid}:{uuid.uuid4().hex[:8]}"
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._sleep = sleep
        self.poll_interval_s = (
            poll_interval_s
            if poll_interval_s is not None
            else min(1.0, max(0.05, self.ttl_s / 20.0))
        )
        self.generation = 0  # token from OUR last successful acquire
        self._held = False
        # (claim content, first seen at) — how long the same orphan claim
        # has sat over a free record; past ttl_s it is droppable
        self._claim_seen: tuple[str, float] | None = None

    # ----------------------------------------------------------------- file
    def read(self) -> LeaseRecord | None:
        """Current lease record, or None when no lease file exists yet.
        A torn/corrupt read (mid-rename on a sloppy filesystem) is
        retried once, then treated as contention — never as 'free'."""
        for attempt in (0, 1):
            try:
                with open(self.path, encoding="utf-8") as fh:
                    return LeaseRecord.from_json(json.load(fh))
            except FileNotFoundError:
                return None
            except (OSError, ValueError):
                if attempt == 0:
                    self._sleep(0.01)
        # unreadable twice: report a synthetic held-forever record so the
        # caller waits (and eventually times out loudly) instead of
        # acquiring on top of garbage
        return LeaseRecord(
            owner="<unreadable>",
            generation=0,
            acquired_at=self._clock(),
            ttl_s=self.ttl_s,
        )

    def _write(self, rec: LeaseRecord) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".lease-")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                json.dump(rec.to_json(), fh)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------- protocol
    def _stealable(self, cur: LeaseRecord, now: float) -> bool:
        if cur.free() or cur.owner == self.owner:
            return True
        if cur.expired(now):
            return True
        # same-host fast steal: the holder's pid is visibly gone — the
        # instant-recovery property flock gave single-box deploys
        if cur.host == self.host and cur.pid and not _pid_alive(cur.pid):
            return True
        return False

    @property
    def claim_path(self) -> str:
        return self.path + ".claim"

    def _try_claim(self) -> bool:
        """Atomically create the claim file (O_EXCL). True = we hold the
        exclusion primitive and may write the lease record."""
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        try:
            fd = os.open(
                self.claim_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY
            )
        except FileExistsError:
            return False
        try:
            os.write(
                fd,
                json.dumps(
                    {"owner": self.owner, "host": self.host, "pid": self.pid}
                ).encode("utf-8"),
            )
        finally:
            os.close(fd)
        return True

    def _drop_claim(self) -> None:
        try:
            os.unlink(self.claim_path)
        except OSError:
            pass

    def _read_claim(self) -> dict[str, Any]:
        try:
            with open(self.claim_path, encoding="utf-8") as fh:
                obj = json.load(fh)
            return obj if isinstance(obj, dict) else {}
        except (OSError, ValueError):
            return {}

    def _claim_is_stale(self, cur: LeaseRecord | None, now: float) -> bool:
        """May the existing claim be unlinked? ONLY when it provably
        belongs to a dead or expired holder — never on a hunch, because
        unlinking a LIVE claimant's file would hand exclusion to two
        processes at once (the very race the claim exists to close):

        - claim owner == the record's owner and the record is stealable
          (expired TTL / dead pid): the holder died holding both;
        - claim's own host:pid is this host and the pid is gone: a
          claimant that crashed between claiming and writing the record;
        - the same claim content has sat over a free record for a full
          TTL of OUR observation: a foreign-host claimant crashed
          mid-acquire (judged on the injected clock, so fake-clock tests
          and real deployments agree on the rule)."""
        claim = self._read_claim()
        if not claim:
            # unreadable/half-written: judge it by observation time below
            claim = {"owner": "<unreadable>"}
        c_owner = str(claim.get("owner", ""))
        if cur is not None and not cur.free():
            self._claim_seen = None  # record owned: observation over
            if c_owner == cur.owner:
                return self._stealable(cur, now)
            return False  # someone else's live hold is in flight: wait
        if (
            str(claim.get("host", "")) == self.host
            and int(claim.get("pid", 0) or 0)
            and not _pid_alive(int(claim["pid"]))
        ):
            return True
        seen = self._claim_seen
        if seen is not None and seen[0] == c_owner:
            return now - seen[1] >= self.ttl_s
        self._claim_seen = (c_owner, now)
        return False

    def acquire(self, timeout_s: float = 60.0) -> int:
        """Block until held (or :class:`LeaseTimeoutError`); returns the
        fencing token. Two layers: the O_EXCL claim file serializes
        writers; the lease record decides liveness (TTL / dead-pid
        steals) and carries the token."""
        deadline = self._clock() + timeout_s
        waited = False
        claimed = False
        try:
            while True:
                now = self._clock()
                cur = self.read()
                if not claimed:
                    claimed = self._try_claim()
                    if not claimed:
                        if self._read_claim().get("owner") == self.owner:
                            # our own leftover (a lost confirm edge, an
                            # aborted acquire): it is already exclusion
                            claimed = True
                        elif self._claim_is_stale(cur, now):
                            # a claimant that died holding the claim
                            # (with or without having written its
                            # record): clear the orphan and race O_EXCL
                            # — exactly one waiter wins
                            self._drop_claim()
                            self._claim_seen = None
                            claimed = self._try_claim()
                if claimed:
                    cur = self.read()
                    if cur is None or self._stealable(cur, now):
                        stolen = (
                            cur is not None
                            and not cur.free()
                            and cur.owner != self.owner
                        )
                        cand = LeaseRecord(
                            owner=self.owner,
                            generation=(cur.generation if cur else 0) + 1,
                            acquired_at=now,
                            ttl_s=self.ttl_s,
                            host=self.host,
                            pid=self.pid,
                        )
                        self._write(cand)
                        # steal-vs-steal edge (a racer whose claim was
                        # cleared underneath it): re-read to confirm our
                        # record actually survived
                        back = self.read()
                        if (
                            back is not None
                            and back.owner == self.owner
                            and back.generation == cand.generation
                        ):
                            self.generation = cand.generation
                            self._held = True
                            claimed = False  # ours now; keep the file
                            _bump("acquires")
                            if stolen:
                                _bump("steals")
                                logger.warning(
                                    "lease %s stolen from %s (token %d)",
                                    self.path,
                                    cur.owner,
                                    cand.generation,
                                )
                            with _COUNTS_LOCK:
                                _GENERATIONS[self.path] = cand.generation
                            return cand.generation
                        claimed = False  # lost the edge; start over
                    # else: live foreign record under our claim (we raced
                    # a release in progress) — hold the claim and poll
                if self._clock() >= deadline:
                    holder = cur.owner if cur else "?"
                    raise LeaseTimeoutError(
                        f"lease {self.path} held by {holder!r} past "
                        f"{timeout_s:.1f}s wait budget"
                    )
                if not waited:
                    waited = True
                    _bump("waits")
                self._sleep(self.poll_interval_s)
        except BaseException:
            if claimed and self._read_claim().get("owner") == self.owner:
                self._drop_claim()
            raise

    def verify(self) -> int:
        """Fencing check: still ours? Returns the token, or raises
        :class:`LeaseLostError`. Called by the store immediately before
        every persisted transition."""
        cur = self.read()
        if (
            cur is None
            or cur.owner != self.owner
            or cur.generation != self.generation
        ):
            self._held = False
            _bump("lost")
            raise LeaseLostError(
                f"lease {self.path} no longer held (token {self.generation}; "
                f"current: {cur.to_json() if cur else 'missing'})"
            )
        return self.generation

    def renew(self) -> int:
        """Re-stamp acquired_at (long critical sections); fencing token
        unchanged. Raises :class:`LeaseLostError` when already lost."""
        self.verify()
        self._write(
            LeaseRecord(
                owner=self.owner,
                generation=self.generation,
                acquired_at=self._clock(),
                ttl_s=self.ttl_s,
                host=self.host,
                pid=self.pid,
            )
        )
        return self.generation

    def release(self) -> None:
        """Write the free tombstone (generation preserved — tokens are
        never handed out twice). Releasing a lease someone already stole is a
        no-op: their record must survive."""
        if not self._held:
            return
        self._held = False
        cur = self.read()
        if (
            cur is None
            or cur.owner != self.owner
            or cur.generation != self.generation
        ):
            return  # stolen: the thief's record AND claim must survive
        self._write(
            LeaseRecord(
                owner="",
                generation=self.generation,
                acquired_at=self._clock(),
                ttl_s=self.ttl_s,
            )
        )
        # ownership-checked: after the release/steal interleave the claim
        # file may already be a waiter's — unlinking theirs would hand
        # exclusion to two processes at once
        if self._read_claim().get("owner") == self.owner:
            self._drop_claim()

    @property
    def held(self) -> bool:
        return self._held

    def __enter__(self) -> "LeaseMutex":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


def lease_enabled() -> bool:
    """``PIO_REGISTRY_LEASE=0`` opts strictly-local deployments out of
    the lease layer (flock alone, the pre-PR-17 behavior)."""
    return os.environ.get("PIO_REGISTRY_LEASE", "1") not in ("0", "false", "no")


def lease_ttl_s() -> float:
    try:
        return float(os.environ.get("PIO_REGISTRY_LEASE_TTL", DEFAULT_TTL_S))
    except ValueError:
        return DEFAULT_TTL_S


def register_lease_metrics(metrics: Any) -> None:
    """Export the process-wide lease counters as ``pio_registry_lease_*``
    (docs/observability.md §Registry). Idempotent per registry — the
    MetricsRegistry returns the existing instrument on re-registration."""
    m_acquires = metrics.counter(
        "pio_registry_lease_acquires_total",
        "registry lease acquisitions by this process (steals included)",
    )
    m_steals = metrics.counter(
        "pio_registry_lease_steals_total",
        "leases taken over from a dead/expired holder (TTL expiry or "
        "same-host pid-gone fast path)",
    )
    m_lost = metrics.counter(
        "pio_registry_lease_lost_total",
        "fencing-token rejections: transitions aborted because the lease "
        "was stolen mid-critical-section",
    )
    m_waits = metrics.counter(
        "pio_registry_lease_waits_total",
        "acquire calls that had to wait on another holder",
    )
    m_gen = metrics.gauge(
        "pio_registry_lease_generation",
        "current fencing token per lease file (monotonic across owners; "
        "a persisted transition always carries the token that wrote it)",
        labelnames=("lease",),
    )

    def collect() -> None:
        with _COUNTS_LOCK:
            counts = dict(_COUNTS)
            gens = dict(_GENERATIONS)
        m_acquires.set_total(float(counts["acquires"]))
        m_steals.set_total(float(counts["steals"]))
        m_lost.set_total(float(counts["lost"]))
        m_waits.set_total(float(counts["waits"]))
        for path, gen in gens.items():
            m_gen.set(
                float(gen),
                lease=os.path.basename(os.path.dirname(path)) or path,
            )

    metrics.register_collector(collect)


__all__ = [
    "DEFAULT_TTL_S",
    "LeaseLostError",
    "LeaseMutex",
    "LeaseRecord",
    "LeaseTimeoutError",
    "lease_enabled",
    "lease_ttl_s",
    "register_lease_metrics",
]
