"""Pluggable host runtime: where the fleet's worker processes live.

Port of ``predictionio_tpu/fleet/hostrt.py``, unchanged: the drivers only
spawn and signal processes, so nothing here knows the device. The
launcher hides the card from a cpu-fallback worker (``fleet/launch.py``).

Every robustness property of the fleet — zero-5xx
restarts, crash ladders, incident bundles, autoscaling — silently
assumed one machine: the supervisor ``Popen``ed workers next to itself.
This module breaks that assumption with a small driver interface
(``spawn`` / ``signal`` / ``poll`` / ``fetch_log_tail`` / ``probe``) and
a declared host inventory, so the same supervisor policy places workers
across N boxes:

- :class:`LocalHostDriver` — the original ``subprocess.Popen`` path,
  refactored to be *one driver among several* instead of the hard-wired
  default. ``--hosts`` unset collapses to exactly this, byte-for-byte.
- :class:`SshHostDriver` — stdlib subprocess-over-``ssh``. The local ssh
  client *is* the process handle: its stdout mirrors the remote worker's
  (so the logbook keeps capturing crash evidence with zero new
  machinery) and its exit status mirrors the remote exit status.
- :class:`ContainerHostDriver` — docker/podman CLI. One attached
  ``<engine> run`` client per worker; signals go through
  ``<engine> kill -s`` so the *container's* pid 1 gets them, not the
  attached client.
- :class:`FakeHostDriver` — real local processes grouped under fake
  host names, with a host-level kill switch. This is the chaos lever:
  ``kill_host()`` SIGKILLs every resident process *and* fails the
  host's liveness probe from then on, which is exactly what a kernel
  panic looks like from the supervisor's chair. CI drives the two-host
  survive-host-death gate through it without needing a second machine.

Inventory syntax (``--hosts``)::

    --hosts local:2,ssh@node1:4,container@pio-worker:2,fake@b:2

i.e. comma-separated ``[driver@]host:slots``; a bare ``host:slots``
means the local driver. Slots bound placement — the supervisor's
host-aware spawn path refuses to overfill a box.

Blocking by design: drivers shell out (ssh handshakes, docker starts).
The supervisor runs ``tick()`` on an executor thread, never the serving
event loop — the same rule the autoscaler and incident captures follow.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import signal as _signal
import subprocess
import time
from typing import IO, Any, Callable

from predictionio_tpu_torch.fleet.worklog import WorkerLogBook

logger = logging.getLogger(__name__)

DRIVER_LOCAL = "local"
DRIVER_SSH = "ssh"
DRIVER_CONTAINER = "container"
DRIVER_FAKE = "fake"

_KNOWN_DRIVERS = (DRIVER_LOCAL, DRIVER_SSH, DRIVER_CONTAINER, DRIVER_FAKE)


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One box in the fleet inventory: a stable name (metric label,
    placement identity), how many worker slots it offers, which driver
    reaches it, and the address the gateway connects to its workers on
    (loopback for local/fake/container-with-host-network, the ssh target
    host otherwise)."""

    name: str
    slots: int
    driver: str = DRIVER_LOCAL
    address: str = ""  # ssh target (user@host) or container image
    connect_ip: str = "127.0.0.1"


def parse_hosts(spec: str) -> list[HostSpec]:
    """``[driver@]host:slots`` comma list -> inventory. Raises
    ``ValueError`` with an operator-grade message on malformed entries,
    duplicate names, unknown drivers, or non-positive slots."""
    hosts: list[HostSpec] = []
    seen: set[str] = set()
    for raw in (p.strip() for p in spec.split(",")):
        if not raw:
            continue
        head, sep, slots_s = raw.rpartition(":")
        if not sep or not head:
            raise ValueError(
                f"--hosts entry {raw!r}: expected [driver@]host:slots "
                "(e.g. local:2 or ssh@node1:4)"
            )
        try:
            slots = int(slots_s)
        except ValueError:
            raise ValueError(
                f"--hosts entry {raw!r}: slots must be an integer"
            ) from None
        if slots <= 0:
            raise ValueError(f"--hosts entry {raw!r}: slots must be >= 1")
        driver, sep, host = head.partition("@")
        if not sep:
            driver, host = DRIVER_LOCAL, head
        if driver not in _KNOWN_DRIVERS:
            raise ValueError(
                f"--hosts entry {raw!r}: unknown driver {driver!r} "
                f"(known: {', '.join(_KNOWN_DRIVERS)})"
            )
        if not host:
            raise ValueError(f"--hosts entry {raw!r}: empty host name")
        name = host
        address = ""
        connect_ip = "127.0.0.1"
        if driver == DRIVER_SSH:
            address = host
            # "user@host" ssh targets keep the user out of the dial addr
            name = host.rpartition("@")[2]
            connect_ip = name
        elif driver == DRIVER_CONTAINER:
            # the entry names the image; the host *name* is the image too
            # (one logical box per image entry), reachable on loopback via
            # --network host
            address = host
        if name in seen:
            raise ValueError(f"--hosts: duplicate host name {name!r}")
        seen.add(name)
        hosts.append(
            HostSpec(
                name=name,
                slots=slots,
                driver=driver,
                address=address,
                connect_ip=connect_ip,
            )
        )
    if not hosts:
        raise ValueError("--hosts: empty inventory")
    return hosts


class HostDriver:
    """The driver contract. All methods may block (subprocess waits, ssh
    handshakes) — callers run them on executor threads."""

    kind = "abstract"

    def spawn(
        self,
        host: HostSpec,
        name: str,
        argv: list[str],
        env: dict[str, str] | None = None,
    ) -> Any:  # ProcessHandle
        raise NotImplementedError

    def signal(self, host: HostSpec, name: str, handle: Any, sig: int) -> None:
        """Deliver ``sig`` to the worker. The default reaches through the
        local handle (Popen.send_signal); remote drivers override to
        signal the far side."""
        try:
            handle.send_signal(sig)
        except (OSError, ValueError):
            pass

    def poll(self, handle: Any) -> int | None:
        return handle.poll()

    def fetch_log_tail(
        self, host: HostSpec, name: str, max_bytes: int = 8192
    ) -> str:
        """Last bytes of the worker's captured output — the crash and
        host-death evidence incident bundles embed."""
        return ""

    def probe(self, host: HostSpec) -> bool:
        """Host-level liveness: can this driver still reach the box at
        all? (Distinct from per-worker exits: one worker dying is a
        crash; the probe failing is a *host death* and every resident
        worker is gone with it.)"""
        return True


class LocalHostDriver(HostDriver):
    """The original fleet spawn path (``worklog.spawn_with_log``) as a
    driver. The machine running the supervisor is by definition alive,
    so the probe never fails."""

    kind = DRIVER_LOCAL

    def __init__(self, logbook: WorkerLogBook | None = None):
        self.logbook = logbook

    def _open_log(self, name: str) -> IO[bytes] | None:
        return None if self.logbook is None else self.logbook.open_for(name)

    def spawn(
        self,
        host: HostSpec,
        name: str,
        argv: list[str],
        env: dict[str, str] | None = None,
    ) -> Any:
        fh = self._open_log(name)
        kw: dict[str, Any] = {}
        if env is not None:
            kw["env"] = env
        if fh is not None:
            kw["stdout"] = fh
            kw["stderr"] = subprocess.STDOUT
        try:
            return subprocess.Popen(argv, **kw)
        finally:
            if fh is not None:
                fh.close()

    def fetch_log_tail(
        self, host: HostSpec, name: str, max_bytes: int = 8192
    ) -> str:
        if self.logbook is None:
            return ""
        return self.logbook.tail(name, max_bytes)


class SshHostDriver(HostDriver):
    """Workers on a remote box over plain ``ssh`` (stdlib subprocess, no
    agent/library deps). The local ssh client is the handle: its stdout
    carries the remote worker's output into the logbook, its exit status
    mirrors the remote one, and killing it hangs up the session (sshd
    HUPs the remote process group). TERM/KILL are *also* delivered
    remotely via ``ssh <host> pkill`` keyed on the worker name, because
    a hangup alone races the remote drain."""

    kind = DRIVER_SSH

    def __init__(
        self,
        logbook: WorkerLogBook | None = None,
        ssh_argv: tuple[str, ...] = ("ssh", "-o", "BatchMode=yes"),
        probe_timeout_s: float = 5.0,
    ):
        self.logbook = logbook
        self.ssh_argv = list(ssh_argv)
        self.probe_timeout_s = probe_timeout_s

    def _remote_cmd(
        self, name: str, argv: list[str], env: dict[str, str] | None
    ) -> str:
        import shlex

        exports = " ".join(
            f"{k}={shlex.quote(v)}" for k, v in sorted((env or {}).items())
        )
        cmd = " ".join(shlex.quote(a) for a in argv)
        # PIO_WORKER_NAME tags the remote process so signal() can pkill
        # exactly this worker and nothing else on the box
        tag = f"PIO_WORKER_NAME={shlex.quote(name)}"
        return f"exec env {tag} {exports} {cmd}".replace("  ", " ")

    def spawn(
        self,
        host: HostSpec,
        name: str,
        argv: list[str],
        env: dict[str, str] | None = None,
    ) -> Any:
        fh = None if self.logbook is None else self.logbook.open_for(name)
        kw: dict[str, Any] = {}
        if fh is not None:
            kw["stdout"] = fh
            kw["stderr"] = subprocess.STDOUT
        target = host.address or host.name
        try:
            return subprocess.Popen(
                [*self.ssh_argv, target, self._remote_cmd(name, argv, env)],
                **kw,
            )
        finally:
            if fh is not None:
                fh.close()

    def signal(self, host: HostSpec, name: str, handle: Any, sig: int) -> None:
        target = host.address or host.name
        signame = {_signal.SIGTERM: "TERM", _signal.SIGKILL: "KILL"}.get(
            sig, str(int(sig))
        )
        try:
            subprocess.run(
                [
                    *self.ssh_argv,
                    target,
                    f"pkill -{signame} -f PIO_WORKER_NAME={name}",
                ],
                timeout=self.probe_timeout_s,
                capture_output=True,
            )
        except (OSError, subprocess.SubprocessError):
            # the remote signal failing (host gone) falls back to the
            # hangup path: killing the client tears the session down
            pass
        try:
            handle.send_signal(sig)
        except (OSError, ValueError):
            pass

    def fetch_log_tail(
        self, host: HostSpec, name: str, max_bytes: int = 8192
    ) -> str:
        # the ssh client's stdout == the remote worker's stdout, so the
        # local logbook already holds the evidence
        if self.logbook is None:
            return ""
        return self.logbook.tail(name, max_bytes)

    def probe(self, host: HostSpec) -> bool:
        target = host.address or host.name
        try:
            rc = subprocess.run(
                [*self.ssh_argv, target, "true"],
                timeout=self.probe_timeout_s,
                capture_output=True,
            ).returncode
        except (OSError, subprocess.SubprocessError):
            return False
        return rc == 0


class ContainerHostDriver(HostDriver):
    """Workers inside docker/podman containers, driven purely through
    the engine CLI (no SDK dep). Each worker is one attached
    ``<engine> run --rm`` client (stdout -> logbook); signals route
    through ``<engine> kill -s`` so the container's pid 1 receives them;
    the probe asks the engine daemon for liveness."""

    kind = DRIVER_CONTAINER

    def __init__(
        self,
        logbook: WorkerLogBook | None = None,
        engine: str | None = None,
        extra_run_args: tuple[str, ...] = ("--network", "host"),
        probe_timeout_s: float = 5.0,
    ):
        self.logbook = logbook
        self.engine = engine or self._find_engine()
        self.extra_run_args = list(extra_run_args)
        self.probe_timeout_s = probe_timeout_s

    @staticmethod
    def _find_engine() -> str:
        for cand in ("docker", "podman"):
            if shutil.which(cand):
                return cand
        return "docker"  # fail loudly at spawn time with the real error

    @staticmethod
    def container_name(host: HostSpec, name: str) -> str:
        return f"pio-{host.name}-{name}".replace("/", "-").replace(":", "-")

    def spawn(
        self,
        host: HostSpec,
        name: str,
        argv: list[str],
        env: dict[str, str] | None = None,
    ) -> Any:
        fh = None if self.logbook is None else self.logbook.open_for(name)
        kw: dict[str, Any] = {}
        if fh is not None:
            kw["stdout"] = fh
            kw["stderr"] = subprocess.STDOUT
        env_args: list[str] = []
        for k, v in sorted((env or {}).items()):
            env_args += ["-e", f"{k}={v}"]
        cname = self.container_name(host, name)
        image = host.address or host.name
        try:
            return subprocess.Popen(
                [
                    self.engine,
                    "run",
                    "--rm",
                    "--name",
                    cname,
                    *self.extra_run_args,
                    *env_args,
                    image,
                    *argv,
                ],
                **kw,
            )
        finally:
            if fh is not None:
                fh.close()

    def signal(self, host: HostSpec, name: str, handle: Any, sig: int) -> None:
        signame = {_signal.SIGTERM: "TERM", _signal.SIGKILL: "KILL"}.get(
            sig, str(int(sig))
        )
        try:
            subprocess.run(
                [
                    self.engine,
                    "kill",
                    "-s",
                    signame,
                    self.container_name(host, name),
                ],
                timeout=self.probe_timeout_s,
                capture_output=True,
            )
        except (OSError, subprocess.SubprocessError):
            try:
                handle.send_signal(sig)
            except (OSError, ValueError):
                pass

    def fetch_log_tail(
        self, host: HostSpec, name: str, max_bytes: int = 8192
    ) -> str:
        if self.logbook is not None:
            local = self.logbook.tail(name, max_bytes)
            if local:
                return local
        try:
            out = subprocess.run(
                [
                    self.engine,
                    "logs",
                    "--tail",
                    "100",
                    self.container_name(host, name),
                ],
                timeout=self.probe_timeout_s,
                capture_output=True,
            )
            return (out.stdout + out.stderr).decode(
                "utf-8", errors="replace"
            )[-max_bytes:]
        except (OSError, subprocess.SubprocessError):
            return ""

    def probe(self, host: HostSpec) -> bool:
        try:
            rc = subprocess.run(
                [self.engine, "info", "--format", "{{.ID}}"],
                timeout=self.probe_timeout_s,
                capture_output=True,
            ).returncode
        except (OSError, subprocess.SubprocessError):
            return False
        return rc == 0


class FakeHostDriver(HostDriver):
    """Chaos-grade fake: REAL local processes, partitioned under fake
    host names, each host with a liveness switch. ``kill_host()``
    SIGKILLs every resident process and flips the probe to dead —
    indistinguishable, from the supervisor's chair, from pulling the
    power cord on a box. The two-host survive-host-death CI gate runs on
    this driver so it needs no second machine and no container engine."""

    kind = DRIVER_FAKE

    def __init__(self, logbook: WorkerLogBook | None = None):
        self.logbook = logbook
        self._local = LocalHostDriver(logbook)
        self._alive: dict[str, bool] = {}
        self._resident: dict[str, dict[str, Any]] = {}  # host -> name -> proc

    def spawn(
        self,
        host: HostSpec,
        name: str,
        argv: list[str],
        env: dict[str, str] | None = None,
    ) -> Any:
        if not self._alive.setdefault(host.name, True):
            raise OSError(f"fake host {host.name!r} is down")
        proc = self._local.spawn(host, name, argv, env)
        self._resident.setdefault(host.name, {})[name] = proc
        return proc

    def signal(self, host: HostSpec, name: str, handle: Any, sig: int) -> None:
        self._local.signal(host, name, handle, sig)

    def fetch_log_tail(
        self, host: HostSpec, name: str, max_bytes: int = 8192
    ) -> str:
        return self._local.fetch_log_tail(host, name, max_bytes)

    def probe(self, host: HostSpec) -> bool:
        return self._alive.setdefault(host.name, True)

    def kill_host(self, host_name: str) -> int:
        """Pull the cord: SIGKILL every resident process, fail the probe
        from now on. Returns how many processes died."""
        self._alive[host_name] = False
        killed = 0
        for proc in self._resident.get(host_name, {}).values():
            if proc.poll() is None:
                try:
                    proc.kill()
                    killed += 1
                except OSError:
                    pass
        logger.warning(
            "fake host %s killed (%d resident processes)", host_name, killed
        )
        return killed

    def revive_host(self, host_name: str) -> None:
        self._alive[host_name] = True
        self._resident.pop(host_name, None)


def make_driver(
    kind: str, logbook: WorkerLogBook | None = None
) -> HostDriver:
    if kind == DRIVER_LOCAL:
        return LocalHostDriver(logbook)
    if kind == DRIVER_SSH:
        return SshHostDriver(logbook)
    if kind == DRIVER_CONTAINER:
        return ContainerHostDriver(logbook)
    if kind == DRIVER_FAKE:
        return FakeHostDriver(logbook)
    raise ValueError(f"unknown host driver {kind!r}")


class HostRuntime:
    """The inventory + its drivers: one shared driver instance per
    driver kind (the fake driver's host-liveness state must be shared
    across hosts it serves), spawn/signal/tail routed by the worker's
    home host, and the probe the supervisor's host-death detection
    polls."""

    def __init__(
        self,
        hosts: list[HostSpec],
        logbook: WorkerLogBook | None = None,
        drivers: dict[str, HostDriver] | None = None,
    ):
        if not hosts:
            raise ValueError("HostRuntime needs at least one host")
        self._hosts = {h.name: h for h in hosts}
        if len(self._hosts) != len(hosts):
            raise ValueError("duplicate host names in inventory")
        self.logbook = logbook
        self._drivers: dict[str, HostDriver] = dict(drivers or {})
        for h in hosts:
            if h.driver not in self._drivers:
                self._drivers[h.driver] = make_driver(h.driver, logbook)

    # ------------------------------------------------------------- inventory
    def hosts(self) -> list[HostSpec]:
        return list(self._hosts.values())

    def host(self, name: str) -> HostSpec:
        try:
            return self._hosts[name]
        except KeyError:
            raise KeyError(f"unknown host {name!r} in fleet inventory") from None

    def driver_for(self, host_name: str) -> HostDriver:
        return self._drivers[self.host(host_name).driver]

    def total_slots(self) -> int:
        return sum(h.slots for h in self._hosts.values())

    # ------------------------------------------------------------- operations
    def spawn_worker(
        self,
        host_name: str,
        worker_name: str,
        argv: list[str],
        env: dict[str, str] | None = None,
    ) -> Any:
        host = self.host(host_name)
        return self.driver_for(host_name).spawn(host, worker_name, argv, env)

    def signal_worker(
        self, host_name: str, worker_name: str, handle: Any, sig: int
    ) -> None:
        host = self.host(host_name)
        self.driver_for(host_name).signal(host, worker_name, handle, sig)

    def log_tail(
        self, host_name: str, worker_name: str, max_bytes: int = 8192
    ) -> str:
        host = self.host(host_name)
        return self.driver_for(host_name).fetch_log_tail(
            host, worker_name, max_bytes
        )

    def probe(self, host_name: str) -> bool:
        host = self.host(host_name)
        try:
            return bool(self.driver_for(host_name).probe(host))
        except Exception:
            logger.exception("host probe failed for %s", host_name)
            return False


def assign_hosts(
    n: int,
    hosts: list[HostSpec],
    taken: dict[str, int] | None = None,
) -> list[str]:
    """Boot-time placement: deal ``n`` workers across the inventory
    breadth-first (fill hosts evenly, never past their slots). Raises
    ``ValueError`` when the inventory is too small — a fleet that cannot
    fit should refuse to boot, not overfill a box."""
    load = {h.name: 0 for h in hosts}
    for name, count in (taken or {}).items():
        if name in load:
            load[name] = count
    order = list(hosts)
    out: list[str] = []
    for _ in range(n):
        free = [h for h in order if load[h.name] < h.slots]
        if not free:
            total = sum(h.slots for h in hosts)
            raise ValueError(
                f"host inventory has {total} slots but "
                f"{n + sum((taken or {}).values())} workers requested "
                "(grow --hosts or shrink --fleet)"
            )
        pick = min(free, key=lambda h: (load[h.name] / h.slots, h.name))
        load[pick.name] += 1
        out.append(pick.name)
    return out


__all__ = [
    "ContainerHostDriver",
    "DRIVER_CONTAINER",
    "DRIVER_FAKE",
    "DRIVER_LOCAL",
    "DRIVER_SSH",
    "FakeHostDriver",
    "HostDriver",
    "HostRuntime",
    "HostSpec",
    "LocalHostDriver",
    "SshHostDriver",
    "assign_hosts",
    "make_driver",
    "parse_hosts",
]
