"""Multi-rank job launcher (own copy of ``predictionio_tpu/parallel/launcher.py``).

The framework creates the distributed job: ONE worker process per rank
with the ``PIO_COORDINATOR``/``PIO_NUM_PROCESSES``/``PIO_PROCESS_ID``
contract that ``parallel.distributed.maybe_initialize_distributed``
consumes; the launcher supervises them, propagates the first failure
(terminating the stragglers) and reaps everything on exit.

Two placement modes:
  - local (``num_hosts``): every worker on this machine, each with its
    ``PIO_LOCAL_RANK`` (ranks beyond the visible cards share them over
    gloo);
  - remote (``hosts=[h1, h2, ...]``): one worker per host via ``ssh`` with
    the environment contract inlined, each the only rank of its machine.
"""

from __future__ import annotations

import logging
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


def pick_free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclass
class LaunchResult:
    returncodes: list[int]

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)


@dataclass
class MultiHostLauncher:
    """Spawn + supervise one worker process per host.

    ``command`` is the worker argv (e.g. ``[sys.executable, "-m",
    "predictionio_tpu_torch.tools.cli", "train", ...]``). Each worker gets the
    coordinator env triplet; everything else is inherited.
    """

    command: list[str]
    num_hosts: int = 1
    hosts: list[str] | None = None  # remote mode when set
    coordinator_host: str | None = None
    coordinator_port: int | None = None
    env_extra: dict[str, str] = field(default_factory=dict)
    stream_logs: bool = True
    _procs: list[subprocess.Popen] = field(default_factory=list, init=False)

    def _worker_env(self, process_id: int, coordinator: str) -> dict[str, str]:
        env = dict(os.environ)
        env.update(self.env_extra)
        env["PIO_COORDINATOR"] = coordinator
        env["PIO_NUM_PROCESSES"] = str(self.n_processes)
        env["PIO_PROCESS_ID"] = str(process_id)
        env["PIO_LOCAL_RANK"] = str(process_id)
        env["PIO_LOCAL_WORLD_SIZE"] = str(self.n_processes)
        return env

    @property
    def n_processes(self) -> int:
        return len(self.hosts) if self.hosts else self.num_hosts

    @property
    def _stdout_target(self) -> int:
        # stream_logs=False must NOT leave a PIPE nobody drains: a worker
        # writing past the ~64KB OS pipe buffer would block in write() and
        # the fleet would hang forever in _supervise
        return subprocess.PIPE if self.stream_logs else subprocess.DEVNULL

    def _spawn_local(self, process_id: int, coordinator: str) -> subprocess.Popen:
        return subprocess.Popen(
            self.command,
            env=self._worker_env(process_id, coordinator),
            stdout=self._stdout_target,
            stderr=subprocess.STDOUT,
            start_new_session=True,  # isolate signals: we terminate explicitly
        )

    def _spawn_remote(
        self, host: str, process_id: int, coordinator: str
    ) -> subprocess.Popen:
        # env contract inlined into the remote command; cwd mirrored so
        # engine dirs resolve the same way on every host
        assignments = " ".join(
            f"{k}={shlex.quote(v)}"
            for k, v in {
                **self.env_extra,
                "PIO_COORDINATOR": coordinator,
                "PIO_NUM_PROCESSES": str(self.n_processes),
                "PIO_PROCESS_ID": str(process_id),
                "PIO_LOCAL_RANK": "0",
                "PIO_LOCAL_WORLD_SIZE": "1",
            }.items()
        )
        remote = f"cd {shlex.quote(os.getcwd())} && env {assignments} " + " ".join(
            shlex.quote(c) for c in self.command
        )
        return subprocess.Popen(
            ["ssh", "-o", "BatchMode=yes", host, remote],
            stdout=self._stdout_target,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )

    def _pump(self, idx: int, proc: subprocess.Popen) -> None:
        """Prefix-stream a worker's output (a fleet needs per-process
        attribution)."""
        assert proc.stdout is not None
        for line in proc.stdout:
            sys.stderr.write(f"[host {idx}] {line.decode(errors='replace')}")

    def run(self, poll_interval: float = 0.2) -> LaunchResult:
        """Launch the fleet and block until every worker exits. The first
        nonzero exit terminates the remaining workers (fail-fast, matching
        a collective job's semantics: a lost process wedges the others at
        the next collective anyway)."""
        n = self.n_processes
        host = self.coordinator_host or (
            self.hosts[0] if self.hosts else "127.0.0.1"
        )
        # hosts entries are ssh targets and may carry a user prefix
        # ("ubuntu@10.0.0.1") — the coordinator address must be a bare
        # host:port or every worker's rendezvous fails on the malformed URL
        host = host.rsplit("@", 1)[-1]
        # NOTE: with a port chosen here, remote mode assumes the port is
        # also free on the coordinator HOST (we can only probe locally);
        # pass coordinator_port explicitly to pin a known-free one
        port = self.coordinator_port or pick_free_port()
        coordinator = f"{host}:{port}"
        logger.info("launching %d workers; coordinator %s", n, coordinator)
        pumps = []
        try:
            for pid in range(n):
                if self.hosts:
                    proc = self._spawn_remote(self.hosts[pid], pid, coordinator)
                else:
                    proc = self._spawn_local(pid, coordinator)
                self._procs.append(proc)
                if self.stream_logs:
                    t = threading.Thread(
                        target=self._pump, args=(pid, proc), daemon=True
                    )
                    t.start()
                    pumps.append(t)
            return self._supervise(poll_interval, pumps)
        finally:
            self.terminate()

    def _supervise(self, poll_interval: float, pumps: list) -> LaunchResult:
        procs = self._procs
        while True:
            states = [p.poll() for p in procs]
            failed = [rc for rc in states if rc not in (None, 0)]
            if failed:
                logger.error(
                    "worker failed (rc=%d); terminating remaining workers",
                    failed[0],
                )
                self.terminate()
                break
            if all(rc is not None for rc in states):
                break
            time.sleep(poll_interval)
        for p in procs:
            p.wait()
        for t in pumps:
            t.join(timeout=2.0)
        return LaunchResult([p.returncode for p in procs])

    def terminate(self, grace_s: float = 5.0) -> None:
        """SIGTERM every live worker, escalate to SIGKILL after ``grace_s``
        (the reference Runner's shutdown hook kills its spark-submit child)."""
        live = [p for p in self._procs if p.poll() is None]
        for p in live:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        deadline = time.monotonic() + grace_s
        for p in live:
            remaining = deadline - time.monotonic()
            try:
                p.wait(timeout=max(0.1, remaining))
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                p.wait()


def launch_cli_multihost(
    cli_args: list[str],
    num_hosts: int,
    hosts: list[str] | None = None,
    env_extra: dict[str, str] | None = None,
) -> int:
    """Re-exec this framework's CLI once per host (the ``pio train
    --num-hosts N`` path). Returns an exit code: 0 iff every worker
    succeeded."""
    launcher = MultiHostLauncher(
        command=[sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *cli_args],
        num_hosts=num_hosts,
        hosts=hosts,
        env_extra=env_extra or {},
    )
    result = launcher.run()
    if not result.ok:
        logger.error("multi-host launch failed: rcs=%s", result.returncodes)
        return 1
    return 0
