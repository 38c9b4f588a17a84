"""Helpers shared by the port's template parity tests (tests/test_torch_*.py):
the same events into both packages' stores, shared ALS initial factors, the
tie-aware comparison of two ranked answers, and a CLI drive of the port
from ``app new`` to ``POST /queries.json`` in subprocesses."""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def write_events(path: Path, events: list[dict]) -> Path:
    path.write_text("".join(json.dumps(e) + "\n" for e in events))
    return path


def event_time(k: int, day: int = 1) -> str:
    """A distinct time per k (one second apart), so both stores read one
    row order."""
    return f"2024-03-{day:02d}T{k // 3600:02d}:{k // 60 % 60:02d}:{k % 60:02d}.000Z"


def jax_store(memory_storage, app: str, events_path: Path):
    """The JAX package's memory store holding the file's events, and a
    training context on it."""
    from predictionio_tpu.data.storage.base import App
    from predictionio_tpu.tools.import_export import import_events
    from predictionio_tpu.workflow.context import WorkflowContext as JaxContext

    memory_storage.get_meta_data_apps().insert(App(0, app))
    import_events(str(events_path), app, storage=memory_storage)
    return JaxContext(_storage=memory_storage, app_name=app)


PORT_BACKENDS = ("memory", "sqlite")  # the port's backends a template test runs on


def port_storage_env(tmp_path: Path, backend: str = "sqlite") -> dict[str, str]:
    """The ``PIO_STORAGE_*`` environment of an isolated port storage: every
    repository on the memory backend or on one sqlite file under
    ``tmp_path``; ``jsonl`` puts the events in JSON-lines files and the
    metadata and models in sqlite."""
    home = tmp_path / "port_home"
    home.mkdir(parents=True, exist_ok=True)
    env = {"PIO_FS_BASEDIR": str(home)}
    if backend == "memory":
        env["PIO_STORAGE_SOURCES_S_TYPE"] = "memory"
    elif backend in ("sqlite", "jsonl"):
        env["PIO_STORAGE_SOURCES_S_TYPE"] = "sqlite"
        env["PIO_STORAGE_SOURCES_S_PATH"] = str(home / "pio.db")
    else:
        raise ValueError(backend)
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "S"
    if backend == "jsonl":
        env["PIO_STORAGE_SOURCES_J_TYPE"] = "jsonl"
        env["PIO_STORAGE_SOURCES_J_PATH"] = str(home / "events")
        env["PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE"] = "J"
    return env


def port_storage(tmp_path: Path, backend: str = "sqlite"):
    """An isolated ``Storage`` of the port (see :func:`port_storage_env`)."""
    from predictionio_tpu_torch.data.storage.registry import Storage

    return Storage(env=port_storage_env(tmp_path, backend))


def port_store(tmp_path: Path, app: str, events_path: Path, mode: str = "training",
               backend: str = "sqlite"):
    """The port's storage (``backend``) holding the file's events, imported
    through ``import_events``, and a CPU context on it."""
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.tools.import_export import import_events
    from predictionio_tpu_torch.workflow.context import WorkflowContext

    storage = port_storage(tmp_path, backend)
    storage.get_meta_data_apps().insert(App(0, app))
    import_events(str(events_path), app, storage=storage)
    return WorkflowContext(mode=mode, device="cpu", _storage=storage, app_name=app)


def shared_init(monkeypatch) -> None:
    """ALS in the port starts from the JAX package's initial factors."""
    from predictionio_tpu.ops import als as jax_als
    from predictionio_tpu_torch.ops import als as pt_als

    def init(*, n_users, n_items, rank, seed, device):
        uf, vf = jax_als._als_init(n_users=n_users, n_items=n_items, rank=rank, seed=seed)
        return (torch.tensor(np.asarray(uf), device=device),
                torch.tensor(np.asarray(vf), device=device))

    monkeypatch.setattr(pt_als, "_als_init", init)


def variant(template: str, name: str | None = None, *, app: str, **algo_overrides) -> dict:
    """A JAX package engine.json (or one of its variants) with the app name
    set and ``algo_overrides`` applied to the ALS algorithms (those with a
    rank)."""
    base = REPO / "predictionio_tpu/models" / template
    path = base / "engine.json" if name is None else base / "variants" / f"{name}.json"
    v = json.loads(path.read_text())
    v["datasource"]["params"]["appName"] = app
    for algo in v["algorithms"]:
        if "rank" in algo["params"]:
            algo["params"].update(algo_overrides)
        if "appName" in algo["params"]:
            algo["params"]["appName"] = app
    return v


def ranked(result) -> list[tuple[str, float]]:
    """(id, score) pairs of a JSON-encoded ranked answer of any template."""
    d = result.to_json_dict() if hasattr(result, "to_json_dict") else result
    rows = d.get("itemScores", d.get("similarUserScores"))
    return [(r.get("item", r.get("user")), r["score"]) for r in rows]


def assert_same_ranking(got, want, score_of, rtol: float, atol: float = 1e-6) -> None:
    """Scores agree; an id may differ only where the port scores the JAX
    package's id the same (a tie), which ``score_of(item)`` checks."""
    g, w = ranked(got), ranked(want)
    assert len(g) == len(w), (g, w)
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rtol, atol=atol)
    for (gi, _), (wi, ws) in zip(g, w):
        if gi != wi:
            np.testing.assert_allclose(score_of(wi), ws, rtol=rtol, atol=atol)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post(url: str, payload) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def cli_deployed(tmp_path: Path, app: str, events_path: Path, engine_json: dict, deploy_flags=()):
    """app new -> import -> train -> deploy (with ``deploy_flags``) through
    the port's CLI on the CPU, each verb a subprocess; yields the server's
    base URL and stops it with SIGTERM (it must exit 0)."""
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps(engine_json))
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(tmp_path / "h")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}

    def run(*args):
        out = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        return out.stdout

    run("app", "new", app)
    assert "Imported" in run("import", "--appname", app, "--input", str(events_path))
    assert "Training completed" in run("train", "--engine-dir", str(engine_dir), "--device", "cpu")
    port = _free_port()
    err_path = tmp_path / "deploy.err"
    with open(err_path, "w") as err:
        server = subprocess.Popen(
            [*cli, "deploy", "--engine-dir", str(engine_dir), "--device", "cpu",
             "--ip", "127.0.0.1", "--port", str(port), *deploy_flags],
            env=env, stdout=subprocess.DEVNULL, stderr=err,
        )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert server.poll() is None, err_path.read_text()
            try:
                with urllib.request.urlopen(base + "/", timeout=2) as r:
                    assert json.loads(r.read())["device"] == "cpu"
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        yield base
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    assert server.returncode == 0, err_path.read_text()


def no_jax_subprocess(code: str) -> str:
    """Run ``code`` in a fresh interpreter and check that it imported nothing
    of JAX or the JAX package; returns its standard output."""
    check = (
        "\nimport sys\n"
        "assert 'jax' not in sys.modules\n"
        "assert not [k for k in sys.modules if k == 'predictionio_tpu' "
        "or k.startswith('predictionio_tpu.')]\n"
    )
    out = subprocess.run([sys.executable, "-c", code + check], capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=180, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return out.stdout


def chip_smoke():
    """The repo's chip_smoke.py as a module (its data generators, quality
    measures and gate constants; importing it runs nothing)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
