"""The port's offline CLI verbs and ``/stop`` on the CPU: ``undeploy``
against a deployed server (``/stop`` answers as the JAX server does and the
process exits 0), ``status``, ``version``, ``upgrade``, ``template
list/get``, ``run``, ``batchpredict`` (file and ``--from-events``, with the
JAX package's exit codes) and ``eval`` (``--workers 0``, ``--resume``,
``--publish`` without an engine identity refused, a FakeRun). Every
subprocess has its own timeout."""

import asyncio
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from predictionio_tpu_torch.tools import cli
from tests.torch_template_helpers import REPO, _free_port, write_events

APP = "offapp"


def _rate_events(n_users=14, n_items=9):
    out, k = [], 0
    for u in range(n_users):
        for i in range(n_items):
            if (u * 7 + i * 3) % 4 == 0:
                continue
            out.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                        "targetEntityType": "item", "targetEntityId": f"i{i}",
                        "properties": {"rating": float(1 + (u + i) % 5)},
                        "eventTime": f"2024-03-01T00:{k // 60:02d}:{k % 60:02d}.000Z"})
            k += 1
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """app new -> import -> train of the recommendation template on the
    CPU through ``cli.main``; returns (home, engine_dir)."""
    base = tmp_path_factory.mktemp("cli_offline")
    home, engine_dir = base / "home", base / "engine"
    engine_dir.mkdir()
    variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
    variant["datasource"]["params"]["appName"] = APP
    variant["algorithms"][0]["params"].update(rank=4, numIterations=3)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    events = write_events(base / "ev.jsonl", _rate_events())
    assert cli.main(["--home", str(home), "app", "new", APP]) == 0
    assert cli.main(["--home", str(home), "import", "--appname", APP, "--input", str(events)]) == 0
    assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir),
                     "--device", "cpu"]) == 0
    return home, engine_dir


def test_stop_answers_as_the_jax_server_does():
    """The port's ``/stop`` body and status equal the JAX server's
    ``handle_stop`` (called on a stand-in with its stop event)."""
    import numpy as np

    from predictionio_tpu.workflow.create_server import QueryServer as JaxQueryServer
    from predictionio_tpu_torch.models.recommendation.engine import ALSModel, engine_factory
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig

    class StandIn:
        _stop_event = asyncio.Event()

    jax_resp = asyncio.run(JaxQueryServer.handle_stop(StandIn(), None))
    assert StandIn._stop_event.is_set()

    engine = engine_factory()
    ep = engine.engine_params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
    rng = np.random.default_rng(0)
    model = ALSModel(rng.normal(size=(3, 2)).astype(np.float32),
                     rng.normal(size=(4, 2)).astype(np.float32), ["a", "b", "c"], ["w", "x", "y", "z"])
    ctx = WorkflowContext(mode="serving", device="cpu")
    model.device = ctx.device
    for method in ("POST", "GET"):
        server = QueryServer(engine, ep, [model], ctx, ServerConfig(ip="127.0.0.1", port=0))
        port = server.start()
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/stop", method=method,
                                         data=b"" if method == "POST" else None)
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert resp.status == jax_resp.status == 200
                assert json.loads(resp.read()) == json.loads(jax_resp.text) == {"message": "Stopping."}
            assert server.stop_requested.wait(5)
        finally:
            server.shutdown()
        assert not server.batcher._thread.is_alive()  # the micro-batcher stopped too


def test_undeploy_stops_a_deployed_server_which_exits_0(trained, capsys):
    home, engine_dir = trained
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    server = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(home), "deploy",
         "--engine-dir", str(engine_dir), "--device", "cpu", "--ip", "127.0.0.1", "--port", str(port)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 90
        while True:
            assert server.poll() is None, server.stderr.read()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=2):
                    break
            except OSError:
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port)]) == 0
        assert json.loads(capsys.readouterr().out) == {"message": "Stopping."}
        assert server.wait(timeout=10) == 0
    finally:
        if server.poll() is None:
            server.kill()
            server.wait(timeout=10)
    # nothing listens any more: undeploy now fails with exit code 1
    assert cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port)]) == 1


def test_status_version_upgrade(tmp_path, capsys):
    import predictionio_tpu_torch

    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == predictionio_tpu_torch.__version__
    assert cli.main(["--home", str(tmp_path), "status"]) == 0
    out = capsys.readouterr().out
    assert "storage: all data objects verified" in out
    assert "cards:" in out  # the card probe answered (0 cards on this host)
    assert cli.main(["--home", str(tmp_path), "upgrade"]) == 0
    assert "No migration necessary." in capsys.readouterr().out


def test_template_list_and_get(tmp_path, capsys):
    assert cli.main(["template", "list"]) == 0
    names = capsys.readouterr().out.split()
    assert {"recommendation", "sequential", "twotower", "similarproduct", "ecommerce",
            "recommendeduser", "classification"} == set(names)
    dst = tmp_path / "myengine"
    assert cli.main(["template", "get", "sequential", str(dst)]) == 0
    got = json.loads((dst / "engine.json").read_text())
    assert got["engineFactory"] == "predictionio_tpu_torch.models.sequential.engine.engine_factory"
    assert (dst / "template.json").exists()
    assert cli.main(["template", "get", "sequential", str(dst)]) == 1  # not empty
    assert cli.main(["template", "get", "nosuch", str(tmp_path / "x")]) == 1


def test_run_executes_a_main(tmp_path, capsys, monkeypatch):
    script = tmp_path / "main.py"
    script.write_text("import sys\nprint('ran', sys.argv[1:])\n")
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    assert cli.main(["run", str(script), "a", "b"]) == 0
    assert "ran ['a', 'b']" in capsys.readouterr().out


def test_batchpredict_file_and_from_events(trained, tmp_path, capsys):
    home, engine_dir = trained
    base = ["--home", str(home), "batchpredict", "--engine-dir", str(engine_dir), "--device", "cpu"]
    qf = tmp_path / "q.json"
    qf.write_text('{"user": "u1", "num": 3}\nBROKEN\n{"user": "u2", "num": 2}\n')
    out = tmp_path / "out.jsonl"
    assert cli.main([*base, "--input", str(qf), "--output", str(out), "--batch", "2"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [len(r.get("itemScores", [])) for r in rows] == [3, 0, 2] and rows[1]["line"] == 2
    assert "3 queries (2 ok, 1 errors)" in capsys.readouterr().out
    # every line failed -> exit 1; setup errors -> exit 1
    qf.write_text("BROKEN1\nBROKEN2\n")
    assert cli.main([*base, "--input", str(qf), "--output", str(out)]) == 1
    assert cli.main([*base, "--input", str(tmp_path / "missing.json"), "--output", str(out)]) == 1
    assert cli.main([*base, "--from-events", "--input", str(qf)]) == 1
    # --from-events --to-events: one line and one write-back event per user
    out2 = tmp_path / "users.jsonl"
    assert cli.main([*base, "--from-events", "--to-events", "--output", str(out2)]) == 0
    assert len(out2.read_text().splitlines()) == 14
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.data.store.event_store import LEventStore

    storage = Storage(env={**os.environ, "PIO_FS_BASEDIR": str(home)})
    written = list(LEventStore(storage).find(app_name=APP, event_names=["batchpredict.result"]))
    assert len(written) == 14 and {e.entity_id for e in written} == {f"u{u}" for u in range(14)}


def test_batchpredict_defaults_to_the_card(trained, tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    home, engine_dir = trained
    qf = tmp_path / "q.json"
    qf.write_text('{"user": "u1", "num": 3}\n')
    rc = cli.main(["--home", str(home), "batchpredict", "--engine-dir", str(engine_dir),
                   "--input", str(qf), "--output", str(tmp_path / "o.json")])
    assert rc == 1 and "CUDA is not available" in capsys.readouterr().err


EVAL_MODULE = '''
from predictionio_tpu_torch.eval import Evaluation
from predictionio_tpu_torch.models.recommendation.engine import engine_factory
from predictionio_tpu_torch.tuning.metrics import PrecisionAtK
from predictionio_tpu_torch.workflow.fake_workflow import FakeRun


def make_evaluation():
    engine = engine_factory()
    return Evaluation(
        engine=engine,
        metric=PrecisionAtK(k=3),
        engine_params_generator=[
            engine.engine_params_from_variant({
                "datasource": {"params": {"appName": "offapp", "evalParams": {"kFold": 2}}},
                "algorithms": [{"name": "als", "params": {"rank": r, "numIterations": 3}}],
            })
            for r in (2, 4)
        ],
    )


class Hello(FakeRun):
    def func(ctx):
        print("hello from", ctx.mode)
'''


def test_eval_workers_0_resume_publish_and_fakerun(trained, tmp_path, capsys, monkeypatch):
    home, _ = trained
    (tmp_path / "offline_eval_mod.py").write_text(EVAL_MODULE)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))
    base = ["--home", str(home), "eval", "offline_eval_mod.make_evaluation", "--device", "cpu"]
    workdir = tmp_path / "grid"
    report = tmp_path / "report.json"
    assert cli.main([*base, "--workers", "0", "--workdir", str(workdir), "--out", str(report)]) == 0
    out = capsys.readouterr().out
    assert "4 cells = 2 params x 2 folds, 0 resumed" in out and "Evaluation instance ID" in out
    first = json.loads(report.read_text())
    assert first["cells_run"] == 4 and len(first["scores"]) == 2
    assert all(0.0 <= s["score"] <= 1.0 for s in first["scores"])
    # a used workdir is refused without --resume; --resume retrains nothing
    assert cli.main([*base, "--workdir", str(workdir)]) == 1
    assert cli.main([*base, "--workdir", str(workdir), "--resume", "--out", str(report)]) == 0
    again = json.loads(report.read_text())
    assert again["cells_run"] == 0 and again["cells_skipped"] == 4
    assert again["scores"] == first["scores"]
    capsys.readouterr()
    # --publish needs the engine identity the winner publishes under
    assert cli.main([*base, "--workdir", str(tmp_path / "g2"), "--publish"]) == 1
    assert "--engine-dir" in capsys.readouterr().err
    assert not (tmp_path / "g2").exists()
    assert cli.main([*base, "--resume"]) == 1  # --resume needs --workdir
    # a FakeRun evaluation runs as is, on the sequential path
    assert cli.main(["--home", str(home), "eval", "offline_eval_mod.Hello", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "hello from evaluation" in out and "FakeRun (not persisted)" in out
