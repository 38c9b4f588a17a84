"""``pio train --num-hosts 2`` of the recommendation template with
``distributed: true`` through the port's CLI on the CPU (two gloo ranks
under the port's launcher), then a single-process ``pio deploy`` that
answers as ``serve_batch`` of the persisted model: the composition the JAX
package's ``tests/test_subprocess_quickstart.py::
test_multihost_sharded_als_train_and_serve`` tests. Also the launcher's
rendezvous, fail-fast and reaping, and that a rank other than the
coordinator persists nothing."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu_torch.data.storage.registry import Storage  # noqa: E402
from predictionio_tpu_torch.parallel import distributed  # noqa: E402
from predictionio_tpu_torch.parallel.launcher import MultiHostLauncher, pick_free_port  # noqa: E402
from tests.test_torch_recommendation import _write_events  # noqa: E402
from tests.torch_dist_worker import REPO  # noqa: E402

APP = "MhApp"
RENDEZVOUS = (
    "import sys, torch\n"
    "from predictionio_tpu_torch.parallel import distributed, collectives, mesh\n"
    "assert distributed.maybe_initialize_distributed('cpu')\n"
    "r = distributed.runtime()\n"
    "if len(sys.argv) > 1 and r.rank == int(sys.argv[1]):\n"
    "    sys.exit(3)\n"
    "m = mesh.make_mesh(None, 'cpu')\n"
    "x = collectives.all_gather(torch.tensor([float(r.rank)]), m, 'data')\n"
    "assert x.tolist() == [0.0, 1.0], x\n"
    "print('rank', r.rank, r.backend, 'ok')\n"
)


def _clean_env() -> dict:
    return {"PIO_COORDINATOR": "", "PIO_NUM_PROCESSES": "", "PIO_PROCESS_ID": "",
            "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def _run(launcher: MultiHostLauncher, timeout_s: float = 50.0):
    timer = threading.Timer(timeout_s, launcher.terminate)
    timer.start()
    try:
        return launcher.run()
    finally:
        timer.cancel()


def test_two_rank_rendezvous():
    result = _run(MultiHostLauncher(command=[sys.executable, "-c", RENDEZVOUS], num_hosts=2,
                                    env_extra=_clean_env()))
    assert result.ok and result.returncodes == [0, 0]


def test_fail_fast_terminates_the_survivor():
    """Rank 1 exits 3 before its collective; rank 0, blocked in it, is
    terminated by the supervisor, not left running."""
    launcher = MultiHostLauncher(command=[sys.executable, "-c", RENDEZVOUS, "1"], num_hosts=2,
                                 env_extra=_clean_env())
    result = _run(launcher)
    assert not result.ok and result.returncodes[1] == 3 and result.returncodes[0] != 0
    assert all(p.poll() is not None for p in launcher._procs)


def test_terminate_reaps_a_worker_that_ignores_sigterm():
    code = "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); print('up', flush=True); time.sleep(60)"
    launcher = MultiHostLauncher(command=[sys.executable, "-c", code], num_hosts=1, env_extra=_clean_env(),
                                 stream_logs=False)
    launcher._procs.append(launcher._spawn_local(0, f"127.0.0.1:{pick_free_port()}"))
    time.sleep(1.0)
    t0 = time.monotonic()
    launcher.terminate(grace_s=0.5)
    assert launcher._procs[0].returncode == -signal.SIGKILL and time.monotonic() - t0 < 10


def test_strip_launcher_flags_equals_jax():
    from predictionio_tpu.tools.cli import _strip_launcher_flags as jstrip
    from predictionio_tpu_torch.tools.cli import _strip_launcher_flags

    for argv in (["train", "--num-hosts", "2", "--engine-dir", "d"], ["train", "--hosts=a,b", "--num-hosts=2"],
                 ["--home", "h", "train", "--hosts", "a@h1,h2", "--device", "cpu"]):
        assert _strip_launcher_flags(argv) == jstrip(argv)


def test_a_rank_other_than_the_coordinator_persists_nothing(tmp_path, monkeypatch):
    from predictionio_tpu_torch.models.recommendation import engine as rec
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest
    from tests.test_torch_recommendation import APP as REC_APP
    from tests.test_torch_recommendation import _port_training_data

    events = _write_events(tmp_path / "ev.jsonl", seed=4)
    ctx, _ = _port_training_data(tmp_path, events)
    storage = ctx.storage
    engine = rec.engine_factory()
    params = engine.engine_params_from_variant(
        {"datasource": {"params": {"appName": REC_APP}},
         "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}]})
    manifest = EngineManifest(engine_id="e", version="1", variant="v", engine_factory="f")
    monkeypatch.setattr(distributed, "_runtime", distributed.Runtime("gloo", 1, 2, 1, 2, torch.device("cpu")))
    gathered = []

    def all_gather_object(out, obj):  # the worker's part in the launch-count gather
        gathered.append(obj)
        out[:] = [obj] * len(out)

    monkeypatch.setattr(torch.distributed, "all_gather_object", all_gather_object)
    assert run_train(engine, manifest, params, ctx) == ""
    assert storage.get_meta_data_engine_instances().get_all() == []
    assert gathered == [{"spd_cg": 0, "attention_block": 0, "flash_attention": 0}]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_train_num_hosts_2_then_deploy_answers_serve_batch(tmp_path):
    events = tmp_path / "events.jsonl"
    _write_events(events, n_users=40, n_items=30, n=900, seed=2)
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    variant = {"id": "mh", "engineFactory": "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
               "datasource": {"params": {"appName": APP}},
               "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 3, "lambda": 0.05,
                                                         "distributed": True}}]}
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    home = tmp_path / "h"
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(home)]
    env = {k: v for k, v in os.environ.items() if k not in ("PIO_COORDINATOR", "PIO_NUM_PROCESSES", "PIO_PROCESS_ID")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def run(*args, timeout=120):
        out = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout + out.stderr

    run("app", "new", APP)
    run("import", "--appname", APP, "--input", str(events))
    text = run("train", "--engine-dir", str(engine_dir), "--device", "cpu", "--num-hosts", "2")
    assert "[host 0] Training completed" in text and "[host 1] Rank finished" in text, text[-3000:]

    storage = Storage(env={**os.environ, "PIO_FS_BASEDIR": str(home)})
    (instance,) = storage.get_meta_data_engine_instances().get_all()
    assert instance.status == "COMPLETED"
    # both ranks trained (on the CPU no kernel launches: the plain versions)
    assert json.loads(instance.spark_conf["kernel_launches"]) == [
        {"spd_cg": 0, "attention_block": 0, "flash_attention": 0}] * 2
    from predictionio_tpu_torch.workflow import model_io

    (model,) = model_io.deserialize_models(storage.get_model_data_models().get(instance.id).models)
    assert np.isfinite(model.user_factors).all() and model.user_factors.shape == (40, 4)

    port = pick_free_port()
    err = open(tmp_path / "deploy.err", "w")
    server = subprocess.Popen([*cli, "deploy", "--engine-dir", str(engine_dir), "--device", "cpu", "--ip",
                               "127.0.0.1", "--port", str(port)], env=env, stdout=subprocess.DEVNULL, stderr=err,
                              cwd=REPO)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            assert server.poll() is None, (tmp_path / "deploy.err").read_text()
            try:
                with urllib.request.urlopen(base + "/", timeout=2):
                    break
            except OSError:
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        from predictionio_tpu_torch.ops.als import ServingIndex

        index = ServingIndex(model.user_factors, model.item_factors, "cpu")
        users = [f"u{u}" for u in range(40) if model.user_index(f"u{u}") is not None][:20]
        scores, ids = index.serve_batch(np.array([model.user_index(u) for u in users]), 5)
        for u, s_row, i_row in zip(users, scores, ids):
            status, body = _post(base + "/queries.json", {"user": u, "num": 5})
            assert status == 200
            got = body["itemScores"]
            np.testing.assert_allclose([g["score"] for g in got], s_row, rtol=1e-5, atol=1e-6)
            assert [g["item"] for g in got] == [model.item_vocab[i] for i in i_row]
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
        err.close()
    assert server.returncode == 0, (tmp_path / "deploy.err").read_text()
