"""The port's small tools held to the JAX package's: the capacity planner's
mesh and ``pio doctor --mesh --gather-dtype`` (the reference's
``TestCapacityPlanner`` cases run against the port), ``LatencyHistogram``
(``tests/test_aux.py::TestLatencyHistogram``), ``CleanupFunctions`` at the
points the JAX workflows run them, ``pio build`` / ``unregister`` texts,
``start-all`` / ``stop-all``, ``pio shell`` and the CPU guard of
``utils/platform.py``."""

from __future__ import annotations

import inspect
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import predictionio_tpu.tools.cli as jax_cli  # noqa: E402
import tests.test_aux as ref_aux  # noqa: E402
import tests.test_xray as ref_xray  # noqa: E402
from predictionio_tpu_torch.obs import xray  # noqa: E402
from predictionio_tpu_torch.tools import cli  # noqa: E402
from predictionio_tpu_torch.utils.histogram import LatencyHistogram  # noqa: E402
from predictionio_tpu_torch.workflow.cleanup import CleanupFunctions  # noqa: E402
from tests.test_torch_fleet import reference_tests, run_reference  # noqa: E402
from tests.torch_dist_worker import CLEANUP_HOOK_OUT, REPO, run_world  # noqa: E402

PLANNER_CASES = ["test_mesh_parsing_forms", "test_malformed_mesh_raises_instead_of_silent_one_device",
                 "test_sharding_divides_and_gather_transient_adds", "test_doctor_capacity_exit_codes",
                 "test_doctor_mesh_and_nnz_flags"]


# ---------------------------------------------------------------------------
# the capacity planner and pio doctor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("test_name", PLANNER_CASES)
def test_the_reference_capacity_planner_cases_hold_for_the_port(test_name, monkeypatch, capsys):
    """The reference's cases with its module's ``xray`` the port's and its
    ``pio`` main the port's CLI."""
    monkeypatch.setattr(ref_xray, "xray", xray)
    monkeypatch.setattr(jax_cli, "main", cli.main)
    method = getattr(ref_xray.TestCapacityPlanner(), test_name)
    method(**({"capsys": capsys} if "capsys" in inspect.signature(method).parameters else {}))


@pytest.mark.parametrize("mesh", [None, 1, 8, "8", "data=2", "data=4,model=2", {"data": 2, "model": 2}])
@pytest.mark.parametrize("gather", ["f32", "bf16"])
def test_estimate_factors_over_a_mesh_equals_the_jax_planner(mesh, gather):
    from predictionio_tpu.obs import xray as jxray

    got = xray.estimate_factors(138_000, 27_000, 32, mesh=mesh, nnz=20_000_000, gather_dtype=gather)
    want = jxray.estimate_factors(138_000, 27_000, 32, mesh=mesh, nnz=20_000_000, gather_dtype=gather)
    assert got.to_json_dict() == want.to_json_dict()


def test_a_port_mesh_and_malformed_sizes_as_the_jax_planner():
    from predictionio_tpu.obs import xray as jxray
    from predictionio_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(("data", "model"), [2, 2], 0, torch.device("cpu"), {})
    assert xray.estimate_factors(100, 50, 8, mesh=mesh).n_devices == 4
    for bad in ("data=-1", "model=0,data=2", {"data": -1}):
        messages = []
        for planner in (xray, jxray):
            with pytest.raises(ValueError) as err:
                planner.estimate_factors(10, 10, 4, mesh=bad)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


def test_doctor_mesh_equals_the_jax_doctor_and_the_budget_says_shard_wider(capsys):
    argv = ["doctor", "--capacity", "138000", "27000", "32", "--mesh", "data=2", "--gather-dtype", "bf16"]
    outs = []
    for main in (jax_cli.main, cli.main):
        assert main(argv) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[1]["capacity"]["n_devices"] == 2
    assert cli.main([*argv, "--hbm-bytes", "10MB"]) == 1
    assert "shard wider (--mesh)" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# LatencyHistogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls_name,test_name", reference_tests(ref_aux, "TestLatencyHistogram"))
def test_the_reference_histogram_cases_hold_for_the_port(cls_name, test_name, monkeypatch, tmp_path):
    run_reference(monkeypatch, ref_aux, {"LatencyHistogram": LatencyHistogram}, cls_name, test_name, tmp_path)


def test_the_histogram_summarises_as_the_jax_one():
    from predictionio_tpu.utils.histogram import LatencyHistogram as JaxHistogram

    port, jax_h = LatencyHistogram(), JaxHistogram()
    for k in range(500):
        sec = 1e-6 * (1.37 ** (k % 60)) + 1e-7 * k
        port.observe(sec)
        jax_h.observe(sec)
    assert port.summary() == jax_h.summary()
    assert [port.percentile(q) for q in (0.1, 0.5, 0.9, 1.0)] == [jax_h.percentile(q) for q in (0.1, 0.5, 0.9, 1.0)]


# ---------------------------------------------------------------------------
# CleanupFunctions where the JAX workflows run them
# ---------------------------------------------------------------------------


@pytest.fixture
def hook():
    calls: list[int] = []
    CleanupFunctions.clear()
    CleanupFunctions.add(lambda: calls.append(1))
    CleanupFunctions.add(lambda: 1 / 0)  # a failing hook is logged; the others still run
    yield calls
    CleanupFunctions.clear()


def _sample_train(tmp_path, fail: bool):
    from predictionio_tpu_torch.controller import Engine
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest
    from tests import torch_sample_engine as se
    from tests.torch_template_helpers import port_storage

    engine = Engine(se.DataSource0, se.Preparator0, {"a": se.Algo0}, se.Serving0)
    params = engine.engine_params_from_variant({"datasource": {"params": {"id": 1, "fail_sanity": fail}},
                                                "algorithms": [{"name": "a", "params": {"id": 2}}]})
    storage = port_storage(tmp_path, "memory")
    ctx = WorkflowContext(device="cpu", _storage=storage)
    manifest = EngineManifest(engine_id="e", version="1", variant="v", engine_factory="f")
    return run_train(engine, manifest, params, ctx), storage


def test_a_hook_runs_once_per_train_completed_or_failed(tmp_path, hook):
    iid, storage = _sample_train(tmp_path, fail=False)
    assert storage.get_meta_data_engine_instances().get(iid).status == "COMPLETED"
    assert hook == [1]
    with pytest.raises(AssertionError, match="failed sanity check"):
        _sample_train(tmp_path / "failed", fail=True)
    assert hook == [1, 1]


def test_a_hook_runs_once_on_every_rank_of_a_two_rank_gloo_train(tmp_path):
    run_world(2, ["cleanup2"], str(tmp_path))
    for r in range(2):
        with open(tmp_path / f"{CLEANUP_HOOK_OUT}.rank{r}") as fh:
            assert fh.read() == "ran\n", f"rank {r}"


def test_a_hook_runs_once_per_evaluation_and_grid_evaluation(tmp_path, hook):
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation, run_grid_evaluation
    from tests.test_torch_eval import EngineParamsGenerator, Evaluation, QidMetric, make_engine, params
    from tests.test_torch_tuning import make_eval
    from tests.torch_template_helpers import port_storage

    ctx = WorkflowContext(mode="evaluation", device="cpu", _storage=port_storage(tmp_path, "memory"))
    evaluation = Evaluation(engine=make_engine(), metric=QidMetric(),
                            engine_params_generator=EngineParamsGenerator([params(4), params(2)]))
    run_evaluation(evaluation, ctx)
    assert hook == [1]
    run_grid_evaluation(make_eval(), ctx, workdir=str(tmp_path / "grid"), workers=0)
    assert hook == [1, 1]
    with pytest.raises(ValueError, match="resume"):  # the ledger exists: a failed start
        run_grid_evaluation(make_eval(), ctx, workdir=str(tmp_path / "grid"), workers=0)
    assert hook == [1, 1, 1]


# ---------------------------------------------------------------------------
# CLI verbs: build, unregister, start-all, stop-all, shell
# ---------------------------------------------------------------------------


def test_build_and_unregister_print_the_jax_texts(tmp_path, capsys):
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "smoke-build", "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
        "datasource": {"params": {"appName": "A"}},
        "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 2}}]}))
    for verb in ("build", "unregister"):
        outs = []
        for main in (jax_cli.main, cli.main):
            assert main([verb, "--engine-dir", str(engine_dir)]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1], verb
    assert cli.main(["build", "--engine-dir", str(tmp_path / "missing")]) == 1


def _get(port: int) -> int:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as resp:
        return resp.status


def test_start_all_then_stop_all_leaves_no_process(tmp_path, monkeypatch, capsys):
    from predictionio_tpu_torch.parallel.launcher import pick_free_port

    monkeypatch.setenv("PYTHONPATH", REPO)
    home = str(tmp_path / "home")
    ports = [pick_free_port() for _ in range(3)]
    assert cli.main(["--home", home, "start-all", "--eventserver-port", str(ports[0]),
                     "--adminserver-port", str(ports[1]), "--dashboard-port", str(ports[2])]) == 0
    started = capsys.readouterr().out.split("\n")
    pids = [int(line.split("pid ")[1].rstrip(")")) for line in started if line.startswith("started")]
    assert len(pids) == 3
    try:
        assert cli.main(["--home", home, "start-all"]) == 1  # a second start is refused
        deadline = time.monotonic() + 60
        for port in ports:
            while True:
                try:
                    assert _get(port) == 200
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
    finally:
        assert cli.main(["--home", home, "stop-all"]) == 0
    assert not os.path.exists(os.path.join(home, "pio-services.pid"))
    deadline = time.monotonic() + 30
    for pid in pids:
        while os.waitpid(pid, os.WNOHANG) == (0, 0):
            if time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
                raise AssertionError(f"pid {pid} still running after stop-all")
            time.sleep(0.1)
    assert cli.main(["--home", home, "stop-all"]) == 1  # nothing left to stop


# one line a statement: code.interact (without IPython) prompts again on a continuation
SHELL_SCRIPT = """import sys
names = dir()
print("BOUND", sorted(n for n in names if n in ("storage", "p_event_store", "l_event_store", "Event", "DataMap", "CleanupFunctions", "torch", "device")))
print("IMPORTED", "jax" in sys.modules, any(m.split(".")[0] == "predictionio_tpu" for m in sys.modules))
print("CUDA", torch.cuda.is_initialized(), torch.cuda.is_available(), device)
CleanupFunctions.add(lambda: print("HOOK ran"))
"""


def test_shell_binds_the_stores_without_jax_and_runs_the_hooks_on_exit(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(tmp_path),
                          "shell", "--device", "cpu"], input=SHELL_SCRIPT, capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    bound = ["CleanupFunctions", "DataMap", "Event", "device", "l_event_store", "p_event_store", "storage",
             "torch"]
    assert f"BOUND {bound}" in out.stdout
    assert "IMPORTED False False" in out.stdout
    assert "CUDA False False cpu" in out.stdout
    assert "HOOK ran" in out.stdout


def test_the_cpu_guard_hides_the_card_only_when_asked(monkeypatch):
    from predictionio_tpu_torch.utils import platform

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert platform.ensure_cpu_if_requested("cuda") is False
    assert "CUDA_VISIBLE_DEVICES" not in os.environ
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert platform.ensure_cpu_if_requested("cpu") is True
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="after CUDA initialised"):
        platform.ensure_cpu_if_requested("cpu")
