"""``pio train``'s sanity-check and stop-after options in the port, as the
JAX package has them: ``Engine.train`` with ``TrainOptions`` (the cases of
``tests/test_engine.py``'s ``TestTrain``), and the CLI flags
``--skip-sanity-check``, ``--stop-after-read`` and ``--stop-after-prepare``
in both packages (a stop exits 0, leaves the instance COMPLETED and saves
no model blob)."""

import json
import os

import numpy as np
import pytest

from predictionio_tpu.data.datamap import DataMap
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.controller import Engine, EngineParams, EmptyParams, TrainOptions
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.context import WorkflowContext
from tests.torch_sample_engine import Algo0, AlgoParams, DataSource0, DSParams, Preparator0, Serving0
from tests.torch_template_helpers import REPO, write_events

CTX = WorkflowContext(mode="training", device="cpu")


def make_engine():
    return Engine({"ds": DataSource0}, {"prep": Preparator0}, {"a": Algo0}, {"s": Serving0})


def params(fail_sanity=False):
    return EngineParams(
        data_source=("ds", DSParams(id=1, fail_sanity=fail_sanity)),
        preparator=("prep", DSParams(id=2)),
        algorithms=[("a", AlgoParams(id=3))],
        serving=("s", EmptyParams()),
    )


def test_sanity_check_failure_propagates_unless_skipped():
    with pytest.raises(AssertionError):
        make_engine().train(CTX, params(fail_sanity=True))
    models = make_engine().train(CTX, params(fail_sanity=True), TrainOptions(skip_sanity_check=True))
    assert len(models) == 1


@pytest.mark.parametrize("option", ["stop_after_read", "stop_after_prepare"])
def test_stop_after_returns_no_models(option):
    assert make_engine().train(CTX, params(), TrainOptions(**{option: True})) == []
    assert len(make_engine().train(CTX, params(), TrainOptions())) == 1


def _rate_events(n_users=12, n_items=8):
    return [{"event": "rate", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
             "targetEntityId": f"i{(u * 3 + j) % n_items}", "properties": {"rating": float(1 + (u + j) % 5)},
             "eventTime": f"2024-03-01T00:00:{u:02d}.{j:03d}Z"}
            for u in range(n_users) for j in range(4)]


FLAGS = {"--stop-after-read": True, "--stop-after-prepare": True, "--skip-sanity-check": False}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_port_cli_train_flags(tmp_path, capsys, flag):
    home, engine_dir = tmp_path / "home", tmp_path / "engine"
    engine_dir.mkdir()
    variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
    variant["datasource"]["params"]["appName"] = "optapp"
    variant["algorithms"][0]["params"].update(rank=4, numIterations=2)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    events = write_events(tmp_path / "ev.jsonl", _rate_events())
    assert cli.main(["--home", str(home), "app", "new", "optapp"]) == 0
    assert cli.main(["--home", str(home), "import", "--appname", "optapp", "--input", str(events)]) == 0
    capsys.readouterr()
    assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir), "--device", "cpu",
                     flag]) == 0
    assert "Training completed" in capsys.readouterr().out
    storage = Storage(env={**os.environ, "PIO_FS_BASEDIR": str(home)})
    (instance,) = storage.get_meta_data_engine_instances().get_all()
    assert instance.status == "COMPLETED"
    has_blob = storage.get_model_data_models().get(instance.id) is not None
    assert has_blob is not FLAGS[flag]


@pytest.mark.parametrize("flag", list(FLAGS))
def test_jax_cli_train_flags(memory_storage, capsys, flag):
    """The reference's behaviour the port's test above matches."""
    assert jax_cli.main(["app", "new", "MyApp1"]) == 0  # the JAX engine.json's app
    app = memory_storage.get_meta_data_apps().get_by_name("MyApp1")
    rng = np.random.default_rng(0)
    memory_storage.get_l_events().insert_batch(
        [JaxEvent(event="rate", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                  target_entity_id=f"i{rng.integers(0, 8)}", properties=DataMap({"rating": 3.0}))
         for u in range(12) for _ in range(4)], app.id)
    capsys.readouterr()
    assert jax_cli.main(["train", "--engine-dir", "predictionio_tpu/models/recommendation", flag]) == 0
    (instance,) = memory_storage.get_meta_data_engine_instances().get_all()
    assert instance.status == "COMPLETED"
    has_blob = memory_storage.get_model_data_models().get(instance.id) is not None
    assert has_blob is not FLAGS[flag]
