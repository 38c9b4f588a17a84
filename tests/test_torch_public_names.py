"""Public names a user's engine imports, held to the JAX package's:
``IdentityPreparator``, ``AverageServing``, ``EngineFactory`` (and the
engine loader taking its subclasses), ``params_from_json``,
``PersistentModel`` / ``PersistentModelManifest``, ``EventValidation``
(``tests/test_event.py``'s cases run against the port), ``ops.als``'s
``predict_scores`` / ``top_k_items`` (``tests/test_als.py::TestTopK``) and
the blocking server entry functions ``run_event_server``,
``run_query_server``, ``run_admin_server`` and ``run_dashboard``."""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import predictionio_tpu.controller as jax_controller  # noqa: E402
import predictionio_tpu.ops.als as jax_als  # noqa: E402
import tests.test_als as ref_als  # noqa: E402
import tests.test_event as ref_event  # noqa: E402
from predictionio_tpu.workflow import engine_loader as jax_loader  # noqa: E402
from predictionio_tpu_torch import controller  # noqa: E402
from predictionio_tpu_torch.data import event as pt_event  # noqa: E402
from predictionio_tpu_torch.ops import als as pt_als  # noqa: E402
from predictionio_tpu_torch.workflow import engine_loader  # noqa: E402
from tests.test_torch_fleet import reference_tests, run_reference  # noqa: E402
from tests.torch_dist_worker import REPO  # noqa: E402

PACKAGES = {"jax": jax_controller, "port": controller}


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


def test_the_controller_exports_the_jax_names():
    jax_only = {"JaxAlgorithm"}  # the port's counterpart is TorchAlgorithm
    assert set(jax_controller.__all__) - jax_only <= set(controller.__all__)
    assert "TorchAlgorithm" in controller.__all__


@pytest.mark.parametrize("which", sorted(PACKAGES))
def test_identity_preparator_and_average_serving(which):
    c = PACKAGES[which]
    data = object()
    assert c.IdentityPreparator().prepare(None, data) is data
    assert c.AverageServing().serve(None, [1.0, 2.0, 4.5]) == pytest.approx(7.5 / 3)
    assert c.FirstServing().serve(None, ["a", "b"]) == "a"


def _params_classes():
    out = {}
    for which, c in PACKAGES.items():
        @dataclasses.dataclass(frozen=True)
        class P(c.Params):
            rank: int = 10
            name: str = "x"
            tags: tuple[str, ...] = ()
        out[which] = P
    return out


@pytest.mark.parametrize("text", ['{"rank": 4, "tags": ["a", "b"]}', "", "   ", '{"name": "y"}',
                                  '{"rank": 1, "nope": 2}'])
def test_params_from_json_equals_the_jax_function(text):
    got = {}
    for which, cls in _params_classes().items():
        try:
            got[which] = dataclasses.asdict(PACKAGES[which].params_from_json(cls, text))
        except PACKAGES[which].ParamsError as exc:
            got[which] = ("ParamsError", str(exc))
    assert got["port"] == got["jax"]


def test_persistent_model_and_its_manifest():
    for c in PACKAGES.values():
        with pytest.raises(NotImplementedError):
            c.PersistentModel().save("i", None, "/nowhere")
        with pytest.raises(NotImplementedError):
            c.PersistentModel.load("i", None, "/nowhere")
    assert (controller.PersistentModelManifest("a.B").to_json_dict()
            == jax_controller.PersistentModelManifest("a.B").to_json_dict() == {"class_path": "a.B"})


FACTORY_MODULE = """
from {pkg}.controller import Engine, EngineFactory, FirstServing, IdentityPreparator
from tests.{sample} import Algo0, DataSource0


class SampleFactory(EngineFactory):
    def apply(self):
        return Engine(DataSource0, IdentityPreparator, {{"a": Algo0}}, FirstServing)


class Broken(EngineFactory):
    pass


NOT_AN_ENGINE = 3
"""


@pytest.mark.parametrize("which", sorted(PACKAGES))
def test_the_engine_loader_takes_an_engine_factory_subclass(which, tmp_path, monkeypatch):
    pkg, sample, loader = (("predictionio_tpu", "sample_engine", jax_loader) if which == "jax"
                           else ("predictionio_tpu_torch", "torch_sample_engine", engine_loader))
    mod = f"factories_{which}"
    (tmp_path / f"{mod}.py").write_text(FACTORY_MODULE.format(pkg=pkg, sample=sample))
    monkeypatch.syspath_prepend(str(tmp_path))
    engine = loader.load_engine_factory(f"{mod}.SampleFactory")
    assert isinstance(engine, PACKAGES[which].Engine)
    assert engine.algorithm_classes == {"a": sys.modules[f"tests.{sample}"].Algo0}
    with pytest.raises(NotImplementedError):
        loader.load_engine_factory(f"{mod}.Broken")
    with pytest.raises(loader.EngineLoadError, match="not an Engine factory"):
        loader.load_engine_factory(f"{mod}.NOT_AN_ENGINE")


# ---------------------------------------------------------------------------
# EventValidation
# ---------------------------------------------------------------------------

EVENT_CASES = ["test_valid_plain_event", "test_valid_event_with_target", "test_unset_requires_properties",
               "test_special_events_allowed", "test_builtin_entity_type_allowed",
               "test_reserved_property_rejected"]
INVALID_EVENTS = next(m for m in ref_event.test_invalid_events.pytestmark if m.name == "parametrize").args[1]
PORT_EVENT_NAMES = {"Event": pt_event.Event, "EventValidation": pt_event.EventValidation, "DataMap": dict}


@pytest.mark.parametrize("case", EVENT_CASES)
def test_the_reference_event_validation_cases_hold_for_the_port(case, monkeypatch):
    for name, value in PORT_EVENT_NAMES.items():
        monkeypatch.setattr(ref_event, name, value)
    getattr(ref_event, case)()


@pytest.mark.parametrize("kw", INVALID_EVENTS)
def test_the_reference_invalid_events_are_refused_by_the_port(kw, monkeypatch):
    for name, value in PORT_EVENT_NAMES.items():
        monkeypatch.setattr(ref_event, name, value)
    ref_event.test_invalid_events(kw)


def test_event_validation_keeps_the_jax_class_surface():
    from predictionio_tpu.data.event import EventValidation as JaxValidation

    V = pt_event.EventValidation
    for name in ("$set", "$unset", "$delete", "$x", "pio_y", "rate", "pio_pr"):
        assert V.is_reserved_prefix(name) == JaxValidation.is_reserved_prefix(name)
        assert V.is_special_event(name) == JaxValidation.is_special_event(name)
        assert V.is_builtin_entity_type(name) == JaxValidation.is_builtin_entity_type(name)
    assert V.DEFAULT_TZ == JaxValidation.DEFAULT_TZ and V.BUILTIN_PROPERTIES == JaxValidation.BUILTIN_PROPERTIES


# ---------------------------------------------------------------------------
# ops.als: predict_scores, top_k_items
# ---------------------------------------------------------------------------


def _port_top_k(user, vf, k, mask=None):
    """The port's top_k_items on the reference case's arrays, as tensors."""
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return pt_als.top_k_items(as_t(user), as_t(vf), k, None if mask is None else as_t(mask))


@pytest.mark.parametrize("cls_name,test_name", reference_tests(ref_als, "TestTopK"))
def test_the_reference_top_k_cases_hold_for_the_port(cls_name, test_name, monkeypatch, tmp_path):
    run_reference(monkeypatch, ref_als, {"top_k_items": _port_top_k}, cls_name, test_name, tmp_path)


def test_predict_scores_and_top_k_items_equal_the_jax_functions():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    vf = rng.normal(size=(200, 16)).astype(np.float32)
    user = rng.normal(size=16).astype(np.float32)
    mask = rng.random(200) > 0.3
    np.testing.assert_allclose(pt_als.predict_scores(torch.from_numpy(user), torch.from_numpy(vf)).numpy(),
                               np.asarray(jax_als.predict_scores(jnp.asarray(user), jnp.asarray(vf))),
                               rtol=1e-5, atol=1e-5)
    for m in (None, mask):
        s, i = pt_als.top_k_items(torch.from_numpy(user), torch.from_numpy(vf), 10,
                                  None if m is None else torch.from_numpy(m))
        js, ji = jax_als.top_k_items(jnp.asarray(user), jnp.asarray(vf), 10, None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(s, js, rtol=1e-5)
        assert list(i) == list(ji)  # no ties among normal draws
        assert s.dtype == np.float32 and i.dtype == np.int32


# ---------------------------------------------------------------------------
# the blocking server entry functions
# ---------------------------------------------------------------------------

SERVE = """
import sys
which, port = sys.argv[1], int(sys.argv[2])
print("serving", flush=True)
if which == "event":
    from predictionio_tpu_torch.data.api.event_server import EventServerConfig, run_event_server
    run_event_server(EventServerConfig(ip="127.0.0.1", port=port))
elif which == "admin":
    from predictionio_tpu_torch.tools.admin_api import run_admin_server
    run_admin_server(port=port)
elif which == "dashboard":
    from predictionio_tpu_torch.tools.dashboard import run_dashboard
    run_dashboard(port=port)
else:
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, run_query_server
    run_query_server(sys.argv[3], config=ServerConfig(ip="127.0.0.1", port=port), device="cpu")
"""


def _serve_then_sigterm(env, which: str, engine_dir: str = "", user: str = "") -> dict:
    """Start one entry function in a process, GET / (and, given a user,
    one query), then SIGTERM: it must exit 0."""
    from predictionio_tpu_torch.parallel.launcher import pick_free_port

    port = pick_free_port()
    out: dict = {}
    proc = subprocess.Popen([sys.executable, "-c", SERVE, which, str(port), engine_dir], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5) as resp:
                    out.update(status=resp.status, body=resp.read())
                break
            except OSError:
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise AssertionError(f"{which} never answered: {proc.communicate(timeout=5)[0]}")
                time.sleep(0.2)
        if user:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                         data=json.dumps({"user": user, "num": 3}).encode())
            with urllib.request.urlopen(req, timeout=30) as resp:
                out["answer"] = json.loads(resp.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out


def test_the_server_entry_functions_serve_until_sigterm(tmp_path):
    from predictionio_tpu_torch.tools import cli
    from tests.test_torch_cli_offline import APP, _rate_events
    from tests.torch_template_helpers import write_events

    home, engine_dir = tmp_path / "home", tmp_path / "engine"
    engine_dir.mkdir()
    variant = json.loads(open(os.path.join(REPO, "predictionio_tpu_torch/models/recommendation/engine.json")).read())
    variant["datasource"]["params"]["appName"] = APP
    variant["algorithms"][0]["params"].update(rank=4, numIterations=3)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    assert cli.main(["--home", str(home), "app", "new", APP]) == 0
    events = write_events(tmp_path / "ev.jsonl", _rate_events())
    assert cli.main(["--home", str(home), "import", "--appname", APP, "--input", str(events)]) == 0
    assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir), "--device", "cpu"]) == 0
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=str(home), PYTHONPATH=REPO, PIO_REGISTRY_DIR=str(tmp_path / "registry"))
    for which in ("event", "admin", "dashboard"):
        assert _serve_then_sigterm(env, which)["status"] == 200, which
    assert json.loads(_serve_then_sigterm(env, "event")["body"]) == {"status": "alive"}
    query = _serve_then_sigterm(env, "query", str(engine_dir), "u1")
    assert query["status"] == 200 and len(query["answer"]["itemScores"]) == 3
