"""The port's classification template against the JAX package's, on the CPU.

The same seeded ``$set``/``$unset``/``$delete`` streams of user properties
go through both packages: the DataSource read (``aggregate_properties``
with ``required``), naive Bayes (``log_theta`` within 1e-12, identical
labels on the host path; the batched path scores in float32 on the model's
device and must give the float64 labels except where the top two scores lie
within 1e-5 relative), the random forest (identical trees and predictions
from one seed), both variants through the JAX factory strings, a
JAX-written blob served by the port, the CLI from import to
``POST /queries.json``, and a train and serve in a process without JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu.models.classification import engine as jax_cl  # noqa: E402
from predictionio_tpu.ops import classify as jax_classify  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu_torch.models.classification import engine as pt_cl  # noqa: E402
from predictionio_tpu_torch.ops import classify as pt_classify  # noqa: E402
from predictionio_tpu_torch.workflow import model_io  # noqa: E402
from predictionio_tpu_torch.workflow.engine_loader import load_engine_factory  # noqa: E402
from torch_template_helpers import (  # noqa: E402
    cli_deployed,
    event_time,
    jax_store,
    no_jax_subprocess,
    port_store,
    post,
    variant,
    write_events,
)

APP = "clsapp"


def _events(n=120, seed=0, custom=False):
    """Labelled points as user properties: each point's class sets its
    attribute means; some users lose an attribute ($unset), some are
    deleted, some are re-set later."""
    rng = np.random.default_rng(seed)
    label_key = "label" if custom else "plan"
    attrs = ["featureA", "featureB", "featureC", "featureD"] if custom else ["attr0", "attr1", "attr2"]
    out, k = [], 0

    def add(**ev):
        nonlocal k
        out.append({"eventId": f"e{k:05d}", "eventTime": event_time(k), "entityType": "user", **ev})
        k += 1

    for p in range(n):
        c = int(rng.integers(3))
        props = {label_key: float(c)}
        props.update({a: float(rng.poisson(2 + 3 * ((c + j) % 3))) for j, a in enumerate(attrs)})
        add(event="$set", entityId=f"u{p}", properties=props)
    for p in rng.choice(n, 10, replace=False):
        add(event="$unset", entityId=f"u{p}", properties={attrs[0]: None})
    for p in rng.choice(n, 5, replace=False):
        add(event="$delete", entityId=f"u{p}")
    for p in rng.choice(n, 10, replace=False):
        add(event="$set", entityId=f"u{p}", properties={attrs[0]: 7.0})
    add(event="view", entityId="u0", targetEntityType="item", targetEntityId="i1")
    return out


@pytest.fixture
def events(tmp_path):
    return write_events(tmp_path / "ev.jsonl", _events())


def test_datasource_read_matches_jax(memory_storage, tmp_path, events):
    jtd = jax_cl.DataSource(jax_cl.DataSourceParams(app_name=APP)).read_training(
        jax_store(memory_storage, APP, events))
    ptd = pt_cl.DataSource(pt_cl.DataSourceParams(app_name=APP)).read_training(
        port_store(tmp_path, APP, events))
    np.testing.assert_array_equal(ptd.labels, jtd.labels)
    np.testing.assert_array_equal(ptd.features, jtd.features)
    assert ptd.features.shape[1] == 3 and 90 < len(ptd.labels) < 120


@pytest.mark.parametrize("smoothing", [1.0, 0.3])
def test_naive_bayes_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 4, 500).astype(np.float64)
    feats = rng.poisson(2.0, size=(500, 12)).astype(np.float64) + labels[:, None] * (
        np.arange(12) % 4 == labels[:, None] % 4)
    jm = jax_classify.train_naive_bayes(labels, feats, smoothing)
    pm = pt_classify.train_naive_bayes(labels, feats, smoothing)
    np.testing.assert_array_equal(pm.labels, jm.labels)
    np.testing.assert_allclose(pm.log_priors, jm.log_priors, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pm.log_theta, jm.log_theta, rtol=0, atol=1e-12)
    X = rng.poisson(2.0, size=(300, 12)).astype(np.float64)
    host = np.asarray([pm.predict(x) for x in X])
    assert np.array_equal(host, [jm.predict(x) for x in X])
    pm.device = "cpu"
    batched = pm.predict_batch(X)
    assert np.array_equal(batched, jm.predict_batch(X))
    scores = pm.log_priors[None, :] + X @ pm.log_theta.T
    top2 = np.sort(scores, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) <= 1e-5 * np.abs(top2[:, 1])
    assert np.array_equal(batched[~near_tie], host[~near_tie])
    with pytest.raises(ValueError, match="non-negative"):
        pt_classify.train_naive_bayes(labels[:2], -np.ones((2, 3)))


def _same_tree(a, b):
    assert (a.feature, a.threshold, a.prediction) == (b.feature, b.threshold, b.prediction)
    if a.feature >= 0:
        _same_tree(a.left, b.left)
        _same_tree(a.right, b.right)


@pytest.mark.parametrize("num_trees,max_depth,seed", [(10, 4, 42), (5, 6, 7)])
def test_random_forest_grows_the_jax_trees(num_trees, max_depth, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, 200).astype(np.float64)
    feats = rng.normal(size=(200, 4)) + labels[:, None]
    jm = jax_classify.train_random_forest(labels, feats, num_trees, max_depth, seed)
    pm = pt_classify.train_random_forest(labels, feats, num_trees, max_depth, seed)
    for a, b in zip(pm.trees, jm.trees):
        _same_tree(a, b)
    X = rng.normal(size=(100, 4)) + 1.0
    assert [pm.predict(x) for x in X] == [jm.predict(x) for x in X]


@pytest.mark.parametrize("name", [None, "add-algorithm", "reading-custom-properties"],
                         ids=["default", "add-algorithm", "reading-custom-properties"])
def test_variants_train_and_serve_like_jax(memory_storage, tmp_path, name):
    custom = name == "reading-custom-properties"
    events = write_events(tmp_path / "ev.jsonl", _events(custom=custom))
    v = variant("classification", name, app=APP)
    jfactory = jax_cl.custom_properties_engine_factory if custom else jax_cl.engine_factory
    jengine, pengine = jfactory(), load_engine_factory(v["engineFactory"])
    jep, pep = jengine.engine_params_from_variant(v), pengine.engine_params_from_variant(v)
    jmodels = jengine.train(jax_store(memory_storage, APP, events), jep)
    pctx = port_store(tmp_path, APP, events)
    pmodels = pengine.prepare_deploy(pctx, pep, pengine.train(pctx, pep))
    _, _, jalgos, _ = jengine.make_components(jep)
    _, _, palgos, pserving = pengine.make_components(pep)
    rng = np.random.default_rng(5)
    keys = ["featureA", "featureB", "featureC", "featureD"] if custom else ["attr0", "attr1", "attr2"]
    payloads = [{k: float(x) for k, x in zip(keys, rng.poisson(4, len(keys)))} for _ in range(40)]
    jq = [jengine.decode_query(p) for p in payloads]
    pq = [pengine.decode_query(p) for p in payloads]
    for jalgo, jm, palgo, pm in zip(jalgos, jmodels, palgos, pmodels):
        got = [palgo.predict(pm, q).to_json_dict() for q in pq]
        assert got == [jalgo.predict(jm, q).to_json_dict() for q in jq]
        assert got == [p.to_json_dict() for p in palgo.predict_batch(pm, pq)]
    assert pserving.serve(pq[0], [palgos[0].predict(pmodels[0], pq[0])]).label in (0.0, 1.0, 2.0)
    if name is None:
        batch = palgos[0].batch_predict(pmodels[0], list(enumerate(pq)))
        assert [(i, r.label) for i, r in batch] == [
            (i, r.label) for i, r in jalgos[0].batch_predict(jmodels[0], list(enumerate(jq)))]


def test_read_eval_waits_for_the_eval_slice(tmp_path, events):
    ds = pt_cl.DataSource(pt_cl.DataSourceParams(app_name=APP, eval_k=3))
    with pytest.raises(NotImplementedError, match="A9"):
        ds.read_eval(port_store(tmp_path, APP, events))


def test_jax_blob_serves_in_the_port(memory_storage, tmp_path, events):
    v = variant("classification", "add-algorithm", app=APP)
    jengine = jax_cl.engine_factory()
    jep = jengine.engine_params_from_variant(v)
    jmodels = jengine.train(jax_store(memory_storage, APP, events), jep)
    pmodels = model_io.deserialize_models(jax_model_io.serialize_models(jmodels))
    assert [type(m) for m in pmodels] == [pt_classify.NaiveBayesModel, pt_classify.RandomForestModel]
    assert isinstance(pmodels[1].trees[0], pt_classify._Node)
    pengine = pt_cl.engine_factory()
    pep = pengine.engine_params_from_variant(v)
    pmodels = pengine.prepare_deploy(port_store(tmp_path, APP, events, mode="serving"), pep, pmodels)
    _, _, jalgos, _ = jengine.make_components(jep)
    _, _, palgos, _ = pengine.make_components(pep)
    rng = np.random.default_rng(9)
    X = rng.poisson(4, size=(50, 3)).astype(float)
    for jalgo, jm, palgo, pm in zip(jalgos, jmodels, palgos, pmodels):
        got = [palgo.predict(pm, pt_cl.Query(*x)).label for x in X]
        assert got == [jalgo.predict(jm, jax_cl.Query(*x)).label for x in X]
    assert np.array_equal(pmodels[0].predict_batch(X), jmodels[0].predict_batch(X))


def test_cli_from_the_jax_add_algorithm_variant(tmp_path, events):
    v = variant("classification", "add-algorithm", app=APP)
    with cli_deployed(tmp_path, APP, events, v) as base:
        code, body = post(base + "/queries.json", {"attr0": 2, "attr1": 0, "attr2": 0})
        assert code == 200 and body["label"] in (0.0, 1.0, 2.0)
        assert post(base + "/queries.json", {"attr0": 1})[0] == 400


def test_trains_and_serves_in_a_process_without_jax(tmp_path, events):
    port_store(tmp_path, APP, events)
    out = no_jax_subprocess(f"""
from predictionio_tpu_torch.data.store import LocalStore
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.models.classification import engine as cl
ctx = WorkflowContext(device="cpu", store=LocalStore({str(tmp_path / "port_home")!r}), app_name={APP!r})
engine = cl.engine_factory()
ep = engine.engine_params_from_variant({{"datasource": {{"params": {{"appName": {APP!r}}}}},
    "algorithms": [{{"name": "naive", "params": {{"lambda": 1.0}}}},
                   {{"name": "randomforest", "params": {{"numTrees": 3}}}}]}})
models = engine.prepare_deploy(ctx, ep, engine.train(ctx, ep))
_, _, algos, _ = engine.make_components(ep)
print(algos[0].predict(models[0], cl.Query(1.0, 2.0, 3.0)).label in (0.0, 1.0, 2.0),
      len(models[0].predict_batch([[1.0, 2.0, 3.0], [0.0, 0.0, 9.0]])))
""")
    assert out.strip() == "True 2"
