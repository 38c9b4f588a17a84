"""The port's recommended-user template against the JAX package's, on the CPU.

The same seeded follow graph (users in communities, most follows inside
the community, some repeated) goes through both packages: the DataSource
read, implicit ALS from shared initial factors (factors within atol 1e-3,
rankings with scores within rtol 1e-3 and ids equal up to ties) with
white/black lists and several query users, a JAX-written blob served by the
port (rtol 1e-5), the CLI from import to ``POST /queries.json`` from the
JAX engine.json, and a train and serve in a process without JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu.models.recommendeduser import engine as jax_ru  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu_torch.models.recommendeduser import engine as pt_ru  # noqa: E402
from predictionio_tpu_torch.workflow import model_io  # noqa: E402
from predictionio_tpu_torch.workflow.engine_loader import load_engine_factory  # noqa: E402
from torch_template_helpers import (  # noqa: E402
    assert_same_ranking,
    cli_deployed,
    event_time,
    jax_store,
    no_jax_subprocess,
    PORT_BACKENDS,
    port_store,
    port_storage_env,
    post,
    shared_init,
    variant,
    write_events,
)

APP = "followapp"


def _events(n_users=40, n_follows=500, seed=0):
    rng = np.random.default_rng(seed)
    community = np.arange(n_users) % 4
    out = []
    for k in range(n_follows):
        u = int(rng.integers(n_users))
        same = np.flatnonzero(community == community[u])
        v = int(rng.choice(same)) if rng.random() < 0.9 else int(rng.integers(n_users))
        if v == u:
            continue
        out.append({"eventId": f"e{k:05d}", "event": "follow", "entityType": "user",
                    "entityId": f"u{u}", "targetEntityType": "user", "targetEntityId": f"u{v}",
                    "eventTime": event_time(k)})
    out.append({"eventId": "x1", "event": "view", "entityType": "user", "entityId": "u1",
                "targetEntityType": "item", "targetEntityId": "i1", "eventTime": event_time(9000)})
    return out


@pytest.fixture
def events(tmp_path):
    return write_events(tmp_path / "ev.jsonl", _events())


def _queries(mod):
    Q = mod.Query
    return [
        Q(users=("u1",), num=5),
        Q(users=("u2", "u6", "u10"), num=4),
        Q(users=("u3",), num=50),
        Q(users=("u4",), num=3, white_list=frozenset({f"u{i}" for i in range(0, 40, 3)})),
        Q(users=("u5",), num=5, black_list=frozenset({"u9", "u13", "u17"})),
        Q(users=("nobody",), num=3),
        Q(users=("u7",), num=0),
    ]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_datasource_read_matches_jax(memory_storage, tmp_path, events, backend):
    jtd = jax_ru.DataSource(jax_ru.DataSourceParams(app_name=APP)).read_training(
        jax_store(memory_storage, APP, events))
    ptd = pt_ru.DataSource(pt_ru.DataSourceParams(app_name=APP)).read_training(
        port_store(tmp_path, APP, events, backend=backend))
    assert ptd.user_vocab == jtd.user_vocab and ptd.followed_vocab == jtd.followed_vocab
    np.testing.assert_array_equal(ptd.follower_idx, jtd.follower_idx)
    np.testing.assert_array_equal(ptd.followed_idx, jtd.followed_idx)


def _score_of(model, query):
    qidx = [model.user_index(u) for u in query.users if model.user_index(u) is not None]

    def score(user):
        return float(model.followed_factors[qidx].sum(0) @ model.followed_factors[model.user_index(user)])

    return score


def test_train_and_serve_like_jax(memory_storage, tmp_path, events, monkeypatch):
    shared_init(monkeypatch)
    v = variant("recommendeduser", None, app=APP, rank=6, numIterations=6)
    jengine, pengine = jax_ru.engine_factory(), load_engine_factory(v["engineFactory"])
    jep, pep = jengine.engine_params_from_variant(v), pengine.engine_params_from_variant(v)
    (jm,) = jengine.train(jax_store(memory_storage, APP, events), jep)
    pctx = port_store(tmp_path, APP, events)
    (pm,) = pengine.prepare_deploy(pctx, pep, pengine.train(pctx, pep))
    np.testing.assert_allclose(pm.followed_factors, jm.followed_factors, rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(pm.followed_factors, axis=1), 1.0, rtol=1e-5)
    _, _, (jalgo,), _ = jengine.make_components(jep)
    _, _, (palgo,), _ = pengine.make_components(pep)
    pq = _queries(pt_ru)
    pres, jres = palgo.predict_batch(pm, pq), jalgo.predict_batch(jm, _queries(jax_ru))
    for q, got, want in zip(pq, pres, jres):
        assert_same_ranking(got, want, _score_of(pm, q), rtol=1e-3, atol=1e-3)
        users = {s.user for s in got.similar_user_scores}
        assert not users & set(q.users)
        if q.white_list is not None:
            assert users <= q.white_list
        if q.black_list is not None:
            assert not users & q.black_list
        assert_same_ranking(palgo.predict(pm, q), got, _score_of(pm, q), rtol=1e-5)
    assert pres[5].to_json_dict() == {"similarUserScores": []}


def test_jax_blob_serves_in_the_port(memory_storage, tmp_path, events):
    v = variant("recommendeduser", None, app=APP, rank=5, numIterations=4)
    jengine = jax_ru.engine_factory()
    jep = jengine.engine_params_from_variant(v)
    (jm,) = jengine.train(jax_store(memory_storage, APP, events), jep)
    (pm,) = model_io.deserialize_models(jax_model_io.serialize_models([jm]))
    assert type(pm) is pt_ru.SimilarUserModel
    pengine = pt_ru.engine_factory()
    pep = pengine.engine_params_from_variant(v)
    (pm,) = pengine.prepare_deploy(port_store(tmp_path, APP, events, mode="serving"), pep, [pm])
    _, _, (jalgo,), _ = jengine.make_components(jep)
    _, _, (palgo,), _ = pengine.make_components(pep)
    for q, got, want in zip(_queries(pt_ru), palgo.predict_batch(pm, _queries(pt_ru)),
                            jalgo.predict_batch(jm, _queries(jax_ru))):
        assert_same_ranking(got, want, _score_of(pm, q), rtol=1e-5)


def test_cli_from_the_jax_engine_json(tmp_path, events):
    v = variant("recommendeduser", None, app=APP, rank=4, numIterations=3)
    with cli_deployed(tmp_path, APP, events, v) as base:
        code, body = post(base + "/queries.json", {"users": ["u1", "u5"], "num": 4})
        assert code == 200 and len(body["similarUserScores"]) == 4
        assert not {"u1", "u5"} & {s["user"] for s in body["similarUserScores"]}
        code, body = post(base + "/queries.json", {"users": ["nobody"]})
        assert code == 200 and body == {"similarUserScores": []}
        assert post(base + "/queries.json", {"num": 3})[0] == 400


def test_trains_and_serves_in_a_process_without_jax(tmp_path, events):
    port_store(tmp_path, APP, events)
    out = no_jax_subprocess(f"""
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.models.recommendeduser import engine as ru
ctx = WorkflowContext(device="cpu", _storage=Storage(env={port_storage_env(tmp_path)!r}), app_name={APP!r})
engine = ru.engine_factory()
ep = engine.engine_params_from_variant({{"datasource": {{"params": {{"appName": {APP!r}}}}},
    "algorithms": [{{"name": "als", "params": {{"rank": 3, "numIterations": 2}}}}]}})
models = engine.prepare_deploy(ctx, ep, engine.train(ctx, ep))
_, _, algos, _ = engine.make_components(ep)
print(len(algos[0].predict(models[0], ru.Query(users=("u1",), num=3)).similar_user_scores))
""")
    assert out.strip() == "3"


def test_quality_gate_is_the_jax_packages_value():
    """chip_smoke.py gates the card's same-community share of each user's
    top-10 similar users (50,000 users) at the JAX package's CPU value on
    the small graph FOLLOW_GATE_GRAPH less 0.05: that value is recomputed
    here and must be the constant; the port on the CPU passes the gate on
    the same graph."""
    from predictionio_tpu.workflow.context import WorkflowContext as JaxContext
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from torch_template_helpers import chip_smoke

    cs = chip_smoke()
    n_users, n_comm, n_follows = cs.FOLLOW_GATE_GRAPH
    follower, followed = cs.follow_graph(n_users, n_comm, n_follows, seed=8)
    users = np.random.default_rng(41).choice(n_users, 512, replace=False)
    vocab = [f"u{i}" for i in range(n_users)]
    shares = {}
    for mod, ctx in ((jax_ru, JaxContext()), (pt_ru, WorkflowContext(device="cpu"))):
        algo = mod.ALSAlgorithm(mod.ALSAlgorithmParams(**cs.GALLERY_ALS))
        model = algo.train(ctx, mod.TrainingData(vocab, vocab, follower, followed))
        shares[mod] = cs.similar_users_share(algo, model, mod.Query, users, n_comm)
    assert round(shares[jax_ru], 4) == cs.JAX_CPU_FOLLOW_COMMUNITY_SHARE
    assert shares[pt_ru] > cs.JAX_CPU_FOLLOW_COMMUNITY_SHARE - 0.05
