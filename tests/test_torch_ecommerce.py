"""The port's e-commerce template against the JAX package's, on the CPU.

The same seeded events (rates, buys, views, item categories, the
``unavailableItems`` and ``weightedItems`` constraints) go through both
packages: the DataSource read, the weighted dot top-k ending (scores within
1e-5), implicit ALS from shared initial factors (factors within atol 1e-3),
and serving with live store reads for known users, cold users with recent
views and cold users without (rankings within rtol 1e-3, ids equal up to
ties) under ``unseenOnly``, the constraints, filters and ``adjust-score``.
Also: the TTL cache's store reads, an event appended after deploy changing
the next answer (in-process and through the CLI), a JAX-written blob served
by the port, and a model with no serving context refusing to guess one.
"""

import subprocess
import time
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu.models.ecommerce import engine as jax_ec  # noqa: E402
from predictionio_tpu.ops import topk as jax_topk  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu_torch.data.event import Event  # noqa: E402
from predictionio_tpu_torch.data.store.event_store import LEventStore  # noqa: E402
from predictionio_tpu_torch.models.ecommerce import engine as pt_ec  # noqa: E402
from predictionio_tpu_torch.ops import topk as pt_topk  # noqa: E402
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
    port_storage,
    port_storage_env,
    post,
    shared_init,
    variant,
    write_events,
)

APP = "ecomapp"
N_ITEMS = 30


def _events(n_users=30, seed=0, with_weights=True):
    rng = np.random.default_rng(seed)
    out, k = [], 0

    def add(**ev):
        nonlocal k
        out.append({"eventId": f"e{k:05d}", "eventTime": event_time(k), **ev})
        k += 1

    for i in range(N_ITEMS - 2):
        add(event="$set", entityType="item", entityId=f"i{i}",
            properties={"categories": [f"c{i % 3}"] + (["sale"] if i % 4 == 0 else [])})
    for _ in range(450):
        u, i = int(rng.integers(n_users)), int(rng.integers(N_ITEMS))
        add(event="rate", entityType="user", entityId=f"u{u}", targetEntityType="item",
            targetEntityId=f"i{i}", properties={"rating": float(rng.integers(1, 6))})
    for _ in range(60):
        u, i = int(rng.integers(n_users)), int(rng.integers(N_ITEMS))
        add(event="buy", entityType="user", entityId=f"u{u}", targetEntityType="item",
            targetEntityId=f"i{i}")
    for _ in range(80):  # views: seen items and the cold users' recent items
        u = ["u1", "u2", "u5", "cold_viewer"][int(rng.integers(4))]
        add(event="view", entityType="user", entityId=u, targetEntityType="item",
            targetEntityId=f"i{int(rng.integers(N_ITEMS))}")
    add(event="$set", entityType="constraint", entityId="unavailableItems",
        properties={"items": ["i3", "i4"]})
    add(event="$set", entityType="constraint", entityId="unavailableItems",
        properties={"items": ["i5", "i6", "nope"]})  # the latest wins
    if with_weights:
        add(event="$set", entityType="constraint", entityId="weightedItems",
            properties={"weights": [{"items": ["i7", "i8", "i9"], "weight": 3.0},
                                    {"items": ["i10"], "weight": 0.25}]})
    return out


@pytest.fixture
def events(tmp_path):
    return write_events(tmp_path / "ev.jsonl", _events())


def _queries(mod):
    Q = mod.Query
    return [
        Q(user="u1", num=5),
        Q(user="u2", num=40),
        Q(user="u3", num=6, categories=frozenset({"sale", "c1"})),
        Q(user="u4", num=4, white_list=frozenset({f"i{i}" for i in range(0, 30, 2)})),
        Q(user="u5", num=5, black_list=frozenset({"i11", "i12", "i13"})),
        Q(user="cold_viewer", num=5),
        Q(user="cold_viewer", num=4, categories=frozenset({"c2"})),
        Q(user="nobody", num=6),
        Q(user="nobody", num=6, black_list=frozenset({"i1"})),
        Q(user="u6", num=0),
    ]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_datasource_read_matches_jax(memory_storage, tmp_path, events, backend):
    jtd = jax_ec.DataSource(jax_ec.DataSourceParams(app_name=APP)).read_training(
        jax_store(memory_storage, APP, events))
    ptd = pt_ec.DataSource(pt_ec.DataSourceParams(app_name=APP)).read_training(
        port_store(tmp_path, APP, events, backend=backend))
    assert (ptd.user_vocab, ptd.item_vocab, ptd.item_categories) == (
        jtd.user_vocab, jtd.item_vocab, jtd.item_categories)
    for name in ("rate_user_idx", "rate_item_idx", "rate_values", "buy_user_idx", "buy_item_idx"):
        np.testing.assert_array_equal(getattr(ptd, name), getattr(jtd, name))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dot_top_k_matches_jax(weighted, masked):
    """The dot ending, with the adjust-score weights: scores within 1e-5,
    ids as sets within ties, weighted scores = plain product x weight."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n, f, B, k = 50, 6, 8, 8
    table = rng.normal(size=(n, f)).astype(np.float32)
    vecs = rng.normal(size=(B, f)).astype(np.float32)
    mask = rng.random((B, n)) < 0.7 if masked else None
    weights = rng.uniform(0.2, 3.0, n) if weighted else None
    want_s, want_i = jax_topk.fetch_topk(jax_topk.dot_top_k_async(
        jnp.asarray(table), vecs.copy(), None if mask is None else mask.copy(), k,
        weights=weights))
    got_s, got_i = pt_topk.fetch_topk(pt_topk.dot_top_k_async(
        torch.from_numpy(table), vecs, mask, k, weights=weights))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    plain = vecs @ table.T
    for row in range(B):
        w = weights[got_i[row]].astype(np.float32) if weighted else 1.0
        np.testing.assert_allclose(got_s[row], plain[row, got_i[row]] * w, rtol=1e-5, atol=1e-5)
        if masked:
            assert mask[row, got_i[row]].all()
        ties = np.isclose(got_s[row], got_s[row][-1], rtol=1e-5, atol=1e-5)
        assert set(got_i[row][~ties]) == set(want_i[row][~ties])


def _trained(memory_storage, tmp_path, events, monkeypatch, name=None, **overrides):
    shared_init(monkeypatch)
    v = variant("ecommerce", name, app=APP, rank=6, numIterations=6, **overrides)
    jengine, pengine = jax_ec.engine_factory(), load_engine_factory(v["engineFactory"])
    jep, pep = jengine.engine_params_from_variant(v), pengine.engine_params_from_variant(v)
    (jm,) = jengine.train(jax_store(memory_storage, APP, events), jep)
    pctx = port_store(tmp_path, APP, events)
    (pm,) = pengine.train(pctx, pep)
    (pm,) = pengine.prepare_deploy(pctx, pep, [pm])
    _, _, (jalgo,), _ = jengine.make_components(jep)
    _, _, (palgo,), _ = pengine.make_components(pep)
    return jalgo, jm, palgo, pm, pctx


def _score_of(algo, model, query):
    """The port's score of an item for a query, before the mask."""
    ctx = model.context()
    uidx = model.user_index(query.user)
    if uidx is not None:
        vec = model.user_factors[uidx]
    else:
        recent = algo._recent_item_indices_live(ctx, model, query.user)
        vec = model.item_factors[recent].sum(0) if recent else None
    weights = algo._weights(ctx, model)

    def score(item):
        i = model.item_index(item)
        s = float(model.popular_counts[i]) if vec is None else float(vec @ model.item_factors[i])
        return s * (float(np.float32(weights[i])) if weights is not None else 1.0)

    return score


@pytest.mark.parametrize("name", [None, "adjust-score"], ids=["default", "adjust-score"])
@pytest.mark.parametrize("unseen_only", [True, False])
def test_train_and_serve_like_jax(memory_storage, tmp_path, events, monkeypatch, name,
                                  unseen_only):
    jalgo, jm, palgo, pm, _ = _trained(memory_storage, tmp_path, events, monkeypatch, name,
                                       unseenOnly=unseen_only)
    np.testing.assert_allclose(pm.item_factors, jm.item_factors, rtol=0, atol=1e-3)
    np.testing.assert_allclose(pm.user_factors, jm.user_factors, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(pm.popular_counts, jm.popular_counts)
    pq, jq = _queries(pt_ec), _queries(jax_ec)
    pres, jres = palgo.predict_batch(pm, pq), jalgo.predict_batch(jm, jq)
    unavailable = {"i5", "i6"}
    for q, got, want in zip(pq, pres, jres):
        assert_same_ranking(got, want, _score_of(palgo, pm, q), rtol=1e-3, atol=1e-3)
        items = {s.item for s in got.item_scores}
        assert not items & unavailable
        if unseen_only:
            seen = palgo._seen_items_live(pm.context(), q.user)
            assert not items & seen
        if q.categories is not None:
            assert all(pm.item_categories[pm.item_index(it)] & q.categories for it in items)
        if q.white_list is not None:
            assert items <= q.white_list
        if q.black_list is not None:
            assert not items & q.black_list
        one = palgo.predict(pm, q)
        assert_same_ranking(one, got, _score_of(palgo, pm, q), rtol=1e-5)
    if name == "adjust-score":  # weighted scores are the plain ones times the weight
        weights = palgo._item_weights_live(pm.context(), pm)
        assert weights[pm.item_index("i7")] == 3.0 and weights[pm.item_index("i10")] == 0.25
        for s in pres[0].item_scores:
            i = pm.item_index(s.item)
            plain = float(pm.user_factors[pm.user_index("u1")] @ pm.item_factors[i])
            np.testing.assert_allclose(s.score, plain * weights[i], rtol=1e-5, atol=1e-6)


def test_adjust_score_without_a_constraint_serves_plain_scores(memory_storage, tmp_path,
                                                               monkeypatch):
    events = write_events(tmp_path / "nw.jsonl", _events(with_weights=False))
    jalgo, jm, palgo, pm, _ = _trained(memory_storage, tmp_path, events, monkeypatch,
                                       "adjust-score")
    assert palgo._weights(pm.context(), pm) is None
    for q, got, want in zip(_queries(pt_ec), palgo.predict_batch(pm, _queries(pt_ec)),
                            jalgo.predict_batch(jm, _queries(jax_ec))):
        assert_same_ranking(got, want, _score_of(palgo, pm, q), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ttl,reads", [(0.0, "every query"), (60.0, "none once warm")])
def test_store_reads_per_query(memory_storage, tmp_path, events, monkeypatch, ttl, reads):
    """cacheTtlS 0 reads the store live on every query (seen items, the
    unavailable and weights constraints, a cold user's recent items); 60
    serves them from the cache once warm."""
    _, _, palgo, pm, ctx = _trained(memory_storage, tmp_path, events, monkeypatch,
                                    "adjust-score", cacheTtlS=ttl)
    calls = []
    real = LEventStore.find_by_entity
    monkeypatch.setattr(LEventStore, "find_by_entity", lambda self, **kw: calls.append(
        (kw["entity_type"], kw["entity_id"])) or real(self, **kw))
    queries = [pt_ec.Query(user="u1"), pt_ec.Query(user="cold_viewer")]
    palgo.predict_batch(pm, queries)  # warm
    calls.clear()
    palgo.predict_batch(pm, queries)
    if ttl == 0:
        # per batch: the weights once; per query: seen items, unavailable;
        # the cold user: its recent items, and the weights once more
        assert calls.count(("constraint", "weightedItems")) == 2
        assert calls.count(("constraint", "unavailableItems")) == 2
        assert ("user", "u1") in calls and calls.count(("user", "cold_viewer")) == 2
    else:
        assert calls == []


def test_an_event_appended_after_deploy_changes_the_next_answer(memory_storage, tmp_path,
                                                                events, monkeypatch):
    """cacheTtlS 0: a view appended by another writer (unseenOnly) and a new
    unavailableItems constraint take effect on the very next query."""
    _, _, palgo, pm, ctx = _trained(memory_storage, tmp_path, events, monkeypatch)
    first = [s.item for s in palgo.predict(pm, pt_ec.Query(user="u7", num=3)).item_scores]
    # another process's storage on the same sqlite file: its own connection
    writer = port_storage(tmp_path).get_l_events()
    app_id = ctx.storage.get_meta_data_apps().get_by_name(APP).id
    writer.insert(Event("view", "user", "u7", "item", first[0]), app_id)
    second = [s.item for s in palgo.predict(pm, pt_ec.Query(user="u7", num=3)).item_scores]
    assert first[0] not in second and second[:2] == first[1:]
    writer.insert(Event("$set", "constraint", "unavailableItems",
                        properties={"items": [second[0]]}), app_id)
    third = [s.item for s in palgo.predict_batch(pm, [pt_ec.Query(user="u7", num=3)])[0].item_scores]
    assert second[0] not in third


def test_jax_blob_serves_in_the_port(memory_storage, tmp_path, events):
    v = variant("ecommerce", "adjust-score", app=APP, rank=5, numIterations=4)
    jengine = jax_ec.engine_factory()
    jep = jengine.engine_params_from_variant(v)
    (jm,) = jengine.train(jax_store(memory_storage, APP, events), jep)
    (pm,) = model_io.deserialize_models(jax_model_io.serialize_models([jm]))
    assert type(pm) is pt_ec.ECommModel
    with pytest.raises(RuntimeError, match="no serving context"):
        pm.context()
    pengine = pt_ec.engine_factory()
    pep = pengine.engine_params_from_variant(v)
    (pm,) = pengine.prepare_deploy(port_store(tmp_path, APP, events, mode="serving"), pep, [pm])
    _, _, (jalgo,), _ = jengine.make_components(jep)
    _, _, (palgo,), _ = pengine.make_components(pep)
    for q, got, want in zip(_queries(pt_ec), palgo.predict_batch(pm, _queries(pt_ec)),
                            jalgo.predict_batch(jm, _queries(jax_ec))):
        assert_same_ranking(got, want, _score_of(palgo, pm, q), rtol=1e-5)


def test_cli_serves_and_sees_a_later_import(tmp_path, events):
    """import -> train -> deploy from the JAX engine.json, then a second
    ``import`` (another process) of an unavailableItems constraint removes
    the top item from the next answer once the result cache's TTL (its
    staleness bound for live reads outside the model, 1 s here) passed."""
    v = variant("ecommerce", None, app=APP, rank=4, numIterations=3)
    with cli_deployed(tmp_path, APP, events, v, deploy_flags=("--result-cache-ttl", "1")) as base:
        code, body = post(base + "/queries.json", {"user": "u3", "num": 4})
        assert code == 200 and len(body["itemScores"]) == 4
        top = body["itemScores"][0]["item"]
        code, cold = post(base + "/queries.json", {"user": "cold_viewer", "num": 3})
        assert code == 200 and len(cold["itemScores"]) == 3
        later = write_events(tmp_path / "later.jsonl", [{
            "event": "$set", "entityType": "constraint", "entityId": "unavailableItems",
            "properties": {"items": [top]}, "eventTime": "2024-04-01T00:00:00.000Z"}])
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home",
             str(tmp_path / "h"), "import", "--appname", APP, "--input", str(later)],
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        time.sleep(1.1)  # past the cache's TTL
        code, body = post(base + "/queries.json", {"user": "u3", "num": 4})
        assert code == 200 and top not in {s["item"] for s in body["itemScores"]}
        assert post(base + "/queries.json", {"num": 3})[0] == 400


def test_trains_and_serves_in_a_process_without_jax(tmp_path, events):
    port_store(tmp_path, APP, events)
    out = no_jax_subprocess(f"""
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.workflow.context import WorkflowContext
from predictionio_tpu_torch.models.ecommerce import engine as ec
ctx = WorkflowContext(device="cpu", _storage=Storage(env={port_storage_env(tmp_path)!r}), app_name={APP!r})
engine = ec.engine_factory()
ep = engine.engine_params_from_variant({{"datasource": {{"params": {{"appName": {APP!r}}}}},
    "algorithms": [{{"name": "ecomm", "params": {{"appName": {APP!r}, "unseenOnly": True,
                                                  "rank": 3, "numIterations": 2}}}}]}})
models = engine.prepare_deploy(ctx, ep, engine.train(ctx, ep))
_, _, algos, _ = engine.make_components(ep)
print(len(algos[0].predict(models[0], ec.Query(user="u1", num=3)).item_scores))
""")
    assert out.strip() == "3"
