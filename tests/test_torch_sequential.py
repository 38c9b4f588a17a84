"""The port's sequential template end to end, against the JAX package's, on
the CPU: the ordered session read, the Markov math, both scorers, model
blobs carried across, the top-k endings, the CLI in a subprocess, and the
rule that the new modules import no JAX.

Tolerances: the Markov path is host arithmetic on the same counts and must
agree exactly. The attention scorer differs by design at bf16 rounding: the
JAX package serves through ``attention_reference`` in f32 on the CPU, the
port through the plain version of kernel B2 (bf16 products, f32 sums). So
served scores agree within 2e-2·max|score|, and ids wherever the gap to the
neighbouring score is larger than that. Two trains start from initial
factors of different generators, so they are compared by held-out
hit-rate@10 (within 0.05).
"""

import datetime as dt
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
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in parallel worker processes

import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.data.datamap import DataMap  # noqa: E402
from predictionio_tpu.data.event import Event as JaxEvent  # noqa: E402
from predictionio_tpu.data.storage.base import App  # noqa: E402
from predictionio_tpu.e2 import markov_chain as jax_mc  # noqa: E402
from predictionio_tpu.models.sequential import engine as jax_seq  # noqa: E402
from predictionio_tpu.ops import topk as jax_topk  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.data.event import Event, event_seq_key  # noqa: E402
from predictionio_tpu_torch.data.store import LocalStore  # noqa: E402
from predictionio_tpu_torch.e2 import markov_chain as pt_mc  # noqa: E402
from predictionio_tpu_torch.models.sequential import engine as pt_seq  # noqa: E402
from predictionio_tpu_torch.ops import topk as pt_topk  # noqa: E402
from predictionio_tpu_torch.workflow import model_io  # noqa: E402
from predictionio_tpu_torch.workflow.context import WorkflowContext  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT_PKG = REPO / "predictionio_tpu_torch"
APP = "seqapp"
UTC = dt.timezone.utc
T0 = dt.datetime(2024, 6, 1, tzinfo=UTC)


def hop_sessions(n_users, n_items, length, seed):
    """The bench's hop generator (bench.py:2731-2740): each item moves on to
    item + 1..3 with probability 0.7, else to a random item."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        s = [int(rng.integers(n_items))]
        for _ in range(length - 1):
            if rng.random() < 0.7:
                s.append((s[-1] + int(rng.integers(1, 4))) % n_items)
            else:
                s.append(int(rng.integers(n_items)))
        seqs.append(np.asarray(s, np.int32))
    return seqs


def _wire_events(seed=0, n_users=12, n_items=9):
    """view sessions interleaved across users, with ties in creation time
    broken by id, inserted in shuffled order, plus events the reader must
    skip. Every event carries its creationTime and eventId."""
    rng = np.random.default_rng(seed)
    events = []
    n = 0
    for step in range(8):
        for u in range(n_users):
            if rng.random() < 0.25:
                continue
            n += 1
            tick = n // 3  # three events share each creation microsecond
            ct = T0 + dt.timedelta(seconds=tick)
            events.append({
                "event": "view", "entityType": "user", "entityId": f"u{u}",
                "targetEntityType": "item", "targetEntityId": f"i{int(rng.integers(n_items))}",
                "eventTime": (T0 + dt.timedelta(seconds=n)).isoformat(),
                "creationTime": ct.isoformat(),
                "eventId": f"e{rng.integers(1 << 30):09d}",
            })
    events.append({"event": "buy", "entityType": "user", "entityId": "u1",
                   "targetEntityType": "item", "targetEntityId": "i1",
                   "creationTime": T0.isoformat(), "eventId": "zz-buy"})
    events.append({"event": "view", "entityType": "shop", "entityId": "s1",
                   "targetEntityType": "item", "targetEntityId": "i2",
                   "creationTime": T0.isoformat(), "eventId": "zz-shop"})
    order = rng.permutation(len(events))
    return [events[i] for i in order]


def _jax_event(d):
    return JaxEvent(
        event=d["event"], entity_type=d["entityType"], entity_id=d["entityId"],
        target_entity_type=d.get("targetEntityType"), target_entity_id=d.get("targetEntityId"),
        properties=DataMap({}),
        event_time=dt.datetime.fromisoformat(d.get("eventTime", d["creationTime"])),
        creation_time=dt.datetime.fromisoformat(d["creationTime"]),
        event_id=d["eventId"],
    )


def _jax_read(memory_storage, wire, page=3):
    memory_storage.get_meta_data_apps().insert(App(0, APP))
    app_id = memory_storage.get_meta_data_apps().get_by_name(APP).id
    levents = memory_storage.get_l_events()
    for d in wire:
        levents.insert(_jax_event(d), app_id)
    ds = jax_seq.DataSource(jax_seq.DataSourceParams(app_name=APP, page=page))
    return ds.read_training(JaxContext(_storage=memory_storage))


def _port_store(tmp_path, wire):
    store = LocalStore(tmp_path / "home")
    store.create_app(APP)
    path = tmp_path / "events.jsonl"
    path.write_text("".join(json.dumps(d) + "\n" for d in wire))
    store.import_file(APP, str(path))
    return store


def _port_read(store, page=3):
    ctx = WorkflowContext(device="cpu", store=store)
    return pt_seq.DataSource(pt_seq.DataSourceParams(app_name=APP, page=page)).read_training(ctx)


# ---------------------------------------------------------------------------
# ordered read and Markov math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page", [1, 3, 2048])
def test_read_training_matches_jax_including_creation_time_ties(memory_storage, tmp_path, page):
    wire = _wire_events(seed=1)
    jtd = _jax_read(memory_storage, wire, page)
    ptd = _port_read(_port_store(tmp_path, wire), page)
    assert ptd.users == jtd.users
    assert ptd.item_vocab == jtd.item_vocab
    for a, b in zip(ptd.sequences, jtd.sequences):
        np.testing.assert_array_equal(a, b)
    assert "s1" not in ptd.users and len(ptd.users) == 12


def test_iter_ordered_orders_by_seq_key_and_takes_the_head_at_entry(tmp_path):
    wire = _wire_events(seed=2)
    store = _port_store(tmp_path, wire)
    events = store.iter_ordered(APP, page=2)
    first = next(events)
    store.append(APP, [Event.from_json_dict({  # lands after the read began
        "event": "view", "entityType": "user", "entityId": "late",
        "targetEntityType": "item", "targetEntityId": "i0", "eventId": "late"})])
    rest = [first, *events]
    assert len(rest) == len(wire)
    keys = [event_seq_key(e) for e in rest]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert [e.event_id for e in store.iter_ordered(APP, max_events=5)] == [e.event_id for e in rest[:5]]
    assert any(e.entity_id == "late" for e in store.iter_ordered(APP))
    with pytest.raises(ValueError):
        store.iter_ordered(APP, page=0)


def test_event_seq_key_matches_jax():
    for d in _wire_events(seed=3)[:20]:
        from predictionio_tpu.data.storage.base import event_seq_key as jax_key

        assert event_seq_key(Event.from_json_dict(d)) == jax_key(_jax_event(d))


def test_sequences_and_markov_match_jax_exactly():
    seqs = hop_sessions(30, 25, 12, seed=4)
    events = []
    for u, s in enumerate(seqs):
        for k, i in enumerate(s):
            events.append((u, k, int(i)))
    events.sort(key=lambda t: (t[1], t[0]))  # interleave users

    def wire(cls, props):
        return [cls(event="view", entity_type="user", entity_id=f"u{u}", target_entity_type="item",
                    target_entity_id=f"i{i}", properties=props()) for u, _, i in events]

    kw = dict(event_names=("view",), entity_type="user", target_entity_type="item")
    pu, pv = pt_seq.sequences_from_events(iter(wire(Event, dict)), **kw)
    ju, jv = jax_seq.sequences_from_events(iter(wire(JaxEvent, lambda: DataMap({}))), **kw)
    assert pu == ju and pv == jv
    users = sorted(pu)
    pseqs = [np.asarray(pu[u], np.int32) for u in users]
    pm, pc = pt_seq.build_markov(pseqs, len(pv), 5)
    jm, jc = jax_seq.build_markov(pseqs, len(jv), 5)
    assert pc == jc
    assert pm.transitions == jm.transitions and (pm.n_states, pm.top_n) == (jm.n_states, jm.top_n)
    coords = pt_seq.transition_coordinates(pseqs)
    assert coords == jax_seq.transition_coordinates(pseqs)
    assert pt_mc.train_markov_chain(coords, 25, 3).transitions == jax_mc.train_markov_chain(coords, 25, 3).transitions
    assert pt_seq.markov_from_counts(pc, 25, 5).transitions == jm.transitions
    assert pt_seq.last_items(pseqs, users) == jax_seq.last_items(pseqs, users)


def test_markov_tie_order_is_minus_p_then_state():
    m = pt_mc.train_markov_chain([(0, 3, 1.0), (0, 1, 1.0), (0, 2, 2.0), (0, 1, 0.0)], 4, 3)
    assert [j for j, _ in m.transition_probs(0)] == [2, 1, 3]
    assert m.predict(0) == 2 and m.predict(7) is None


# ---------------------------------------------------------------------------
# scorers
# ---------------------------------------------------------------------------


def _td(mod, seqs, n_items):
    return mod.TrainingData([f"u{k}" for k in range(len(seqs))], list(seqs), [f"i{j}" for j in range(n_items)])


def _queries(mod, vocab, seqs, n=24):
    out = [mod.Query(recent_items=tuple(vocab[i] for i in s[-(1 + k % 12):]), num=1 + k % 12)
           for k, s in enumerate(seqs[:n])]
    out += [mod.Query(user="u3", num=5), mod.Query(user="nobody", num=4),
            mod.Query(recent_items=("not-an-item",), num=3),
            mod.Query(user="u4", recent_items=(vocab[0], "x", vocab[2]), num=30)]
    return out


def test_markov_predict_matches_jax_exactly():
    seqs = hop_sessions(40, 30, 10, seed=5)
    palgo = pt_seq.MarkovAlgorithm(pt_seq.MarkovAlgorithmParams(top_n=6))
    jalgo = jax_seq.MarkovAlgorithm(jax_seq.MarkovAlgorithmParams(top_n=6))
    pm = palgo.train(WorkflowContext(device="cpu"), _td(pt_seq, seqs, 30))
    jm = jalgo.train(JaxContext(), _td(jax_seq, seqs, 30))
    for pq, jq in zip(_queries(pt_seq, pm.item_vocab, seqs), _queries(jax_seq, jm.item_vocab, seqs)):
        assert palgo.predict(pm, pq).to_json_dict() == jalgo.predict(jm, jq).to_json_dict()


@pytest.fixture(scope="module")
def jax_attention():
    seqs = hop_sessions(60, 40, 14, seed=6)
    jalgo = jax_seq.AttentionAlgorithm(jax_seq.AttentionAlgorithmParams(rank=8, num_iterations=4, context=8))
    jmodel = jalgo.train(JaxContext(), _td(jax_seq, seqs, 40))
    return seqs, jalgo, jmodel


def _assert_served_alike(pt_results, jax_results, pt_queries, model):
    banned_of = [set(model.session_indices(q)) for q in pt_queries]
    for p, j, banned in zip(pt_results, jax_results, banned_of):
        ps = np.asarray([s.score for s in p.item_scores])
        js = np.asarray([s.score for s in j.item_scores])
        assert len(ps) == len(js)
        if not len(js):
            continue
        tol = 2e-2 * np.abs(js).max()
        np.testing.assert_allclose(ps, js, rtol=0, atol=tol)
        assert list(ps) == sorted(ps, reverse=True)
        vocab_idx = model.item_index()
        assert not banned & {vocab_idx[s.item] for s in p.item_scores}
        for pos in range(len(js) - 1):
            gaps = [abs(js[pos] - js[pos + 1])] + ([abs(js[pos] - js[pos - 1])] if pos else [])
            if min(gaps) > tol:
                assert p.item_scores[pos].item == j.item_scores[pos].item


def test_jax_trained_attention_model_serves_alike_from_numpy_and_blob(jax_attention):
    seqs, jalgo, jmodel = jax_attention
    palgo = pt_seq.AttentionAlgorithm(pt_seq.AttentionAlgorithmParams(rank=8, context=8))
    ctx = WorkflowContext(device="cpu")
    from_numpy = convert.sequential_model_from_numpy(
        jmodel.item_vocab, jmodel.item_in, jmodel.item_out, jmodel.pair_counts,
        jmodel.user_last, jmodel.top_n, jmodel.context,
    )
    (from_blob,) = model_io.deserialize_models(jax_model_io.serialize_models([jmodel]))
    assert type(from_blob) is pt_seq.SequentialModel
    assert type(from_blob.markov) is pt_mc.MarkovChainModel
    assert from_numpy.markov.transitions == jmodel.markov.transitions
    jq = _queries(jax_seq, jmodel.item_vocab, seqs)
    pq = _queries(pt_seq, jmodel.item_vocab, seqs)
    want = jalgo.predict_batch(jmodel, jq)
    assert any(r.item_scores for r in want)
    for pmodel in (from_numpy, from_blob):
        pmodel = palgo.prepare_model(ctx, pmodel)
        _assert_served_alike(palgo.predict_batch(pmodel, pq), want, pq, pmodel)
        assert palgo.predict(pmodel, pt_seq.Query(user="nobody")).item_scores == ()


def test_sequential_model_from_numpy_rejects_mismatched_tables(jax_attention):
    _, _, m = jax_attention
    with pytest.raises(ValueError):
        convert.sequential_model_from_numpy(m.item_vocab, m.item_in[:, :3], m.item_out, {}, {})
    with pytest.raises(ValueError):
        convert.sequential_model_from_numpy(m.item_vocab, m.item_in, None, {}, {})
    with pytest.raises(ValueError, match="outside"):
        convert.sequential_model_from_numpy(m.item_vocab, None, None, {(0, 999): 1.0}, {})
    markov_only = convert.sequential_model_from_numpy(m.item_vocab, None, None, m.pair_counts, m.user_last)
    assert markov_only.item_in is None and markov_only.markov.transitions


@pytest.fixture(scope="module")
def trained_pair():
    """The port and the JAX package each train the attention algorithm on
    the same hop sessions, the last item of each held out."""
    seqs = hop_sessions(300, 200, 25, seed=7)
    prefix = [s[:-1] for s in seqs]
    params = dict(rank=16, num_iterations=8, context=8)
    palgo = pt_seq.AttentionAlgorithm(pt_seq.AttentionAlgorithmParams(**params))
    jalgo = jax_seq.AttentionAlgorithm(jax_seq.AttentionAlgorithmParams(**params))
    pm = palgo.train(WorkflowContext(device="cpu"), _td(pt_seq, prefix, 200))
    jm = jalgo.train(JaxContext(), _td(jax_seq, prefix, 200))
    return seqs, (palgo, pt_seq, pm), (jalgo, jax_seq, jm)


def _held_out_hit_rate(seqs, algo, mod, model, session: bool):
    """hit-rate@10 of each session's held-out last item. A bare-user query
    is answered from the stored last item of the training prefix (a window
    of one item repeated); a session query sends the 8 items before the
    held-out one as recentItems, so the attention mixes 8 items."""
    queries = [mod.Query(recent_items=tuple(f"i{i}" for i in s[-9:-1]), num=10) if session
               else mod.Query(user=f"u{k}", num=10) for k, s in enumerate(seqs)]
    res = algo.predict_batch(model, queries)
    return float(np.mean([f"i{s[-1]}" in {x.item for x in r.item_scores} for r, s in zip(res, seqs)]))


def test_port_train_hit_rate_within_005_of_jax(trained_pair):
    """Held-out last item of each session, queried as a bare user."""
    seqs, port, jax_side = trained_pair
    assert port[2].item_in.shape == (200, 16) and port[2].item_in.dtype == np.float32
    p_hr = _held_out_hit_rate(seqs, *port, session=False)
    j_hr = _held_out_hit_rate(seqs, *jax_side, session=False)
    assert j_hr > 0.3  # the scorer learned the hops
    assert abs(p_hr - j_hr) <= 0.05, (p_hr, j_hr)


def test_port_train_session_hit_rate_within_005_of_jax(trained_pair):
    """The same held-out items queried with 8-item sessions. Both packages
    score these below their bare-user rate (the window's average dilutes
    the last item, which alone predicts a hop), and far above chance
    (10 of 200 items)."""
    seqs, port, jax_side = trained_pair
    p_hr = _held_out_hit_rate(seqs, *port, session=True)
    j_hr = _held_out_hit_rate(seqs, *jax_side, session=True)
    assert j_hr > 4 * 10 / 200
    assert j_hr < _held_out_hit_rate(seqs, *jax_side, session=False)
    assert abs(p_hr - j_hr) <= 0.05, (p_hr, j_hr)


def test_markov_only_model_on_attention_lane_uses_host_scorer():
    seqs = hop_sessions(20, 15, 8, seed=8)
    mm = pt_seq.MarkovAlgorithm(pt_seq.MarkovAlgorithmParams()).train(
        WorkflowContext(device="cpu"), _td(pt_seq, seqs, 15))
    assert mm.item_in is None
    alg = pt_seq.AttentionAlgorithm(pt_seq.AttentionAlgorithmParams())
    q = pt_seq.Query(recent_items=("i3",), num=4)
    assert alg.predict(mm, q) == pt_seq.MarkovAlgorithm(pt_seq.MarkovAlgorithmParams()).predict(mm, q)


def test_model_state_matches_jax_and_drops_device_tables(jax_attention):
    _, _, jm = jax_attention
    pm = convert.sequential_model_from_numpy(
        jm.item_vocab, jm.item_in, jm.item_out, jm.pair_counts, jm.user_last, jm.top_n, jm.context)
    pm.device = "cpu"
    assert pm.device_in() is pm.device_in()  # built once
    state = pm.__getstate__()
    assert sorted(state) == sorted(jm.__getstate__())
    (back,) = model_io.deserialize_models(model_io.serialize_models([pm]))
    assert back._dev_in is None and back.device == "cuda"
    np.testing.assert_array_equal(back.item_out, jm.item_out)


def test_jax_engine_json_with_eval_params_trains_the_same(tmp_path):
    """``evalParams`` in a JAX engine.json parses in both packages, is kept
    for the eval folds, and the train reads and learns exactly as without."""
    store = _port_store(tmp_path, _wire_events(seed=9))
    base = {"datasource": {"params": {"appName": APP}},
            "algorithms": [{"name": "markov", "params": {}}]}
    variant = json.loads(json.dumps(base))
    variant["datasource"]["params"]["evalParams"] = {"kFold": 2, "queryNum": 5, "holdoutTail": 1}
    jax_seq.engine_factory().engine_params_from_variant(variant)  # the JAX package takes it
    engine = pt_seq.engine_factory()
    with_key, without = (engine.engine_params_from_variant(v) for v in (variant, base))
    assert with_key.data_source[1].eval_params == pt_seq.EvalParams(
        k_fold=2, query_num=5, holdout_tail=1)
    ctx = WorkflowContext(device="cpu", store=store)
    (m1,), (m2,) = (engine.train(ctx, ep) for ep in (with_key, without))
    assert m1.pair_counts == m2.pair_counts and m1.user_last == m2.user_last
    assert m1.item_vocab == m2.item_vocab


def test_read_eval_waits_for_the_eval_slice(tmp_path):
    ds = pt_seq.DataSource(pt_seq.DataSourceParams(app_name=APP))
    with pytest.raises(NotImplementedError, match="eval"):
        ds.read_eval(WorkflowContext(device="cpu", store=LocalStore(tmp_path)))


# ---------------------------------------------------------------------------
# top-k endings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_dot_top_k_matches_jax(masked):
    rng = np.random.default_rng(9)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    vecs = rng.normal(size=(4, 6)).astype(np.float32)
    mask = rng.random((4, 50)) < 0.6 if masked else None
    handle = pt_topk.dot_top_k_async(torch.from_numpy(table), vecs, mask, 8)
    assert handle.shape == (4, 2, 8) and handle.dtype == torch.int32
    ps, pi = pt_topk.fetch_topk(handle)
    js, ji = jax_topk.fetch_topk(jax_topk.dot_top_k_async(jnp.asarray(table), vecs, mask, 8))
    np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pi, ji)


def test_host_top_k_matches_jax():
    rng = np.random.default_rng(10)
    scores = rng.random(30)
    scores[[3, 7]] = -np.inf
    mask = rng.random(30) < 0.5
    for k in (0, 1, 5, 40):
        for m in (None, mask):
            ps, pi = pt_topk.host_top_k(scores, m, k)
            js, ji = jax_topk.host_top_k(scores, m, k)
            np.testing.assert_array_equal(ps, js)
            np.testing.assert_array_equal(pi, ji)


def test_scratch_full_and_warmup_buckets():
    pool = pt_topk.ScratchBuffers()
    view = pool.full("m", (3, 5), bool, True)
    assert view.all() and view.shape == (3, 5)
    seen = []
    pt_topk.warmup_pow2_buckets(20, lambda b: seen.append(b) or torch.zeros(b))
    assert seen == [1, 2, 4, 8, 16, 32]


# ---------------------------------------------------------------------------
# server, CLI and the import rule
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_query_server_batches_sequential_queries(tmp_path, jax_attention):
    import concurrent.futures

    from predictionio_tpu_torch.workflow.create_server import QueryServer, ServerConfig

    seqs, _, jm = jax_attention
    model = convert.sequential_model_from_numpy(
        jm.item_vocab, jm.item_in, jm.item_out, jm.pair_counts, jm.user_last)
    ctx = WorkflowContext(device="cpu", store=LocalStore(tmp_path))
    engine = pt_seq.engine_factory()
    ep = engine.engine_params_from_variant(
        {"datasource": {"params": {"appName": APP}},
         "algorithms": [{"name": "attention", "params": {"rank": 8}}]})
    models = engine.prepare_deploy(ctx, ep, [model])
    server = QueryServer(engine, ep, models, ctx, ServerConfig(ip="127.0.0.1", port=0, max_batch=16))
    port = server.start()
    url = f"http://127.0.0.1:{port}/queries.json"
    try:
        payloads = [{"recentItems": [f"i{i}" for i in s[-5:]], "num": 4} for s in seqs[:40]]
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            outs = list(pool.map(lambda p: _post(url, p), payloads))
        algo = pt_seq.AttentionAlgorithm(pt_seq.AttentionAlgorithmParams(rank=8))
        for p, (code, body) in zip(payloads, outs):
            assert code == 200
            want = algo.predict(models[0], pt_seq.Query.from_json_dict(p)).to_json_dict()
            assert [s["item"] for s in body["itemScores"]] == [s["item"] for s in want["itemScores"]]
            assert not set(p["recentItems"]) & {s["item"] for s in body["itemScores"]}
        assert _post(url, [1, 2])[0] == 400  # a payload of the wrong type fails alone
        assert _post(url, {"user": "nobody"}) == (200, {"itemScores": []})
        assert server.batcher.queries_dispatched == 42
    finally:
        server.shutdown()


def test_cli_import_train_deploy_sequential_on_cpu(tmp_path):
    seqs = hop_sessions(30, 25, 12, seed=11)
    lines = []
    n = 0
    for u, s in enumerate(seqs):
        for i in s:
            n += 1
            lines.append({"event": "view", "entityType": "user", "entityId": f"u{u}",
                          "targetEntityType": "item", "targetEntityId": f"i{i}",
                          "creationTime": (T0 + dt.timedelta(milliseconds=n)).isoformat(),
                          "eventId": f"e{n:06d}"})
    events = tmp_path / "ev.jsonl"
    events.write_text("".join(json.dumps(x) + "\n" for x in lines))
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "seq-cli-test",
        "engineFactory": "predictionio_tpu_torch.models.sequential.engine.engine_factory",
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "attention", "params": {"rank": 4, "numIterations": 3, "context": 6}}],
    }))
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(tmp_path / "h")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}

    def run(*args):
        out = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        return out.stdout

    run("app", "new", APP)
    assert f"Imported {len(lines)} events" in run("import", "--appname", APP, "--input", str(events))
    assert "Training completed" in run("train", "--engine-dir", str(engine_dir), "--device", "cpu")
    port = _free_port()
    err_path = tmp_path / "deploy.err"
    with open(err_path, "w") as err:  # the child keeps its own copy
        server = subprocess.Popen(
            [*cli, "deploy", "--engine-dir", str(engine_dir), "--device", "cpu",
             "--ip", "127.0.0.1", "--port", str(port)],
            env=env, stdout=subprocess.DEVNULL, stderr=err,
        )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert server.poll() is None, err_path.read_text()
            try:
                with urllib.request.urlopen(base + "/", timeout=2) as r:
                    status = json.loads(r.read())
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        assert status["device"] == "cpu"
        session = [f"i{i}" for i in seqs[0][-4:]]
        code, body = _post(base + "/queries.json", {"recentItems": session, "num": 5})
        assert code == 200 and len(body["itemScores"]) == 5
        assert not set(session) & {s["item"] for s in body["itemScores"]}
        code, body = _post(base + "/queries.json", {"user": "u2", "num": 3})
        assert code == 200 and len(body["itemScores"]) == 3
        assert f"i{seqs[2][-1]}" not in {s["item"] for s in body["itemScores"]}
        assert _post(base + "/queries.json", {"user": "nobody"}) == (200, {"itemScores": []})
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    assert server.returncode == 0


def test_cli_sequential_train_refuses_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from predictionio_tpu_torch.tools import cli

    for verb in ("train", "deploy"):
        rc = cli.main(["--home", str(tmp_path), verb, "--engine-dir", str(PORT_PKG / "models/sequential")])
        assert rc == 1
        assert "CUDA is not available" in capsys.readouterr().err


def test_engine_json_of_the_port_names_the_port():
    manifest = json.loads((PORT_PKG / "models/sequential/engine.json").read_text())
    assert manifest["engineFactory"].startswith("predictionio_tpu_torch.")
    ep = pt_seq.engine_factory().engine_params_from_variant(manifest)
    assert ep.algorithms[0][0] == "markov" and ep.algorithms[0][1].top_n == 10


def test_new_modules_import_no_jax_in_a_clean_process():
    modules = ["predictionio_tpu_torch.ops.attention", "predictionio_tpu_torch.e2.markov_chain",
               "predictionio_tpu_torch.models.sequential.engine", "predictionio_tpu_torch.convert"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
        "or k == 'predictionio_tpu' or k.startswith('predictionio_tpu.')]\n"
        "print(len(bad), bad[:5])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    covered = {".".join(p.relative_to(REPO).with_suffix("").parts) for p in PORT_PKG.rglob("*.py")}
    assert set(modules) <= covered  # the package-wide import rule walks these files too
