"""The recommendation template's five variants in the port
(``predictionio_tpu_torch/models/recommendation/variants/``) against the
JAX package's, on the CPU.

Each copied variant names the port's factory; its JAX original names the
JAX package's. The same seeded events (rate, buy, like, dislike and view)
go into both packages' stores; each variant trains from shared initial
factors (factors within atol 1e-3) and answers the same queries through
its algorithm and serving (scores within rtol 1e-3, ids equal up to ties,
which the port's own scores judge). The variant's own rule is held in the
port: no blacklisted item served, the listed items out of the factors'
vocabulary, a disabled-items file edited live and seen by the next query,
like and dislike trained as ratings 4 and 1, views trained implicitly.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu.models.recommendation import engine as jax_rec  # noqa: E402
from predictionio_tpu_torch.models.recommendation import engine as pt_rec  # noqa: E402
from predictionio_tpu_torch.workflow.engine_loader import load_engine_factory  # noqa: E402
from torch_template_helpers import (  # noqa: E402
    assert_same_ranking,
    event_time,
    jax_store,
    port_store,
    shared_init,
    write_events,
)

REPO = Path(__file__).resolve().parents[1]
APP = "varapp"
VARIANTS = ["blacklist-items", "customize-data-prep", "customize-serving",
            "reading-custom-events", "train-with-view-event"]
PORT_FACTORY = "predictionio_tpu_torch.models.recommendation.engine.engine_factory"
N_USERS, N_ITEMS = 30, 24


def _events(seed=0) -> list[dict]:
    """Users and items of three tastes: rates and buys, likes where the
    tastes agree and dislikes where they do not, and views; each at its own
    time, so both stores read one row order."""
    rng = np.random.default_rng(seed)
    cu, ci = rng.integers(0, 3, N_USERS), np.arange(N_ITEMS) % 3
    out = []
    for k in range(900):
        u, i = int(rng.integers(N_USERS)), int(rng.integers(N_ITEMS))
        ev = {"entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
              "targetEntityId": f"i{i}", "eventTime": event_time(k)}
        kind = k % 5
        if kind == 0:
            ev.update(event="buy")
        elif kind == 1:
            ev.update(event="rate", properties={"rating": float(rng.integers(1, 6))})
        elif kind == 2:
            ev.update(event="like" if cu[u] == ci[i] else "dislike")
        else:
            if cu[u] != ci[i] and rng.random() < 0.7:
                continue
            ev.update(event="view")
        out.append(ev)
    return out


def _variant(path: Path, files: dict) -> dict:
    v = json.loads(path.read_text())
    v["datasource"]["params"]["appName"] = APP
    for algo in v["algorithms"]:
        algo["params"].update(rank=6, numIterations=6)
    for part in ("preparator", "serving"):
        if part in v:
            v[part]["params"]["filepath"] = str(files[part])
    return v


@pytest.fixture
def events(tmp_path):
    return write_events(tmp_path / "ev.jsonl", _events())


def test_the_port_ships_each_variant_of_the_jax_package_with_its_own_factory():
    jax_dir = REPO / "predictionio_tpu/models/recommendation/variants"
    port_dir = REPO / "predictionio_tpu_torch/models/recommendation/variants"
    assert sorted(p.name for p in port_dir.glob("*.json")) == sorted(p.name for p in jax_dir.glob("*.json")) \
        == [f"{n}.json" for n in VARIANTS]
    for name in VARIANTS:
        port, jax = (json.loads((d / f"{name}.json").read_text()) for d in (port_dir, jax_dir))
        assert port.pop("engineFactory") == PORT_FACTORY
        jax.pop("engineFactory")
        assert port == jax


@pytest.mark.parametrize("name", VARIANTS)
def test_variants_train_and_serve_like_jax(memory_storage, tmp_path, events, monkeypatch, name):
    shared_init(monkeypatch)
    files = {"preparator": tmp_path / "no_train_items.txt", "serving": tmp_path / "disabled_items.txt"}
    files["preparator"].write_text("i1\ni4\n\nnot-an-item\n")
    files["serving"].write_text("i2\ni5\n")
    pv = _variant(REPO / f"predictionio_tpu_torch/models/recommendation/variants/{name}.json", files)
    jv = _variant(REPO / f"predictionio_tpu/models/recommendation/variants/{name}.json", files)
    pengine = load_engine_factory(pv["engineFactory"])
    jengine = jax_rec.engine_factory()
    pep, jep = pengine.engine_params_from_variant(pv), jengine.engine_params_from_variant(jv)
    pctx, jctx = port_store(tmp_path, APP, events), jax_store(memory_storage, APP, events)
    (pm,) = pengine.prepare_deploy(pctx, pep, pengine.train(pctx, pep))
    (jm,) = jengine.train(jctx, jep)
    _, _, (palgo,), pserving = pengine.make_components(pep)
    _, _, (jalgo,), jserving = jengine.make_components(jep)
    assert pm.item_vocab == jm.item_vocab and pm.user_vocab == jm.user_vocab
    np.testing.assert_allclose(pm.item_factors, jm.item_factors, rtol=0, atol=1e-3)
    np.testing.assert_allclose(pm.user_factors, jm.user_factors, rtol=0, atol=1e-3)

    rng = np.random.default_rng(7)
    users = [f"u{u}" for u in range(N_USERS)]
    blacklists = [frozenset(f"i{j}" for j in rng.choice(N_ITEMS, 4, replace=False))
                  if name == "blacklist-items" else None for _ in users]
    pq = [pt_rec.Query(user=u, num=6, black_list=b) for u, b in zip(users, blacklists)]
    jq = [jax_rec.Query(user=u, num=6, black_list=b) for u, b in zip(users, blacklists)]
    full = pm.user_factors @ pm.item_factors.T

    def answers():
        got = [pserving.serve(q, [r]) for q, r in zip(pq, palgo.predict_batch(pm, pq))]
        want = [jserving.serve(q, [r]) for q, r in zip(jq, jalgo.predict_batch(jm, jq))]
        for q, g, w in zip(pq, got, want):
            assert_same_ranking(g, w, lambda item, q=q: full[pm.user_index(q.user), pm.item_index(item)],
                                rtol=1e-3, atol=1e-3)
        return [[s.item for s in g.item_scores] for g in got]

    served = answers()
    assert any(served)
    if name == "blacklist-items":
        assert all(not set(items) & q.black_list for items, q in zip(served, pq))
    elif name == "customize-data-prep":
        assert not {"i1", "i4"} & set(pm.item_vocab) and len(pm.item_vocab) == N_ITEMS - 2
    elif name == "customize-serving":
        assert not {"i2", "i5"} & {it for items in served for it in items}
        files["serving"].write_text("i0\ni3\n")  # edited live: the next query sees it
        served = answers()
        assert not {"i0", "i3"} & {it for items in served for it in items}
        assert {"i2", "i5"} & {it for items in served for it in items}
    elif name == "reading-custom-events":
        td = pengine.make_components(pep)[0].read_training(pctx)
        assert set(np.unique(td.ratings).tolist()) == {1.0, 4.0}
    else:
        assert palgo.params.implicit_prefs and jalgo.params.implicit_prefs
