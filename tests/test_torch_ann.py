"""The port's ANN retrieval (``predictionio_tpu_torch/ann``) against the JAX
package's ``predictionio_tpu/ann``, on the CPU.

The same numpy inputs go through both packages: the k-means assignment
and update (assignments equal, centroids within 1e-6 relative), the build
(PIOANN01 blobs byte-equal), blobs written by one package searched by
both (scores rtol 1e-5, ids as sets inside runs of tied scores, counts
equal), the incremental refresh and its drift guard, the registry
lifecycle (min_items, verified attach, GC, the stream refresh of a
candidate), and each engine's ANN dispatch (similar-product, two-tower,
sequential) on the same model and index, with filters, exclusions, int8,
the counted exact fallback and the recall shadow. Every port answer is
also held to the exact top-k over its probed candidates in float64
(``chip_smoke.ann_answers_held``, the check the card runs).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu.ann import index as jax_index  # noqa: E402
from predictionio_tpu.ann import lifecycle as jax_lifecycle  # noqa: E402
from predictionio_tpu.ann.metrics import AnnInstruments as JaxInstruments  # noqa: E402
from predictionio_tpu.ann.search import AnnSearcher as JaxSearcher  # noqa: E402
from predictionio_tpu.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from predictionio_tpu.registry import ArtifactStore as JaxStore  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu_torch.ann import index as pt_index  # noqa: E402
from predictionio_tpu_torch.ann import lifecycle  # noqa: E402
from predictionio_tpu_torch.ann.metrics import AnnInstruments  # noqa: E402
from predictionio_tpu_torch.ann.search import AnnSearcher  # noqa: E402
from predictionio_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from predictionio_tpu_torch.registry import ArtifactStore, ModelManifest  # noqa: E402
from predictionio_tpu_torch.registry.store import ArtifactIntegrityError  # noqa: E402
from predictionio_tpu_torch.workflow import model_io  # noqa: E402
from torch_template_helpers import chip_smoke  # noqa: E402

CS = chip_smoke()
RTOL = 1e-5


def clustered_corpus(n, f, modes=32, noise=0.1, seed=0):
    """Normalised rows around ``modes`` centres (tests/test_ann.py's corpus)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(modes, f))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    vecs = centers[rng.integers(0, modes, n)] + noise * rng.normal(size=(n, f))
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    return vecs.astype(np.float32)


def queries_near(vecs, b, seed):
    rng = np.random.default_rng(seed)
    q = vecs[rng.integers(0, len(vecs), b)] + 0.1 * rng.normal(size=(b, vecs.shape[1]))
    return q.astype(np.float32)


def assert_same_answers(got_s, got_i, want_s, want_i):
    """Rows of two packed top-k answers agree: finite scores within rtol
    1e-5, the same number of them, ids as sets inside each run of scores
    tied within that rtol (a run cut by k only by its scores)."""
    for gs, gi, ws, wi in zip(got_s, got_i, want_s, want_i):
        gf, wf = np.isfinite(gs), np.isfinite(ws)
        assert gf.sum() == wf.sum()
        gs, gi, ws, wi = gs[gf], gi[gf], ws[wf], wi[wf]
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6)
        start = 0
        while start < len(ws):
            end = start + 1
            while end < len(ws) and abs(ws[end] - ws[start]) <= RTOL * abs(ws[start]) + 1e-6:
                end += 1
            if end < len(ws):  # a run wholly inside k
                assert set(gi[start:end].tolist()) == set(wi[start:end].tolist())
            start = end


def build_both(vecs, **cfg):
    j = jax_index.build_index(vecs, jax_index.AnnConfig(**cfg), model_version="v1")
    p = pt_index.build_index(vecs, pt_index.AnnConfig(**cfg), model_version="v1", device="cpu")
    return j, p


# ---------------------------------------------------------------------------
# build mechanics
# ---------------------------------------------------------------------------


def test_assign_and_kmeans_equal_the_jax_package():
    vecs = clustered_corpus(2_000, 16, seed=3)
    c0 = vecs[np.random.default_rng(1).choice(2_000, 32, replace=False)]
    d = (c0.astype(np.float64) ** 2).sum(1)[None, :] - 2 * vecs.astype(np.float64) @ c0.T.astype(np.float64)
    two = np.sort(d, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() > 1e-4  # no near-ties on this seed
    np.testing.assert_array_equal(pt_index._assign(vecs, c0, 512, "cpu"),
                                  np.asarray(jax_index._assign(vecs, c0, 512)))
    pc, pa = pt_index.kmeans(vecs, 32, 10, 0, 16_384, "cpu")
    jc, ja = jax_index.kmeans(vecs, 32, 10, 0, 16_384)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_allclose(pc, jc, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,f,cfg", [
    (2_000, 16, dict(min_items=0, clusters=32)),
    (2_000, 16, dict(min_items=0, clusters=32, quantize_int8=True)),
    (3_000, 8, dict(min_items=0)),  # default sizing
    (50, 8, dict(min_items=0, clusters=64)),  # fewer items than clusters
    (300, 8, dict(min_items=0, clusters=1)),  # one cluster
])
def test_build_index_blobs_are_byte_equal_across_packages(n, f, cfg):
    j, p = build_both(clustered_corpus(n, f, seed=5), **cfg)
    assert pt_index.serialize_index(p) == jax_index.serialize_index(j)
    assert p.manifest_meta() == j.manifest_meta() and p.hbm_bytes() == j.hbm_bytes()


def test_skewed_corpus_spills_as_the_jax_package_does():
    rng = np.random.default_rng(2)
    vecs = clustered_corpus(2_000, 8, seed=1)
    # a third of the items in cluster 0: past the shared capacity, it spills
    assign = np.where(rng.random(2_000) < 0.33, 0, rng.integers(1, 16, 2_000)).astype(np.int32)
    centroids = np.stack([vecs[assign == c].mean(0) for c in range(16)]).astype(np.float32)
    assert np.bincount(assign).max() > jax_index.bucket_capacity(len(vecs), 16)
    got = pt_index._bucketize(vecs, assign, 16, centroids)
    want = jax_index._bucketize(vecs, assign, 16, centroids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids = got[0][got[0] >= 0]
    assert sorted(ids.tolist()) == list(range(len(vecs)))  # each item in exactly one bucket
    assert got[0].shape[1] == pt_index.bucket_capacity(len(vecs), 16)


def test_sizing_rules_and_config_equal_the_jax_package():
    for n in (0, 1, 7, 100, 8_000, 50_000, 100_000, 1_000_000, 20_000_000):
        assert pt_index.default_clusters(n) == jax_index.default_clusters(n)
        c = pt_index.default_clusters(n)
        assert pt_index.default_nprobe(c) == jax_index.default_nprobe(c)
        assert pt_index.bucket_capacity(n, c) == jax_index.bucket_capacity(n, c)
        assert pt_index.AnnConfig().resolved(n).__dict__ == jax_index.AnnConfig().resolved(n).__dict__
    cfg = pt_index.AnnConfig()
    assert (cfg.min_items, cfg.build_iters, cfg.assign_chunk, cfg.refresh_drift) == (50_000, 10, 16_384, 0.25)


def test_serialization_roundtrip_and_corrupt_blobs():
    _, p = build_both(clustered_corpus(500, 8), min_items=0, quantize_int8=True)
    blob = pt_index.serialize_index(p)
    back = pt_index.deserialize_index(blob)
    for name in ("centroids", "bucket_ids", "bucket_vecs", "bucket_scale", "nearest_assign"):
        np.testing.assert_array_equal(getattr(back, name), getattr(p, name))
    assert back.config == p.config and back.model_version == "v1"
    for bad in (b"NOTANN01" + blob[8:], blob[:12] + b"x" + blob[13:], blob[:-10]):
        with pytest.raises(pt_index.AnnFormatError):
            pt_index.deserialize_index(bad)


# ---------------------------------------------------------------------------
# the four searches, on blobs written by either package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus_indexes():
    vecs = clustered_corpus(4_000, 16, seed=6)
    f32 = jax_index.build_index(vecs, jax_index.AnnConfig(min_items=0, clusters=64, nprobe=8))
    q8 = pt_index.build_index(vecs, pt_index.AnnConfig(min_items=0, clusters=64, nprobe=8,
                                                         quantize_int8=True), device="cpu")
    return vecs, {"f32": jax_index.serialize_index(f32), "int8": pt_index.serialize_index(q8)}


def _search_inputs(vecs, kind, b=16, seed=9):
    q = queries_near(vecs, b, seed)
    rng = np.random.default_rng(seed)
    kw = {}
    if kind == "excl" or kind == "q8":
        kw["exclude"] = np.full((b, 4), -1, np.int32)
        kw["exclude"][:, :3] = rng.integers(0, len(vecs), (b, 3))
    if kind == "masked":
        kw["mask"] = rng.random((b, len(vecs))) < 0.5
    return q, kw


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["plain", "excl", "masked", "q8"])
def test_both_packages_search_a_blob_alike(corpus_indexes, writer, kind):
    vecs, blobs = corpus_indexes
    blob = blobs["int8" if kind == "q8" else "f32"]
    if writer == "port":  # a port-written blob of the same index
        blob = pt_index.serialize_index(pt_index.deserialize_index(blob))
    jidx, pidx = jax_index.deserialize_index(blob), pt_index.deserialize_index(blob)
    assert jax_index.serialize_index(jidx) == blob
    import jax.numpy as jnp

    q, kw = _search_inputs(vecs, kind)
    k = 10
    jsearch = JaxSearcher(jidx, exact_table=jnp.asarray(vecs) if jidx.quantized else None)
    psearch = AnnSearcher(pidx, exact_table=torch.tensor(vecs) if pidx.quantized else None, device="cpu")
    js, ji, jc = JaxSearcher.fetch(jsearch.search_async(q.copy(), k, **kw))
    ps, pi, pc = AnnSearcher.fetch(psearch.search_async(q.copy(), k, **kw))
    np.testing.assert_array_equal(pc, jc)
    assert_same_answers(ps, pi, js, ji)
    assert CS.ann_answers_held(pidx, q, ps, pi, k, exact_table=vecs, what=kind,
                               exclude=kw.get("exclude"), mask=kw.get("mask")) == len(q)


def test_search_never_returns_excluded_or_masked_ids_and_counts_real_candidates(corpus_indexes):
    vecs, blobs = corpus_indexes
    idx = pt_index.deserialize_index(blobs["f32"])
    s = AnnSearcher(idx, device="cpu")
    q, kw = _search_inputs(vecs, "excl")
    _, ids, counts = AnnSearcher.fetch(s.search_async(q, 10, **kw))
    for row, ex in zip(ids, kw["exclude"]):
        assert not set(row.tolist()) & set(ex[ex >= 0].tolist())
    sizes = (idx.bucket_ids >= 0).sum(axis=1)
    probes = torch.topk(torch.tensor(q) @ torch.tensor(idx.centroids).T, idx.nprobe, dim=1).indices
    np.testing.assert_array_equal(counts, sizes[probes.numpy()].sum(axis=1))
    q, kw = _search_inputs(vecs, "masked")
    scores, ids, _ = AnnSearcher.fetch(s.search_async(q, 10, **kw))
    for r in range(len(q)):
        fin = np.isfinite(scores[r])
        assert kw["mask"][r][ids[r][fin]].all()
    assert s.supports(s.candidate_pool()) and not s.supports(s.candidate_pool() + 1)
    assert not s.supports(0)


def test_a_device_tensor_query_and_a_masked_int8_search(corpus_indexes):
    vecs, blobs = corpus_indexes
    idx = pt_index.deserialize_index(blobs["f32"])
    q = queries_near(vecs, 4, 1)
    a = AnnSearcher.fetch(AnnSearcher(idx, device="cpu").search_async(torch.tensor(q), 5))
    b = AnnSearcher.fetch(AnnSearcher(idx, device="cpu").search_async(q, 5))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    q8 = pt_index.deserialize_index(blobs["int8"])
    with pytest.raises(ValueError, match="exact f32 table"):
        AnnSearcher(q8, device="cpu")
    with pytest.raises(ValueError, match="int8 path"):
        AnnSearcher(q8, exact_table=torch.tensor(vecs), device="cpu").search_async(
            q, 5, mask=np.ones((4, len(vecs)), bool))


def test_the_searcher_refuses_cuda_without_a_card(corpus_indexes):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnnSearcher(pt_index.deserialize_index(corpus_indexes[1]["f32"]))


# ---------------------------------------------------------------------------
# refresh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["grown", "drifted", "dim-changed"])
def test_refresh_takes_the_jax_packages_path(case):
    vecs = clustered_corpus(1_500, 8, seed=4)
    j, p = build_both(vecs, min_items=0, clusters=32)
    if case == "grown":  # new items near the old clusters, old ones nudged
        new = np.concatenate([vecs + 0.001, clustered_corpus(100, 8, seed=4)[:100]])
    elif case == "drifted":
        new = clustered_corpus(1_500, 8, seed=40)
    else:
        new = clustered_corpus(1_500, 16, seed=4)
    jr, jrep = jax_index.refresh_index(j, new, model_version="v2")
    pr, prep = pt_index.refresh_index(p, new, model_version="v2", device="cpu")
    assert prep == jrep
    assert prep["path"] == {"grown": "refresh", "drifted": "rebuild", "dim-changed": "rebuild"}[case]
    assert pt_index.serialize_index(pr) == jax_index.serialize_index(jr)
    assert pr.n_items == len(new) and pr.built_from == prep["path"]


# ---------------------------------------------------------------------------
# registry lifecycle
# ---------------------------------------------------------------------------


def _publish_similar_model(store, engine_id, vecs):
    from predictionio_tpu_torch.models.similarproduct.engine import SimilarModel

    model = SimilarModel(vecs.copy(), [f"i{j}" for j in range(len(vecs))], [None] * len(vecs))
    model.device = "cpu"
    manifest = store.publish(
        ModelManifest(version="", engine_id=engine_id, engine_version="1", engine_variant="engine.json"),
        model_io.serialize_models([model]),
    )
    return manifest, model


def test_build_for_version_respects_min_items_and_pins_the_jax_packages_blob(tmp_path):
    store = ArtifactStore(str(tmp_path))
    vecs = clustered_corpus(300, 8)
    m, model = _publish_similar_model(store, "eng", vecs)
    cfg = pt_index.AnnConfig(min_items=1_000)
    assert lifecycle.build_for_version(store, "eng", m.version, [model], cfg, device="cpu") is None
    assert not store.get_manifest("eng", m.version).ann_index
    meta = lifecycle.build_for_version(store, "eng", m.version, [model], cfg, force=True, device="cpu")
    assert meta and meta["items"] == 300 and meta["sha256"] and meta["builtFrom"] == "train"
    jax_blob = jax_index.serialize_index(jax_index.build_index(
        vecs, jax_index.AnnConfig(min_items=1_000), model_version=m.version))
    assert store.load_ann_blob("eng", m.version)[0] == jax_blob
    # the JAX package reads the port's registry entry, verified
    jidx = jax_lifecycle.load_index(JaxStore(str(tmp_path)), "eng", m.version)
    assert jidx.n_items == 300


def test_min_items_comes_from_the_reference_variables(monkeypatch, tmp_path):
    store = ArtifactStore(str(tmp_path))
    m, model = _publish_similar_model(store, "eng", clustered_corpus(120, 8))
    monkeypatch.setenv("PIO_ANN_MIN_ITEMS", "100")
    monkeypatch.setenv("PIO_ANN_CLUSTERS", "4")
    assert lifecycle.config_from_env().__dict__ == jax_lifecycle.config_from_env().__dict__
    assert lifecycle.config_from_env().clusters == 4
    assert lifecycle.build_for_version(store, "eng", m.version, [model], device="cpu")["clusters"] == 4
    monkeypatch.setenv("PIO_ANN", "0")
    assert not lifecycle.ann_enabled()
    assert lifecycle.build_for_version(store, "eng", m.version, [model], device="cpu") is None


def test_attach_verifies_serves_and_rejects(tmp_path):
    store = ArtifactStore(str(tmp_path))
    vecs = clustered_corpus(400, 8)
    m, model = _publish_similar_model(store, "eng", vecs)
    assert lifecycle.attach_from_registry(store, "eng", m.version, [model], device="cpu") is None
    # a JAX-built index pinned through the JAX package's own lifecycle
    jax_lifecycle.build_for_version(JaxStore(str(tmp_path)), "eng", m.version, [model],
                                    jax_index.AnnConfig(min_items=0), force=True)
    fresh = model_io.deserialize_models(store.load_blob("eng", m.version))
    serving = lifecycle.attach_from_registry(store, "eng", m.version, fresh, device="cpu")
    assert serving is not None and getattr(fresh[0], lifecycle.ATTR) is serving
    assert serving.index.model_version == m.version
    assert model_io.serialize_models(fresh) == store.load_blob("eng", m.version)  # never pickled
    from predictionio_tpu_torch.models.similarproduct.engine import SimilarModel

    shrunk = SimilarModel(vecs[:100].copy(), [f"i{j}" for j in range(100)], [None] * 100)
    assert lifecycle.attach_from_registry(store, "eng", m.version, [shrunk], device="cpu") is None
    sha = store.get_manifest("eng", m.version).ann_index["sha256"]
    path = store._blob_path("eng", sha)
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:  # a bit flip
        fh.write(blob[:100] + bytes([blob[100] ^ 0xFF]) + blob[101:])
    with pytest.raises(ArtifactIntegrityError):
        store.load_ann_blob("eng", m.version)
    assert lifecycle.attach_from_registry(store, "eng", m.version, [model], device="cpu") is None


def test_gc_keeps_referenced_index_blobs_and_drops_orphaned(tmp_path):
    import os

    store = ArtifactStore(str(tmp_path))
    manifests = []
    for seed in range(3):
        m, model = _publish_similar_model(store, "eng", clustered_corpus(300, 8, seed=seed))
        lifecycle.build_for_version(store, "eng", m.version, [model],
                                    pt_index.AnnConfig(min_items=0), device="cpu")
        manifests.append(store.get_manifest("eng", m.version))
    store.promote("eng", manifests[-1].version)
    removed = store.gc("eng", keep_last=1)
    assert "v000002" in removed
    assert not os.path.exists(store._blob_path("eng", manifests[1].ann_index["sha256"]))
    assert store.load_ann_blob("eng", manifests[-1].version) is not None


def test_pinned_indexes_and_instruments_follow_the_lanes():
    vecs = clustered_corpus(200, 8)
    from predictionio_tpu_torch.models.similarproduct.engine import SimilarModel

    model = SimilarModel(vecs, [f"i{j}" for j in range(200)], [None] * 200)
    idx = pt_index.build_index(vecs, pt_index.AnnConfig(min_items=0, clusters=8), model_version="v7",
                               device="cpu")
    setattr(model, lifecycle.ATTR, lifecycle.AnnServing(idx, model, device="cpu"))
    assert lifecycle.pinned_indexes([[model], [object()]]) == {"v7": (200.0, 8.0)}
    reg = MetricsRegistry()
    ins = AnnInstruments(reg)
    lifecycle.bind_instruments([model], ins)
    assert ins.index_items.value(version="v7") == 200
    reg.register_collector(lambda: ins.sync_indexes({}))
    assert reg.snapshot()["pio_ann_index_items"]["samples"] == [{"labels": {"version": "v7"}, "value": 0.0}]
    assert sorted(reg.snapshot()) == sorted(JaxInstruments(JaxRegistry()).registry.snapshot())


# ---------------------------------------------------------------------------
# the stream refresh of a candidate
# ---------------------------------------------------------------------------


def _rate_events(n, event_cls):
    import datetime as dt

    out = []
    for i in range(n):
        when = dt.datetime(2024, 3, 1, 0, 0, 0, i, tzinfo=dt.timezone.utc)
        out.append(event_cls(event="rate", entity_type="user", entity_id=f"u{i % 5}",
                             target_entity_type="item", target_entity_id=f"i{i % 7}",
                             properties={"rating": 4.0}, event_time=when, creation_time=when))
    return out


def _stream_pipeline(tmp_path, parent_index: bool, refresh=None):
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.memory import MemoryStorageClient
    from predictionio_tpu_torch.models.recommendation.engine import ALSModel
    from predictionio_tpu_torch.stream import CursorStore, EventTailer
    from predictionio_tpu_torch.stream.pipeline import StreamConfig, StreamInstruments, StreamPipeline
    from predictionio_tpu_torch.stream.trainers import FoldInALSTrainer

    rng = np.random.default_rng(0)
    n_users, n_items, rank = 20, 60, 4
    seed_model = ALSModel(rng.normal(size=(n_users, rank)).astype(np.float32),
                          rng.normal(size=(n_items, rank)).astype(np.float32),
                          [f"u{i}" for i in range(n_users)], [f"i{i}" for i in range(n_items)])
    store = ArtifactStore(str(tmp_path / "registry"))
    stable = store.publish(
        ModelManifest(version="", engine_id="streameng", engine_version="1", engine_variant="engine.json"),
        model_io.serialize_models([seed_model]),
    )
    if parent_index:
        meta = lifecycle.build_for_version(store, "streameng", stable.version, [seed_model],
                                           pt_index.AnnConfig(min_items=0), device="cpu")
        assert meta["builtFrom"] == "train"
    levents = MemoryStorageClient().l_events()
    levents.init(1)
    for e in _rate_events(12, Event):
        levents.insert(e, 1)
    instruments = StreamInstruments(MetricsRegistry())
    pipeline = StreamPipeline(
        EventTailer(levents, 1, batch_limit=50), FoldInALSTrainer([seed_model], device="cpu"),
        CursorStore(str(tmp_path / "cursors")), store,
        StreamConfig(engine_id="streameng", publish_min_events=1), instruments=instruments,
    )
    return pipeline, store, stable, instruments


def test_a_stream_publish_carries_a_refreshed_index_to_promote(tmp_path):
    pipeline, store, stable, instruments = _stream_pipeline(tmp_path, parent_index=True)
    candidate = pipeline.run_once()["published"]
    assert candidate == "v000002"
    state = store.get_state("streameng")
    assert (state.stable, state.candidate) == (stable.version, candidate)
    cm = store.get_manifest("streameng", candidate)
    assert cm.ann_index["builtFrom"] in ("refresh", "rebuild") and cm.ann_index["modelVersion"] == candidate
    (rec,) = pipeline.ann_refreshes
    assert rec["path"] == cm.ann_index["builtFrom"] and rec["seconds"] >= 0
    assert instruments.ann.refreshes.value() + instruments.ann.rebuilds.value() == 1
    assert instruments.errors.value(stage="ann") == 0
    # the same refresh in the JAX package: its path and drift
    parent = jax_lifecycle.load_index(JaxStore(str(tmp_path / "registry")), "streameng", stable.version)
    models = model_io.deserialize_models(store.load_blob("streameng", candidate))
    _, jrep = jax_index.refresh_index(parent, models[0].item_factors, model_version=candidate)
    assert {k: rec[k] for k in jrep} == jrep
    serving = lifecycle.attach_from_registry(store, "streameng", candidate, models, device="cpu")
    assert serving is not None and serving.index.n_items == len(models[0].item_vocab)
    store.promote("streameng")
    assert store.get_state("streameng").stable == candidate
    assert store.load_ann_blob("streameng", candidate) is not None


def test_no_parent_index_means_no_refresh(tmp_path):
    pipeline, store, _, instruments = _stream_pipeline(tmp_path, parent_index=False)
    candidate = pipeline.run_once()["published"]
    assert not store.get_manifest("streameng", candidate).ann_index
    assert not pipeline.ann_refreshes and instruments.ann.refreshes.value() == 0
    store2 = ArtifactStore(str(tmp_path / "r2"))
    m, model = _publish_similar_model(store2, "eng", clustered_corpus(200, 8))
    assert lifecycle.refresh_for_publish(store2, "eng", m.version, m.version, [model], device="cpu") is None


def test_a_failed_refresh_is_counted_and_the_candidate_still_stages(tmp_path, monkeypatch):
    pipeline, store, _, instruments = _stream_pipeline(tmp_path, parent_index=True)

    def broken(*a, **k):
        raise RuntimeError("refresh failed")

    monkeypatch.setattr(lifecycle, "refresh_for_publish", broken)
    candidate = pipeline.run_once()["published"]
    assert store.get_state("streameng").candidate == candidate
    assert not store.get_manifest("streameng", candidate).ann_index
    assert instruments.errors.value(stage="ann") == 1


# ---------------------------------------------------------------------------
# engines: the ANN dispatch of each, against the JAX engine's
# ---------------------------------------------------------------------------


def _ranked(results):
    return [[(s.item, s.score) for s in r.item_scores] for r in results]


def assert_same_results(got, want):
    """Two engines' answers: scores within rtol 1e-5, items as sets inside
    runs of tied scores."""
    for g, w in zip(_ranked(got), _ranked(want)):
        assert len(g) == len(w), (g, w)
        gs = np.array([s for _, s in g] + [-np.inf])
        ws = np.array([s for _, s in w] + [-np.inf])
        ids = {it: k for k, it in enumerate(sorted({i for i, _ in g} | {i for i, _ in w}))}
        assert_same_answers(gs[None], np.array([ids[i] for i, _ in g] + [-1])[None],
                            ws[None], np.array([ids[i] for i, _ in w] + [-1])[None])


@pytest.fixture(scope="module")
def similar_served():
    from predictionio_tpu.models.similarproduct import engine as jax_sp

    from predictionio_tpu_torch.models.similarproduct import engine as pt_sp

    n, f = 3_000, 8
    vecs = clustered_corpus(n, f, seed=6)
    vocab = [f"i{j}" for j in range(n)]
    cats = [frozenset({"even"} if j % 2 == 0 else {"odd"}) for j in range(n)]

    def pair(quantize: bool, tag: str):
        cfg = dict(min_items=0, quantize_int8=quantize)
        blob = jax_index.serialize_index(jax_index.build_index(vecs, jax_index.AnnConfig(**cfg),
                                                               model_version=tag))
        jm = jax_sp.SimilarModel(vecs.copy(), list(vocab), list(cats))
        pm = pt_sp.SimilarModel(vecs.copy(), list(vocab), list(cats))
        pm.device = "cpu"
        setattr(jm, jax_lifecycle.ATTR, jax_lifecycle.AnnServing(
            jax_index.deserialize_index(blob), jm, instruments=JaxInstruments(JaxRegistry()),
            recall_sample_every=0))
        setattr(pm, lifecycle.ATTR, lifecycle.AnnServing(
            pt_index.deserialize_index(blob), pm, instruments=AnnInstruments(MetricsRegistry()),
            recall_sample_every=0, device="cpu"))
        return jm, pm

    plain = pt_sp.SimilarModel(vecs.copy(), list(vocab), list(cats))
    plain.device = "cpu"
    return {
        "jax_sp": jax_sp, "pt_sp": pt_sp, "vocab": vocab, "vecs": vecs, "plain": plain,
        "f32": pair(False, "v1"), "int8": pair(True, "v8"),
        "jalgo": jax_sp.ALSAlgorithm(None), "palgo": pt_sp.ALSAlgorithm(None),
    }


SIMILAR_CASES = {
    "plain": dict(),
    "two-items": dict(extra=1),
    "category": dict(categories=frozenset({"odd"})),
    "blacklist": dict(black_list=frozenset({"i10", "i11", "i12"})),
    "whitelist": dict(white_list=frozenset(f"i{j}" for j in range(0, 3_000, 3))),
}


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("case", list(SIMILAR_CASES))
def test_similarproduct_ann_dispatch_equals_the_jax_engines(similar_served, kind, case):
    sv = similar_served
    jm, pm = sv[kind]
    kw = dict(SIMILAR_CASES[case])
    extra = kw.pop("extra", 0)
    rng = np.random.default_rng(8)
    starts = rng.integers(0, 2_990, 12)
    items = [tuple(sv["vocab"][int(j) + e] for e in range(1 + extra)) for j in starts]
    jq = [sv["jax_sp"].Query(items=it, num=10, **kw) for it in items]
    pq = [sv["pt_sp"].Query(items=it, num=10, **kw) for it in items]
    jins, pins = getattr(jm, jax_lifecycle.ATTR).instruments, getattr(pm, lifecycle.ATTR).instruments
    before = (pins.queries.value(), pins.fallbacks.value(), jins.fallbacks.value())
    got = sv["palgo"].predict_batch(pm, pq)
    want = sv["jalgo"].predict_batch(jm, jq)
    assert_same_results(got, want)
    for r, q in zip(got, pq):
        assert r.item_scores and not {s.item for s in r.item_scores} & set(q.items)
        if q.categories:
            assert all(int(s.item[1:]) % 2 == 1 for s in r.item_scores)
        if q.black_list:
            assert not {s.item for s in r.item_scores} & q.black_list
    filtered = case in ("category", "blacklist", "whitelist")
    if kind == "int8" and filtered:  # exact fallback, counted by both packages
        assert pins.fallbacks.value() - before[1] == 12 == jins.fallbacks.value() - before[2]
        assert_same_results(got, sv["palgo"].predict_batch(sv["plain"], pq))
    else:
        assert pins.queries.value() - before[0] == 12
    if kind == "f32" and not filtered:
        # every answer the exact top-k over its probed candidates
        ann = getattr(pm, lifecycle.ATTR)
        qv = np.stack([sv["vecs"][[int(i[1:]) for i in it]].sum(0) for it in items])
        excl = np.array([[int(i[1:]) for i in it] + [-1] * (2 - len(it)) for it in items], np.int32)
        s, i, _ = AnnSearcher.fetch(ann.search_async(qv, 16, exclude=excl))
        CS.ann_answers_held(ann.index, qv, s, i, 16, exclude=excl, what="similar-product")
        for r, row in zip(got, i):
            assert [x.item for x in r.item_scores] == [sv["vocab"][j] for j in row[:10]]


def test_similarproduct_oversized_k_falls_back_and_the_recall_shadow_samples(similar_served):
    sv = similar_served
    jm, pm = sv["f32"]
    ann = getattr(pm, lifecycle.ATTR)
    ins = AnnInstruments(MetricsRegistry())
    ann.bind(ins)
    big = ann.searcher.candidate_pool() + 1
    q = [sv["pt_sp"].Query(items=("i2",), num=big)]
    res = sv["palgo"].predict_batch(pm, q)
    assert [s.item for s in res[0].item_scores] == [s.item for s in sv["palgo"].predict_batch(sv["plain"], q)[0].item_scores]
    assert ins.fallbacks.value() == 1 and ins.queries.value() == 0
    ann._sample_every, ann._batches = 1, 0
    try:
        sv["palgo"].predict_batch(pm, [sv["pt_sp"].Query(items=("i1",), num=10)])
    finally:
        ann._sample_every = 0
    assert ins.queries.value() == 1 and ins.probes.value() == ann.searcher.nprobe
    assert 0 < ins.candidates_frac.value() <= 0.10
    assert ins.recall_samples.value() == 1 and ins.recall_sampled.value() >= 0.9
    sv["palgo"].warmup_serving(pm, max_batch=4)


@pytest.fixture(scope="module")
def twotower_served(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from predictionio_tpu.models.twotower import engine as jax_tt
    from predictionio_tpu.models.twotower.model import TwoTower, TwoTowerConfig

    n_users, n_items = 50, 2_500
    config = TwoTowerConfig(n_users=n_users, n_items=n_items, embed_dim=8, hidden=(8,), out_dim=8)
    mdl = TwoTower(config)
    params = mdl.init(jax.random.PRNGKey(0), jnp.zeros((2,), jnp.int32), jnp.zeros((2,), jnp.int32),
                      None)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    item_emb = np.asarray(mdl.apply({"params": params}, jnp.arange(n_items, dtype=jnp.int32),
                                    method=TwoTower.embed_items))
    jm = jax_tt.TwoTowerModelState(config=config, params=params, item_embeddings=item_emb,
                                   user_vocab=[f"u{i}" for i in range(n_users)],
                                   item_vocab=[f"i{i}" for i in range(n_items)], losses=[])
    (pm,) = model_io.deserialize_models(jax_model_io.serialize_models([jm]))
    (plain,) = model_io.deserialize_models(jax_model_io.serialize_models([jm]))
    pm.device = plain.device = "cpu"
    blob = jax_index.serialize_index(jax_index.build_index(item_emb, jax_index.AnnConfig(min_items=0),
                                                           model_version="v1"))
    setattr(jm, jax_lifecycle.ATTR, jax_lifecycle.AnnServing(jax_index.deserialize_index(blob), jm,
                                                              recall_sample_every=0))
    setattr(pm, lifecycle.ATTR, lifecycle.AnnServing(pt_index.deserialize_index(blob), pm,
                                                      recall_sample_every=0, device="cpu"))
    from predictionio_tpu_torch.models.twotower import engine as pt_tt

    return jax_tt, pt_tt, jm, pm, plain


def test_twotower_ann_dispatch_equals_the_jax_engines(twotower_served):
    jax_tt, pt_tt, jm, pm, plain = twotower_served
    users = [f"u{i}" for i in range(16)] + ["nobody"]
    palgo = pt_tt.TwoTowerAlgorithm(None)
    got = palgo.predict_batch(pm, [pt_tt.Query(user=u, num=10) for u in users])
    want = jax_tt.TwoTowerAlgorithm(None).predict_batch(jm, [jax_tt.Query(user=u, num=10) for u in users])
    assert got[-1].item_scores == () and want[-1].item_scores == ()
    assert_same_results(got, want)
    ann = getattr(pm, lifecycle.ATTR)
    uidx = np.arange(16, dtype=np.int32)
    qv = pm.embed_users_async(uidx, None).numpy()
    s, i, _ = AnnSearcher.fetch(ann.search_async(qv, 16))
    CS.ann_answers_held(ann.index, qv, s, i, 16, what="two-tower")
    exact = palgo.predict_batch(plain, [pt_tt.Query(user=u, num=10) for u in users[:16]])
    assert CS.recall_at(np.array([[x.item for x in r.item_scores] for r in got[:16]]),
                        np.array([[x.item for x in r.item_scores] for r in exact]), 10) >= 0.9


def test_twotower_recall_shadow_fallback_and_warmup(twotower_served):
    _, pt_tt, _, pm, _ = twotower_served
    ann = getattr(pm, lifecycle.ATTR)
    ins = AnnInstruments(MetricsRegistry())
    ann.bind(ins)
    palgo = pt_tt.TwoTowerAlgorithm(None)
    ann._sample_every, ann._batches = 1, 0
    try:
        palgo.predict_batch(pm, [pt_tt.Query(user="u3", num=10)])
    finally:
        ann._sample_every = 0
    assert ins.recall_samples.value() == 1 and ins.recall_sampled.value() >= 0.9
    palgo.predict_batch(pm, [pt_tt.Query(user="u3", num=ann.searcher.candidate_pool() + 1)])
    assert ins.fallbacks.value() == 1
    palgo.warmup_serving(pm, max_batch=4)


@pytest.fixture(scope="module")
def sequential_served():
    from predictionio_tpu.models.sequential import engine as jax_seq

    from predictionio_tpu_torch import convert
    from predictionio_tpu_torch.models.sequential import engine as pt_seq

    rng = np.random.default_rng(11)
    n, f = 1_500, 8
    vocab = [f"i{j}" for j in range(n)]
    item_in = rng.normal(size=(n, f)).astype(np.float32) * 0.3
    item_out = clustered_corpus(n, f, seed=12)
    jm = jax_seq.SequentialModel(item_vocab=list(vocab), item_in=item_in.copy(), item_out=item_out.copy(),
                                 context=8)
    (pm,) = model_io.deserialize_models(jax_model_io.serialize_models([jm]))
    pm.device = "cpu"
    blob = jax_index.serialize_index(jax_index.build_index(item_out, jax_index.AnnConfig(min_items=0),
                                                           model_version="v1"))
    setattr(jm, jax_lifecycle.ATTR, jax_lifecycle.AnnServing(jax_index.deserialize_index(blob), jm,
                                                              recall_sample_every=0))
    setattr(pm, lifecycle.ATTR, lifecycle.AnnServing(pt_index.deserialize_index(blob), pm,
                                                      recall_sample_every=0, device="cpu"))
    assert convert is not None
    return jax_seq, pt_seq, jm, pm, vocab


def test_sequential_ann_dispatch_equals_the_jax_engines(sequential_served, monkeypatch):
    from predictionio_tpu.ops import attention as jax_attention

    jax_seq, pt_seq, jm, pm, vocab = sequential_served
    # the JAX package's encoder through its f32 reference, the port's
    # through B2's plain version: session vectors within bf16 rounding
    rng = np.random.default_rng(13)
    sessions = [tuple(vocab[int(j)] for j in rng.integers(0, len(vocab), int(rng.integers(1, 12))))
                for _ in range(10)]
    jalgo = jax_seq.AttentionAlgorithm(jax_seq.AttentionAlgorithmParams(context=8))
    palgo = pt_seq.AttentionAlgorithm(pt_seq.AttentionAlgorithmParams(context=8))
    got = palgo.predict_batch(pm, [pt_seq.Query(recent_items=s, num=10) for s in sessions])
    want = jalgo.predict_batch(jm, [jax_seq.Query(recent_items=s, num=10) for s in sessions])
    assert jax_attention is not None
    for g, w, s in zip(got, want, sessions):
        assert not {x.item for x in g.item_scores} & set(s)
        gi, wi = [x.item for x in g.item_scores], [x.item for x in w.item_scores]
        assert len(gi) == len(wi) == 10
        assert len(set(gi) & set(wi)) >= 8  # bf16 session vectors may swap a near-tie
        np.testing.assert_allclose([x.score for x in g.item_scores], [x.score for x in w.item_scores],
                                   rtol=2e-2, atol=2e-2)
    # exactly the top-k over the probed candidates of the port's own vectors
    hist, _, sess, bb = palgo._stage_batch(pm, [pt_seq.Query(recent_items=s, num=10) for s in sessions])
    ctx = palgo._encode(pm.device_in(), torch.tensor(hist)).numpy()
    excl = palgo._exclude_rows(sess, bb)
    ann = getattr(pm, lifecycle.ATTR)
    s, i, _ = AnnSearcher.fetch(ann.search_async(ctx, 16, exclude=excl))
    CS.ann_answers_held(ann.index, ctx, s[: len(sessions)], i[: len(sessions)], 16,
                        exclude=excl[: len(sessions)], what="sequential")
    for r, row in zip(got, i):
        assert [x.item for x in r.item_scores] == [vocab[j] for j in row[:10]]
    ins = AnnInstruments(MetricsRegistry())
    ann.bind(ins)
    palgo.predict_batch(pm, [pt_seq.Query(recent_items=sessions[0], num=ann.searcher.candidate_pool() + 1)])
    assert ins.fallbacks.value() == 1
    palgo.warmup_serving(pm, max_batch=4)


# ---------------------------------------------------------------------------
# train and deploy: the index built at publish, attached from the registry
# ---------------------------------------------------------------------------


def test_train_publish_pins_an_index_and_the_registry_deploy_serves_through_it(tmp_path, monkeypatch):
    from predictionio_tpu_torch.workflow.context import WorkflowContext
    from predictionio_tpu_torch.workflow.core_workflow import _publish_to_registry
    from predictionio_tpu_torch.workflow.create_server import ServerConfig, create_query_server
    from torch_template_helpers import port_storage

    from predictionio_tpu_torch.models.similarproduct import engine as pt_sp
    from predictionio_tpu_torch.workflow.engine_loader import EngineManifest

    import json
    import pathlib

    vecs = clustered_corpus(600, 8, seed=2)
    vocab = [f"i{j}" for j in range(600)]
    model = pt_sp.SimilarModel(vecs, vocab, [None] * 600)
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    variant = json.loads((pathlib.Path(pt_sp.__file__).parent / "engine.json").read_text())
    variant["id"] = "annsim"
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    manifest = EngineManifest(engine_id="annsim", version="1", variant="engine.json",
                              engine_factory=variant["engineFactory"])
    monkeypatch.setenv("PIO_ANN_MIN_ITEMS", "500")
    reg = str(tmp_path / "registry")
    _publish_to_registry(manifest, "", model_io.serialize_models([model]), {}, 1.0, "", reg, 5,
                         models=[model], device="cpu")
    store = ArtifactStore(reg)
    stable = store.get_state("annsim").stable
    meta = store.get_manifest("annsim", stable).ann_index
    assert meta["items"] == 600 and meta["builtFrom"] == "train" and store.load_ann_blob("annsim", stable)
    ctx = WorkflowContext(device="cpu", _storage=port_storage(tmp_path / "home"))
    server = create_query_server(str(engine_dir), ctx, ServerConfig(registry_dir=reg))
    try:
        (served,) = server.models
        ann = getattr(served, lifecycle.ATTR)
        assert ann.instruments is server.ann_instruments
        (fin,) = [server.dispatch_batch([{"items": ["i3"], "num": 5}])]
        out = fin()
        assert server.ann_instruments.queries.value() == 1
        body = out[0][0]
        assert len(body["itemScores"]) == 5
        snap = server.metrics.snapshot()
        assert snap["pio_ann_index_items"]["samples"][0]["value"] == 600
    finally:
        server.shutdown()


def test_cli_train_pins_an_index_under_the_reference_variable(tmp_path, capsys, monkeypatch):
    """``pio train --registry-dir`` with ``PIO_ANN_MIN_ITEMS=0`` (the JAX
    package's variable) pins an index on the version it publishes; without
    it the 9-item corpus stays under the default threshold."""
    import json

    from predictionio_tpu_torch.tools import cli
    from torch_template_helpers import REPO, write_events

    events = [{"event": "rate", "entityType": "user", "entityId": f"u{u}", "targetEntityType": "item",
               "targetEntityId": f"i{(u * 5 + j) % 9}", "properties": {"rating": float(1 + (u + j) % 5)},
               "eventTime": f"2024-03-01T00:00:{u:02d}.{j:03d}Z"} for u in range(14) for j in range(4)]
    home, engine_dir = tmp_path / "home", tmp_path / "engine"
    engine_dir.mkdir()
    variant = json.loads((REPO / "predictionio_tpu_torch/models/recommendation/engine.json").read_text())
    variant.update(id="annengine")
    variant["datasource"]["params"]["appName"] = "annapp"
    variant["algorithms"][0]["params"].update(rank=4, numIterations=2)
    (engine_dir / "engine.json").write_text(json.dumps(variant))
    assert cli.main(["--home", str(home), "app", "new", "annapp"]) == 0
    assert cli.main(["--home", str(home), "import", "--appname", "annapp", "--input",
                     str(write_events(tmp_path / "ev.jsonl", events))]) == 0
    store = ArtifactStore(str(tmp_path / "registry"))
    for min_items, version in ((None, "v000001"), ("0", "v000002")):
        if min_items is not None:
            monkeypatch.setenv("PIO_ANN_MIN_ITEMS", min_items)
        assert cli.main(["--home", str(home), "train", "--engine-dir", str(engine_dir), "--device", "cpu",
                         "--registry-dir", str(tmp_path / "registry")]) == 0
        meta = store.get_manifest(variant["id"], version).ann_index
        assert bool(meta) == (min_items is not None)
    assert meta["builtFrom"] == "train" and meta["items"] == 9
    assert store.load_ann_blob(variant["id"], "v000002") is not None
