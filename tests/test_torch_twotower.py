"""The port's two-tower template against the JAX package's, on the CPU, at
a small size (embed_dim 16, hidden (32,), out_dim 8, T 8, 2 heads), with
inputs from numpy seeds and the JAX init carried over by
``convert.twotower_params_from_numpy``.

Tolerances, each measured on these inputs and stated with its reason:
  - SeqEncoder with both sides on the bf16 contract (the JAX package's
    ``fused_attention`` forced through its Pallas kernels in interpret
    mode, the port's plain version of B2): atol 1e-3, as the attention
    tests hold the two kernels (measured 2.4e-7). Against the JAX default,
    the f32 ``attention_reference``: atol 2e-2, the bf16 bound (measured
    5.0e-3).
  - Tower (bf16 Dense layers on both sides, f32 norm): atol 1e-2; one bf16
    rounding of an input that falls the other way moves a unit-vector
    output by up to a few 1e-3 (measured 0.0 here: both round alike).
  - loss on identical tower outputs: atol 1e-6 (f32 on both sides).
  - build_history_matrix: bit-equal.
  - five training steps from one init on one permutation: the first
    step's loss within rtol 1e-6 without the encoder (the same forward) and
    2e-3 with it (the JAX package trains through the f32 reference, the
    port through B2's bf16 forward; measured 5e-4); every step within rtol
    5e-3 (measured 1.1e-3 and 1.4e-3: the bf16 towers' gradients round in
    another order, and Adam's normalised steps carry that on).
  - a JAX-written blob served by the port: scores within 2e-2 (the bf16
    forward of B2 against the f32 reference, then the bf16 towers), ids
    compared as sets within runs of scores closer than that.
"""

import functools
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from predictionio_tpu.data.storage.base import App  # noqa: E402
from predictionio_tpu.models.twotower import engine as jax_eng  # noqa: E402
from predictionio_tpu.models.twotower import model as jax_tt  # noqa: E402
from predictionio_tpu.ops import attention as jax_attn  # noqa: E402
from predictionio_tpu.tools.import_export import import_events  # noqa: E402
from predictionio_tpu.workflow import model_io as jax_model_io  # noqa: E402
from predictionio_tpu.workflow.context import WorkflowContext as JaxContext  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models.twotower import engine as pt_eng  # noqa: E402
from predictionio_tpu_torch.models.twotower import model as pt_tt  # noqa: E402
from predictionio_tpu_torch.ops import attention as pt_attn  # noqa: E402
from predictionio_tpu_torch.workflow import model_io  # noqa: E402
from predictionio_tpu_torch.workflow.context import WorkflowContext  # noqa: E402
from torch_template_helpers import port_store  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
APP = "ttapp"
SMALL = dict(n_users=30, n_items=20, embed_dim=16, hidden=(32,), out_dim=8, n_heads=2)


def _configs(history_len=8, **kw):
    fields = {**SMALL, "history_len": history_len, **kw}
    return jax_tt.TwoTowerConfig(**fields), pt_tt.TwoTowerConfig(**fields)


def _jax_init(config, seed=0):
    model = jax_tt.TwoTower(config)
    z = jnp.zeros((4,), jnp.int32)
    hist = jnp.zeros((4, config.history_len), jnp.int32) if config.history_len else None
    params = model.init(jax.random.PRNGKey(seed), z, z, hist)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(config, jparams):
    model = pt_tt.TwoTower(config)
    state = convert.twotower_params_from_numpy(jparams)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _histories(n, T, vocab, seed):
    """Chronological rows with -1 padding at the end, and a few -1 mid-row
    (the train step's target masking)."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (n, T)).astype(np.int32)
    lengths = rng.integers(0, T + 1, n)
    hist[np.arange(T)[None, :] >= lengths[:, None]] = -1
    hist[rng.random((n, T)) < 0.1] = -1
    return hist


def _encode_jax(model, params, hist):
    return np.asarray(model.apply({"params": params}, jnp.asarray(hist),
                                  method=lambda m, h: m.hist_encoder(h)))


def test_params_carry_over_with_every_shape():
    jconf, pconf = _configs()
    _, jparams = _jax_init(jconf)
    model = _port_model(pconf, jparams)
    state = convert.twotower_params_from_numpy(jparams)
    assert set(state) == set(model.state_dict())
    assert len(jax.tree_util.tree_leaves(jparams)) == len(state)
    np.testing.assert_array_equal(state["user_tower.dense.0.weight"],
                                  jparams["user_tower"]["dense_0"]["kernel"].T)
    assert convert.is_flax_tree(jparams) and not convert.is_flax_tree(state)


def test_seq_encoder_matches_jax_forced_pallas(monkeypatch):
    jconf, pconf = _configs()
    jmodel, jparams = _jax_init(jconf, seed=1)
    pmodel = _port_model(pconf, jparams)
    hist = _histories(12, 8, 20, seed=2)
    with torch.no_grad():
        got = pmodel.hist_encoder(torch.from_numpy(hist.astype(np.int64))).numpy()
    reference = _encode_jax(jmodel, jparams, hist)  # the JAX default: f32 reference
    np.testing.assert_allclose(got, reference, rtol=0, atol=2e-2)
    monkeypatch.setattr(jax_attn, "fused_attention",
                        functools.partial(jax_attn.fused_attention, force_pallas=True))
    pallas = _encode_jax(jmodel, jparams, hist)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-3)


def test_seq_encoder_runs_b2s_plain_version_on_the_cpu(monkeypatch):
    """The port's encoder reaches the routed kernel's plain version (B2 at
    T = 8) through fused_attention, with contiguous [B, H, T, Dh] heads."""
    _, pconf = _configs()
    model = pt_tt.build_model(pconf, "cpu")
    seen = []
    real = pt_attn._fused_attention_plain

    def spy(q, k, v, causal):
        seen.append((tuple(q.shape), q.is_contiguous(), k.is_contiguous(), v.is_contiguous(), causal))
        return real(q, k, v, causal)

    monkeypatch.setattr(pt_attn, "_fused_attention_plain", spy)
    with torch.no_grad():
        model.hist_encoder(torch.from_numpy(_histories(5, 8, 20, seed=3).astype(np.int64)))
    assert seen == [((5, 2, 8, 8), True, True, True, True)]


def test_tower_matches_jax_bf16():
    jconf, pconf = _configs(history_len=0)
    jmodel, jparams = _jax_init(jconf, seed=4)
    pmodel = _port_model(pconf, jparams)
    ids = np.arange(30, dtype=np.int32)
    extra = np.random.default_rng(5).normal(size=(30, 16)).astype(np.float32)
    for e in (None, extra):
        want = np.asarray(jmodel.apply(
            {"params": jparams}, jnp.asarray(ids), None if e is None else jnp.asarray(e),
            method=lambda m, i, x: m.user_tower(i, x)))
        with torch.no_grad():
            got = pmodel.user_tower(torch.from_numpy(ids.astype(np.int64)),
                                    None if e is None else torch.from_numpy(e)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


class _Outputs:
    """A stand-in flax module whose apply returns fixed tower outputs."""

    def __init__(self, u, v):
        self.out = (jnp.asarray(u), jnp.asarray(v))

    def apply(self, variables, *args):
        return self.out


@pytest.mark.parametrize("with_log_q", [False, True])
def test_loss_matches_jax_on_identical_tower_outputs(with_log_q):
    rng = np.random.default_rng(6)
    u = rng.normal(size=(16, 8)).astype(np.float32)
    v = rng.normal(size=(16, 8)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    items = rng.integers(0, 6, 16).astype(np.int32)  # duplicates in the batch
    log_q = np.log(rng.dirichlet(np.ones(6))).astype(np.float32) if with_log_q else None
    want = float(jax_tt.loss_fn(_Outputs(u, v), None, jnp.arange(16), jnp.asarray(items), 0.05,
                                None, None if log_q is None else jnp.asarray(log_q)))
    got = float(pt_tt.in_batch_loss(torch.from_numpy(u), torch.from_numpy(v),
                                    torch.from_numpy(items.astype(np.int64)), 0.05,
                                    None if log_q is None else torch.from_numpy(log_q)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("with_times", [False, True])
def test_build_history_matrix_is_bit_equal(with_times):
    rng = np.random.default_rng(7)
    users = rng.integers(0, 40, 500).astype(np.int32)
    items = rng.integers(0, 60, 500).astype(np.int32)
    times = rng.integers(0, 50, 500).astype(np.float64) if with_times else None  # ties
    for T in (1, 8, 30):
        want = jax_tt.build_history_matrix(users, items, times, 45, T)
        got = pt_tt.build_history_matrix(users, items, times, 45, T)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    empty = pt_tt.build_history_matrix(users[:0], items[:0], None, 3, 4)
    assert np.array_equal(empty, jax_tt.build_history_matrix(users[:0], items[:0], None, 3, 4))


@pytest.mark.parametrize("history_len,first_rtol", [(0, 1e-6), (8, 2e-3)])
def test_five_training_steps_match_jax(history_len, first_rtol):
    """One init (JAX's, carried over), one permutation, the same five
    batches of 16: the per-step losses of both packages."""
    jconf, pconf = _configs(history_len=history_len)
    jmodel, jparams = _jax_init(jconf, seed=8)
    rng = np.random.default_rng(9)
    users = rng.integers(0, 30, 200).astype(np.int32)
    items = ((users + rng.integers(0, 4, 200)) % 20).astype(np.int32)
    hist = pt_tt.build_history_matrix(users, items, None, 30, history_len) if history_len else None
    log_q = pt_tt.item_log_q(items, 20)
    perm = np.random.default_rng(10).permutation(200)

    tx = optax.adam(1e-3)
    jstep = jax.jit(jax_tt.make_train_step(jmodel, tx, 0.05, with_history=bool(history_len),
                                           item_log_q=jnp.asarray(log_q)))
    jp, jopt = jax.tree_util.tree_map(jnp.asarray, jparams), tx.init(jparams)
    pmodel = _port_model(pconf, jparams)
    pstep = pt_tt.make_train_step(pmodel, pt_tt.make_optimizer(pmodel, 1e-3), 0.05,
                                  with_history=bool(history_len), item_log_q=torch.from_numpy(log_q))
    hist_t = torch.from_numpy(hist.astype(np.int64)) if history_len else None
    jl, pl = [], []
    for s in range(5):
        sel = perm[s * 16:(s + 1) * 16]
        args = (jnp.asarray(users[sel]), jnp.asarray(items[sel]))
        if history_len:
            jp, jopt, loss = jstep(jp, jopt, *args, jnp.asarray(hist))
        else:
            jp, jopt, loss = jstep(jp, jopt, *args)
        jl.append(float(loss))
        pl.append(float(pstep(torch.from_numpy(users[sel].astype(np.int64)),
                              torch.from_numpy(items[sel].astype(np.int64)), hist_t)))
    np.testing.assert_allclose(pl[0], jl[0], rtol=first_rtol)
    np.testing.assert_allclose(pl, jl, rtol=5e-3)
    assert jl[-1] != jl[0]  # the steps moved the parameters


def test_train_two_tower_loop_and_item_table(monkeypatch):
    """The loop's contract on the CPU: batch min(batch_size, max(n, 8)),
    n // B steps and one loss per epoch, finite falling losses, and an
    item table equal to the trained tower's output."""
    _, pconf = _configs(batch_size=32, epochs=4)
    rng = np.random.default_rng(11)
    users = rng.integers(0, 30, 300).astype(np.int32)
    items = ((users * 3 + rng.integers(0, 3, 300)) % 20).astype(np.int32)
    hist = pt_tt.build_history_matrix(users, items, None, 30, 8)
    calls = []
    real = pt_attn._fused_attention_plain

    def spy(q, k, v, causal):
        calls.append(q.shape[0])
        return real(q, k, v, causal)

    monkeypatch.setattr(pt_attn, "_fused_attention_plain", spy)
    res = pt_tt.train_two_tower(users, items, pconf, history=hist, device="cpu")
    assert calls == [32] * (4 * (300 // 32))  # one forward per step
    assert len(res.losses) == 4 and np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0]
    model = pt_tt.TwoTower(pconf)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in res.params.items()})
    with torch.no_grad():
        table = model.embed_items(torch.arange(20)).numpy()
    np.testing.assert_array_equal(res.item_embeddings, table)


def test_epoch_checkpoint_resume_and_clear(tmp_path, monkeypatch):
    """A run cut after epoch 1 resumes at epoch 2 and ends where an uncut
    run ends; a finished run clears its checkpoint; a checkpoint of another
    run is ignored."""
    rng = np.random.default_rng(12)
    users = rng.integers(0, 30, 120).astype(np.int32)
    items = rng.integers(0, 20, 120).astype(np.int32)
    hist = pt_tt.build_history_matrix(users, items, None, 30, 8)
    _, full = _configs(batch_size=16, epochs=2)
    uncut = pt_tt.train_two_tower(users, items, full, history=hist, device="cpu")

    ckpt = str(tmp_path / "ckpt")
    _, first = _configs(batch_size=16, epochs=1, checkpoint_dir=ckpt)
    monkeypatch.setattr(pt_tt, "clear_train_checkpoint", lambda d: None)  # the cut
    pt_tt.train_two_tower(users, items, first, history=hist, device="cpu")
    assert pt_tt.load_train_checkpoint(ckpt)["epoch"] == 1
    monkeypatch.undo()
    _, resumed_conf = _configs(batch_size=16, epochs=2, checkpoint_dir=ckpt)
    resumed = pt_tt.train_two_tower(users, items, resumed_conf, history=hist, device="cpu")
    assert pt_tt.load_train_checkpoint(ckpt) is None
    assert resumed.losses == pytest.approx(uncut.losses, rel=1e-6)
    for k, v in uncut.params.items():
        np.testing.assert_allclose(resumed.params[k], v, rtol=0, atol=1e-6)

    # a checkpoint of another dataset is not resumed
    _, one = _configs(batch_size=16, epochs=1, checkpoint_dir=ckpt)
    monkeypatch.setattr(pt_tt, "clear_train_checkpoint", lambda d: None)
    pt_tt.train_two_tower(users[::-1].copy(), items, one, history=hist, device="cpu")
    monkeypatch.undo()
    again = pt_tt.train_two_tower(users, items, resumed_conf, history=hist, device="cpu")
    assert again.losses == pytest.approx(uncut.losses, rel=1e-6)


def _ratings_file(path, n_users=40, n_items=25, n=800, seed=13):
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for k in range(n):
            u = int(rng.integers(n_users))
            i = int((u * 2 + rng.integers(0, 5)) % n_items)
            t = f"2024-03-01T{k // 3600:02d}:{k // 60 % 60:02d}:{k % 60:02d}.000Z"
            ev = {"event": ("rate", "buy", "view")[k % 3], "entityType": "user",
                  "entityId": f"u{u}", "targetEntityType": "item", "targetEntityId": f"i{i}",
                  "eventTime": t}
            if k % 3 == 0:
                ev["properties"] = {"rating": 4.0}
            fh.write(json.dumps(ev) + "\n")
        fh.write(json.dumps({"event": "like", "entityType": "user", "entityId": "u1",
                             "targetEntityType": "item", "targetEntityId": "i1",
                             "eventTime": "2024-03-02T00:00:00.000Z"}) + "\n")
    return path


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_read_training_matches_jax(memory_storage, tmp_path, backend):
    events = _ratings_file(tmp_path / "ev.jsonl")
    memory_storage.get_meta_data_apps().insert(App(0, APP))
    import_events(str(events), APP, storage=memory_storage)
    jtd = jax_eng.DataSource(jax_eng.DataSourceParams(app_name=APP)).read_training(
        JaxContext(_storage=memory_storage))
    ptd = pt_eng.DataSource(pt_eng.DataSourceParams(app_name=APP)).read_training(
        port_store(tmp_path, APP, events, backend=backend))
    assert ptd.user_vocab == jtd.user_vocab and ptd.item_vocab == jtd.item_vocab
    np.testing.assert_array_equal(ptd.user_idx, jtd.user_idx)
    np.testing.assert_array_equal(ptd.item_idx, jtd.item_idx)
    np.testing.assert_array_equal(ptd.timestamps, jtd.timestamps)
    assert len(ptd.user_idx) == 800  # the like event is skipped


@pytest.fixture(params=[0, 8], ids=["no_history", "history"])
def jax_blob(request, memory_storage):
    """A two-tower model trained and pickled by the JAX package."""
    rng = np.random.default_rng(14)
    users = rng.integers(0, 30, 400).astype(np.int32)
    items = ((users * 3 + rng.integers(0, 4, 400)) % 20).astype(np.int32)
    td = jax_eng.TrainingData(users, items, [f"u{i}" for i in range(30)],
                              [f"i{i}" for i in range(20)], np.arange(400, dtype=np.float64))
    algo = jax_eng.TwoTowerAlgorithm(jax_eng.TwoTowerAlgorithmParams(
        embed_dim=16, hidden=(32,), out_dim=8, batch_size=64, epochs=2,
        history_len=request.param))
    model = algo.train(JaxContext(_storage=memory_storage), td)
    return algo, model, jax_model_io.serialize_models([model])


def test_jax_blob_deploys_in_the_port_and_agrees(jax_blob):
    jalgo, jmodel, blob = jax_blob
    (pmodel,) = model_io.deserialize_models(blob)
    assert type(pmodel) is pt_eng.TwoTowerModelState
    assert type(pmodel.config) is pt_tt.TwoTowerConfig and not convert.is_flax_tree(pmodel.params)
    palgo = pt_eng.TwoTowerAlgorithm(pt_eng.TwoTowerAlgorithmParams())
    pmodel = palgo.prepare_model(WorkflowContext(device="cpu"), pmodel)
    users = [f"u{u}" for u in range(30)] + ["nobody"]
    pres = palgo.predict_batch(pmodel, [pt_eng.Query(user=u, num=5) for u in users])
    jres = jalgo.predict_batch(jmodel, [jax_eng.Query(user=u, num=5) for u in users])
    assert pres[-1].item_scores == () and jres[-1].item_scores == ()
    # the JAX package's full scores, to judge ids within tied runs
    jm = jmodel.model()
    uidx = jnp.arange(30, dtype=jnp.int32)
    hist = None if jmodel.history is None else jnp.asarray(jmodel.history)
    u = np.asarray(jm.apply({"params": jmodel.params}, uidx, hist,
                            method=jax_tt.TwoTower.embed_users))
    full = u @ jmodel.item_embeddings.T
    tol = 2e-2
    for r, (p, j) in enumerate(zip(pres[:-1], jres[:-1])):
        ps = np.asarray([s.score for s in p.item_scores])
        js = np.asarray([s.score for s in j.item_scores])
        np.testing.assert_allclose(ps, js, rtol=0, atol=tol)
        pids = {int(s.item[1:]) for s in p.item_scores}
        jids = {int(s.item[1:]) for s in j.item_scores}
        for i in pids ^ jids:  # a differing id lies within tol of the boundary
            assert abs(full[r, i] - js[-1]) <= tol, (r, i)


def test_port_blob_roundtrip(tmp_path):
    rng = np.random.default_rng(15)
    users = rng.integers(0, 30, 200).astype(np.int32)
    items = rng.integers(0, 20, 200).astype(np.int32)
    td = pt_eng.TrainingData(users, items, [f"u{i}" for i in range(30)],
                             [f"i{i}" for i in range(20)], np.arange(200, dtype=np.float64))
    algo = pt_eng.TwoTowerAlgorithm(pt_eng.TwoTowerAlgorithmParams(
        embed_dim=16, hidden=(32,), out_dim=8, batch_size=32, epochs=1, history_len=8))
    model = algo.train(WorkflowContext(device="cpu"), td)
    (back,) = model_io.deserialize_models(model_io.serialize_models([model]))
    assert set(back.params) == set(model.params) and back.history.shape == (30, 8)
    back = algo.prepare_model(WorkflowContext(device="cpu"), back)
    q = [pt_eng.Query(user="u3", num=4)]
    assert algo.predict_batch(back, q) == algo.predict_batch(model, q)


def test_mesh_and_context_parallel_params():
    # without a job the mesh has one rank: a mesh asking for more is refused
    # with the JAX package's message (parallel/mesh.py _resolve_sizes)
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    assert make_mesh("", "cpu").size == 1
    assert make_mesh("data=-1,model=1", "cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="require 8 devices, have 1"):
        make_mesh("data=4,model=2", "cpu")
    with pytest.raises(ValueError, match="context_parallel"):
        pt_tt.TwoTowerConfig(n_users=2, n_items=2, context_parallel=True)
    with pytest.raises(ValueError, match="divisible"):
        pt_tt.TwoTowerConfig(n_users=2, n_items=2, embed_dim=15, history_len=4)
    # context parallelism on one device: the encoder attends as without it
    _, plain = _configs()
    _, cp = _configs(context_parallel=True, sp_impl="ulysses")
    a, b = pt_tt.build_model(plain, "cpu"), pt_tt.build_model(cp, "cpu")
    hist = torch.from_numpy(_histories(4, 8, 20, seed=16).astype(np.int64))
    with torch.no_grad():
        assert torch.equal(a.hist_encoder(hist), b.hist_encoder(hist))


def test_jax_engine_json_maps_to_the_port():
    from predictionio_tpu_torch.workflow.engine_loader import EngineLoadError, load_engine_factory

    variant = json.loads((REPO / "predictionio_tpu/models/twotower/engine.json").read_text())
    engine = load_engine_factory(variant["engineFactory"])
    ep = engine.engine_params_from_variant(variant)
    name, p = ep.algorithms[0]
    assert name == "twotower" and p.embed_dim == 64 and p.history_len == 0
    assert isinstance(p, pt_eng.TwoTowerAlgorithmParams)
    port_variant = json.loads((REPO / "predictionio_tpu_torch/models/twotower/engine.json").read_text())
    assert port_variant["engineFactory"].startswith("predictionio_tpu_torch.")
    assert port_variant["algorithms"] == variant["algorithms"]
    # every template of the JAX package is ported; a factory name of the JAX
    # package that is none of theirs is still refused, never imported
    with pytest.raises(EngineLoadError, match="no counterpart"):
        load_engine_factory("predictionio_tpu.models.classification.engine.no_such_factory")


def test_train_two_tower_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, pconf = _configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_tt.train_two_tower(np.zeros(4, np.int32), np.zeros(4, np.int32), pconf)


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


def test_cli_trains_and_deploys_a_jax_engine_json_with_history_on_cpu(tmp_path):
    """app new -> import -> train -> deploy -> POST /queries.json, from an
    engine.json that names the JAX package's engineFactory."""
    events = _ratings_file(tmp_path / "ev.jsonl", seed=17)
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    (engine_dir / "engine.json").write_text(json.dumps({
        "id": "tt-cli",
        "engineFactory": "predictionio_tpu.models.twotower.engine_factory",
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "twotower", "params": {
            "embedDim": 16, "hidden": [32], "outDim": 8, "epochs": 2, "batchSize": 64,
            "historyLen": 8, "nHeads": 2, "mesh": "data=-1,model=1"}}],
    }))
    cli = [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "--home", str(tmp_path / "h")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}

    def run(*args):
        out = subprocess.run([*cli, *args], env=env, capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr
        return out.stdout

    run("app", "new", APP)
    assert "Imported 801 events" in run("import", "--appname", APP, "--input", str(events))
    assert "Training completed" in run("train", "--engine-dir", str(engine_dir), "--device", "cpu")
    port = _free_port()
    err_path = tmp_path / "deploy.err"
    with open(err_path, "w") as err:
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
                with urllib.request.urlopen(base + "/", timeout=2):
                    break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "deploy never answered"
                time.sleep(0.2)
        code, body = _post(base + "/queries.json", {"user": "u2", "num": 4})
        assert code == 200 and len(body["itemScores"]) == 4
        scores = [s["score"] for s in body["itemScores"]]
        assert scores == sorted(scores, reverse=True) and np.all(np.isfinite(scores))
        assert _post(base + "/queries.json", {"user": "nobody"}) == (200, {"itemScores": []})
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            server.wait(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait()
    assert "jax" not in err_path.read_text().lower()
