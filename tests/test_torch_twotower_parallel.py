"""One two-tower training step across gloo ranks against the JAX package's
train step on a CPU mesh of as many devices, and against one step on one
rank over the same global batch (models/twotower/model.py with a mesh).

Every case starts from one JAX init (``TwoTower.init`` of the JAX package,
carried into the port with ``convert.twotower_params_from_numpy``). On a
mesh with ``model`` > 1 the user and item id tables are sharded over it as
the JAX ``param_sharding_tree`` places them: each rank holds its [V/M, D]
rows, ``hist_embed`` stays whole; the sharded tables are compared after
their gather. Each rank embeds its ``data`` slice of the batch, and the
all-gathered tower outputs give the one in-batch loss of the global batch;
the gradients summed over the ranks are the whole-batch gradient.

Against JAX: the JAX ``make_train_step``, jitted on a mesh of the first
2 or 4 CPU devices (``parallel.mesh.make_mesh``) with the batch sharded
over ``data`` (``batch_sharding``), the parameters by
``param_sharding_tree`` and, with ``context_parallel``, the history
encoder's attention sharded over ``model`` by JAX's ring or ulysses. Its
gradients come from the same step with an optax transformation that keeps
them as its state. Off the TPU the JAX package's attention is its f32
reference, so the port's step here attends each local block through the
f32 ``attention_reference`` too (the worker's "f32" variant; ring's blocks
are f32 either way).

Against one rank: the port's step as it runs ("port" variant: ulysses and
the data axis attend through ``fused_attention``, B2's plain version on
the CPU) against the port's one-rank step, with the f32 reference for
ring, whose one-rank counterpart is f32.

Tolerances, both comparisons: the loss at rtol 1e-5; each gradient within
1e-2 of its tensor's largest entry (the towers' bf16 Dense layers round a
batch slice's partial sums where one device rounds the whole batch's)
plus 1e-6; Adam's first step moves every parameter by about ±lr, so a
parameter either equals the other within 1e-6 or, where a near-zero
gradient's sign flipped, differs by at most 2·lr — at most 1 % of the
entries.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from predictionio_tpu.models.twotower import model as jax_tt  # noqa: E402
from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from predictionio_tpu.obs import xray as jax_xray  # noqa: E402
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models.twotower import model as M  # noqa: E402
from predictionio_tpu_torch.obs import xray  # noqa: E402
from predictionio_tpu_torch.ops import attention as pt_attn  # noqa: E402
from predictionio_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests.torch_dist_worker import TWO_TOWER_INIT, TWO_TOWER_MESHES, load, run_world, two_tower_case  # noqa: E402

CASES = [(n, *case) for n in (2, 4) for case in TWO_TOWER_MESHES[n]]
IDS = [f"{n}-{s}-{i if c else 'dp'}" for n, s, c, i in CASES]


def _jax_init() -> dict:
    """The JAX package's init of the test model (its seed), as flax numpy."""
    cfg_kw, _, _, _ = two_tower_case()
    config = jax_tt.TwoTowerConfig(**cfg_kw)
    z = jnp.zeros((4,), jnp.int32)
    params = jax_tt.TwoTower(config).init(jax.random.PRNGKey(config.seed), z, z,
                                          jnp.zeros((4, config.history_len), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, init):
    state = convert.twotower_params_from_numpy(init)
    out = {}
    for n in (2, 4):
        d = str(tmp_path_factory.mktemp(f"tt{n}"))
        np.savez(os.path.join(d, TWO_TOWER_INIT), **state)
        run_world(n, [f"two_tower{n}", f"two_tower_resume{n}"], d)
        out[n] = d
    return out


def _keep_gradients() -> optax.GradientTransformation:
    """An optax transformation whose state after one update is that
    update's gradients (and which moves no parameter)."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


def _jax_spec(spec: str) -> str:
    """The JAX spelling of the port's mesh: a mesh without a ``data`` axis
    has one rank on it in the port, and JAX's train step needs the axis
    named (its ``batch_sharding`` shards over "data"), so it gets data=1."""
    return spec if "data=" in spec else f"data=1,{spec}"


def _jax_mesh_step(init, n_world, spec, cp, impl):
    """(loss, gradients, updated parameters) of one JAX train step on a
    mesh of the first ``n_world`` CPU devices; the trees in the port's
    names and layouts."""
    cfg_kw, users, items, hist = two_tower_case()
    config = jax_tt.TwoTowerConfig(**cfg_kw, context_parallel=cp, sp_impl=impl)
    mesh = jax_make_mesh(_jax_spec(spec), devices=jax.devices()[:n_world])
    model = jax_tt.TwoTower(config, sp_mesh=mesh if cp else None)
    b_sharding = jax_tt.batch_sharding(mesh)
    ub = jax.device_put(users.astype(np.int32), b_sharding)
    ib = jax.device_put(items.astype(np.int32), b_sharding)
    replicated = NamedSharding(mesh, P())
    hist_dev = jax.device_put(hist.astype(np.int32), replicated)
    log_q = jax.device_put(M.item_log_q(items, config.n_items), replicated)
    out = []
    for tx in (_keep_gradients(), optax.adam(config.learning_rate)):
        params = jax.device_put(init, jax_tt.param_sharding_tree(init, mesh))
        step = jax.jit(jax_tt.make_train_step(model, tx, config.temperature, with_history=True, item_log_q=log_q))
        out.append(step(params, tx.init(params), ub, ib, hist_dev))
    (_, grads, loss), (new_params, _, _) = out
    to_port = lambda tree: convert.twotower_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    return float(loss), to_port(grads), to_port(new_params)


def _one_rank_step(init, f32_attention: bool, monkeypatch):
    """(loss, gradients, updated parameters) of the port's one-rank step."""
    cfg_kw, users, items, hist = two_tower_case()
    if f32_attention:
        monkeypatch.setattr(M, "fused_attention", pt_attn.attention_reference)
    config = M.TwoTowerConfig(**cfg_kw)
    model = M.TwoTower(config)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in convert.twotower_params_from_numpy(init).items()})
    opt = M.make_optimizer(model, config.learning_rate)
    step = M.make_train_step(model, opt, config.temperature, True,
                             torch.from_numpy(M.item_log_q(items, config.n_items)))
    loss = step(torch.from_numpy(users), torch.from_numpy(items), torch.from_numpy(hist))
    return (float(loss), {n: p.grad.numpy() for n, p in model.named_parameters()},
            {n: p.detach().numpy() for n, p in model.named_parameters()})


def _assert_same_step(results, tag, loss, grads, params, lr):
    """Rank 0's step under ``tag`` against (loss, grads, params), and every
    rank's gathered tables and whole parameters equal to rank 0's."""
    got = results[0]
    assert float(got[f"loss|{tag}"]) == pytest.approx(loss, rel=1e-5)
    assert set(grads) == {k.split("|")[-1] for k in got if k.startswith(f"grad|{tag}|")}
    moved = total = 0
    for name, g1 in grads.items():
        np.testing.assert_allclose(got[f"grad|{tag}|{name}"], g1, rtol=0,
                                   atol=1e-2 * float(np.abs(g1).max()) + 1e-6, err_msg=name)
        diff = np.abs(got[f"param|{tag}|{name}"] - params[name])
        assert diff.max() <= 2 * lr + 1e-6, name
        moved += int((diff > 1e-6).sum())
        total += diff.size
        for other in results[1:]:  # every rank took the same step
            np.testing.assert_array_equal(other[f"param|{tag}|{name}"], got[f"param|{tag}|{name}"])
    assert moved <= 0.01 * total, f"{moved} of {total} parameters moved otherwise"


@pytest.mark.parametrize("n_world,spec,cp,impl", CASES, ids=IDS)
def test_one_step_across_ranks_is_the_jax_mesh_step(worlds, init, n_world, spec, cp, impl):
    loss, grads, params = _jax_mesh_step(init, n_world, spec, cp, impl)
    results = [load(worlds[n_world], f"two_tower{n_world}", r) for r in range(n_world)]
    _assert_same_step(results, f"f32|{spec}_{impl if cp else 'dp'}", loss, grads, params,
                      two_tower_case()[0]["learning_rate"])


@pytest.mark.parametrize("n_world,spec,cp,impl", CASES, ids=IDS)
def test_one_step_across_ranks_is_the_one_rank_step(worlds, init, n_world, spec, cp, impl, monkeypatch):
    loss, grads, params = _one_rank_step(init, cp and impl == "ring", monkeypatch)
    results = [load(worlds[n_world], f"two_tower{n_world}", r) for r in range(n_world)]
    _assert_same_step(results, f"port|{spec}_{impl if cp else 'dp'}", loss, grads, params,
                      two_tower_case()[0]["learning_rate"])


def test_the_encoder_refuses_a_history_the_model_axis_does_not_divide():
    mesh = Mesh(("data", "model"), [1, 3], 0, torch.device("cpu"), {})
    cfg_kw, users, _, hist = two_tower_case()
    # vocabularies both axes (3 and 4) divide: the tables shard over model
    cfg_kw = {**cfg_kw, "n_users": 48, "n_items": 36}
    for impl, match in (("ring", "history_len 8 not divisible by mesh axis model=3"),
                        ("ulysses", "history_len 8 not divisible by mesh axis model=3")):
        model = M.build_model(M.TwoTowerConfig(**cfg_kw, context_parallel=True, sp_impl=impl), "cpu", mesh)
        with pytest.raises(ValueError, match=match):
            model.hist_encoder(torch.from_numpy(hist[:2]))
    mesh = Mesh(("data", "model"), [1, 4], 0, torch.device("cpu"), {})
    model = M.build_model(M.TwoTowerConfig(**{**cfg_kw, "n_heads": 2, "embed_dim": 16}, context_parallel=True,
                                           sp_impl="ulysses"), "cpu", mesh)
    with pytest.raises(ValueError, match=r"n_heads 2 not divisible by mesh axis model=4 \(ulysses splits heads\)"):
        model.hist_encoder(torch.from_numpy(hist[:2]))


# ---------------------------------------------------------------------------
# the placement: [V/M, D] tables, JAX's records, the inspector, resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_world,spec,cp,impl", CASES, ids=IDS)
def test_each_rank_holds_its_rows_of_the_id_tables_and_the_rest_whole(worlds, init, n_world, spec, cp, impl):
    cfg_kw = two_tower_case()[0]
    m = int(spec.split("model=")[1])
    tag = f"port|{spec}_{impl if cp else 'dp'}"
    whole = convert.twotower_params_from_numpy(init)
    for r in range(n_world):
        got = load(worlds[n_world], f"two_tower{n_world}", r)
        assert list(got[f"shape|{tag}|user_tower.embed.weight"]) == [cfg_kw["n_users"] // m, cfg_kw["embed_dim"]]
        assert list(got[f"shape|{tag}|item_tower.embed.weight"]) == [cfg_kw["n_items"] // m, cfg_kw["embed_dim"]]
        for name, v in whole.items():
            if name not in ("user_tower.embed.weight", "item_tower.embed.weight"):
                assert list(got[f"shape|{tag}|{name}"]) == list(v.shape), name
            # the sharded model carried back to the JAX package's whole tree
            path, transposed = convert._flax_path(name)
            flax = got[f"flax|{tag}|{'/'.join(path)}"]
            np.testing.assert_array_equal(flax.T if transposed else flax, got[f"param|{tag}|{name}"])


def _jax_records(init, n_world: int, spec: str) -> dict:
    mesh = jax_make_mesh(_jax_spec(spec), devices=jax.devices()[:n_world])
    placed = jax.device_put(init, jax_tt.param_sharding_tree(init, mesh))
    return {e["name"]: e for e in jax_xray.describe_shardings(placed)}


@pytest.mark.parametrize("n_world,spec,cp,impl", CASES, ids=IDS)
def test_describe_shardings_gives_the_jax_records_of_the_same_placement(worlds, init, n_world, spec, cp, impl):
    """The port's records of its model against JAX's of the
    ``param_sharding_tree`` placement on a CPU mesh of as many devices,
    leaf by leaf through convert's key map (a Linear weight's shape is the
    Dense kernel's reversed). ``per_device_bytes`` is what a
    rank holds: equal to JAX's where a table is sharded on every mesh axis
    or replicated; on data=2,model=2 JAX divides by all 4 devices (C18) and
    the port gives the shard's bytes, twice JAX's."""
    tag = f"port|{spec}_{impl if cp else 'dp'}"
    want = _jax_records(init, n_world, spec)
    keys = convert.twotower_key_map(convert.twotower_params_from_numpy(init))
    for r in range(n_world):
        got = {e["name"]: e for e in json.loads(str(load(worlds[n_world], f"two_tower{n_world}", r)[f"describe|{tag}"]))}
        assert sorted(got) == sorted(keys)
        for name, e in got.items():
            j = want["".join(f"['{k}']" for k in keys[name])]
            # a Linear weight is the Dense kernel transposed
            assert e["shape"] == (j["shape"][::-1] if convert._flax_path(name)[1] else j["shape"]), name
            for key in ("dtype", "bytes", "devices", "replicated"):
                assert e[key] == j[key], (name, key)
            sharded = not e["replicated"]
            if sharded and "data=2,model=2" in spec:
                assert e["per_device_bytes"] == e["bytes"] // 2 == 2 * j["per_device_bytes"], name
            else:
                assert e["per_device_bytes"] == j["per_device_bytes"], name
        flags = {e["name"] for e in xray.find_replicated(list(got.values()), 1024)}
        jflags = {e["name"] for e in jax_xray.find_replicated(list(want.values()), 1024)}
        assert {"".join(f"['{k}']" for k in keys[n]) for n in flags} == jflags


def test_describe_shardings_undercount_of_the_reference_is_pinned():
    """C18 in the reference: an [8, 4] f32 leaf under P("model", None) on a
    data=2,model=2 mesh. Every device holds a (4, 4) shard, 64 B; JAX's
    ``describe_shardings`` reports 32."""
    from jax.sharding import Mesh as JaxMesh

    mesh = JaxMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    leaf = jax.device_put(np.zeros((8, 4), np.float32), NamedSharding(mesh, P("model", None)))
    assert {s.data.nbytes for s in leaf.addressable_shards} == {64}
    (rec,) = jax_xray.describe_shardings({"t": leaf})
    assert rec["per_device_bytes"] == 32


# the collectives one step issues on each rank (forward, backward, gradient
# sums), by the code: the towers' outputs all-gathered over data (2, and
# their reduce-scatters backward); with model > 1 each of the two sharded
# lookups all-reduces over model forward and backward (4), the encoder's
# output is all-gathered over model (1, and its reduce-scatter), and the
# shards' gradients are summed over data (1) beside the whole parameters'
# (1); ring passes K and V once forward and once backward at model=2 (4
# permutes), ulysses exchanges q, k, v and the output each way (8); a mesh
# without a data axis issues nothing over it (its gathers are the
# identity and the shards' gradients need no sum)
STEP_COLLECTIVES = {
    "data=2,model=1_dp": {"all_gather": 2, "reduce_scatter": 2, "all_reduce": 1},
    "model=2_dp": {"all_reduce": 5},
    "data=1,model=2_ring": {"all_gather": 3, "reduce_scatter": 3, "all_reduce": 6, "collective_permute": 4},
    "data=1,model=2_ulysses": {"all_gather": 3, "reduce_scatter": 3, "all_reduce": 6, "all_to_all": 8},
    "data=2,model=2_ring": {"all_gather": 3, "reduce_scatter": 3, "all_reduce": 6, "collective_permute": 4},
}


@pytest.mark.parametrize("n_world,spec,cp,impl", CASES, ids=IDS)
def test_inspect_train_step_counts_one_step_and_puts_everything_back(worlds, n_world, spec, cp, impl):
    key = f"{spec}_{impl if cp else 'dp'}"
    for r in range(n_world):
        got = load(worlds[n_world], f"two_tower{n_world}", r)
        assert bool(got[f"unchanged|port|{key}"]), "parameters or Adam state changed"
        report = json.loads(str(got[f"inspect|port|{key}"]))
        assert report["collectives"] == STEP_COLLECTIVES[key]
        names = {e["name"] for e in report["arrays"]}
        assert {"params.user_tower.embed.weight", "opt_state.user_tower.embed.weight.exp_avg",
                "user_ids", "hist"} <= names
        assert report["flags"] == []  # nothing of 1 MiB at these sizes


@pytest.mark.parametrize("n_world", [2, 4])
def test_a_sharded_train_resumed_equals_the_uninterrupted_one(worlds, n_world):
    cfg_kw = two_tower_case()[0]
    for r in range(n_world):
        got = load(worlds[n_world], f"two_tower_resume{n_world}", r)
        assert int(got["table_rows"]) == cfg_kw["n_users"] // 2
        assert bool(got["checkpoint_after|cut"]) and not bool(got["checkpoint_after|resumed"])
        np.testing.assert_allclose(got["losses|resumed"], got["losses|uncut"], rtol=1e-6)
        np.testing.assert_allclose(got["items|resumed"], got["items|uncut"], rtol=0, atol=1e-6)
        for k in [k for k in got if k.startswith("param|uncut|")]:
            name = k.split("|")[2]
            np.testing.assert_allclose(got[f"param|resumed|{name}"], got[k], rtol=0, atol=1e-6, err_msg=name)
            if "embed" in name and "hist" not in name:
                assert got[k].shape[0] == cfg_kw["n_users" if name.startswith("user") else "n_items"]


def test_a_vocabulary_the_model_axis_does_not_divide_is_refused_as_jax_refuses():
    """43 users over model=2: jax.device_put refuses the placement (its
    message: the dimension should be divisible by 2) and so does the port,
    with that meaning; the history table (not sharded) takes any size."""
    cfg_kw = {**two_tower_case()[0], "n_users": 43}
    mesh = jax_make_mesh("data=1,model=2", devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="should be divisible by 2"):
        jax.device_put(np.zeros((43, 16), np.float32), NamedSharding(mesh, P("model", None)))
    fake = Mesh(("data", "model"), [1, 2], 0, torch.device("cpu"), {})
    with pytest.raises(ValueError, match="user_tower.embed.*should be divisible by 2"):
        M.build_model(M.TwoTowerConfig(**cfg_kw), "cpu", fake)
    model = M.build_model(M.TwoTowerConfig(**{**cfg_kw, "n_users": 44, "n_items": 30}), "cpu", fake)
    assert model.hist_encoder.hist_embed.weight.shape[0] == 31  # 30 items + the mask token, whole
