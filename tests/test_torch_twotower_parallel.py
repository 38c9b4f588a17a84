"""One two-tower training step across gloo ranks against the JAX package's
train step on a CPU mesh of as many devices, and against one step on one
rank over the same global batch (models/twotower/model.py with a mesh).

Every case starts from one JAX init (``TwoTower.init`` of the JAX package,
carried into the port with ``convert.twotower_params_from_numpy``; the
tables are whole on every rank). Each rank embeds its ``data`` slice of
the batch, and the all-gathered tower outputs give the one in-batch loss
of the global batch; the gradients summed over the ranks are the
whole-batch gradient.

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
from predictionio_tpu_torch import convert  # noqa: E402
from predictionio_tpu_torch.models.twotower import model as M  # noqa: E402
from predictionio_tpu_torch.ops import attention as pt_attn  # noqa: E402
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
        run_world(n, [f"two_tower{n}"], d)
        out[n] = d
    return out


def _keep_gradients() -> optax.GradientTransformation:
    """An optax transformation whose state after one update is that
    update's gradients (and which moves no parameter)."""
    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))


def _jax_mesh_step(init, n_world, spec, cp, impl):
    """(loss, gradients, updated parameters) of one JAX train step on a
    mesh of the first ``n_world`` CPU devices; the trees in the port's
    names and layouts."""
    cfg_kw, users, items, hist = two_tower_case()
    config = jax_tt.TwoTowerConfig(**cfg_kw, context_parallel=cp, sp_impl=impl)
    mesh = jax_make_mesh(spec, devices=jax.devices()[:n_world])
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
    rank's parameters equal to rank 0's."""
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
    from predictionio_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(("data", "model"), [1, 3], 0, torch.device("cpu"), {})
    cfg_kw, users, _, hist = two_tower_case()
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
