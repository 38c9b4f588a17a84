"""The port's sharded ALS (ops/als_sharded.py) against the JAX package's, on
the CPU: the port on gloo ranks started by ``tests/torch_dist_worker.py``,
the JAX package on a CPU mesh of as many devices (tests/conftest.py forces
eight). Block tables are integers and exact copies of ratings, so they must
be equal bit for bit; factors go through sums in another order, so they
hold at the tolerances of ``tests/test_torch_als.py`` (one step rtol 1e-4 /
atol 1e-5, a whole train atol 1e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from predictionio_tpu.ops import als as jax_als  # noqa: E402
from predictionio_tpu.ops import als_sharded as jax_sharded  # noqa: E402
from predictionio_tpu_torch.ops import als as pt_als  # noqa: E402
from predictionio_tpu_torch.ops import als_sharded as pt_sharded  # noqa: E402
from tests.torch_dist_worker import (  # noqa: E402
    ALS_SHAPE,
    ALS_STEP_CASES,
    als_ratings,
    als_step_factors,
    load,
    run_world,
    train_ratings,
)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One 2-rank and one 4-rank job over this module's cases."""
    out = {}
    for n, cases in ((2, ["als_step2", "als_train2"]), (4, ["als_step4"])):
        d = str(tmp_path_factory.mktemp(f"als{n}"))
        run_world(n, cases, d)
        out[n] = d
    return out


@pytest.mark.parametrize("n_dev,d", [(1, 8), (2, 16), (3, 8), (4, 16)])
def test_block_partition_equals_jax_bit_for_bit(n_dev, d):
    u, i, v = als_ratings(50, 37, 900, seed=n_dev)
    for rows, cols, n in ((u, i, 50), (i, u, 37)):
        block = -(-n // n_dev)
        got = pt_sharded._block_partition_blocked(rows, cols, v, block, n_dev, d, 8)
        want = jax_sharded._block_partition_blocked(rows, cols, v, block, n_dev, d, 8)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _jax_step(n_dev, f, implicit, gather_dtype):
    sh = ALS_SHAPE
    u, i, v = als_ratings(sh["n_users"], sh["n_items"], sh["nnz"])
    bu, bi = -(-sh["n_users"] // n_dev), -(-sh["n_items"] // n_dev)
    ub = jax_sharded._block_partition_blocked(u, i, v, bu, n_dev, sh["d"], sh["block_chunk"])
    ib = jax_sharded._block_partition_blocked(i, u, v, bi, n_dev, sh["d"], sh["block_chunk"])
    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("data")))  # noqa: E731
    uf0, vf0 = als_step_factors(n_dev, bu, bi, f)
    cfg = jax_als.ALSConfig(implicit=implicit)
    ju, jv = jax_sharded._als_sharded_step(
        put(uf0), put(vf0), *map(put, (*ub, *ib)), mesh=mesh, axis="data", bu=bu, bi=bi, rank=f,
        reg=sh["reg"], implicit=implicit, alpha=sh["alpha"], block_chunk=sh["block_chunk"],
        degree_scaled_reg=cfg.degree_scaled_reg, solver="cg", gather_dtype=gather_dtype)
    return np.asarray(ju), np.asarray(jv), ub, ib


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("f,implicit,gather_dtype", ALS_STEP_CASES)
def test_one_sharded_step_matches_jax(worlds, n_dev, f, implicit, gather_dtype):
    """One _als_sharded_step from the same per-rank factors on n_dev gloo
    ranks against JAX's on n_dev CPU devices, every row (dummy rows too)."""
    ju, jv, ub, ib = _jax_step(n_dev, f, implicit, gather_dtype)
    got = load(worlds[n_dev], f"als_step{n_dev}")
    for k, (gu, gi) in enumerate(zip(ub, ib)):
        np.testing.assert_array_equal(got[f"ublocks{k}"], gu)
        np.testing.assert_array_equal(got[f"iblocks{k}"], gi)
    key = f"f{f}_{'implicit' if implicit else 'explicit'}_{gather_dtype}"
    np.testing.assert_allclose(got["uf_" + key], ju, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["vf_" + key], jv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("implicit", [False, True])
def test_two_rank_train_matches_one_rank_als_train(worlds, implicit, monkeypatch):
    """The 2-rank als_train_sharded against the port's one-device
    als_train on the same ratings from the same initial factors:
    _als_init's draw, which the sharded init partitions, with the dummy
    item row zeroed as the sharded init zeroes rows past n_items (the
    one-device dummy row enters implicit mode's first shared Gram term)."""
    init = pt_als._als_init

    def zero_dummy(**kw):
        uf, vf = init(**kw)
        vf[-1] = 0.0
        return uf, vf

    monkeypatch.setattr(pt_als, "_als_init", zero_dummy)
    u, i, v = train_ratings(implicit)
    cfg = pt_als.ALSConfig(rank=4, iterations=6, reg=0.05, implicit=implicit, chunk=256)
    pu, pv = pt_als.als_train(u, i, v, 120, 80, cfg, device="cpu")
    got = load(worlds[2], "als_train2")
    tag = "implicit" if implicit else "explicit"
    assert np.isfinite(got[f"uf_{tag}"]).all() and np.isfinite(got[f"vf_{tag}"]).all()
    np.testing.assert_allclose(got[f"uf_{tag}"], pu.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[f"vf_{tag}"], pv.numpy(), rtol=0, atol=1e-3)
    assert got[f"gathers_{tag}"].shape == (6,)
    assert np.array_equal(got[f"uf_{tag}"], load(worlds[2], "als_train2", rank=1)[f"uf_{tag}"])


def test_sharded_train_without_a_job_is_the_single_device_schedule():
    """No job: one rank, no process group; the same factors as als_train
    from the same init at the whole-train tolerance, and the timings."""
    u, i, v = als_ratings(120, 80, 4000, seed=7)
    cfg = pt_als.ALSConfig(rank=4, iterations=6, reg=0.05, chunk=256)
    timings: dict = {}
    su, sv = pt_sharded.als_train_sharded(u, i, v, 120, 80, cfg, timings=timings, device="cpu")
    pu, pv = pt_als.als_train(u, i, v, 120, 80, cfg, device="cpu")
    np.testing.assert_allclose(su, pu.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(sv, pv.numpy(), rtol=0, atol=1e-3)
    assert timings["n_dev"] == 1 and len(timings["gather_s"]) == 6
    assert {"pack_s", "upload_s", "device_s", "nb_u", "nb_i", "d"} <= set(timings)


def test_sharded_train_rejects_out_of_range_ids():
    u = np.array([0, 5], np.int32)
    i = np.array([0, 1], np.int32)
    with pytest.raises(ValueError, match="user index 5 out of range"):
        pt_sharded.als_train_sharded(u, i, np.ones(2, np.float32), 3, 2, pt_als.ALSConfig(rank=2),
                                     device="cpu")


def test_ratings_wire_decodes_to_the_table():
    v = np.array([[1.0, 2.5, 0.0], [5.0, 0.0, 3.5]], np.float32)
    np.testing.assert_array_equal(pt_sharded._put_vals(v, torch.device("cpu")).numpy(), v)
    w = np.random.default_rng(0).random((2, 300)).astype(np.float32)  # > 256 values: f32
    np.testing.assert_array_equal(pt_sharded._put_vals(w, torch.device("cpu")).numpy(), w)
