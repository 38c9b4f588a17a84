"""The port's ALS (ops/als.py) against the JAX package's, on the CPU.

Inputs are made from numpy seeds and handed to both stacks. Block tables
are integers and exact copies of ratings, so they must be equal. Factors go
through sums taken in another order (the scatter-adds, the batched
products), hence the stated tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in parallel worker processes: one intra-op thread each
# keeps torch from crowding the other workers' tests
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from predictionio_tpu.ops import als as jax_als  # noqa: E402
from predictionio_tpu_torch.ops import als as pt_als  # noqa: E402


def _ratings(n_u, n_i, nnz, seed=0, rank=4, skip_tail=True):
    """Low-rank ratings; with ``skip_tail`` the last users and items get no
    rating at all (trailing zero-degree entities)."""
    rng = np.random.default_rng(seed)
    hi_u, hi_i = (n_u - 3, n_i - 4) if skip_tail else (n_u, n_i)
    u = rng.integers(0, hi_u, nnz).astype(np.int32)
    i = rng.integers(0, hi_i, nnz).astype(np.int32)
    U = rng.normal(size=(n_u, rank))
    V = rng.normal(size=(n_i, rank))
    v = np.round(np.sum(U[u] * V[i], axis=1) * 2) / 2 + 3
    return u, i, v.astype(np.float32)


def _wire(u, i, v, n_u, n_i, d, block_chunk):
    """The wire form als_train uploads (both stacks share the host code)."""
    cols_u, vals_u, deg_u = pt_als._host_group_by(u, i, v, n_u)
    deg_i = np.bincount(i, minlength=n_i).astype(np.int32)
    nb_u = pt_als._pad_blocks(int((-(-deg_u // d)).sum()), block_chunk)
    nb_i = pt_als._pad_blocks(int((-(-deg_i // d)).sum()), block_chunk)
    cols_u = cols_u.astype(np.int16)
    vals_u, table = pt_als._compress_ratings_wire(vals_u)
    return (cols_u, vals_u, deg_u, deg_i), table, nb_u, nb_i


@pytest.mark.parametrize("seed,d", [(0, 8), (1, 16), (2, 128)])
def test_block_coo_equals_jax(seed, d):
    u, i, v = _ratings(50, 37, 900, seed=seed)
    for rows, cols, n in ((u, i, 50), (i, u, 37)):
        got = pt_als._block_coo(rows, cols, v, d, 8, n)
        want = jax_als._block_coo(rows, cols, v, d, 8, n)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed,d,zero_head", [(0, 8, False), (3, 16, False), (4, 8, True)])
def test_device_pack_equals_jax(seed, d, zero_head):
    """All eight tables, trailing zero-degree users and items included; with
    ``zero_head`` users 0 and 1 have no rating either."""
    n_u, n_i = 60, 41
    u, i, v = _ratings(n_u, n_i, 1500, seed=seed)
    if zero_head:
        u = np.maximum(u, 2)
    wire, table, nb_u, nb_i = _wire(u, i, v, n_u, n_i, d, 8)
    assert table is not None  # the uint8 dictionary wire engages
    kw = dict(d=d, nb_u=nb_u, nb_i=nb_i, n_users=n_u, n_items=n_i)
    want = jax_als._device_pack(*[jnp.asarray(a) for a in wire], val_table=jnp.asarray(table), **kw)
    got = pt_als._device_pack(
        *[torch.from_numpy(a) for a in wire], val_table=torch.from_numpy(table), **kw
    )
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # the user side also equals the host packing (the item side orders each
    # item's ratings by user there, by arrival order on the host)
    for g, h in zip(got[:4], pt_als._block_coo(u, i, v, d, 8, n_u)):
        np.testing.assert_array_equal(g.numpy(), h)


def test_compress_ratings_wire_equals_jax():
    rng = np.random.default_rng(0)
    for vals in (
        np.round(rng.uniform(1, 5, 1000) * 2) / 2,
        rng.uniform(1, 5, 1000).astype(np.float16).astype(np.float32),
        rng.normal(size=1000),
    ):
        vals = vals.astype(np.float32)
        (g, gt), (w, wt) = pt_als._compress_ratings_wire(vals), jax_als._compress_ratings_wire(vals)
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
        assert (gt is None) == (wt is None)


@pytest.mark.parametrize(
    "implicit,solver,gather_dtype,reg_scaling",
    [
        (False, "cg", "f32", "auto"),
        (True, "cg", "f32", "auto"),
        (False, "cholesky", "f32", "auto"),
        (False, "cg_fused", "bf16", "auto"),
        (False, "cg", "f32", "constant"),
    ],
)
def test_one_als_step_matches_jax(implicit, solver, gather_dtype, reg_scaling):
    """One _als_step from the same numpy factors (rtol 1e-4 / atol 1e-5:
    scatter and sum order differ)."""
    n_u, n_i, f, d, bc = 50, 37, 8, 16, 8
    u, i, v = _ratings(n_u, n_i, 1200, seed=11)
    host = (
        *jax_als._block_coo(u, i, v, d, bc, n_u),
        *jax_als._block_coo(i, u, v, d, bc, n_i),
    )
    rng = np.random.default_rng(12)
    uf0 = rng.normal(size=(n_u + 1, f)).astype(np.float32)
    vf0 = (rng.normal(size=(n_i + 1, f)) / np.sqrt(f)).astype(np.float32)
    cfg = jax_als.ALSConfig(implicit=implicit, reg_scaling=reg_scaling)
    kw = dict(
        n_users=n_u, n_items=n_i, reg=0.05, implicit=implicit, alpha=0.7,
        block_chunk=bc, degree_scaled_reg=cfg.degree_scaled_reg, solver=solver,
        gather_dtype=gather_dtype,
    )
    ju, jv = jax_als._als_step(jnp.asarray(uf0), jnp.asarray(vf0), *map(jnp.asarray, host), **kw)
    tables = [torch.from_numpy(a) for a in host]
    for k in (0, 1, 4, 5):
        tables[k] = tables[k].long()
    pu, pv = pt_als._als_step(torch.from_numpy(uf0), torch.from_numpy(vf0), *tables, **kw)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


def _shared_init(monkeypatch):
    """The port's _als_init replaced by the JAX package's initial factors:
    jax.random's bits cannot be drawn with torch."""

    def init(*, n_users, n_items, rank, seed, device):
        uf, vf = jax_als._als_init(n_users=n_users, n_items=n_items, rank=rank, seed=seed)
        return torch.tensor(np.asarray(uf), device=device), torch.tensor(np.asarray(vf), device=device)

    monkeypatch.setattr(pt_als, "_als_init", init)


@pytest.mark.parametrize("pack", ["auto", "host"])
def test_full_train_matches_jax_from_shared_init(monkeypatch, pack):
    """The tests/test_spd_solve.py:71-77 problem, factors within atol 1e-3."""
    _shared_init(monkeypatch)
    rng = np.random.default_rng(7)
    n_u, n_i, nnz = 120, 80, 4000
    u = rng.integers(0, n_u, nnz).astype(np.int32)
    i = rng.integers(0, n_i, nnz).astype(np.int32)
    U = rng.normal(size=(n_u, 4))
    V = rng.normal(size=(n_i, 4))
    v = np.sum(U[u] * V[i], axis=1).astype(np.float32)
    cfg_j = jax_als.ALSConfig(rank=4, iterations=6, reg=0.05, pack=pack)
    cfg_p = pt_als.ALSConfig(rank=4, iterations=6, reg=0.05, pack=pack)
    ju, jv = jax_als.als_train(u, i, v, n_u, n_i, cfg_j)
    timings: dict = {}
    pu, pv = pt_als.als_train(u, i, v, n_u, n_i, cfg_p, timings=timings, device="cpu")
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-3)
    assert set(timings) == {"pack_s", "upload_s", "build_s", "device_s", "nb_u", "nb_i", "d"}


def test_train_rejects_out_of_range_ids():
    u = np.array([0, 5], np.int32)
    i = np.array([0, 1], np.int32)
    v = np.ones(2, np.float32)
    with pytest.raises(ValueError, match="user index 5"):
        pt_als.als_train(u, i, v, 3, 2, pt_als.ALSConfig(rank=2), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        pt_als._host_group_by(u, i, v, 3)


def test_config_validation_matches_jax():
    for bad in (dict(solver="newton"), dict(pack="x"), dict(gather_dtype="f16"), dict(reg_scaling="y")):
        with pytest.raises(ValueError):
            pt_als.ALSConfig(**bad)
        with pytest.raises(ValueError):
            jax_als.ALSConfig(**bad)
    for kw in (dict(), dict(implicit=True), dict(reg_scaling="degree", implicit=True)):
        assert pt_als.ALSConfig(**kw).degree_scaled_reg == jax_als.ALSConfig(**kw).degree_scaled_reg


def test_hbm_model_and_pow2_equal_jax():
    for kw in (dict(), dict(gather_dtype="bf16"), dict(solver="cholesky", implicit=True)):
        args = (300, 200, 128, 32, 1000, 500)
        assert pt_als.solver_hbm_bytes_per_iter(*args, **kw) == jax_als.solver_hbm_bytes_per_iter(*args, **kw)
    for n in (0, 1, 2, 3, 64, 65, 1000):
        assert pt_als.next_pow2(n) == jax_als.next_pow2(n)


def _assert_topk_match(s_pt, i_pt, s_jax, i_jax, full, rtol=1e-5):
    """Scores equal; ids may differ only inside runs of equal scores, so
    every id the port served must score what JAX served at that rank."""
    np.testing.assert_allclose(s_pt, s_jax, rtol=rtol, atol=1e-6)
    for row in range(s_pt.shape[0]):
        np.testing.assert_allclose(full[row, i_pt[row]], s_jax[row], rtol=rtol, atol=1e-6)
        assert len(set(i_pt[row].tolist())) == len(i_pt[row])


def test_serving_index_batch_matches_jax():
    rng = np.random.default_rng(3)
    U = rng.normal(size=(40, 8)).astype(np.float32)
    V = rng.normal(size=(300, 8)).astype(np.float32)
    V[7] = V[9]  # an exact tie
    users = np.array([0, 3, 3, 17, 39, 8, 8, 21], np.int32)
    s_j, i_j = jax_als.ServingIndex(U, V).serve_batch(users, 16)
    index = pt_als.ServingIndex(U, V, device="cpu")
    s_p, i_p = index.serve_batch(users, 16)
    assert s_p.dtype == np.float32 and i_p.dtype == np.int32
    _assert_topk_match(s_p, i_p, s_j, i_j, U[users] @ V.T)
    packed = index.serve_batch_async(users, 16)
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (8, 2, 16)


def test_serving_index_single_with_mask_matches_jax():
    rng = np.random.default_rng(4)
    U = rng.normal(size=(10, 6)).astype(np.float32)
    V = rng.normal(size=(50, 6)).astype(np.float32)
    mask = np.ones(50, bool)
    mask[np.argsort(-(V @ U[2]))[:5]] = False  # hide the five best
    s_j, i_j = jax_als.ServingIndex(U, V).serve(2, 7, mask=mask)
    s_p, i_p = pt_als.ServingIndex(U, V, device="cpu").serve(2, 7, mask=mask)
    _assert_topk_match(s_p[None], i_p[None], s_j[None], i_j[None], (U[2] @ V.T)[None])
    assert not set(i_p.tolist()) & set(np.flatnonzero(~mask).tolist())


def test_upload_copies_host_memory():
    host = np.arange(6, dtype=np.int32)
    dev = pt_als.upload(host, device="cpu")
    host[:] = -1
    assert dev.tolist() == [0, 1, 2, 3, 4, 5]
    t = torch.ones(3)
    assert pt_als.upload(t, device="cpu") is t


def test_fetch_barrier_returns_a_checksum():
    assert pt_als.fetch_barrier(torch.ones(3), torch.full((2,), 2.0)) == 7.0
    assert pt_als.fetch_barrier(torch.ones(3)) == float(jax_als.fetch_barrier(jnp.ones(3)))


def test_cpu_jax_backend():
    assert jax.default_backend() == "cpu"


def test_pack_batch_wire_round_trips_through_fetch_topk():
    """Score bits ride row 0 of the int32 wire unchanged (small indices
    must not pass through a float view), as the JAX package's pack_batch."""
    from predictionio_tpu.ops import topk as jax_topk
    from predictionio_tpu_torch.ops import topk as pt_topk

    scores = np.array([[3.5, -0.0, 1e-40, float("-inf")], [2.0, 1.0, 0.5, 0.25]], np.float32)
    idx = np.array([[7, 0, 1, 2], [3, 2, 1, 0]], np.int32)
    packed = pt_topk.pack_batch(torch.from_numpy(scores), torch.from_numpy(idx))
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (2, 2, 4)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_topk.pack_batch(jnp.asarray(scores), jnp.asarray(idx)))
    )
    s, i = pt_topk.fetch_topk(packed)
    np.testing.assert_array_equal(s.view(np.int32), scores.view(np.int32))
    np.testing.assert_array_equal(i, idx)
    s1, i1 = pt_topk.fetch_topk(packed[0])  # a single query's [2, k]
    assert s1.shape == (1, 4) and i1.tolist() == [idx[0].tolist()]


def test_scratch_buffers_are_per_thread_and_grow():
    import threading

    from predictionio_tpu_torch.ops import topk as pt_topk

    pool = pt_topk.scratch()
    a = pool.zeros("x", (3,), np.int32)
    assert a.tolist() == [0, 0, 0] and pool.get("x", (4,), np.int32).base is a.base
    assert pool.get("x", (9,), np.int32).shape == (9,)
    other = []
    t = threading.Thread(target=lambda: other.append(pt_topk.scratch()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and other[0] is not pool
