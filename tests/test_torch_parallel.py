"""The port's parallel package (predictionio_tpu_torch/parallel) on the CPU:
mesh parsing and sizing against the JAX package's, the rank layout, and
the collectives and their gradients on gloo jobs of 2 and 4 ranks
(``tests/torch_dist_worker.py``), each value and gradient against the one
the primitive's definition gives (``lax.all_gather``, ``lax.all_to_all``
tiled, ``lax.ppermute`` and their transposes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from predictionio_tpu.parallel import ingest as jax_ingest  # noqa: E402
from predictionio_tpu.parallel import mesh as jax_mesh  # noqa: E402
from predictionio_tpu_torch.parallel import distributed, ingest, mesh  # noqa: E402
from tests.torch_dist_worker import load, run_world  # noqa: E402

SPECS = ["", "data=8", "data=-1", "data=-1,model=2", "model=2,data=-1", "data=2,model=4",
         " data = 3 , model=-1", "data", "a=1,b=-1,c=2"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in (2, 4):
        d = str(tmp_path_factory.mktemp(f"par{n}"))
        run_world(n, [f"collectives{n}"], d)
        out[n] = d
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_mesh_spec_parse_equals_jax(spec):
    assert mesh.MeshSpec.parse(spec).axes == jax_mesh.MeshSpec.parse(spec).axes


@pytest.mark.parametrize("sizes,n", [([-1], 8), ([2, -1], 8), ([2, 4], 8), ([3, -1], 9), ([1], 1),
                                     ([-1, -1], 4), ([3, -1], 8), ([2, 2], 8), ([2, 2], 3)])
def test_resolve_sizes_answers_and_errors_equal_jax(sizes, n):
    def outcome(fn):
        try:
            return fn(sizes, n)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert outcome(mesh._resolve_sizes) == outcome(jax_mesh._resolve_sizes)


def test_pad_to_multiple_equals_jax():
    for n, m in ((5, 4), (8, 4), (0, 3), (7, 1)):
        x = np.arange(n * 2, dtype=np.int32).reshape(n, 2)
        got, want = ingest.pad_to_multiple(x, m, -1), jax_ingest.pad_to_multiple(x, m, -1)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_without_a_job_everything_is_one_rank(monkeypatch):
    monkeypatch.delenv("PIO_COORDINATOR", raising=False)
    monkeypatch.setenv("PIO_MESH", "data=-1,model=1")
    assert distributed.maybe_initialize_distributed("cpu") is False
    assert distributed.runtime() is None and distributed.is_coordinator()
    assert distributed.process_info()["process_count"] == 1
    m = mesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.group("data") is None and m.device.type == "cpu"
    x = torch.arange(6.0).reshape(2, 3)
    from predictionio_tpu_torch.parallel import collectives as C

    assert C.all_gather(x, m, "data") is x and C.ppermute(x, m, "data", [(0, 0)]) is x
    cols, n = ingest.shard_columns(m, {"a": np.arange(3)}, mask_name="ok")
    assert n == 3 and cols["ok"].tolist() == [True] * 3
    with pytest.raises(ValueError, match="require 8 devices, have 1"):
        mesh.make_mesh("data=4,model=2", "cpu")


def test_backend_rule():
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert distributed.choose_backend(cpu, 1) == "gloo"
    # torch.cuda.device_count() is 0 here: any local rank outnumbers the cards
    assert distributed.choose_backend(card, 1) == ("nccl" if torch.cuda.device_count() >= 1 else "gloo")
    assert distributed.choose_backend(card, torch.cuda.device_count() + 1) == "gloo"


def test_rank_layout_is_row_major():
    m = mesh.Mesh(("data", "model"), [2, 3], 4, torch.device("cpu"), {})
    assert m.coords == {"data": 1, "model": 1} and m.size == 6
    assert m.axis_ranks("data") == [1, 4] and m.axis_ranks("model") == [3, 4, 5]


@pytest.mark.parametrize("n_world", [2, 4])
def test_collectives_and_their_gradients(worlds, n_world):
    spec = mesh.MeshSpec.parse("data=2" if n_world == 2 else "data=2,model=2")
    names = [a for a, _ in spec.axes]
    sizes = mesh._resolve_sizes([s for _, s in spec.axes], n_world)
    for r in range(n_world):
        got = load(worlds[n_world], f"collectives{n_world}", r)
        layout = mesh.Mesh(tuple(names), sizes, r, torch.device("cpu"), {})
        assert got["coords"].tolist() == [layout.axis_index(a) for a in names]
        assert got["axis_ranks"].tolist() == [layout.axis_ranks("data")]
        for axis in names:
            ranks, me = layout.axis_ranks(axis), layout.axis_index(axis)
            n = len(ranks)
            xs = [np.arange(12.0).reshape(3, 4) + 100 * j for j in ranks]
            np.testing.assert_array_equal(got[f"all_gather_{axis}"], np.concatenate(xs))
            w = np.arange(3 * n * 4).reshape(3 * n, 4) + 1.0
            np.testing.assert_array_equal(got[f"all_gather_grad_{axis}"], n * w[3 * me:3 * me + 3])
            ys = [np.arange(2.0 * n * 3 * n).reshape(2 * n, 3 * n) + 1000 * j for j in ranks]
            a = np.concatenate([y[2 * me:2 * me + 2] for y in ys], axis=1)
            np.testing.assert_array_equal(got[f"all_to_all_{axis}"], a)
            up = [np.arange(a.size).reshape(a.shape) + 1.0] * n
            dy = np.concatenate([u[:, 3 * n * me:3 * n * (me + 1)] for u in up])
            np.testing.assert_array_equal(got[f"all_to_all_grad_{axis}"], dy)
            np.testing.assert_array_equal(got[f"ppermute_{axis}"], np.ones(3) * (ranks[(me - 1) % n] + 1))
            np.testing.assert_array_equal(got[f"ppermute_grad_{axis}"], np.ones(3) * ((me + 1) % n + 1))
            per = max(j + 1 for j in ranks)
            np.testing.assert_array_equal(got[f"shard_{axis}"], np.r_[np.arange(r + 1), -np.ones(per - r - 1)])
            assert got[f"shard_mask_{axis}"].tolist() == [True] * (r + 1) + [False] * (per - r - 1)
            assert int(got[f"shard_n_{axis}"]) == r + 1
        np.testing.assert_array_equal(got["all_reduce"], np.full(5, n_world * (n_world + 1) / 2))
