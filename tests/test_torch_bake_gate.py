"""The bake gate's latency veto on equal work (ROADMAP C16).

A lane's predict time is observed once per micro-batch over that lane's
share of the batch. The port's ``RolloutController`` compares the lanes at
one common batch size (``registry.controller.matched_work_p95``); the JAX
controller compares the raw per-batch p95s. The feed below is the same for
both: micro-batches of 16 queries split by the candidate's share, each
lane's time a fixed launch cost plus a per-row cost, with a seeded
multiplicative jitter. The candidate may be slower in both costs alike,
or per row only (at the common size of 8 rows a 3x per-row cost is 2.09x
the stable's time, 2.5x is 1.82x).
"""

import numpy as np
import pytest

from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.registry import PromotionCriteria, RolloutController, RolloutInstruments
from predictionio_tpu_torch.registry.controller import VERDICT_PROMOTE, VERDICT_ROLLBACK, matched_work_p95
from predictionio_tpu_torch.registry.router import LANE_CANDIDATE, LANE_STABLE

FIXED_S, PER_ROW_S = 0.0008, 0.00012  # a batch's launch cost and each row's


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _batches(share: float, slowdown: float = 1.0, per_row: float = 1.0, batches: int = 400,
             batch: int = 16, seed: int = 0):
    """Each lane's (version, lane, rows, seconds) per micro-batch. The
    candidate's fixed and per-row costs are ``slowdown`` times the
    stable's, its per-row cost ``per_row`` times more."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        cand_rows = int(rng.binomial(batch, share))
        for version, lane, rows, factor, row_factor in (("v1", LANE_STABLE, batch - cand_rows, 1.0, 1.0),
                                                        ("v2", LANE_CANDIDATE, cand_rows, slowdown, per_row)):
            if rows:
                seconds = factor * (FIXED_S + row_factor * PER_ROW_S * rows) * float(np.exp(0.05 * rng.normal()))
                out.append((version, lane, rows, seconds))
    return out


def _feed(pkg: str, share: float, slowdown: float = 1.0, per_row: float = 1.0):
    """One bake of :func:`_batches` through ``pkg``'s controller; returns
    its (verdict, reason)."""
    if pkg == "jax":
        from predictionio_tpu.obs.metrics import MetricsRegistry as Reg
        from predictionio_tpu.registry import PromotionCriteria as Crit
        from predictionio_tpu.registry import RolloutController as Ctrl
        from predictionio_tpu.registry import RolloutInstruments as Inst
    else:
        Reg, Crit, Ctrl, Inst = MetricsRegistry, PromotionCriteria, RolloutController, RolloutInstruments
    inst = Inst(Reg())
    clock = FakeClock()
    ctrl = Ctrl(inst, Crit(bake_window_s=10.0, min_requests=10), clock=clock)
    ctrl.begin("v1", "v2", "canary")
    for version, lane, rows, seconds in _batches(share, slowdown, per_row):
        inst.requests.inc(rows, version=version, lane=lane)
        if pkg == "jax":
            inst.predict_seconds.observe(seconds, version=version)
        else:
            inst.observe_predict(seconds, rows, version=version)
    clock.t += 11
    return ctrl.evaluate()


@pytest.mark.parametrize("share", [0.1, 0.5, 0.9])
def test_equal_models_get_no_latency_verdict_at_any_share(share):
    verdict, reason = _feed("port", share, slowdown=1.0)
    assert verdict == VERDICT_PROMOTE, reason


@pytest.mark.parametrize("share", [0.1, 0.5, 0.9])
def test_a_candidate_twice_as_slow_for_equal_rows_is_vetoed_at_any_share(share):
    verdict, reason = _feed("port", share, slowdown=2.0)
    assert verdict == VERDICT_ROLLBACK and reason.startswith("latency gate:"), reason


@pytest.mark.parametrize("per_row,ratio", [(2.5, 1.82), (3.0, 2.09)])
@pytest.mark.parametrize("share", [0.05, 0.1, 0.5, 0.9, 0.95])
def test_a_candidate_slower_per_row_only_is_vetoed_at_any_share(share, per_row, ratio):
    """The same fixed cost and a slower per-row cost: the lanes' samples
    show two cost shapes, each lane keeps its own, and the candidate reads
    slower at the common size by its true ratio there (within 5 %, exact
    percentiles over the same samples), and is vetoed. The gate's own p95s
    are the histogram's bucket-bounded ones, too coarse to show the ratio."""
    verdict, reason = _feed("port", share, per_row=per_row)
    assert verdict == VERDICT_ROLLBACK and reason.startswith("latency gate:"), reason
    lanes = {"v1": [], "v2": []}
    for version, _, rows, seconds in _batches(share, per_row=per_row):
        lanes[version].append((rows, seconds))
    c, s = matched_work_p95([lanes["v2"], lanes["v1"]], lambda xs: float(np.percentile(xs, 95)))
    assert c / s == pytest.approx(ratio, rel=0.05)


def test_the_reference_reads_the_split_at_a_share_of_0_9():
    """The documented difference: the same equal models through the JAX
    controller are rolled back at 0.9 (the candidate's batches are larger),
    and the port promotes them."""
    theirs = _feed("jax", 0.9, slowdown=1.0)
    assert theirs[0] == VERDICT_ROLLBACK and theirs[1].startswith("latency gate:"), theirs
    assert _feed("port", 0.9, slowdown=1.0)[0] == VERDICT_PROMOTE


def test_matched_work_p95_scales_samples_along_the_shared_cost_shape():
    identity = lambda xs: float(np.percentile(xs, 95))  # noqa: E731
    # one shape, 1 + 0.5 rows: stable at 1-2 rows, candidate at 9-10 rows
    stable = [(1, 1.5), (2, 2.0)] * 10
    cand = [(9, 5.5), (10, 6.0)] * 10
    c, s = matched_work_p95([cand, stable], identity)
    assert c == pytest.approx(s, rel=0.02)
    # a candidate twice as slow reads about twice as slow
    c, s = matched_work_p95([[(r, 2 * t) for r, t in cand], stable], identity)
    assert c / s == pytest.approx(2.0, rel=0.02)
    # lanes of three row counts each on two shapes keep their own: the
    # stable 1 + 0.1 r, the candidate 1 + r, both 1.0 at no rows; at the
    # common size of 4.5 rows, 1.45 and 5.5
    flat = [(r, 1.0 + 0.1 * r) for r in (1, 2, 3)] * 10
    steep = [(r, 1.0 + r) for r in (6, 7, 8)] * 10
    c, s = matched_work_p95([steep, flat], identity)
    assert s == pytest.approx(1.45, rel=0.02) and c / s == pytest.approx(5.5 / 1.45, rel=0.03)
    # a lane that saw one row count cannot bend the shape
    c, s = matched_work_p95([[(10, 6.0)] * 5, stable], identity)
    assert c == pytest.approx(s, rel=0.02)
    # equal rows are compared as measured; an empty lane reads 0.0
    assert matched_work_p95([[(1, 3.0)] * 4, [(1, 1.0)] * 4], identity) == [3.0, 1.0]
    assert matched_work_p95([[], [(1, 1.0)]], identity) == [0.0, 1.0]


@pytest.mark.parametrize("share", [0.05, 0.95])
def test_equal_models_at_an_extreme_split_with_a_noisy_small_lane(share):
    """The bandit's 0.05 and 0.95 rounds: micro-batches of 1-16 queries, so
    the small lane sees few samples of one or two row counts, each sample
    with 30 % noise. Over 200 bakes of equal models the 1.5x veto fires in
    at most 2 % (a slope fitted to each lane alone, moving samples by
    seconds per row, fired in 52 of them at 0.95; what remains is the
    sampling noise of a p95 over about 17 samples)."""
    identity = lambda xs: float(np.percentile(xs, 95))  # noqa: E731
    rng = np.random.default_rng(2)
    vetoed = 0
    for _ in range(200):
        lanes = ([], [])
        for _ in range(60):
            n = int(rng.integers(1, 17))
            rows_c = int(rng.binomial(n, share))
            for lane, rows in zip(lanes, (rows_c, n - rows_c)):
                if rows:
                    lane.append((rows, (FIXED_S + PER_ROW_S * rows) * float(np.exp(0.3 * rng.normal()))))
        c, s = matched_work_p95(list(lanes), identity)
        vetoed += c > 1.5 * s
    assert vetoed <= 4, vetoed


def test_a_new_bake_reads_only_its_own_samples():
    inst = RolloutInstruments(MetricsRegistry())
    for _ in range(50):
        inst.observe_predict(0.5, 4, version="v2")
    mark = inst.predict_mark("v2")
    inst.observe_predict(0.01, 4, version="v2")
    assert inst.predict_samples_since("v2", mark) == [(4, 0.01)]
    assert inst.predict_samples_since("v9", 0) == []
