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

import math

import numpy as np
import pytest

from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.registry import PromotionCriteria, RolloutController, RolloutInstruments
from predictionio_tpu_torch.registry.controller import (
    VERDICT_PROMOTE,
    VERDICT_ROLLBACK,
    VERDICT_WAIT,
    matched_work_p95,
)
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


# ---------------------------------------------------------------------------
# thin candidates (ROADMAP C20): a p95 over a bake's few candidate batches is
# its largest sample or close to it, so the veto also needs a count of slow
# batches that an equal lane reaches with probability below 1 %
# ---------------------------------------------------------------------------


def _bake(stable: list, cand: list):
    """One bake of given (rows, seconds) batches per lane through the
    port's controller: its (verdict, reason) and what the gate read."""
    inst = RolloutInstruments(MetricsRegistry())
    clock = FakeClock()
    ctrl = RolloutController(inst, PromotionCriteria(bake_window_s=10.0, min_requests=10), clock=clock)
    ctrl.begin("v1", "v2", "canary")
    for version, lane, batches in (("v1", LANE_STABLE, stable), ("v2", LANE_CANDIDATE, cand)):
        for rows, seconds in batches:
            inst.requests.inc(rows, version=version, lane=lane)
            inst.observe_predict(seconds, rows, version=version)
    clock.t += 11
    return ctrl.evaluate(), ctrl.latency_read()


def _equal_lane(n: int, rng, rows: int = 8, slow: int = 0, factor: float = 2.5) -> list:
    """n batches of ``rows`` rows at the shared cost with 5 % jitter, the
    last ``slow`` of them ``factor`` times slower."""
    return [(rows, (FIXED_S + PER_ROW_S * rows) * float(np.exp(0.05 * rng.normal()))
             * (factor if k >= n - slow else 1.0)) for k in range(n)]


def test_slow_batches_needed_is_the_binomial_tail_of_an_equal_lane():
    from predictionio_tpu_torch.registry.controller import slow_batches_needed

    assert [slow_batches_needed(n) for n in (0, 1, 2, 3, 4, 6, 20, 100)] == [None, None, 2, 2, 3, 3, 5, 12]
    for n in (2, 6, 20, 100, 400):
        k = slow_batches_needed(n)
        tail = lambda k: sum(math.comb(n, j) * 0.05**j * 0.95 ** (n - j) for j in range(k, n + 1))  # noqa: E731
        assert tail(k) < 0.01 <= tail(k - 1)


@pytest.mark.parametrize("seed", range(5))
def test_one_slow_batch_of_a_bakes_handful_rolls_back_no_equal_candidate(seed):
    """Equal lanes; the candidate saw 6 batches, one of them 2.5x slow (PR
    20's run B1). Its p95 over six samples reads past 1.5x the stable's,
    which alone vetoed before; one slow batch of six is below the three an
    equal lane reaches with probability 1 %, so the bake promotes."""
    rng = np.random.default_rng(seed)
    (verdict, reason), read = _bake(_equal_lane(300, rng), _equal_lane(6, rng, slow=1))
    assert read["candidate_p95"] > 1.5 * read["stable_p95"]
    assert (read["samples"], read["slow"], read["slow_needed"]) == (6, 1, 3)
    assert verdict == VERDICT_PROMOTE, reason


@pytest.mark.parametrize("seed", range(5))
def test_two_slow_batches_of_many_roll_back_no_equal_candidate_but_most_slow_do(seed):
    rng = np.random.default_rng(seed)
    stable = _equal_lane(300, rng)
    (verdict, reason), read = _bake(stable, _equal_lane(60, rng, slow=2))
    assert read["slow"] == 2 and read["slow_needed"] == 8
    assert verdict == VERDICT_PROMOTE, reason
    (verdict, reason), read = _bake(stable, _equal_lane(60, rng, slow=40, factor=2.0))
    assert read["slow"] == 40
    assert verdict == VERDICT_ROLLBACK and reason.startswith("latency gate:"), reason


@pytest.mark.parametrize("factor", [1.0, 3.0])
def test_a_candidate_too_thin_to_judge_waits(factor):
    """One candidate batch of 16 queries passes the window and the
    request minimum, but no count of one batch can tell a slow lane from
    an equal one: the gate waits, equal or slow, and never promotes."""
    rng = np.random.default_rng(0)
    (verdict, reason), read = _bake(_equal_lane(300, rng), _equal_lane(1, rng, rows=16, slow=1, factor=factor))
    assert read["samples"] == 1 and read["slow_needed"] is None
    assert verdict == VERDICT_WAIT and reason.startswith("latency gate:"), reason
    (verdict, _), _ = _bake(_equal_lane(300, rng),
                            _equal_lane(2, rng, rows=16, slow=2 if factor > 1 else 0, factor=factor))
    assert verdict == (VERDICT_ROLLBACK if factor > 1 else VERDICT_PROMOTE)
