"""Bandit arm state and exploration policies.

Arms are registry lanes: the stable lane and the candidate lane of one
rollout are the two arms of a Bernoulli bandit. Per-arm reward posteriors
are Beta(1 + rewards, 1 + pulls - rewards); the policy's only actuator is
the canary FRACTION of the rollout plan — assignment itself stays the
sticky sha256 bucket, so exploration is fleet-consistent and a user
flips lanes only when the fraction crosses their bucket.

Everything here is pure and deterministic given the seeded RNG: the
serving tick drives it, tests replay it.

The port's own copy of ``predictionio_tpu/bandit/policy.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

ARM_STABLE = "stable"
ARM_CANDIDATE = "candidate"

DECIDE_EXPLORE = "explore"
DECIDE_PROMOTE = "promote"
DECIDE_RETIRE = "retire"


@dataclasses.dataclass
class ArmState:
    """One lane's reward account. ``pulls`` count SERVED impressions (an
    impression that never earns feedback decays the posterior mean — CTR
    semantics); ``rewards`` is the summed clamped-[0,1] reward mass from
    matched feedback events."""

    version: str
    arm: str
    pulls: float = 0.0
    rewards: float = 0.0

    @property
    def alpha(self) -> float:
        return 1.0 + self.rewards

    @property
    def beta(self) -> float:
        return 1.0 + max(0.0, self.pulls - self.rewards)

    @property
    def mean(self) -> float:
        """Posterior mean reward rate."""
        return self.alpha / (self.alpha + self.beta)

    def to_json_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "arm": self.arm,
            "pulls": self.pulls,
            "rewards": self.rewards,
        }

    @classmethod
    def from_json_dict(cls, d: dict[str, Any]) -> "ArmState":
        return cls(
            version=str(d.get("version", "")),
            arm=str(d.get("arm", "")),
            pulls=float(d.get("pulls", 0.0)),
            rewards=float(d.get("rewards", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class BanditCriteria:
    """When the posterior is allowed to decide. ``min_pulls`` gates BOTH
    arms — a decision before either arm has evidence is a coin flip with
    extra steps. Promote/retire thresholds are on P(candidate beats
    stable) estimated from the posteriors."""

    min_pulls: float = 20.0
    promote_threshold: float = 0.95
    retire_threshold: float = 0.05
    # fraction clamp: the candidate always keeps exploring a little and
    # the stable always keeps earning fresh reward evidence
    min_fraction: float = 0.05
    max_fraction: float = 0.9
    samples: int = 512  # Monte-Carlo resolution of P(candidate > stable)


def p_candidate_better(
    stable: ArmState, candidate: ArmState, rng: np.random.Generator, samples: int
) -> float:
    """Monte-Carlo P(candidate reward rate > stable's) under the two Beta
    posteriors — the quantity both policies and the decision gate share."""
    s = rng.beta(stable.alpha, stable.beta, size=samples)
    c = rng.beta(candidate.alpha, candidate.beta, size=samples)
    return float(np.mean(c > s))


class EpsilonGreedyPolicy:
    """Exploit the posterior-better arm with probability ``1 - epsilon``
    of the traffic, keep ``epsilon`` on the other — expressed as the
    candidate fraction of the sticky canary plan."""

    name = "epsilon"

    def __init__(self, epsilon: float = 0.1):
        self.epsilon = min(0.5, max(0.0, epsilon))

    def fraction(
        self,
        stable: ArmState,
        candidate: ArmState,
        criteria: BanditCriteria,
        rng: np.random.Generator,
    ) -> float:
        if candidate.pulls < criteria.min_pulls:
            # cold-start exploration: epsilon traffic until the candidate
            # has enough pulls to have an opinion about
            frac = max(self.epsilon, criteria.min_fraction)
        elif candidate.mean > stable.mean:
            frac = 1.0 - self.epsilon
        else:
            frac = self.epsilon
        return min(criteria.max_fraction, max(criteria.min_fraction, frac))


class ThompsonPolicy:
    """Probability matching: the candidate's traffic share IS the Monte-
    Carlo estimate of P(candidate beats stable) under the posteriors."""

    name = "thompson"

    def __init__(self, epsilon: float = 0.1):
        # epsilon doubles as the cold-start fraction before min_pulls
        self.epsilon = min(0.5, max(0.0, epsilon))

    def fraction(
        self,
        stable: ArmState,
        candidate: ArmState,
        criteria: BanditCriteria,
        rng: np.random.Generator,
    ) -> float:
        if candidate.pulls < criteria.min_pulls:
            frac = max(self.epsilon, criteria.min_fraction)
        else:
            frac = p_candidate_better(stable, candidate, rng, criteria.samples)
        return min(criteria.max_fraction, max(criteria.min_fraction, frac))


def make_policy(name: str, epsilon: float = 0.1):
    if name == EpsilonGreedyPolicy.name:
        return EpsilonGreedyPolicy(epsilon)
    if name == ThompsonPolicy.name:
        return ThompsonPolicy(epsilon)
    raise ValueError(
        f"unknown bandit policy {name!r} (epsilon | thompson)"
    )


@dataclasses.dataclass(frozen=True)
class BanditDecision:
    verdict: str  # explore | promote | retire
    fraction: float
    p_better: float | None
    reason: str


def decide(
    stable: ArmState,
    candidate: ArmState,
    criteria: BanditCriteria,
    fraction: float,
    rng: np.random.Generator,
) -> BanditDecision:
    """The bake-gate-as-reward-accounting verdict: with evidence on both
    arms, a candidate whose P(beats stable) clears ``promote_threshold``
    promotes; one below ``retire_threshold`` retires through the existing
    rollback state machine. Anything else keeps exploring at the policy's
    fraction."""
    if stable.pulls < criteria.min_pulls or candidate.pulls < criteria.min_pulls:
        return BanditDecision(
            DECIDE_EXPLORE,
            fraction,
            None,
            f"collecting evidence ({candidate.pulls:g}/{criteria.min_pulls:g} "
            f"candidate pulls, {stable.pulls:g}/{criteria.min_pulls:g} stable)",
        )
    p = p_candidate_better(stable, candidate, rng, criteria.samples)
    if p >= criteria.promote_threshold:
        return BanditDecision(
            DECIDE_PROMOTE,
            fraction,
            p,
            f"P(candidate better)={p:.3f} >= {criteria.promote_threshold:g}",
        )
    if p <= criteria.retire_threshold:
        return BanditDecision(
            DECIDE_RETIRE,
            fraction,
            p,
            f"P(candidate better)={p:.3f} <= {criteria.retire_threshold:g}",
        )
    return BanditDecision(
        DECIDE_EXPLORE, fraction, p, f"P(candidate better)={p:.3f}"
    )


def regret_proxy(stable: ArmState, candidate: ArmState) -> float:
    """Pulls spent on the posterior-WORSE arm — the observable stand-in
    for cumulative regret (true regret needs the unknowable true means)."""
    worse = candidate if candidate.mean < stable.mean else stable
    return float(worse.pulls)
