"""Contextual-bandit exploration on the rollout machinery (docs/bandit.md).

Arms are registry lanes; assignment is the sticky sha256 canary
bucket; reward is feedback-loop events matched to served impressions by
trace id; the bake gate doubles as reward accounting.

The port's own copy of ``predictionio_tpu/bandit/``.
"""

from predictionio_tpu_torch.bandit.controller import BanditLoop
from predictionio_tpu_torch.bandit.metrics import BanditInstruments
from predictionio_tpu_torch.bandit.policy import (
    ARM_CANDIDATE,
    ARM_STABLE,
    DECIDE_EXPLORE,
    DECIDE_PROMOTE,
    DECIDE_RETIRE,
    ArmState,
    BanditCriteria,
    BanditDecision,
    EpsilonGreedyPolicy,
    ThompsonPolicy,
    decide,
    make_policy,
    p_candidate_better,
    regret_proxy,
)
from predictionio_tpu_torch.bandit.rewards import ImpressionLog, RewardTailer

__all__ = [
    "ARM_CANDIDATE",
    "ARM_STABLE",
    "DECIDE_EXPLORE",
    "DECIDE_PROMOTE",
    "DECIDE_RETIRE",
    "ArmState",
    "BanditCriteria",
    "BanditDecision",
    "BanditInstruments",
    "BanditLoop",
    "EpsilonGreedyPolicy",
    "ImpressionLog",
    "RewardTailer",
    "ThompsonPolicy",
    "decide",
    "make_policy",
    "p_candidate_better",
    "regret_proxy",
]
