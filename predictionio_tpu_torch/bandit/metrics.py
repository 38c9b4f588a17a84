"""The ``pio_bandit_*`` metric family (docs/observability.md).

Registered eagerly on the query server's registry (AnnInstruments
discipline): the family exists at zero from process start whether or not
a bandit policy is configured, so scrapers and the docs metrics-contract
test see it immediately. Label cardinality is bounded by construction:
the only label is ``arm`` with exactly two values (stable | candidate) —
versions live in the snapshot endpoint, not label space.

The port's own copy of ``predictionio_tpu/bandit/metrics.py``.
"""

from __future__ import annotations

from predictionio_tpu_torch.obs.metrics import MetricsRegistry


class BanditInstruments:
    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self.active = r.gauge(
            "pio_bandit_active",
            "1 while a bandit policy is steering a live rollout's traffic "
            "split, else 0",
        )
        self.pulls = r.counter(
            "pio_bandit_pulls_total",
            "matched impressions credited as pulls, per arm",
            labelnames=("arm",),
        )
        self.rewards = r.counter(
            "pio_bandit_rewards_total",
            "clamped [0,1] reward mass credited from matched feedback "
            "events, per arm",
            labelnames=("arm",),
        )
        self.reward_rate = r.gauge(
            "pio_bandit_reward_rate",
            "posterior mean reward rate Beta(1+rewards, 1+pulls-rewards), "
            "per arm",
            labelnames=("arm",),
        )
        self.fraction = r.gauge(
            "pio_bandit_fraction",
            "candidate traffic fraction the policy chose for the sticky "
            "canary plan",
        )
        self.p_better = r.gauge(
            "pio_bandit_p_candidate_better",
            "Monte-Carlo P(candidate posterior beats stable) at the last "
            "tick (-1 before both arms have evidence)",
        )
        self.regret_pulls = r.gauge(
            "pio_bandit_regret_pulls",
            "regret proxy: pulls accumulated by the posterior-worse arm",
        )
        self.matched = r.counter(
            "pio_bandit_matched_rewards_total",
            "feedback events matched to a live impression by trace id",
        )
        self.unmatched = r.counter(
            "pio_bandit_unmatched_rewards_total",
            "feedback events with no matching impression (expired, "
            "duplicate, or foreign trace id)",
        )
        self.evicted = r.counter(
            "pio_bandit_impressions_evicted_total",
            "impressions aged out of the bounded trace log before any "
            "feedback arrived",
        )
        self.promoted = r.counter(
            "pio_bandit_promotions_total",
            "candidate arms promoted by the reward posterior",
        )
        self.retired = r.counter(
            "pio_bandit_retirements_total",
            "candidate arms retired (rolled back) by the reward posterior",
        )

    def sync_arms(self, arms) -> None:
        """Refresh per-arm gauges + totals from ArmState objects."""
        for arm in arms:
            self.pulls.set_total(float(arm.pulls), arm=arm.arm)
            self.rewards.set_total(float(arm.rewards), arm=arm.arm)
            self.reward_rate.set(float(arm.mean), arm=arm.arm)
