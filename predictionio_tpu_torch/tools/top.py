"""``pio top`` — one-screen terminal summary of a running server's /metrics.

Polls ``<url>/metrics`` (QueryServer or EventServer — both export the same
registry format) and renders the numbers an operator staring at a hot
replica actually wants: qps and error rate (derived from counter deltas
between polls), latency percentiles (recomputed from the histogram's
cumulative buckets — the scrape carries the full distribution, not
pre-baked quantiles), shed/deadline/watchdog pressure, breaker states, and
the jit recompile count that distinguishes "TPU is slow" from "TPU is
compiling".

Stdlib-only (urllib + the text parser below): `pio top` must run on an
operator laptop with nothing but the package installed, against any
Prometheus-format endpoint.

The port's own copy of ``predictionio_tpu/tools/top.py``: the same digest
and screens, so both packages' ``pio top`` print alike against either
server. The port registers no ``pio_jit_*`` family (its kernel builds are
``pio_kernel_builds_total``), so the recompile count reads 0 there.
"""

from __future__ import annotations

import os
import re
import sys
import time
import urllib.request
from typing import Any, Callable

# the request-ordered phase vocabulary — single source of truth in
# obs.waterfall (stdlib-only, so it costs `pio top` nothing)
from predictionio_tpu_torch.obs.waterfall import PHASES as _PHASE_ORDER
from predictionio_tpu_torch.resilience import CLOSED, HALF_OPEN, OPEN

# value of the pio_breaker_state gauge -> human name
BREAKER_STATE_NAMES = {0: CLOSED, 1: HALF_OPEN, 2: OPEN}

# value of the pio_rollout_mode gauge -> human name
ROLLOUT_MODE_NAMES = {0: "off", 1: "canary", 2: "shadow"}

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+"
    r"(?P<value>[^ ]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (
        value.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


def parse_prometheus(text: str) -> dict[str, list[tuple[dict[str, str], float]]]:
    """Parse Prometheus text exposition into
    ``{metric_name: [(labels, value), ...]}``. Comment/HELP/TYPE lines are
    skipped; histogram series keep their ``_bucket``/``_sum``/``_count``
    suffixes as distinct names. OpenMetrics exemplar clauses
    (``… # {trace_id="…"} value``) are stripped — the sample value still
    parses even when the scrape negotiated exemplars."""
    out: dict[str, list[tuple[dict[str, str], float]]] = {}
    for line in text.splitlines():
        # exemplar separator is a literal " # " outside label quotes; none
        # of the framework's label values contain one
        line = line.split(" # ", 1)[0].strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        labels = {
            k: _unescape(v) for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            continue
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


Metrics = dict[str, list[tuple[dict[str, str], float]]]


def _total(metrics: Metrics, name: str, **match: str) -> float:
    return sum(
        v
        for labels, v in metrics.get(name, ())
        if all(labels.get(k) == mv for k, mv in match.items())
    )


def _max(metrics: Metrics, name: str) -> float:
    return max((v for _labels, v in metrics.get(name, ())), default=0.0)


def _histogram_quantile(
    metrics: Metrics, name: str, q: float, **match: str
) -> float:
    """Recompute a quantile from ``<name>_bucket{le=...}`` cumulative
    counts, summed across label sets matching ``match`` (linear
    interpolation in-bucket, mirroring obs.metrics.Histogram)."""
    buckets: dict[float, float] = {}
    for labels, v in metrics.get(f"{name}_bucket", ()):
        if any(labels.get(k) != mv for k, mv in match.items()):
            continue
        le = _parse_value(labels.get("le", "+Inf"))
        buckets[le] = buckets.get(le, 0.0) + v
    if not buckets:
        return 0.0
    bounds = sorted(buckets)
    count = buckets.get(float("inf"), max(buckets.values()))
    if count <= 0:
        return 0.0
    target = q * count
    prev_bound, prev_cum = 0.0, 0.0
    for bound in bounds:
        cum = buckets[bound]
        if cum >= target:
            if bound == float("inf"):
                return prev_bound
            width = bound - prev_bound
            in_bucket = cum - prev_cum
            frac = (target - prev_cum) / in_bucket if in_bucket else 1.0
            return prev_bound + width * frac
        prev_bound, prev_cum = bound, cum
    return prev_bound


def summarize(
    metrics: Metrics,
    prev: Metrics | None = None,
    interval_s: float | None = None,
    now: float | None = None,
) -> dict[str, Any]:
    """Digest one scrape (optionally against the previous one for rates)
    into the flat dict ``render`` prints and tests assert on. ``now``
    (unix seconds; injectable for tests) anchors age computations."""
    requests = _total(metrics, "pio_requests_total")
    errors = sum(
        v
        for labels, v in metrics.get("pio_requests_total", ())
        if labels.get("status", "").startswith("5")
    )
    out: dict[str, Any] = {
        "requests_total": requests,
        "errors_total": errors,
        "p50_ms": _histogram_quantile(metrics, "pio_request_seconds", 0.50) * 1e3,
        "p95_ms": _histogram_quantile(metrics, "pio_request_seconds", 0.95) * 1e3,
        "p99_ms": _histogram_quantile(metrics, "pio_request_seconds", 0.99) * 1e3,
        "shed_total": _total(metrics, "pio_load_shed_total"),
        "deadline_total": _total(metrics, "pio_deadline_exceeded_total"),
        "watchdog_total": _total(metrics, "pio_watchdog_trips_total"),
        "queue_depth": _total(metrics, "pio_queue_depth"),
        "queue_high_water": _total(metrics, "pio_queue_high_water"),
        "recompiles": _total(metrics, "pio_jit_cache_misses_total"),
        "xla_compiles": _total(metrics, "pio_xla_compile_events_total"),
        "retries_total": _total(metrics, "pio_storage_retries_total"),
        "events_ingested": _total(metrics, "pio_events_ingested_total"),
        "breakers": {
            labels.get("breaker", "?"): BREAKER_STATE_NAMES.get(int(v), str(v))
            for labels, v in metrics.get("pio_breaker_state", ())
        },
        "rollout_mode": ROLLOUT_MODE_NAMES.get(
            int(_total(metrics, "pio_rollout_mode")), "off"
        ),
        "rollout_fraction": _total(metrics, "pio_rollout_fraction"),
        "rollbacks_total": _total(metrics, "pio_rollbacks_total"),
        "model_versions": _model_versions(metrics),
    }
    out["phases"] = _phase_summary(metrics)
    out["cache_hit_ratio"] = _cache_hit_ratio(metrics)
    out["ann"] = _ann_summary(metrics)
    out["bandit"] = _bandit_summary(metrics)
    out["slo"] = _slo_summary(metrics)
    out["stream"] = _stream_summary(metrics, now)
    out["train"] = _train_summary(metrics)
    out["fleet"] = _fleet_summary(metrics)
    out["autoscaler"] = _autoscaler_summary(metrics)
    out["qps"] = None
    out["shed_rate"] = None
    out["stream_drain_rate"] = None
    out["train_step_rate"] = None
    if prev is not None and interval_s and interval_s > 0:
        d_req = requests - _total(prev, "pio_requests_total")
        d_shed = out["shed_total"] - _total(prev, "pio_load_shed_total")
        out["qps"] = max(0.0, d_req) / interval_s
        out["shed_rate"] = max(0.0, d_shed) / interval_s
        if out["stream"] is not None:
            d_drain = out["stream"]["drains_total"] - _total(
                prev, "pio_stream_drains_total"
            )
            out["stream_drain_rate"] = max(0.0, d_drain) / interval_s
        if out["train"] is not None:
            d_step = out["train"]["steps_total"] - _total(
                prev, "pio_train_steps_total"
            )
            out["train_step_rate"] = max(0.0, d_step) / interval_s
    return out




def _phase_summary(metrics: Metrics) -> dict[str, dict[str, float]] | None:
    """The latency-attribution waterfall, from ``pio_phase_seconds``:
    per-phase p50/p95 (ms) and count, request-ordered. None when the
    endpoint doesn't export the waterfall (e.g. an event server)."""
    if "pio_phase_seconds_bucket" not in metrics:
        return None
    counts: dict[str, float] = {}
    for labels, v in metrics.get("pio_phase_seconds_count", ()):
        phase = labels.get("phase")
        if phase:
            counts[phase] = counts.get(phase, 0.0) + v
    out: dict[str, dict[str, float]] = {}
    for phase in _PHASE_ORDER:
        if not counts.get(phase):
            continue
        out[phase] = {
            "count": counts[phase],
            "p50_ms": _histogram_quantile(
                metrics, "pio_phase_seconds", 0.50, phase=phase
            )
            * 1e3,
            "p95_ms": _histogram_quantile(
                metrics, "pio_phase_seconds", 0.95, phase=phase
            )
            * 1e3,
        }
    return out or None


def _cache_hit_ratio(metrics: Metrics) -> float | None:
    """Result-cache hit ratio from the pio_cache_* counters; None when
    the endpoint has no result cache (an event server) or the cache has
    seen no lookups yet — a disabled cache never moves either counter,
    so a 0/0 endpoint gets no misleading ``cache hit 0%`` column."""
    if "pio_cache_hits_total" not in metrics:
        return None
    hits = _total(metrics, "pio_cache_hits_total")
    misses = _total(metrics, "pio_cache_misses_total")
    total = hits + misses
    return (hits / total) if total else None


def _ann_summary(metrics: Metrics) -> dict[str, Any] | None:
    """The ANN retrieval line, from the ``pio_ann_*`` family: pinned
    index shape, probes per query, candidate fraction, sampled recall.
    None when no index is pinned AND no ANN query was ever served (the
    family registers eagerly at zero, which must not render a line)."""
    indexes = {
        labels.get("version", "?"): {"items": v}
        for labels, v in metrics.get("pio_ann_index_items", ())
        if v > 0
    }
    for labels, v in metrics.get("pio_ann_index_clusters", ()):
        ver = labels.get("version", "?")
        if ver in indexes:
            indexes[ver]["clusters"] = v
    queries = _total(metrics, "pio_ann_queries_total")
    if not indexes and queries <= 0:
        return None
    probes = _total(metrics, "pio_ann_probes_total")
    return {
        "queries_total": queries,
        "fallback_total": _total(metrics, "pio_ann_fallback_total"),
        "probes_per_query": (probes / queries) if queries else None,
        "candidates_frac": _total(metrics, "pio_ann_candidates_frac"),
        "recall_sampled": _total(metrics, "pio_ann_recall_sampled"),
        "recall_samples_total": _total(metrics, "pio_ann_recall_samples_total"),
        "refreshes_total": _total(metrics, "pio_ann_refreshes_total"),
        "rebuilds_total": _total(metrics, "pio_ann_rebuilds_total"),
        "indexes": indexes,
    }


def _bandit_summary(metrics: Metrics) -> dict[str, Any] | None:
    """The bandit line, from the ``pio_bandit_*`` family: per-arm pulls
    and posterior reward rates, the live traffic split, the promote
    probability, and the regret proxy. None while the family sits at its
    eager-registration zero (no policy ever engaged)."""
    if "pio_bandit_active" not in metrics:
        return None
    active = _total(metrics, "pio_bandit_active")
    pulls = {
        labels.get("arm", "?"): v
        for labels, v in metrics.get("pio_bandit_pulls_total", ())
    }
    promoted = _total(metrics, "pio_bandit_promotions_total")
    retired = _total(metrics, "pio_bandit_retirements_total")
    if not active and not pulls and not promoted and not retired:
        return None
    return {
        "active": bool(active),
        "pulls": pulls,
        "reward_rate": {
            labels.get("arm", "?"): v
            for labels, v in metrics.get("pio_bandit_reward_rate", ())
        },
        "fraction": _total(metrics, "pio_bandit_fraction"),
        "p_candidate_better": _total(
            metrics, "pio_bandit_p_candidate_better"
        ),
        "regret_pulls": _total(metrics, "pio_bandit_regret_pulls"),
        "matched_total": _total(metrics, "pio_bandit_matched_rewards_total"),
        "unmatched_total": _total(
            metrics, "pio_bandit_unmatched_rewards_total"
        ),
        "promotions_total": promoted,
        "retirements_total": retired,
    }


def _slo_summary(metrics: Metrics) -> dict[str, dict[str, Any]] | None:
    """The SLO burn-rate block, from the ``pio_slo_*`` gauges: per-SLO
    objective, per-window burn rates, and the alerting bit."""
    if "pio_slo_objective" not in metrics:
        return None
    out: dict[str, dict[str, Any]] = {}
    for labels, v in metrics.get("pio_slo_objective", ()):
        name = labels.get("slo")
        if name:
            out[name] = {"objective": v, "burn": {}, "alerting": False}
    for labels, v in metrics.get("pio_slo_burn_rate", ()):
        name, window = labels.get("slo"), labels.get("window")
        if name in out and window:
            out[name]["burn"][window] = v
    for labels, v in metrics.get("pio_slo_alerting", ()):
        name = labels.get("slo")
        if name in out:
            out[name]["alerting"] = bool(v)
    return out or None


def _stream_summary(metrics: Metrics, now: float | None) -> dict[str, Any] | None:
    """The speed-layer line, from the ``pio_stream_*`` family; None when
    no stream pipeline exports into this endpoint."""
    if not any(
        name in metrics
        for name in ("pio_stream_drains_total", "pio_stream_lag_events")
    ):
        return None
    last_ts = _total(metrics, "pio_stream_last_publish_timestamp")
    age = None
    if last_ts > 0:
        age = max(0.0, (now if now is not None else time.time()) - last_ts)
    return {
        "lag_events": _total(metrics, "pio_stream_lag_events"),
        "lag_seconds": _total(metrics, "pio_stream_lag_seconds"),
        "drains_total": _total(metrics, "pio_stream_drains_total"),
        "events_total": _total(metrics, "pio_stream_events_total"),
        "publishes_total": _total(metrics, "pio_stream_publishes_total"),
        "drift_suppressed": _total(metrics, "pio_stream_drift_suppressed_total"),
        "last_publish_age_s": age,
    }


def _train_summary(metrics: Metrics) -> dict[str, Any] | None:
    """The training screen, from the ``pio_train_*`` family (obs/xray):
    which trainer is in which phase, iterations done, device-time share,
    and the estimated-vs-measured HBM picture. None when no train
    profiler exports into this endpoint."""
    if "pio_train_steps_total" not in metrics:
        return None
    active: dict[str, str] = {}
    for labels, v in metrics.get("pio_train_active", ()):
        if v > 0 and labels.get("trainer"):
            active[labels["trainer"]] = ""
    for labels, v in metrics.get("pio_train_phase", ()):
        trainer, ph = labels.get("trainer"), labels.get("phase")
        if v > 0 and trainer in active and ph:
            active[trainer] = ph
    phase_wall = _total(metrics, "pio_train_phase_seconds_sum")
    device = _total(metrics, "pio_train_device_seconds_total")
    return {
        "steps_total": _total(metrics, "pio_train_steps_total"),
        "rows_total": _total(metrics, "pio_train_rows_total"),
        "active": active,
        "device_time_frac": (device / phase_wall) if phase_wall > 0 else 0.0,
        # busiest trainer, not the sum: per-trainer peaks are independent
        # samples of the same device pool — summing two 6 GB peaks would
        # render an HBM picture no device ever had
        "peak_bytes_per_device": _max(
            metrics, "pio_train_peak_bytes_per_device"
        ),
        "est_bytes_per_device": _max(
            metrics, "pio_train_est_bytes_per_device"
        ),
    }


def _fleet_summary(metrics: Metrics) -> dict[str, Any] | None:
    """The fleet line, from the gateway's federated ``pio_fleet_*``
    family: replica up/inflight states, ejection/readmission/restart
    counters, retry volume, and the gateway-hop p50. None when the
    endpoint isn't a fleet gateway."""
    if (
        "pio_fleet_replicas" not in metrics
        and "pio_fleet_replica_up" not in metrics
    ):
        return None
    replicas: dict[str, dict[str, Any]] = {}
    # rows are created by LIVE-SET gauges only (the exporters prune these
    # when a replica is retired by a scale-in); the monotonic counters
    # below merely annotate surviving rows — a retired replica's ejection
    # history must not resurrect it as a live-but-down entry
    for name, field, cast in (
        ("pio_fleet_replica_up", "up", lambda v: bool(v)),
        ("pio_fleet_replica_inflight", "inflight", float),
        ("pio_fleet_worker_last_crash_unix", "last_crash_unix", float),
    ):
        for labels, v in metrics.get(name, ()):
            rep = labels.get("replica")
            if rep:
                replicas.setdefault(rep, {})[field] = cast(v)
    for name, field in (
        ("pio_fleet_ejections_total", "ejections"),
        ("pio_fleet_readmissions_total", "readmissions"),
    ):
        for labels, v in metrics.get(name, ()):
            rep = labels.get("replica")
            if rep in replicas:
                replicas[rep][field] = float(v)
    # the captured-log path rides an info gauge (bounded: one series per
    # replica); `pio top --fleet` shows it for workers that have crashed,
    # so the excerpt feeding the incident bundle is one `tail` away
    for labels, v in metrics.get("pio_fleet_worker_log_info", ()):
        rep = labels.get("replica")
        if rep and v > 0 and labels.get("path"):
            replicas.setdefault(rep, {})["log_path"] = labels["path"]
    up = sum(1 for info in replicas.values() if info.get("up"))
    # multi-host inventory (--hosts): per-host up/slots/death gauges plus
    # the replica->host info series group the replica list by box; a
    # single-box fleet exports none of these and `hosts` stays empty
    hosts: dict[str, dict[str, Any]] = {}
    for name, field, cast in (
        ("pio_fleet_host_up", "up", lambda v: bool(v)),
        ("pio_fleet_host_slots", "slots", float),
        ("pio_fleet_host_deaths_total", "deaths", float),
    ):
        for labels, v in metrics.get(name, ()):
            host = labels.get("host")
            if host:
                hosts.setdefault(host, {"residents": []})[field] = cast(v)
    for labels, v in metrics.get("pio_fleet_worker_host_info", ()):
        rep, host = labels.get("replica"), labels.get("host")
        if rep and host and v > 0:
            if rep in replicas:
                replicas[rep]["host"] = host
            if host in hosts:
                hosts[host]["residents"].append(rep)
    # resident liveness comes from the SUPERVISOR's worker-named series
    # (`pio_fleet_worker_up{replica="w0"}`) — the gateway's replica rows
    # above are keyed by address, so a name lookup there always misses
    worker_up = {
        labels["replica"]: bool(v)
        for labels, v in metrics.get("pio_fleet_worker_up", ())
        if labels.get("replica")
    }
    for info in hosts.values():
        info["residents"].sort()
        info["residents_up"] = sum(
            1
            for rep in info["residents"]
            if worker_up.get(rep, bool(replicas.get(rep, {}).get("up")))
        )
    return {
        "replicas_total": _total(metrics, "pio_fleet_replicas")
        or float(len(replicas)),
        "replicas_up": float(up),
        "replicas": replicas,
        "hosts": hosts,
        "retries_total": _total(metrics, "pio_fleet_retries_total"),
        "no_replica_total": _total(metrics, "pio_fleet_no_replica_total"),
        "ejections_total": _total(metrics, "pio_fleet_ejections_total"),
        "readmissions_total": _total(metrics, "pio_fleet_readmissions_total"),
        "restarts_total": _total(metrics, "pio_fleet_restarts_total"),
        "crash_loops_total": _total(metrics, "pio_fleet_crash_loops_total"),
        "gateway_p50_ms": _histogram_quantile(
            metrics, "pio_gateway_request_seconds", 0.50
        )
        * 1e3,
    }


def _autoscaler_summary(metrics: Metrics) -> dict[str, Any] | None:
    """The autoscaler line, from the fleet parent's ``pio_autoscaler_*``
    family: live shape per class vs the envelope, plus the decision
    counters. None when no autoscaler runs on the scraped endpoint."""
    if "pio_autoscaler_replicas" not in metrics:
        return None
    shape = {
        labels.get("worker_class", "?"): v
        for labels, v in metrics.get("pio_autoscaler_replicas", ())
    }
    return {
        "shape": shape,
        "min_replicas": _total(metrics, "pio_autoscaler_replicas_min"),
        "max_replicas": _total(metrics, "pio_autoscaler_replicas_max"),
        "cpu_fallback_max": _total(metrics, "pio_autoscaler_cpu_fallback_max"),
        "scale_outs_total": _total(metrics, "pio_autoscaler_scale_outs_total"),
        "scale_ins_total": _total(metrics, "pio_autoscaler_scale_ins_total"),
        "deferred_total": _total(metrics, "pio_autoscaler_deferred_total"),
        "saturated_total": _total(metrics, "pio_autoscaler_saturated_total"),
        "overflow_picks_total": _total(
            metrics, "pio_fleet_overflow_picks_total"
        ),
        "last_scale_unix": _total(metrics, "pio_autoscaler_last_scale_unix"),
        "ticks_total": _total(metrics, "pio_autoscaler_ticks_total"),
        "errors_total": _total(metrics, "pio_autoscaler_errors_total"),
    }


def _model_versions(metrics: Metrics) -> dict[str, dict[str, Any]]:
    """Per-model-version request/error totals and the lanes each version
    serves on, from the ``pio_model_*`` rollout counters."""
    versions: dict[str, dict[str, Any]] = {}
    for name, field in (
        ("pio_model_requests_total", "requests"),
        ("pio_model_errors_total", "errors"),
    ):
        for labels, v in metrics.get(name, ()):
            ver = labels.get("version")
            if not ver:
                continue
            info = versions.setdefault(
                ver, {"requests": 0.0, "errors": 0.0, "lanes": set()}
            )
            info[field] += v
            if v > 0 and labels.get("lane"):
                info["lanes"].add(labels["lane"])
    for info in versions.values():
        info["lanes"] = ",".join(sorted(info["lanes"])) or "-"
    return versions


def format_number(v: Any, suffix: str = "") -> str:
    """'-' for missing, 1 decimal for fractional floats, bare ints
    otherwise. Shared by the terminal screen and the dashboard panels."""
    if v is None:
        return "-"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.1f}{suffix}"
    return f"{int(v)}{suffix}"


def format_bytes(v: Any) -> str:
    """'-' for missing/zero; 1.2GB-style otherwise (decimal units — HBM
    capacities are quoted decimal)."""
    if not v:
        return "-"
    v = float(v)
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if v >= div:
            return f"{v / div:.1f}{unit}"
    return f"{int(v)}B"


def render(summary: dict[str, Any], url: str) -> str:
    """The one screen."""
    num = format_number
    breakers = summary.get("breakers") or {}
    breaker_line = (
        "  ".join(f"{name}={state}" for name, state in sorted(breakers.items()))
        or "(none)"
    )
    lines = [
        f"pio top — {url}   {time.strftime('%H:%M:%S')}",
        "",
        f"  qps        {num(summary['qps'], '/s'):>12}    "
        f"requests   {num(summary['requests_total']):>12}    "
        f"errors(5xx) {num(summary['errors_total']):>10}",
        f"  p50        {num(summary['p50_ms'], ' ms'):>12}    "
        f"p95        {num(summary['p95_ms'], ' ms'):>12}    "
        f"p99         {num(summary['p99_ms'], ' ms'):>10}",
        f"  shed rate  {num(summary['shed_rate'], '/s'):>12}    "
        f"shed total {num(summary['shed_total']):>12}    "
        f"deadlines   {num(summary['deadline_total']):>10}",
        f"  queue      {num(summary['queue_depth']):>12}    "
        f"high water {num(summary['queue_high_water']):>12}    "
        f"watchdog    {num(summary['watchdog_total']):>10}",
        f"  recompiles {num(summary['recompiles']):>12}    "
        f"xla events {num(summary['xla_compiles']):>12}    "
        f"retries     {num(summary['retries_total']):>10}",
        f"  breakers   {breaker_line}",
    ]
    phases = summary.get("phases") or {}
    if phases:
        # the waterfall line: request-ordered per-phase p50s plus their sum
        # — the at-a-glance answer to "where do the milliseconds go"
        parts = [
            f"{phase.replace('_', ' ')} {info['p50_ms']:.2f}"
            for phase, info in phases.items()
        ]
        total_p50 = sum(info["p50_ms"] for info in phases.values())
        tail = f"   (p50 ms, Σ {total_p50:.2f})"
        hit_ratio = summary.get("cache_hit_ratio")
        if hit_ratio is not None:
            # the hit-ratio column rides the waterfall line: a high ratio
            # explains a Σ well under the e2e p50 (hits skip most phases)
            tail += f"   cache hit {hit_ratio * 100.0:.0f}%"
        lines.append("  waterfall  " + " | ".join(parts) + tail)
    ann = summary.get("ann")
    if ann is not None:
        idx_parts = [
            f"{ver} ({num(info.get('items'))} items/"
            f"{num(info.get('clusters'))} clusters)"
            for ver, info in sorted((ann.get("indexes") or {}).items())
        ]
        line = "  ann        " + (" ".join(idx_parts) or "(no index pinned)")
        line += f"   queries {num(ann['queries_total'])}"
        if ann.get("probes_per_query") is not None:
            line += f"   probes/q {ann['probes_per_query']:.1f}"
        if ann.get("candidates_frac"):
            line += f"   cand {ann['candidates_frac'] * 100.0:.1f}%"
        if ann.get("recall_samples_total"):
            line += f"   recall~{ann['recall_sampled']:.3f}"
        if ann.get("fallback_total"):
            line += f"   fallback {num(ann['fallback_total'])}"
        if ann.get("refreshes_total") or ann.get("rebuilds_total"):
            line += (
                f"   refreshes {num(ann['refreshes_total'])}"
                f"/{num(ann['rebuilds_total'])} rebuilt"
            )
        lines.append(line)
    bandit = summary.get("bandit")
    if bandit is not None:
        arm_parts = []
        for arm in ("stable", "candidate"):
            if arm in bandit.get("pulls", {}) or arm in bandit.get(
                "reward_rate", {}
            ):
                rate = bandit.get("reward_rate", {}).get(arm)
                arm_parts.append(
                    f"{arm} "
                    + (f"{rate:.3f}" if rate is not None else "-")
                    + f" ({num(bandit['pulls'].get(arm, 0))} pulls)"
                )
        state = "live" if bandit.get("active") else "idle"
        line = (
            f"  bandit     [{state}] "
            + (" / ".join(arm_parts) or "(no arms)")
        )
        if bandit.get("active"):
            line += f"   split {bandit.get('fraction', 0.0):.2f}"
            p = bandit.get("p_candidate_better")
            if p is not None and p >= 0:
                line += f"   P(cand>stable) {p:.2f}"
        line += f"   regret {num(bandit.get('regret_pulls'))}"
        line += f"   matched {num(bandit.get('matched_total'))}"
        if bandit.get("unmatched_total"):
            line += f" ({num(bandit['unmatched_total'])} unmatched)"
        line += (
            f"   promoted {num(bandit.get('promotions_total'))}"
            f"   retired {num(bandit.get('retirements_total'))}"
        )
        lines.append(line)
    slos = summary.get("slo") or {}
    if slos:
        parts = []
        for name, info in sorted(slos.items()):
            burns = "/".join(
                f"{info['burn'][w]:.2f}"
                for w in sorted(info["burn"], key=float)
            )
            state = "ALERT" if info.get("alerting") else "ok"
            parts.append(f"{name} burn {burns or '-'} {state}")
        lines.append("  slo        " + "   ".join(parts))
    versions = summary.get("model_versions") or {}
    if versions:
        parts = [
            f"{ver}[{info['lanes']}] req {num(info['requests'])} "
            f"err {num(info['errors'])}"
            for ver, info in sorted(versions.items())
        ]
        mode = summary.get("rollout_mode", "off")
        tail = ""
        if mode != "off":
            tail = f"   mode {mode}"
            if mode == "canary":
                tail += f"@{summary.get('rollout_fraction', 0.0):.2f}"
        if summary.get("rollbacks_total"):
            tail += f"   rollbacks {num(summary['rollbacks_total'])}"
        lines.append("  models     " + "  ".join(parts) + tail)
    stream = summary.get("stream")
    if stream is not None:
        age = stream.get("last_publish_age_s")
        published = f"published {num(stream['publishes_total'])}"
        if age is not None:
            published += f" (age {num(round(age, 1), 's')})"
        drain_rate = summary.get("stream_drain_rate")
        drains = f"drains {num(stream['drains_total'])}"
        if drain_rate is not None:
            drains = f"drains {num(drain_rate, '/s')} ({num(stream['drains_total'])})"
        # the fold-in loop's jit cache misses ride the same endpoint: a
        # vocab-growth recompile storm is a stream incident, so it shows
        # on the stream line, not only in the recompiles row
        lines.append(
            f"  stream     lag {num(stream['lag_events'])} ev / "
            f"{num(round(stream['lag_seconds'], 1), 's')}   {drains}   "
            f"{published}   drift-suppressed {num(stream['drift_suppressed'])}"
            f"   recompiles {num(summary.get('recompiles'))}"
        )
    train = summary.get("train")
    if train is not None:
        active = train.get("active") or {}
        who = (
            "  ".join(
                f"{name}[{ph or 'idle'}]" for name, ph in sorted(active.items())
            )
            or "(idle)"
        )
        steps = f"steps {num(train['steps_total'])}"
        rate = summary.get("train_step_rate")
        if rate is not None:
            steps += f" ({num(rate, '/s')})"
        frac = train.get("device_time_frac") or 0.0
        hbm = (
            f"hbm peak {format_bytes(train.get('peak_bytes_per_device'))}"
            f" / est {format_bytes(train.get('est_bytes_per_device'))}"
        )
        lines.append(
            f"  train      {who}   {steps}   device {frac * 100.0:.0f}%   "
            f"rows {num(train['rows_total'])}   {hbm}"
        )
    fleet = summary.get("fleet")
    if fleet is not None:
        parts = []
        for rep, info in sorted((fleet.get("replicas") or {}).items()):
            if "up" not in info:
                # supervisor-side series (crash time, log path) use the
                # worker NAME as the replica label; without probe state
                # they are not routing targets — the crash line below
                # renders them, a phantom [DOWN] entry here would not
                continue
            state = "up" if info.get("up") else "DOWN"
            inflight = info.get("inflight")
            tag = f"{rep}[{state}"
            if inflight is not None:
                tag += f" {num(inflight)}"
            parts.append(tag + "]")
        line = (
            f"  fleet      {num(fleet['replicas_up'])}/"
            f"{num(fleet['replicas_total'])} up   "
            + ("  ".join(parts) or "(no replicas)")
        )
        line += (
            f"   retries {num(fleet['retries_total'])}"
            f"   ejected {num(fleet['ejections_total'])}"
            f"   readmitted {num(fleet['readmissions_total'])}"
        )
        if fleet.get("restarts_total"):
            line += f"   restarts {num(fleet['restarts_total'])}"
        if fleet.get("crash_loops_total"):
            line += f"   CRASH-LOOPED {num(fleet['crash_loops_total'])}"
        if fleet.get("gateway_p50_ms"):
            line += f"   gw p50 {fleet['gateway_p50_ms']:.2f} ms"
        lines.append(line)
        for host, hinfo in sorted((fleet.get("hosts") or {}).items()):
            # one line per declared host: replicas grouped by box, the
            # up/slots census, and a shouting marker when the whole box
            # is gone (the per-replica DOWNs above are its symptoms)
            residents = hinfo.get("residents") or []
            rep_up = hinfo.get("residents_up")
            if rep_up is None:
                rep_up = sum(
                    1
                    for rep in residents
                    if (fleet.get("replicas") or {}).get(rep, {}).get("up")
                )
            hline = (
                f"  host       {host}  {num(float(rep_up))}/"
                f"{num(hinfo.get('slots'))} slots  "
                + ("  ".join(residents) or "(empty)")
            )
            if not hinfo.get("up", True):
                hline += "   HOST-DOWN"
            if hinfo.get("deaths"):
                hline += f"   deaths {num(hinfo['deaths'])}"
            lines.append(hline)
        for rep, info in sorted((fleet.get("replicas") or {}).items()):
            # the last-crash excerpt: which replica died and where its
            # captured stderr tail lives (the incident bundle's source)
            if info.get("last_crash_unix") and info.get("log_path"):
                lines.append(
                    f"  crash      {rep} last "
                    f"{time.strftime('%H:%M:%S', time.localtime(info['last_crash_unix']))}"
                    f"   log {info['log_path']}"
                )
    scaler = summary.get("autoscaler")
    if scaler is not None:
        shape = scaler.get("shape") or {}
        device = shape.get("device", 0.0)
        cpu = shape.get("cpu-fallback", 0.0)
        line = (
            f"  autoscaler device {num(device)} "
            f"[{num(scaler['min_replicas'])}..{num(scaler['max_replicas'])}]"
        )
        if scaler.get("cpu_fallback_max"):
            line += (
                f"   cpu {num(cpu)}/{num(scaler['cpu_fallback_max'])}"
                f"   overflow {num(scaler['overflow_picks_total'])}"
            )
        line += (
            f"   outs {num(scaler['scale_outs_total'])}"
            f"   ins {num(scaler['scale_ins_total'])}"
        )
        if scaler.get("deferred_total"):
            line += f"   deferred {num(scaler['deferred_total'])}"
        if scaler.get("saturated_total"):
            line += f"   SATURATED {num(scaler['saturated_total'])}"
        if scaler.get("last_scale_unix"):
            line += (
                "   last "
                f"{time.strftime('%H:%M:%S', time.localtime(scaler['last_scale_unix']))}"
            )
        lines.append(line)
    if summary.get("events_ingested"):
        lines.append(f"  ingested   {num(summary['events_ingested']):>12}")
    return "\n".join(lines)


def fetch_metrics(url: str, timeout_s: float = 5.0) -> str:
    with urllib.request.urlopen(f"{url}/metrics", timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# --history: the telemetry ring rendered as series
# ---------------------------------------------------------------------------

_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def fetch_stacks(url: str, timeout_s: float = 5.0) -> dict[str, Any]:
    """GET ``<url>/profile/stacks?format=json`` — the host sampler's
    structured snapshot (obs/sampler). Raises on any transport/parse
    failure; the caller degrades the hotspots line, never the screen."""
    import json as _json

    target = url.rstrip("/") + "/profile/stacks?format=json"
    with urllib.request.urlopen(target, timeout=timeout_s) as resp:
        return _json.loads(resp.read().decode("utf-8", errors="replace"))


def render_hotspots(snapshot: dict[str, Any]) -> str:
    """The ``--hotspots`` block: per-role top-of-stack frames from the
    always-on sampler, plus its self-measured overhead — the line that
    says WHICH thread role is hot without leaving the terminal."""
    if "error" in snapshot:
        return f"hotspots: unreachable ({snapshot['error']})"
    overhead = snapshot.get("overheadFrac") or 0.0
    samples = int(snapshot.get("samples") or 0)
    lines = [
        f"hotspots (sampler {overhead * 100:.2f}% ovh, {samples} samples):"
    ]
    hotspots = snapshot.get("hotspots") or {}
    roles = snapshot.get("roles") or {}
    for role in sorted(hotspots, key=lambda r: -roles.get(r, 0)):
        tops = "  ".join(
            f"{e['frame']} {e['frac'] * 100:.0f}%" for e in hotspots[role]
        )
        lines.append(f"  {role:<12} {tops}")
    if len(lines) == 1:
        lines.append("  (no samples yet)")
    return "\n".join(lines)


def sparkline(values: list[float], width: int = 60) -> str:
    """Downsample to ``width`` columns and render with block glyphs;
    empty input renders as '-'. Scaled to the series max (min pinned at
    0 — queue depth and burn are magnitudes, not deltas)."""
    if not values:
        return "-"
    if len(values) > width:
        # mean-pool into width buckets so a spike several records wide
        # survives; a single-record spike still lands in some bucket
        step = len(values) / width
        pooled = []
        for i in range(width):
            lo, hi = int(i * step), max(int(i * step) + 1, int((i + 1) * step))
            chunk = values[lo:hi]
            pooled.append(sum(chunk) / len(chunk))
        values = pooled
    top = max(values)
    if top <= 0:
        return _SPARK_BLOCKS[0] * len(values)
    out = []
    for v in values:
        idx = int((max(0.0, v) / top) * (len(_SPARK_BLOCKS) - 1) + 0.5)
        out.append(_SPARK_BLOCKS[min(idx, len(_SPARK_BLOCKS) - 1)])
    return "".join(out)


def render_history(records: list[dict[str, Any]], window_s: float) -> str:
    """The ``pio top --history`` screen: queue-depth / inflight / burn /
    shed series from the telemetry ring's snapshot records, oldest on
    the left. Works identically whether the records came over HTTP
    (``GET /telemetry/window``) or straight off the on-disk ring — the
    ring surviving a gateway restart is the whole point."""
    if not records:
        return "pio top --history: no telemetry records in the window"
    # the ring carries two record kinds: "fleet" snapshots (the series
    # below) and the autoscaler's "scaling" decisions (rendered as a
    # marker line — they have no gauges to sparkline)
    scaling = [r for r in records if r.get("kind") == "scaling"]
    records = [r for r in records if r.get("kind", "fleet") == "fleet"]
    if not records:
        return "pio top --history: no fleet snapshots in the window"
    t0 = float(records[0].get("t", 0.0))
    t1 = float(records[-1].get("t", t0))
    queue = [float(r.get("gauges", {}).get("queue_depth", 0.0)) for r in records]
    inflight = [float(r.get("gauges", {}).get("inflight", 0.0)) for r in records]
    shed = [float(r.get("counters", {}).get("no_replica", 0.0)) for r in records]
    healthy = [
        float(sum(1 for rep in r.get("replicas", {}).values() if rep.get("healthy")))
        for r in records
    ]
    # fast-window burn per SLO: the series the ROADMAP-2 autoscaler reads
    burns: dict[str, list[float]] = {}
    alerts = 0
    for r in records:
        for name, state in (r.get("slo") or {}).items():
            burn = state.get("burn") or {}
            fast = min(burn, key=float, default=None)
            burns.setdefault(name, []).append(
                float(burn.get(fast, 0.0)) if fast is not None else 0.0
            )
            if state.get("alerting"):
                alerts += 1
    lines = [
        f"pio top --history — {len(records)} snapshots over "
        f"{max(0.0, t1 - t0):.0f}s (window {window_s:.0f}s)   "
        f"{time.strftime('%H:%M:%S', time.localtime(t0))} → "
        f"{time.strftime('%H:%M:%S', time.localtime(t1))}",
        "",
        f"  queue      {sparkline(queue)}  max {format_number(max(queue))}",
        f"  inflight   {sparkline(inflight)}  max {format_number(max(inflight))}",
        f"  healthy    {sparkline(healthy)}  "
        f"min {format_number(min(healthy) if healthy else 0)}",
        f"  shed Σ     {sparkline(shed)}  last {format_number(shed[-1])}",
    ]
    for name, series in sorted(burns.items()):
        lines.append(
            f"  burn {name[:20]:<20} {sparkline(series, width=40)}  "
            f"last {series[-1]:.2f}"
        )
    if alerts:
        lines.append(f"  ALERTING in {alerts} snapshot(s)")
    if scaling:
        last = scaling[-1]
        decision = last.get("decision") or {}
        shape = last.get("shape") or {}
        lines.append(
            f"  scaling    {len(scaling)} decision(s)   last: "
            f"{decision.get('action', '?')} {decision.get('class') or ''} "
            f"({decision.get('reason', '?')}) -> "
            f"device {format_number(shape.get('device', 0))}"
            + (
                f" + cpu {format_number(shape.get('cpu'))}"
                if shape.get("cpu")
                else ""
            )
            + f"   {time.strftime('%H:%M:%S', time.localtime(float(last.get('t', 0.0))))}"
        )
    return "\n".join(lines)


def render_batchpredict(status: dict[str, Any]) -> str:
    """The ``pio top --batchpredict`` progress line, from the run's
    throttled atomic status file (docs/batch_predict.md): live while the
    run is active, final totals after it. One header + one line — the
    offline twin of the serving waterfall line."""
    num = format_number
    state = status.get("state", "?")
    qps = status.get("qps")
    queries = status.get("queries", 0)
    ok = status.get("ok", 0)
    errors = status.get("errors", 0)
    batches = status.get("batches", 0)
    phase_p50 = status.get("phaseP50Ms") or {}
    phases = (
        "  phases "
        + "|".join(
            f"{name} {phase_p50[name]:.1f}"
            for name in ("read", "assemble", "dispatch", "fetch", "write")
            if name in phase_p50
        )
        + " ms"
        if phase_p50
        else ""
    )
    engine = status.get("engineId", "?")
    src = status.get("source", "?")
    return (
        f"pio top — batchpredict {engine} (pid {status.get('pid', '?')}, "
        f"{state})   {time.strftime('%H:%M:%S')}\n"
        f"  batchpredict  {num(queries)} q ({num(ok)} ok, {num(errors)} err)"
        f"  {num(batches)} batches x{num(status.get('batchSize'))}"
        f"  {num(qps, ' q/s')}  src {src}{phases}"
    )


def run_batchpredict_top(
    path: str,
    interval_s: float = 2.0,
    iterations: int | None = None,
    json_mode: bool = False,
    out: Callable[[str], None] = print,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Poll-and-render loop over a batchpredict status file. A missing or
    torn file degrades to an 'unreadable' line (the writer is atomic, so
    torn means 'not started yet'); the loop keeps polling — the usual
    mode is watching a run that is still warming up."""
    import json as _json

    n = 0
    try:
        while iterations is None or n < iterations:
            try:
                with open(path) as fh:
                    status = _json.load(fh)
            except (OSError, ValueError) as exc:
                if json_mode:
                    out(_json.dumps({"batchpredict": path, "error": str(exc)}))
                else:
                    out(f"pio top — batchpredict: {path} unreadable ({exc})")
            else:
                if json_mode:
                    out(_json.dumps({"batchpredict": path, **status}))
                else:
                    out(render_batchpredict(status))
            n += 1
            if iterations is None or n < iterations:
                sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return 0


def render_evalgrid(status: dict[str, Any]) -> str:
    """The ``pio top --eval`` live grid line, from the run's throttled
    atomic status file (docs/evaluation.md): cells done/total, running
    workers, best score so far, ETA — live while the grid runs, final
    totals after."""
    num = format_number
    state = status.get("state", "?")
    done = status.get("cellsDone", 0)
    total = status.get("cellsTotal", 0)
    skipped = status.get("cellsSkipped", 0)
    failed = status.get("cellsFailed", 0)
    best = status.get("bestScore")
    best_str = (
        f"best {best:.4f} (params {status.get('bestParams', '?')})"
        if isinstance(best, (int, float))
        else "best —"
    )
    eta = status.get("etaS") or 0
    eta_str = f"  eta {eta:.0f}s" if eta and state == "running" else ""
    extras = []
    if skipped:
        extras.append(f"{num(skipped)} resumed")
    if failed:
        extras.append(f"{num(failed)} FAILED")
    extra_str = f" ({', '.join(extras)})" if extras else ""
    return (
        f"pio top — eval grid [{status.get('metric', '?')}] "
        f"(pid {status.get('pid', '?')}, {state})   {time.strftime('%H:%M:%S')}\n"
        f"  grid   {num(done)}/{num(total)} cells{extra_str}   "
        f"{num(status.get('folds'))} folds   "
        f"{num(status.get('running'))} running / "
        f"{num(status.get('workers'))} workers   {best_str}{eta_str}"
    )


def run_evalgrid_top(
    path: str,
    interval_s: float = 2.0,
    iterations: int | None = None,
    json_mode: bool = False,
    out: Callable[[str], None] = print,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Poll-and-render loop over an eval-grid status file — the
    batchpredict loop's twin: a missing/torn file degrades to an
    'unreadable' line and the loop keeps polling (the writer is atomic,
    so torn means 'not started yet')."""
    import json as _json

    n = 0
    try:
        while iterations is None or n < iterations:
            try:
                with open(path) as fh:
                    status = _json.load(fh)
            except (OSError, ValueError) as exc:
                if json_mode:
                    out(_json.dumps({"evalgrid": path, "error": str(exc)}))
                else:
                    out(f"pio top — eval grid: {path} unreadable ({exc})")
            else:
                if json_mode:
                    out(_json.dumps({"evalgrid": path, **status}))
                else:
                    out(render_evalgrid(status))
            n += 1
            if iterations is None or n < iterations:
                sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return 0


def render_lifecycle(status: dict[str, Any]) -> str:
    """The ``pio top --lifecycle`` line, from the controller's durable
    state file (docs/lifecycle.md): episode state, what triggered it,
    the grid's progress, the candidate being baked, and the last
    episode's outcome."""
    policy = status.get("policy") or {}
    grid = status.get("grid") or {}
    state = policy.get("state", "?")
    parts = [f"pio top — lifecycle {status.get('engine') or '?'}"]
    if status.get("paused"):
        parts.append("[PAUSED]")
    head = " ".join(parts) + f"   {time.strftime('%H:%M:%S')}"
    detail = [f"  state  {state}"]
    if policy.get("triggerReason"):
        detail.append(f"trigger {policy['triggerReason']}")
    if state == "tuning":
        detail.append(f"grid {grid.get('state') or 'starting'}")
        if grid.get("error"):
            detail.append(f"error {grid['error']}")
    if state == "baking" and policy.get("stagedVersion"):
        detail.append(f"candidate {policy['stagedVersion']}")
    if policy.get("lastOutcome"):
        detail.append(f"last {policy['lastOutcome']}")
    last = status.get("lastDecision") or {}
    if last.get("reason"):
        detail.append(f"({last.get('action')}: {last.get('reason')})")
    return head + "\n" + "   ".join(detail)


def run_lifecycle_top(
    path: str,
    interval_s: float = 2.0,
    iterations: int | None = None,
    json_mode: bool = False,
    out: Callable[[str], None] = print,
    sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Poll-and-render loop over the lifecycle controller's state file —
    the eval-grid loop's twin: a missing/torn file degrades to an
    'unreadable' line and the loop keeps polling (the writer is atomic,
    so torn means 'not started yet')."""
    import json as _json

    n = 0
    try:
        while iterations is None or n < iterations:
            try:
                with open(path) as fh:
                    status = _json.load(fh)
            except (OSError, ValueError) as exc:
                if json_mode:
                    out(_json.dumps({"lifecycle": path, "error": str(exc)}))
                else:
                    out(f"pio top — lifecycle: {path} unreadable ({exc})")
            else:
                if json_mode:
                    out(_json.dumps({"lifecycle": path, **status}))
                else:
                    out(render_lifecycle(status))
            n += 1
            if iterations is None or n < iterations:
                sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return 0


def fetch_telemetry_window(
    url: str, window_s: float, timeout_s: float = 5.0
) -> list[dict[str, Any]]:
    import json as _json

    with urllib.request.urlopen(
        f"{url}/telemetry/window?s={window_s:g}", timeout=timeout_s
    ) as resp:
        data = _json.loads(resp.read().decode("utf-8", errors="replace"))
    return data.get("records", [])


def run_history(
    url: str | None = None,
    obs_dir: str | None = None,
    window_s: float = 600.0,
    json_mode: bool = False,
    out: Callable[[str], None] = print,
) -> int:
    """One-shot history screen, from the gateway's
    ``/telemetry/window`` endpoint (``--url``) or straight off an
    on-disk ring directory (``--obs-dir``, for when the gateway is down
    — the forensic case the ring exists for)."""
    import json as _json

    try:
        if obs_dir:
            ring_dir = os.path.join(obs_dir, "telemetry")
            if not os.path.isdir(ring_dir):
                # read path must not mkdir a typo'd --obs-dir into being
                out(f"pio top --history: no telemetry ring at {ring_dir}")
                return 1
            from predictionio_tpu_torch.obs.tsring import TelemetryRing

            records = TelemetryRing(ring_dir).window(window_s)
        elif url:
            records = fetch_telemetry_window(url, window_s)
        else:
            out("pio top --history needs --url or --obs-dir")
            return 2
    except Exception as exc:
        out(f"pio top --history: telemetry unavailable ({exc})")
        return 1
    if json_mode:
        out(_json.dumps({"window_s": window_s, "records": records}))
    else:
        out(render_history(records, window_s))
    return 0


def run_top(
    url: str,
    interval_s: float = 2.0,
    iterations: int | None = None,
    fetch: Callable[[str], str] | None = None,
    out: Callable[[str], None] = print,
    clear_screen: bool | None = None,
    sleep: Callable[[float], None] = time.sleep,
    json_mode: bool = False,
    urls: list[str] | None = None,
    hotspots: bool = False,
    stacks_fetch: Callable[[str], dict[str, Any]] | None = None,
) -> int:
    """Poll-and-render loop. ``iterations=None`` runs until interrupted;
    fetch/out/sleep are injectable so tests drive it without a network.
    ``json_mode`` emits one machine-readable JSON object per snapshot —
    one per line — so CI and fleet tooling can consume the same digest
    the terminal screen renders. ``urls`` polls SEVERAL endpoints per
    refresh (``--metrics-url`` repeated): fleet dashboards scrape every
    replica directly as well as the gateway's federated view, and each
    endpoint gets its own JSON object (or screen block) per refresh with
    per-endpoint rate state — one unreachable replica degrades only its
    own line, never the whole refresh."""
    import json as _json

    fetch = fetch or fetch_metrics
    endpoints = [u for u in (urls or []) if u] or [url]
    if clear_screen is None:
        clear_screen = sys.stdout.isatty() and not json_mode
    prev: dict[str, Metrics] = {}
    prev_t: dict[str, float] = {}
    n = 0
    # Ctrl-C is a clean exit wherever it lands — mid-fetch (urllib can
    # block up to its timeout against a hung server), mid-render, or in
    # the sleep — never a stack trace
    try:
        while iterations is None or n < iterations:
            screens: list[str] = []
            for u in endpoints:
                try:
                    text = fetch(u)
                except Exception as exc:
                    if json_mode:
                        out(_json.dumps({"url": u, "error": str(exc)}))
                    else:
                        screens.append(f"pio top — {u}: unreachable ({exc})")
                    prev.pop(u, None)
                    prev_t.pop(u, None)
                else:
                    metrics = parse_prometheus(text)
                    now = time.monotonic()
                    last_t = prev_t.get(u)
                    dt = (now - last_t) if last_t is not None else None
                    summary = summarize(
                        metrics, prev=prev.get(u), interval_s=dt
                    )
                    if hotspots:
                        # degradation contract: an endpoint without the
                        # profiling plane (older server, proxy) costs one
                        # "unreachable" line, never the whole refresh
                        try:
                            summary["hotspots"] = (stacks_fetch or fetch_stacks)(u)
                        except Exception as exc:  # noqa: BLE001
                            summary["hotspots"] = {"error": str(exc)}
                    if json_mode:
                        out(
                            _json.dumps(
                                {"url": u, "time": time.time(), **summary}
                            )
                        )
                    else:
                        block = render(summary, u)
                        if hotspots:
                            block += "\n" + render_hotspots(summary["hotspots"])
                        screens.append(block)
                    prev[u], prev_t[u] = metrics, now
            if screens:
                screen = "\n\n".join(screens)
                if clear_screen:
                    out("\x1b[2J\x1b[H" + screen)
                else:
                    out(screen)
            n += 1
            if iterations is None or n < iterations:
                sleep(interval_s)
    except KeyboardInterrupt:
        pass
    return 0
