"""Prometheus text federation: N replica scrapes -> one fleet exposition.

Port of ``predictionio_tpu/fleet/federation.py`` over the port's
``tools/top.parse_prometheus``: for the same scrapes the merged text is
byte-equal to the reference's, with and without exemplars.

The gateway's ``/metrics`` is the fleet's single pane: counters are
summed across replicas, histogram series merge by adding per-``le``
cumulative bucket counts (every replica shares the fixed ladder from
``obs.metrics.DEFAULT_BUCKETS``, so bucket-wise addition is exact), and
``_sum``/``_count`` add like any counter. Gauges are summed too — right
for additive gauges (queue depth, in-flight), documented as
sum-of-replicas for the rest (``docs/fleet.md``); per-replica truth
stays one scrape away on the replica's own endpoint.

OpenMetrics tolerance: a replica scraped with ``?exemplars=1`` decorates
bucket lines with exemplar clauses (``… # {trace_id="…"} v``) and ends
with ``# EOF``. The merge VALUE math strips both via the same ``" # "``
split ``pio top`` uses (the sample still sums exactly); with
``exemplars=True`` the clauses are additionally *carried* onto the
merged output — last replica wins per series, which is the same
last-writer-wins the per-process histogram applies per bucket — so a
federated p99 exemplar still names a concrete trace id that the
gateway's ``/traces/recent?trace_id=`` assembles into a cross-tier
waterfall.

Built on the same stdlib parser ``pio top`` uses, so whatever a replica
can expose, the federated view can carry.
"""

from __future__ import annotations

import re

# _LABEL_RE/_unescape shared with the parser so exemplar-clause keys can
# never diverge from the merged-series keys parse_prometheus produces
from predictionio_tpu_torch.tools.top import (
    _LABEL_RE,
    _parse_value,
    _unescape,
    parse_prometheus,
)

_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (\w+)\s*$")
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
_SAMPLE_NAME_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s")


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _series_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _sample_sort_key(item):
    """Stable exposition order inside one metric: label sets sorted
    lexically, except the histogram ``le`` label which sorts numerically
    so bucket lines stay in ladder order."""
    labels = dict(item[0])
    le = labels.pop("le", None)
    return (
        sorted(labels.items()),
        _parse_value(le) if le is not None else float("-inf"),
    )


def _collect_exemplars(
    text: str,
) -> dict[tuple[str, tuple[tuple[str, str], ...]], str]:
    """``(series_name, label_key) -> exemplar clause`` for every sample
    line carrying one (`` # {…} v`` after the value). The clause is kept
    verbatim for re-attachment to the merged line."""
    out: dict[tuple[str, tuple[tuple[str, str], ...]], str] = {}
    for line in text.splitlines():
        if line.startswith("#") or " # " not in line:
            continue
        sample, clause = line.split(" # ", 1)
        m = _SAMPLE_NAME_RE.match(sample.strip() + " ")
        if not m:
            continue
        labels = {
            k: _unescape(v) for k, v in _LABEL_RE.findall(m.group(2) or "")
        }
        out[(m.group(1), _series_key(labels))] = clause.strip()
    return out


def federate_metrics(texts: list[str], exemplars: bool = False) -> str:
    """Merge N Prometheus/OpenMetrics text expositions into one.

    Identical ``(name, labels)`` series have their values summed; HELP and
    TYPE lines are carried from the first exposition that declares them.
    Input order is the replica order — series unique to one replica pass
    through unchanged. Exemplar clauses and ``# EOF`` in the inputs never
    corrupt the sums (stripped before value parsing); with
    ``exemplars=True`` the clauses are re-attached to the merged lines
    (last input wins per series) and the output ends with ``# EOF`` —
    serve that variant only to scrapers that negotiated OpenMetrics.
    """
    merged: dict[str, dict[tuple[tuple[str, str], ...], float]] = {}
    exemplar_clauses: dict[tuple[str, tuple[tuple[str, str], ...]], str] = {}
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    order: list[str] = []
    for text in texts:
        for line in text.splitlines():
            m = _TYPE_RE.match(line)
            if m:
                types.setdefault(m.group(1), m.group(2))
                continue
            m = _HELP_RE.match(line)
            if m:
                helps.setdefault(m.group(1), m.group(2))
        for name, samples in parse_prometheus(text).items():
            series = merged.setdefault(name, {})
            if name not in order:
                order.append(name)
            for labels, value in samples:
                key = _series_key(labels)
                series[key] = series.get(key, 0.0) + value
        if exemplars:
            exemplar_clauses.update(_collect_exemplars(text))
    lines: list[str] = []
    for name in sorted(order):
        base = _base_metric_name(name, types)
        if base in helps and name == _first_series_name(base, order):
            lines.append(f"# HELP {base} {helps[base]}")
        if base in types and name == _first_series_name(base, order):
            lines.append(f"# TYPE {base} {types[base]}")
        for key, value in sorted(merged[name].items(), key=_sample_sort_key):
            label_str = ""
            if key:
                inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
                label_str = "{" + inner + "}"
            clause = exemplar_clauses.get((name, key)) if exemplars else None
            suffix = f" # {clause}" if clause else ""
            lines.append(f"{name}{label_str} {_format_value(value)}{suffix}")
    if exemplars:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def _base_metric_name(series_name: str, types: dict[str, str]) -> str:
    """``pio_x_seconds_bucket`` -> ``pio_x_seconds`` when the base is a
    declared histogram; otherwise the series name is the metric name."""
    for suffix in ("_bucket", "_sum", "_count"):
        if series_name.endswith(suffix):
            base = series_name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base
    return series_name


def _first_series_name(base: str, order: list[str]) -> str:
    """The lexically-first series name of a metric family — HELP/TYPE are
    emitted exactly once, ahead of that series."""
    candidates = [
        n
        for n in order
        if n == base or n in (f"{base}_bucket", f"{base}_sum", f"{base}_count")
    ]
    return min(candidates) if candidates else base


__all__ = ["federate_metrics"]
