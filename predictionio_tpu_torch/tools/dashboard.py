"""Evaluation + observability dashboard (port 9000).

Reference parity: ``tools/.../dashboard/Dashboard.scala:44-107`` — an HTML
page listing completed EvaluationInstances newest-first with links to their
HTML metric reports, plus the JSON results.

Beyond the reference: the dashboard can be pointed at running servers'
``/metrics`` endpoints (``pio dashboard --metrics-url http://host:8000``,
repeatable) and renders live breaker/queue/latency panels — qps totals,
p50/p95/p99, shed/deadline counts, breaker states, and jit recompile
counts — instead of only the legacy hourly stats. Panels are fetched
server-side at page load with a short timeout; an unreachable server
renders as such rather than failing the page.

The port's own copy of ``predictionio_tpu/tools/dashboard.py``, served by
the standard library's ``ThreadingHTTPServer`` instead of aiohttp (the
same routes and pages); the panels are scraped with ``urllib`` on a
thread each.
"""

from __future__ import annotations

import concurrent.futures
import html
import json
import re
import urllib.parse
import urllib.request
from typing import Sequence

from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.tools.route_server import RouteServer
from predictionio_tpu_torch.tools.top import (
    format_number as _fmt,
    parse_prometheus,
    summarize,
)

_PAGE = """<!DOCTYPE html>
<html><head><title>predictionio_tpu dashboard</title>
<style>
body {{ font-family: sans-serif; margin: 2rem; }}
table {{ border-collapse: collapse; width: 100%; margin-bottom: 2rem; }}
th, td {{ border: 1px solid #ccc; padding: 0.4rem 0.8rem; text-align: left; }}
th {{ background: #f0f0f0; }}
.panel {{ display: inline-block; vertical-align: top; border: 1px solid #ccc;
  border-radius: 6px; padding: 0.8rem 1.2rem; margin: 0 1rem 1rem 0; }}
.panel h3 {{ margin: 0 0 0.5rem 0; font-size: 0.95rem; }}
.panel td {{ border: none; padding: 0.1rem 0.8rem 0.1rem 0; }}
.state-open {{ color: #b00; font-weight: bold; }}
.state-half-open {{ color: #b60; font-weight: bold; }}
.state-closed {{ color: #080; }}
.unreachable {{ color: #b00; }}
</style></head>
<body>
<h1>Dashboard</h1>
{observability}
<h2>Evaluations</h2>
<table>
<tr><th>ID</th><th>Start</th><th>End</th><th>Evaluation</th><th>Batch</th>
<th>Result</th><th></th></tr>
{rows}
</table>
</body></html>"""


def render_metrics_panel(url: str, metrics_text: str | None) -> str:
    """One server's panel: breaker / queue / latency, from a raw /metrics
    scrape (None = the fetch failed)."""
    title = html.escape(url)
    if metrics_text is None:
        return (
            f'<div class="panel"><h3>{title}</h3>'
            '<p class="unreachable">unreachable</p></div>'
        )
    s = summarize(parse_prometheus(metrics_text))
    breaker_cells = (
        " ".join(
            f'<span class="state-{html.escape(str(state))}">'
            f"{html.escape(name)}={html.escape(str(state))}</span>"
            for name, state in sorted((s.get("breakers") or {}).items())
        )
        or "-"
    )
    rows = [
        ("requests", _fmt(s["requests_total"])),
        ("errors (5xx)", _fmt(s["errors_total"])),
        ("p50 / p95 / p99", f"{_fmt(s['p50_ms'])} / {_fmt(s['p95_ms'])} / "
                            f"{_fmt(s['p99_ms'])} ms"),
        ("queue depth", f"{_fmt(s['queue_depth'])} / "
                        f"{_fmt(s['queue_high_water'])} high water"),
        ("shed / deadline", f"{_fmt(s['shed_total'])} / "
                            f"{_fmt(s['deadline_total'])}"),
        ("watchdog trips", _fmt(s["watchdog_total"])),
        ("jit recompiles", _fmt(s["recompiles"])),
        ("storage retries", _fmt(s["retries_total"])),
        ("breakers", breaker_cells),
    ]
    body = "\n".join(
        f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>" for k, v in rows
    )
    return (
        f'<div class="panel"><h3>{title}</h3><table>{body}</table></div>'
    )


_RESULTS = re.compile(r"^/engine_instances/(?P<iid>[^/]+)/evaluator_results\.(?P<ext>html|json)$")
_FETCH_TIMEOUT_S = 2.0


class Dashboard(RouteServer):
    thread_name = "pio-dashboard"

    def __init__(
        self,
        storage: Storage | None = None,
        metrics_urls: Sequence[str] = (),
    ):
        super().__init__()
        self.storage = storage or Storage.instance()
        self.metrics_urls = list(metrics_urls)

    def _fetch_metrics(self, url: str) -> str | None:
        """Scrape one server's /metrics; None on any failure. Split out so
        tests can stub the network."""
        try:
            with urllib.request.urlopen(f"{url}/metrics", timeout=_FETCH_TIMEOUT_S) as resp:
                if resp.status != 200:
                    return None
                return resp.read().decode("utf-8", errors="replace")
        except Exception:
            return None

    def _observability_html(self) -> str:
        if not self.metrics_urls:
            return (
                "<p><i>No metrics sources configured — start with "
                "<code>pio dashboard --metrics-url http://host:port</code> "
                "to see live serving panels.</i></p>"
            )
        # all sources scraped concurrently: page latency is bounded by the
        # slowest single fetch (~2s timeout), not the sum over down servers
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(self.metrics_urls)) as pool:
            texts = list(pool.map(self._fetch_metrics, self.metrics_urls))
        panels = [
            render_metrics_panel(url, text)
            for url, text in zip(self.metrics_urls, texts)
        ]
        return "<h2>Serving</h2>\n" + "\n".join(panels)

    def index_html(self) -> str:
        instances = self.storage.get_meta_data_evaluation_instances().get_completed()
        rows = []
        for i in instances:
            rows.append(
                "<tr>"
                f"<td>{html.escape(i.id)}</td>"
                f"<td>{i.start_time.isoformat()}</td>"
                f"<td>{i.end_time.isoformat()}</td>"
                f"<td>{html.escape(i.evaluation_class)}</td>"
                f"<td>{html.escape(i.batch)}</td>"
                f"<td>{html.escape(i.evaluator_results)}</td>"
                f'<td><a href="/engine_instances/{html.escape(i.id)}/'
                'evaluator_results.html">HTML</a> '
                f'<a href="/engine_instances/{html.escape(i.id)}/'
                'evaluator_results.json">JSON</a></td>'
                "</tr>"
            )
        return _PAGE.format(rows="\n".join(rows), observability=self._observability_html())

    def route(self, method: str, path: str, body: bytes = b"") -> tuple[int, str, bytes]:
        hit = _RESULTS.match(path)
        if path != "/" and hit is None:
            return 404, "text/plain; charset=utf-8", b"404: Not Found"
        if method != "GET":
            return 405, "text/plain; charset=utf-8", b"405: Method Not Allowed"
        if hit is None:
            return 200, "text/html; charset=utf-8", self.index_html().encode()
        instance = self.storage.get_meta_data_evaluation_instances().get(
            urllib.parse.unquote(hit["iid"])
        )
        if hit["ext"] == "html":
            if instance is None:
                return 404, "text/plain; charset=utf-8", b"Not Found"
            text = instance.evaluator_results_html or "<p>(no HTML results)</p>"
            return 200, "text/html; charset=utf-8", text.encode()
        if instance is None:
            return 404, "application/json; charset=utf-8", json.dumps({"message": "Not Found"}).encode()
        return 200, "application/json; charset=utf-8", (instance.evaluator_results_json or "{}").encode()


def run_dashboard(ip: str = "127.0.0.1", port: int = 9000, metrics_urls: Sequence[str] = ()) -> None:
    """Blocking entry point: the dashboard until SIGINT or SIGTERM. Call
    from the main thread."""
    from predictionio_tpu_torch.utils.platform import wait_for_signal

    server = Dashboard(metrics_urls=metrics_urls)
    server.start(ip, port)
    try:
        wait_for_signal()
    finally:
        server.shutdown()
