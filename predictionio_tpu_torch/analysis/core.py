"""Analyzer engine: rule registry, call-graph build, suppression, reporting.

Rules live in sibling ``rules_*`` modules; each declares its metadata with
:func:`register_rule` and registers one checker callable with
:func:`register_checker`. A checker receives a :class:`FileContext` and
yields :class:`Finding` objects; the engine applies inline/file suppressions
afterwards so checkers never need to know about them.

The engine is whole-program: :func:`analyze_paths` first
parses every file, builds one cross-file call graph (callgraph.py) and the
per-category reachability sets (reachability.py) from the config's declared
``entry_points``, then runs the per-file checkers against that shared state.
Context-sensitive rules ask "is this function reachable from a serving /
predict / train / eval / async entry point" instead of matching hand-kept
glob + function-name lists.
"""

from __future__ import annotations

import ast
import dataclasses
import enum
import fnmatch
import io
import os
import re
import time
import tokenize
from typing import Callable, Iterable, Iterator

from .callgraph import ProjectGraph, build_project
from .reachability import (
    CATEGORY_ASYNC,
    CATEGORY_EVAL,
    CATEGORY_PREDICT,
    CATEGORY_SERVING,
    CATEGORY_TRAIN,
    EntryPoint,
    Reachability,
)


class Severity(enum.IntEnum):
    INFO = 10
    WARNING = 20
    ERROR = 30


@dataclasses.dataclass(frozen=True)
class RuleMeta:
    """Declared identity of one rule: id, family, default severity, docs."""

    id: str
    family: str
    severity: Severity
    summary: str


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: Severity
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity.name.lower()} [{self.rule}] {self.message}"
        )

    def to_json_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity.name.lower(),
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


# ---------------------------------------------------------------------------
# entry-point declarations (what the old glob/function-name lists became)
# ---------------------------------------------------------------------------

# request hot path: every def in these modules serves traffic (HTTP
# handlers + their helpers); anything they reach inherits the category
_SERVING_ENTRY_GLOBS = (
    "*/controller/serving.py",
    "*/workflow/create_server.py",
    "*/data/api/*.py",
    # bandit accounting rides the query hot path (record_impression) and
    # the rollout heartbeat — same obs + host-sync discipline as serving.
    # (models/sequential is NOT a serving root: its engine is covered by
    # the predict-category roots below, whose rules know the sanctioned
    # ops/topk endings.)
    "*/bandit/*.py",
)

# module-scoped obs rules (print-logging / label cardinality) are not
# reachability-based: they cover the request-path modules plus the new
# engine + instrument modules that export pio_* families
_OBS_MODULE_GLOBS = _SERVING_ENTRY_GLOBS + ("*/models/sequential/*.py",)

# the predict path's named roots: Engine.dispatch_batch / the batchpredict
# drain / ann search / eval-grid scoring. Reachability covers the helpers
# these flow through — the names stay ONLY for the roots themselves.
_PREDICT_ENTRY_GLOBS = (
    "*/models/*/engine.py",
    "*/ann/*.py",
    "*/workflow/batch_predict.py",
    "*/controller/engine.py",
    "*/tuning/*.py",
)
_PREDICT_ENTRY_FUNCTIONS = (
    "predict",
    "predict_batch",
    "predict_batch_dispatch",
    "predict_with_context",
    "batch_predict",
    "serve",
    "search_async",
    "fetch",
    "record_recall",
    "dispatch_batch",
    "run_pipeline",
    "dispatch_scores",
    "score_cell",
)

# training loops: bare device->host syncs anywhere these reach must go
# through obs.torchprof.timed_fetch / obs.xray device accounting
_TRAIN_ENTRY_GLOBS = (
    "*/ops/als.py",
    "*/ops/als_sharded.py",
    "*/ops/spd_solve.py",
    "*/stream/trainers.py",
    "*/stream/pipeline.py",
    "*/tuning/*.py",
    # the lifecycle controller's tick path reaches the grid runner and
    # registry — bare device syncs there ride the same accounting rule
    "*/lifecycle/*.py",
)

# evaluation grid: held-out scoring must ride Engine.dispatch_batch's
# mega-batches — a per-query .predict() loop anywhere the cell scorers
# reach reinstates one device round-trip per held-out query per cell
_EVAL_ENTRY_FUNCTIONS = ("dispatch_scores", "score_cell")

# fleet event loops: every async def in these modules runs on an event
# loop whose stall is a fleet-wide p99 spike
_ASYNC_ENTRY_GLOBS = (
    "*/fleet/*.py",
    "*/data/api/*.py",
    "*/workflow/create_server.py",
    # the profiling plane: capture/publish do real file I/O and
    # the sampler walks every thread's frames — any async def that grows
    # here (or any handler that calls into them without an executor hop)
    # must prove its blocking work runs off the event loop
    "*/obs/profiler.py",
    "*/obs/sampler.py",
    # the lifecycle controller's async run() shares the fleet parent's
    # event loop with the gateway — its ticks must stay on the executor
    "*/lifecycle/*.py",
)

DEFAULT_ENTRY_POINTS: tuple[EntryPoint, ...] = (
    tuple(EntryPoint(CATEGORY_SERVING, g) for g in _SERVING_ENTRY_GLOBS)
    + tuple(
        EntryPoint(CATEGORY_PREDICT, g, f)
        for g in _PREDICT_ENTRY_GLOBS
        for f in _PREDICT_ENTRY_FUNCTIONS
    )
    + tuple(EntryPoint(CATEGORY_TRAIN, g) for g in _TRAIN_ENTRY_GLOBS)
    + tuple(
        EntryPoint(CATEGORY_EVAL, "*/tuning/*.py", f)
        for f in _EVAL_ENTRY_FUNCTIONS
    )
    + tuple(
        EntryPoint(CATEGORY_ASYNC, g, async_only=True)
        for g in _ASYNC_ENTRY_GLOBS
    )
)


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Tunables a caller (CLI, tests, CI) may override."""

    # declared reachability roots — the ONLY place serving/predict/train/
    # eval/async scopes are configured (the per-rule glob+name lists these
    # replaced are gone; helpers are covered by the call graph)
    entry_points: tuple[EntryPoint, ...] = DEFAULT_ENTRY_POINTS
    # modules on the request hot path, used by the module-scoped obs rules
    # (print-logging / label cardinality) which are not reachability-based
    serving_globs: tuple[str, ...] = _OBS_MODULE_GLOBS
    # modules on the stream (speed-layer) path: event-store reads here
    # must be bounded (rule stream-unbounded-drain). The bandit reward
    # tail and the sequential engine's ordered-event pager drain the same
    # store from long-lived loops, so they ride the same rule.
    stream_globs: tuple[str, ...] = (
        "*/stream/*.py",
        "*/bandit/*.py",
        "*/models/sequential/*.py",
    )
    # fleet gateway/supervisor modules: outbound replica calls and
    # replica state transitions must route through the span/telemetry
    # helpers (rule fleet-unattributed-proxy) — an unattributed proxy is
    # a hop /traces/recent can never assemble, an unattributed
    # eject/park is evidence the incident recorder never sees
    fleet_globs: tuple[str, ...] = (
        "*/fleet/gateway.py",
        "*/fleet/supervisor.py",
        "*/fleet/launch.py",
        "*/fleet/autoscaler.py",
        "*/fleet/hostrt.py",
    )
    # modules holding sharded kernels: the mesh-* family guards axis-name
    # agreement and single-host materialization here
    mesh_sharded_globs: tuple[str, ...] = (
        "*/parallel/*.py",
        "*/ops/*_sharded.py",
    )
    # modules whose event loops must never block (rule async-blocking-call
    # reports at call sites inside these files)
    async_globs: tuple[str, ...] = _ASYNC_ENTRY_GLOBS
    # rule ids to run; None = all registered
    enabled: frozenset[str] | None = None


@dataclasses.dataclass
class ProjectState:
    """Whole-program state shared by every checker in a run."""

    graph: ProjectGraph
    reach: Reachability


@dataclasses.dataclass
class FileContext:
    """Everything a checker may look at for one file."""

    path: str  # absolute path on disk ('' for in-memory sources)
    display_path: str  # what findings print; also the call-graph file key
    source: str
    tree: ast.Module
    config: LintConfig
    cache: dict  # shared across the whole run (cross-file state)

    def finding(self, rule_id: str, node: ast.AST | int, message: str) -> Finding:
        meta = _RULES[rule_id]
        if isinstance(node, int):
            line, col = node, 0
        else:
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
        return Finding(rule_id, meta.severity, self.display_path, line, col, message)

    @property
    def graph_path(self) -> str:
        """The key this file is indexed under in the call graph: the
        absolute path when we have one (display paths are cwd-relative and
        would stop matching globs when linting from inside the tree)."""
        return self.path or self.display_path

    def project(self) -> ProjectState:
        """The run's whole-program state. ``analyze_paths`` pre-builds it
        over every scanned file; a bare ``analyze_source`` (snippet tests)
        gets a single-file graph so in-file reachability still works."""
        state = self.cache.get("project_state")
        if isinstance(state, ProjectState):
            if state.graph.has_file(self.graph_path):
                return state
        per = self.cache.setdefault("_single_file_states", {})
        if self.graph_path not in per:
            graph = build_project([(self.graph_path, self.tree)])
            per[self.graph_path] = ProjectState(
                graph, Reachability(graph, self.config.entry_points)
            )
        return per[self.graph_path]


Checker = Callable[[FileContext], Iterable[Finding]]

_RULES: dict[str, RuleMeta] = {}
_CHECKERS: list[Checker] = []


def register_rule(
    rule_id: str, family: str, severity: Severity, summary: str
) -> RuleMeta:
    if rule_id in _RULES:
        raise ValueError(f"duplicate rule id {rule_id!r}")
    meta = RuleMeta(rule_id, family, severity, summary)
    _RULES[rule_id] = meta
    return meta


def register_checker(fn: Checker) -> Checker:
    _CHECKERS.append(fn)
    return fn


def all_rules() -> list[RuleMeta]:
    return sorted(_RULES.values(), key=lambda m: (m.family, m.id))


# registered eagerly so FileContext.finding works for parse failures too
register_rule(
    "parse-error",
    "engine",
    Severity.ERROR,
    "file does not parse as Python; nothing else can be checked",
)

register_rule(
    "suppression-stale",
    "engine",
    Severity.WARNING,
    "a # pio-lint: disable comment whose target no longer produces that "
    "finding — delete it or re-justify it",
)


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*pio-lint:\s*disable(?P<file>-file)?(?:=(?P<rules>[A-Za-z0-9_\-, ]+))?"
)


@dataclasses.dataclass(frozen=True)
class SuppressionSite:
    """One ``# pio-lint: disable`` comment, for the suppression inventory
    (``pio lint --report-suppressions``) and stale detection."""

    path: str
    line: int
    rules: tuple[str, ...] | None  # None = blanket (all rules)
    reason: str
    file_level: bool
    targets: tuple[int, ...]  # lines the comment covers (file_level: ())
    used: bool = False  # did any raw finding match it this run?

    def format(self) -> str:
        ids = ",".join(self.rules) if self.rules else "ALL"
        scope = "file" if self.file_level else f"line {self.line}"
        state = "used" if self.used else "STALE"
        reason = self.reason or "(no reason given)"
        return f"{self.path}:{self.line}: [{ids}] {scope} {state} — {reason}"


def _iter_comment_tokens(source: str) -> Iterator[tuple[int, int, str]]:
    """(lineno, col, text) for every real COMMENT token. Tokenizing (vs a
    per-line regex) keeps ``# pio-lint:`` examples inside docstrings from
    registering as suppression sites."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.start[1], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return  # unparseable tail: the parse-error finding covers it


def _parse_suppression_sites(source: str, path: str) -> list[SuppressionSite]:
    """Every suppression comment in the file. A comment alone on a line
    also covers the next line, so decorators/long calls can be annotated
    above."""
    if "pio-lint" not in source:  # skip tokenizing the common case
        return []
    sites: list[SuppressionSite] = []
    lines = source.splitlines()
    for lineno, col, text in _iter_comment_tokens(source):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        if rules is not None:
            # anything after `--` is the human reason, not an id (the id
            # character class overlaps it, so cut there first)
            rules = rules.split("--", 1)[0]
        # the full reason, from the original text (ids can't contain "--")
        _, sep, reason = text[m.start():].partition("--")
        reason = reason.strip() if sep else ""
        ids = tuple(
            r.strip() for r in (rules or "").split(",") if r.strip()
        ) or None
        file_level = bool(m.group("file"))
        standalone = lines[lineno - 1][:col].strip() == ""
        if file_level:
            targets: tuple[int, ...] = ()
        elif standalone:
            targets = (lineno, lineno + 1)  # standalone covers next line
        else:
            targets = (lineno,)
        sites.append(
            SuppressionSite(
                path=path,
                line=lineno,
                rules=ids,
                reason=reason,
                file_level=file_level,
                targets=targets,
            )
        )
    return sites


def _suppression_maps(
    sites: Iterable[SuppressionSite],
) -> tuple[dict[int, frozenset[str] | None], frozenset[str] | None, bool]:
    """Collapse sites into the per-line / file-level lookup maps."""
    per_line: dict[int, frozenset[str] | None] = {}
    file_rules: set[str] = set()
    file_all = False
    for site in sites:
        ids = frozenset(site.rules) if site.rules is not None else None
        if site.file_level:
            if ids is None:
                file_all = True
            else:
                file_rules.update(ids)
            continue
        for t in site.targets:
            prev = per_line.get(t, frozenset())
            if prev is None or ids is None:
                per_line[t] = None
            else:
                per_line[t] = prev | ids
    return per_line, frozenset(file_rules) or None, file_all


def _is_suppressed(
    f: Finding,
    per_line: dict[int, frozenset[str] | None],
    file_rules: frozenset[str] | None,
    file_all: bool,
) -> bool:
    if file_all or (file_rules and f.rule in file_rules):
        return True
    ids = per_line.get(f.line, frozenset())
    return ids is None or f.rule in ids


def _mark_usage(
    sites: list[SuppressionSite], raw: list[Finding]
) -> list[SuppressionSite]:
    """Which suppression sites matched at least one raw finding."""
    out = []
    for site in sites:
        if site.file_level:
            used = any(
                site.rules is None or f.rule in site.rules for f in raw
            )
        else:
            used = any(
                f.line in site.targets
                and (site.rules is None or f.rule in site.rules)
                for f in raw
            )
        out.append(dataclasses.replace(site, used=used))
    return out


# ---------------------------------------------------------------------------
# analysis drivers
# ---------------------------------------------------------------------------


def _parse_error_finding(display_path: str, exc: SyntaxError) -> Finding:
    meta = _RULES["parse-error"]
    return Finding(
        meta.id,
        meta.severity,
        display_path,
        exc.lineno or 1,
        (exc.offset or 1) - 1,
        f"syntax error: {exc.msg}",
    )


def _analyze_tree(
    source: str,
    display_path: str,
    tree: ast.Module,
    config: LintConfig,
    cache: dict,
    path: str,
) -> tuple[list[Finding], list[Finding], list[SuppressionSite]]:
    """Run every checker over one pre-parsed file, then apply suppressions
    and stale-suppression detection."""
    ctx = FileContext(path, display_path, source, tree, config, cache)
    raw: list[Finding] = []
    for checker in _CHECKERS:
        for f in checker(ctx):
            if config.enabled is not None and f.rule not in config.enabled:
                continue
            raw.append(f)
    sites = _parse_suppression_sites(source, display_path)
    sites = _mark_usage(sites, raw)
    # stale detection only audits full runs: under --rule filtering most
    # suppressions legitimately match nothing
    if config.enabled is None:
        meta = _RULES["suppression-stale"]
        for site in sites:
            if site.used or site.rules is None:
                continue  # blanket disables can't be stale-checked
            if "suppression-stale" in site.rules:
                # a meta-suppression's own finding only exists after this
                # pass; auditing it here would always call it stale
                continue
            ids = ",".join(site.rules)
            raw.append(
                Finding(
                    meta.id,
                    meta.severity,
                    display_path,
                    site.line,
                    0,
                    f"suppression [{ids}] no longer matches any finding "
                    "on its target line(s); delete it or re-justify it",
                )
            )
    per_line, file_rules, file_all = _suppression_maps(sites)
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for f in sorted(raw, key=lambda f: (f.line, f.col, f.rule)):
        if _is_suppressed(f, per_line, file_rules, file_all):
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed, sites


def analyze_source(
    source: str,
    display_path: str,
    config: LintConfig | None = None,
    cache: dict | None = None,
    path: str = "",
) -> tuple[list[Finding], list[Finding]]:
    """Analyze one source blob. Returns ``(active, suppressed)`` findings.

    Without a pre-built project in ``cache`` the call graph covers just
    this file — cross-file edges need :func:`analyze_paths`.
    """
    config = config or LintConfig()
    cache = cache if cache is not None else {}
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [_parse_error_finding(display_path, exc)], []
    active, suppressed, _sites = _analyze_tree(
        source, display_path, tree, config, cache, path
    )
    return active, suppressed


@dataclasses.dataclass
class Report:
    findings: list[Finding]
    suppressed: list[Finding]
    files_scanned: int
    duration_s: float
    suppression_sites: list[SuppressionSite] = dataclasses.field(
        default_factory=list
    )

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity >= Severity.ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def summary(self) -> str:
        return (
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s) "
            f"({len(self.suppressed)} suppressed) in {self.files_scanned} "
            f"file(s) [{self.duration_s * 1000:.0f} ms]"
        )


_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", "build", "dist"}


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    seen: set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py") and os.path.abspath(p) not in seen:
                seen.add(os.path.abspath(p))
                yield p
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    full = os.path.join(dirpath, name)
                    if os.path.abspath(full) not in seen:
                        seen.add(os.path.abspath(full))
                        yield full


def analyze_paths(
    paths: Iterable[str],
    config: LintConfig | None = None,
    report_paths: Iterable[str] | None = None,
) -> Report:
    """Whole-program run: parse everything, build the call graph once,
    then check each file against the shared reachability state.

    ``report_paths`` (absolute paths) limits which files' findings are
    REPORTED — the graph is still built over all of them, so --changed
    keeps whole-program context.
    """
    config = config or LintConfig()
    start = time.monotonic()
    cwd = os.getcwd()
    report_set = (
        {os.path.abspath(p) for p in report_paths}
        if report_paths is not None
        else None
    )
    files: list[tuple[str, str, str, ast.Module | None, SyntaxError | None]] = []
    for file_path in iter_python_files(paths):
        abs_path = os.path.abspath(file_path)
        display = os.path.relpath(abs_path, cwd)
        if display.startswith(".." + os.sep):
            display = abs_path
        try:
            with open(abs_path, encoding="utf-8", errors="replace") as fh:
                source = fh.read()
        except OSError:
            continue
        try:
            tree: ast.Module | None = ast.parse(source)
            err: SyntaxError | None = None
        except SyntaxError as exc:
            tree, err = None, exc
        files.append((abs_path, display, source, tree, err))

    # graph keys are ABSOLUTE paths: display paths are cwd-relative and
    # would silently stop matching entry-point globs when linting from
    # inside the package tree
    graph = build_project(
        (abs_path, tree) for abs_path, _, _, tree, _ in files if tree is not None
    )
    cache: dict = {
        "project_state": ProjectState(
            graph, Reachability(graph, config.entry_points)
        )
    }

    findings: list[Finding] = []
    suppressed: list[Finding] = []
    sites: list[SuppressionSite] = []
    for abs_path, display, source, tree, err in files:
        if report_set is not None and abs_path not in report_set:
            reportable = False
        else:
            reportable = True
        if tree is None:
            if reportable and err is not None:
                findings.append(_parse_error_finding(display, err))
            continue
        active, supp, file_sites = _analyze_tree(
            source, display, tree, config, cache, abs_path
        )
        if reportable:
            findings.extend(active)
            suppressed.extend(supp)
            sites.extend(file_sites)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(
        findings, suppressed, len(files), time.monotonic() - start, sites
    )


def matches_any_glob(display_path: str, globs: Iterable[str]) -> bool:
    """Match a path against config globs, OS-separator agnostic."""
    norm = display_path.replace(os.sep, "/")
    return any(fnmatch.fnmatch(norm, g) for g in globs)
