"""Console entry for the analyzer: ``pio lint`` and the standalone ``lint``.

Deliberately free of torch/numpy imports so it starts fast in CI and
pre-commit hooks (and never initialises CUDA).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from predictionio_tpu_torch.analysis import LintConfig, all_rules, analyze_paths


def default_lint_paths() -> list[str]:
    """The package itself, the bundled engine templates (inside it) and the
    examples/ tree next to the repo root, when present."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = os.path.dirname(pkg_dir)
    paths = [pkg_dir]
    examples = os.path.join(root, "examples")
    if os.path.isdir(examples):
        paths.append(examples)
    return paths


def add_lint_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "paths",
        nargs="*",
        help="files/directories to lint (default: the installed "
        "predictionio_tpu_torch package and ./examples)",
    )
    parser.add_argument(
        "--format",
        dest="output_format",
        choices=("text", "json", "sarif"),
        default="text",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="exit nonzero on warnings too, not just errors",
    )
    parser.add_argument(
        "--rule",
        action="append",
        dest="rules",
        metavar="RULE-ID",
        help="run only these rule ids (repeatable)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule registry and exit"
    )
    parser.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print findings silenced by pio-lint comments",
    )
    parser.add_argument(
        "--changed",
        action="store_true",
        help="report findings only for files changed vs git HEAD "
        "(+ untracked); the call graph is still built whole-program, so "
        "reachability stays correct",
    )
    parser.add_argument(
        "--report-suppressions",
        action="store_true",
        help="print the suppression inventory (every # pio-lint: disable "
        "site, used or STALE, with its reason) instead of findings",
    )


def _git_changed_files() -> list[str] | None:
    """Absolute paths of .py files changed vs HEAD plus untracked ones,
    or None when git itself fails (not a repo, no git binary)."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD", "--"],
            capture_output=True,
            text=True,
            check=True,
            cwd=top,
        ).stdout
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True,
            text=True,
            check=True,
            cwd=top,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    out: list[str] = []
    for rel in (diff + untracked).splitlines():
        rel = rel.strip()
        if rel.endswith(".py"):
            out.append(os.path.join(top, rel))
    return out


_SARIF_LEVEL = {"ERROR": "error", "WARNING": "warning"}


def to_sarif(report) -> dict:
    """SARIF 2.1.0 — one run, the full rule registry as tool metadata,
    one result per active finding."""
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "pio-lint",
                        "informationUri": (
                            "docs/static_analysis.md"
                        ),
                        "rules": [
                            {
                                "id": m.id,
                                "shortDescription": {"text": m.summary},
                                "defaultConfiguration": {
                                    "level": _SARIF_LEVEL.get(
                                        m.severity.name, "note"
                                    )
                                },
                                "properties": {"family": m.family},
                            }
                            for m in all_rules()
                        ],
                    }
                },
                "results": [
                    {
                        "ruleId": f.rule,
                        "level": _SARIF_LEVEL.get(f.severity.name, "note"),
                        "message": {"text": f.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {
                                        "uri": f.path.replace(os.sep, "/")
                                    },
                                    "region": {
                                        "startLine": f.line,
                                        "startColumn": f.col + 1,
                                    },
                                }
                            }
                        ],
                    }
                    for f in report.findings
                ],
            }
        ],
    }


def run_lint(args) -> int:
    if args.list_rules:
        for meta in all_rules():
            print(
                f"{meta.id:<28} {meta.severity.name.lower():<8} "
                f"[{meta.family}] {meta.summary}"
            )
        return 0
    paths = args.paths or default_lint_paths()
    for p in paths:
        if not os.path.exists(p):
            print(f"[ERROR] no such path: {p}", file=sys.stderr)
            return 2
    if args.rules:
        known = {m.id for m in all_rules()}
        unknown = sorted(set(args.rules) - known)
        if unknown:
            # a typo'd --rule must not neuter the gate while looking green
            print(
                f"[ERROR] unknown rule id(s): {', '.join(unknown)} "
                f"(see --list-rules)",
                file=sys.stderr,
            )
            return 2
    report_paths = None
    if args.changed:
        changed = _git_changed_files()
        if changed is None:
            print(
                "[ERROR] --changed needs a git checkout (git diff failed)",
                file=sys.stderr,
            )
            return 2
        if not changed:
            print("no changed python files vs HEAD")
            return 0
        report_paths = changed
    config = LintConfig(
        enabled=frozenset(args.rules) if args.rules else None,
    )
    report = analyze_paths(paths, config=config, report_paths=report_paths)
    if args.report_suppressions:
        for site in report.suppression_sites:
            print(site.format())
        n = len(report.suppression_sites)
        stale = sum(1 for s in report.suppression_sites if not s.used)
        print(f"{n} suppression site(s), {stale} stale")
        return 0
    if args.output_format == "json":
        print(
            json.dumps(
                {
                    "findings": [f.to_json_dict() for f in report.findings],
                    "suppressed": [f.to_json_dict() for f in report.suppressed],
                    "files_scanned": report.files_scanned,
                    "duration_s": round(report.duration_s, 3),
                },
                indent=2,
            )
        )
    elif args.output_format == "sarif":
        print(json.dumps(to_sarif(report), indent=2))
    else:
        for f in report.findings:
            print(f.format())
        if args.show_suppressed:
            for f in report.suppressed:
                print(f"{f.format()}  (suppressed)")
        print(report.summary())
    failed = bool(report.errors) or (args.strict and report.warnings)
    return 1 if failed else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="lint",
        description="static analyzer for predictionio_tpu_torch code "
        "(staging safety, recompile hazards, host-sync stalls, reachability-"
        "scoped serving/train rules, mesh/sharding agreement, async-blocking "
        "calls, concurrency, storage contracts)",
    )
    add_lint_arguments(parser)
    return run_lint(parser.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
