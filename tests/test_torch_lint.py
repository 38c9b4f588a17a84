"""The port's `pio lint` (``predictionio_tpu_torch/analysis``) held to the
JAX package's analyzer.

- The registry: the same rule ids, families and severities, through the
  API and through ``--list-rules``.
- The engine and the framework-neutral rules (async, concurrency, fleet,
  obs, storage, stream, ``eval-per-query-predict``): every case of
  ``tests/test_lint.py`` for them runs with its analyzer calls sent to
  both packages, which must give equal (rule, path, line, col, severity)
  lists, equal suppressed lists and equal suppression inventories (the
  case's own assertions then run on the JAX answer); plus the transitive
  async case, ``--changed`` in a temp git repository and the SARIF shape;
  and with ``enabled`` set to those rules both analyzers over
  ``predictionio_tpu/`` and over ``predictionio_tpu_torch/`` agree.
- The torch-specific rules (tracer, recompile, hostsync, train, mesh): each
  positive and negative case of ``tests/test_lint.py`` translated to
  PyTorch line for line; the JAX analyzer on the JAX snippet and the port
  on the torch snippet give the same rule ids at the same lines.
- Self-lint: the port is clean under its own rules, with no stale
  suppression, in a clean process that loads no torch, numpy, jax or
  JAX-package module.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

import predictionio_tpu.analysis as jax_lint
import predictionio_tpu_torch.analysis as port_lint
import tests.test_lint as ref
from predictionio_tpu.analysis.cli import main as jax_lint_main
from predictionio_tpu_torch.analysis.cli import default_lint_paths, main as port_lint_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO_ROOT, "predictionio_tpu")
PORT_PKG = os.path.join(REPO_ROOT, "predictionio_tpu_torch")

NEUTRAL_RULES = frozenset({
    "async-blocking-call",
    "concurrency-unlocked-global",
    "fleet-unattributed-proxy",
    "obs-unstructured-log",
    "obs-label-cardinality",
    "storage-missing-method",
    "storage-raw-pickle",
    "stream-unbounded-drain",
    "eval-per-query-predict",
})


def keys(findings):
    return [(f.rule, f.path, f.line, f.col, f.severity.name) for f in findings]


def sites(report):
    return [(s.path, s.line, s.rules, s.reason, s.file_level, s.targets, s.used)
            for s in report.suppression_sites]


def port_config(config):
    """The JAX LintConfig a case built, as the port's."""
    if config is None:
        return None
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    fields["entry_points"] = tuple(port_lint.EntryPoint(**dataclasses.asdict(ep))
                                   for ep in config.entry_points)
    return port_lint.LintConfig(**fields)


def _rule_lines(findings):
    return sorted((f.rule, f.line) for f in findings)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _list_rules(main, capsys):
    assert main(["--list-rules"]) == 0
    out = []
    for line in capsys.readouterr().out.splitlines():
        rule, severity, family = line.split()[:3]
        out.append((rule, severity, family))
    return sorted(out)


@pytest.mark.parametrize("surface", ["api", "list_rules"])
def test_the_registry_is_the_jax_analyzers(surface, capsys):
    if surface == "api":
        jax_rules = [(m.id, m.family, m.severity.name) for m in jax_lint.all_rules()]
        port_rules = [(m.id, m.family, m.severity.name) for m in port_lint.all_rules()]
    else:
        jax_rules, port_rules = _list_rules(jax_lint_main, capsys), _list_rules(port_lint_main, capsys)
    assert port_rules == jax_rules
    assert len(port_rules) == 23


# ---------------------------------------------------------------------------
# the engine and the framework-neutral rules: the reference's own cases,
# each analyzer call sent to both packages
# ---------------------------------------------------------------------------


def _both_source(source, display_path, config=None, **kw):
    active, suppressed = jax_lint.analyze_source(source, display_path, config=config, **kw)
    p_active, p_suppressed = port_lint.analyze_source(source, display_path, config=port_config(config), **kw)
    assert keys(p_active) == keys(active)
    assert keys(p_suppressed) == keys(suppressed)
    return active, suppressed


def _both_paths(paths, config=None, report_paths=None):
    paths = list(paths)
    report = jax_lint.analyze_paths(paths, config=config, report_paths=report_paths)
    port = port_lint.analyze_paths(paths, config=port_config(config), report_paths=report_paths)
    assert keys(port.findings) == keys(report.findings)
    assert keys(port.suppressed) == keys(report.suppressed)
    assert sites(port) == sites(report)
    assert port.files_scanned == report.files_scanned
    return report


NEUTRAL_CLASSES = (
    ref.TestConcurrencyRules,
    ref.TestStorageContractRule,
    ref.TestStorageRawPickle,
    ref.TestStreamRules,
    ref.TestEvalPerQueryPredictRule,
    ref.TestObsRules,
    ref.TestObsLabelCardinality,
    ref.TestFleetUnattributedProxy,
    ref.TestAsyncBlockingRule,
)
# reference cases outside those classes whose snippets hold no JAX code
# (a one-argument np.asarray is a host sync to both analyzers)
NEUTRAL_EXTRA = (
    (ref.TestEngine, "test_parse_error_reported_not_raised"),
    (ref.TestSuppressionEdgeCases, "test_disable_file_with_multiple_rule_ids"),
    (ref.TestSuppressionEdgeCases, "test_stale_suppression_warns"),
    (ref.TestSuppressionEdgeCases, "test_used_suppression_not_stale"),
    (ref.TestSuppressionEdgeCases, "test_blanket_suppression_never_stale_checked"),
    (ref.TestSuppressionEdgeCases, "test_docstring_mention_is_not_a_suppression_site"),
    (ref.TestSuppressionEdgeCases, "test_stale_detection_skipped_under_rule_filter"),
    (ref.TestSuppressionEdgeCases, "test_stale_warning_is_itself_suppressible"),
)
NEUTRAL_CASES = [
    (cls, name) for cls in NEUTRAL_CLASSES for name in sorted(vars(cls)) if name.startswith("test_")
] + list(NEUTRAL_EXTRA)


@pytest.mark.parametrize("cls,name", NEUTRAL_CASES, ids=[f"{c.__name__}.{n}" for c, n in NEUTRAL_CASES])
def test_reference_case_gives_equal_findings_in_both(cls, name, monkeypatch, tmp_path):
    monkeypatch.setattr(ref, "analyze_source", _both_source)
    monkeypatch.setattr(ref, "analyze_paths", _both_paths)
    method = getattr(cls(), name)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    method(**{p: fixtures[p] for p in inspect.signature(method).parameters})


def _write_tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


# the transitive async case (registry I/O three calls below an async
# handler, reported at the handler's call site), with a suppression, a stale
# one and a file that does not parse beside it
NEUTRAL_TREE = {
    "pkg/fleet/manager.py": """
        from pkg.registry.store import publish

        async def run(self):
            publish("fleet.json")

        async def tick(self):
            # pio-lint: disable=async-blocking-call -- startup-only settle, loop not serving yet
            publish("tick.json")

        async def idle(self):
            return 1  # pio-lint: disable=async-blocking-call -- left over from a refactor
        """,
    "pkg/registry/store.py": """
        from pkg.registry.files import save_state

        def publish(name):
            return save_state(name)
        """,
    "pkg/registry/files.py": """
        import fcntl

        def save_state(name):
            with open(name, "wb") as fh:
                fcntl.flock(fh, 2)
                fh.write(b"{}")
        """,
    "pkg/data/api/handler.py": """
        def handle(request):
            print("got", request)
        """,
    "pkg/broken.py": "def broken(:\n",
}


def test_transitive_async_suppressions_stale_and_parse_error_in_both(tmp_path):
    report = _both_paths([_write_tree(tmp_path, NEUTRAL_TREE)])
    assert sorted((f.rule, os.path.basename(f.path), f.line) for f in report.findings) == [
        ("async-blocking-call", "manager.py", 5),
        ("obs-unstructured-log", "handler.py", 3),
        ("parse-error", "broken.py", 1),
        ("suppression-stale", "manager.py", 12),
    ]
    assert keys(report.suppressed)[0][:3] == ("async-blocking-call", report.suppressed[0].path, 9)
    assert [(s.line, s.used) for s in report.suppression_sites] == [(8, True), (12, False)]


def _git(root, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args], cwd=root, check=True,
                   capture_output=True)


def _cli_json(main, args, capsys):
    rc = main(args)
    out = capsys.readouterr().out
    return rc, json.loads(out) if out.lstrip().startswith("{") else out


def test_changed_reports_the_same_files_in_both(tmp_path, capsys, monkeypatch):
    """--changed in a temp git repository: the graph is whole-program in
    both, and only the modified file's finding is reported."""
    root = _write_tree(tmp_path, {
        "pkg/fleet/manager.py": NEUTRAL_TREE["pkg/fleet/manager.py"],
        "pkg/registry/store.py": NEUTRAL_TREE["pkg/registry/store.py"],
        "pkg/registry/files.py": NEUTRAL_TREE["pkg/registry/files.py"],
        "pkg/data/api/handler.py": "def handle(request):\n    return request\n",
    })
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "seed")
    (tmp_path / "pkg/data/api/handler.py").write_text("def handle(request):\n    print(request)\n")
    monkeypatch.chdir(tmp_path)
    outs = [_cli_json(main, [root, "--changed", "--format", "json"], capsys)
            for main in (jax_lint_main, port_lint_main)]
    for rc, doc in outs:
        assert rc == 0
        assert [(f["rule"], f["path"], f["line"]) for f in doc["findings"]] == [
            ("obs-unstructured-log", os.path.join("pkg", "data", "api", "handler.py"), 2)]
    assert outs[0][1]["findings"] == outs[1][1]["findings"]
    assert outs[0][1]["files_scanned"] == outs[1][1]["files_scanned"]


def _strip_sarif(doc):
    run = doc["runs"][0]
    driver = run["tool"]["driver"]
    return {
        "$schema": doc["$schema"], "version": doc["version"], "name": driver["name"],
        "rules": sorted((r["id"], r["defaultConfiguration"]["level"], r["properties"]["family"])
                        for r in driver["rules"]),
        "results": [(r["ruleId"], r["level"], r["locations"][0]["physicalLocation"]) for r in run["results"]],
    }


def test_sarif_shape_is_the_jax_analyzers(tmp_path, capsys):
    root = _write_tree(tmp_path, NEUTRAL_TREE)
    docs = []
    for main in (jax_lint_main, port_lint_main):
        assert main(["--format", "sarif", root]) == 1
        docs.append(json.loads(capsys.readouterr().out))
    assert _strip_sarif(docs[1]) == _strip_sarif(docs[0])
    assert docs[1]["version"] == "2.1.0" and len(docs[1]["runs"][0]["results"]) == 4


# both analyzers over both package trees, one run each, shared by the cases
@pytest.fixture(scope="module")
def neutral_tree_reports():
    out = {}
    for tree in (JAX_PKG, PORT_PKG):
        out[tree] = (
            jax_lint.analyze_paths([tree], config=jax_lint.LintConfig(enabled=NEUTRAL_RULES)),
            port_lint.analyze_paths([tree], config=port_lint.LintConfig(enabled=NEUTRAL_RULES)),
        )
    return out


@pytest.mark.parametrize("tree", [JAX_PKG, PORT_PKG], ids=["predictionio_tpu", "predictionio_tpu_torch"])
def test_neutral_rules_give_equal_findings_over_a_whole_package(tree, neutral_tree_reports):
    jax_report, port_report = neutral_tree_reports[tree]
    assert keys(port_report.findings) == keys(jax_report.findings)
    assert keys(port_report.suppressed) == keys(jax_report.suppressed)
    assert port_report.files_scanned == jax_report.files_scanned > 150
    assert {f.rule for f in jax_report.findings + jax_report.suppressed} <= NEUTRAL_RULES


# ---------------------------------------------------------------------------
# the torch-specific rules: the reference's cases translated line for line
# ---------------------------------------------------------------------------

# (id, display path, the reference's JAX snippet, its PyTorch translation)
SNIPPET_PAIRS = [
    # tracer
    ("tracer_branch_on_param_fires", "snippet.py", """
        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
        """, """
        import torch

        @torch.compile
        def f(x):
            if x > 0:
                return x
            return -x
        """),
    ("tracer_branch_on_static_quiet", "snippet.py", """
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("mode",))
        def f(x, mode):
            if mode == "relu":
                return x * (x > 0)
            return x
        """, """
        import functools
        import torch

        @torch.compile
        def f(x, mode: str):
            if mode == "relu":
                return x * (x > 0)
            return x
        """),
    ("tracer_while_on_alias_fires", "snippet.py", """
        import jax

        @jax.jit
        def f(x):
            y = x * 2
            while y.sum() > 0:
                y = y - 1
            return y
        """, """
        import torch

        @torch.compile(mode="reduce-overhead")
        def f(x):
            y = x * 2
            while y.sum() > 0:
                y = y - 1
            return y
        """),
    ("tracer_shape_branch_and_none_check_quiet", "snippet.py", """
        import jax

        @jax.jit
        def f(x, bias=None):
            if x.shape[0] > 128:
                x = x[:128]
            if bias is not None:
                x = x + bias
            assert x.ndim == 2
            return x
        """, """
        import torch

        @torch.compile
        def f(x, bias=None):
            if x.size(0) > 128:
                x = x[:128]
            if bias is not None:
                x = x + bias
            assert x.dim() == 2
            return x
        """),
    ("tracer_host_cast_fires", "snippet.py", """
        import jax

        @jax.jit
        def f(x):
            return float(x) + x.sum().item()
        """, """
        import torch

        @torch.compile
        def f(x):
            return float(x) + x.sum().item()
        """),
    ("tracer_host_cast_of_static_quiet", "snippet.py", """
        import functools
        import jax

        @functools.partial(jax.jit, static_argnums=(1,))
        def f(x, n):
            return x * int(n)
        """, """
        import functools
        import torch

        @functools.partial(torch.compile, dynamic=False)
        def f(x, n: int):
            return x * int(n)
        """),
    # recompile
    ("recompile_literal_arg_not_static_fires", "snippet.py", """
        import jax

        @jax.jit
        def f(x, flag):
            return x

        def caller(v):
            return f(v, True)
        """, """
        import torch

        @torch.compile
        def f(x, flag):
            return x

        def caller(v):
            return f(v, True)
        """),
    ("recompile_literal_arg_declared_static_quiet", "snippet.py", """
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("flag",))
        def f(x, flag):
            return x

        def caller(v):
            return f(v, flag=True)
        """, """
        import functools
        import torch

        @torch.compile
        def f(x, flag: bool):
            return x

        def caller(v):
            return f(v, flag=True)
        """),
    ("recompile_static_covers_positional_call_quiet", "snippet.py", """
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("flag",))
        def f(x, flag):
            return x

        def caller(v):
            return f(v, True)
        """, """
        import functools
        import torch

        @torch.compile
        def f(x, flag: bool):
            return x

        def caller(v):
            return f(v, True)
        """),
    ("recompile_jit_in_loop_fires", "snippet.py", """
        import jax

        def serve(requests, fn):
            for r in requests:
                jitted = jax.jit(fn)
                yield jitted(r)
        """, """
        import torch

        def serve(requests, fn):
            for r in requests:
                jitted = torch.compile(fn)
                yield jitted(r)
        """),
    ("recompile_jit_hoisted_quiet", "snippet.py", """
        import jax

        def serve(requests, fn):
            jitted = jax.jit(fn)
            for r in requests:
                yield jitted(r)
        """, """
        import torch

        def serve(requests, fn):
            jitted = torch.compile(fn)
            for r in requests:
                yield jitted(r)
        """),
    ("recompile_closure_over_mutable_fires", "snippet.py", """
        import jax

        def make(cfg_items):
            cfg = {}
            cfg.update(cfg_items)

            @jax.jit
            def predict(x):
                return x * cfg["scale"]

            return predict
        """, """
        import torch

        def make(cfg_items):
            cfg = {}
            cfg.update(cfg_items)

            @torch.compile
            def predict(x):
                return x * cfg["scale"]

            return predict
        """),
    ("recompile_closure_over_immutable_quiet", "snippet.py", """
        import jax

        def make(scale):
            @jax.jit
            def predict(x):
                return x * scale

            return predict
        """, """
        import torch

        def make(scale):
            @torch.compile
            def predict(x):
                return x * scale

            return predict
        """),
    # hostsync
    ("hostsync_sync_in_serving_module_fires", "predictionio_tpu/data/api/handlers.py", """
        import numpy as np

        def handle(pred):
            return np.asarray(pred).tolist()
        """, """
        import torch

        def handle(pred):
            return pred.tolist()
        """),
    ("hostsync_same_code_off_serving_path_quiet", "predictionio_tpu/ops/score.py", """
        import numpy as np

        def handle(pred):
            return np.asarray(pred).tolist()
        """, """
        import torch

        def handle(pred):
            return pred.tolist()
        """),
    ("hostsync_block_until_ready_fires", "predictionio_tpu/controller/serving.py", """
        import jax

        def handle(pred):
            jax.block_until_ready(pred)
            return pred
        """, """
        import torch

        def handle(pred):
            torch.cuda.synchronize()
            return pred
        """),
    # train
    ("train_bare_syncs_fire", "pkg/ops/als.py", """
        import jax
        import numpy as np

        def train_loop(dev_arrays, x):
            jax.block_until_ready(x)
            host = np.asarray(x)
            scalar = x.item()
            return host, scalar
        """, """
        import torch
        import numpy as np

        def train_loop(dev_arrays, x):
            torch.cuda.synchronize()
            host = x.cpu()
            scalar = x.item()
            return host, scalar
        """),
    ("train_two_arg_asarray_quiet", "pkg/ops/als.py", """
        import numpy as np

        def prep(ratings):
            return np.asarray(ratings, np.float32)
        """, """
        import torch

        def prep(ratings):
            return torch.as_tensor(ratings, dtype=torch.float32)
        """),
    ("train_sanctioned_forms_quiet", "pkg/stream/trainers.py", """
        from predictionio_tpu.obs import xray
        from predictionio_tpu.obs.jaxprof import timed_block_until_ready

        def train_loop(x, registry):
            timed_block_until_ready(x, registry, where="sweep")
            return xray.device_fetch(x, where="sweep")
        """, """
        from predictionio_tpu_torch.obs import xray
        from predictionio_tpu_torch.obs.torchprof import timed_fetch

        def train_loop(x, registry):
            timed_fetch(x, registry, where="sweep")
            return xray.device_fetch(x, where="sweep")
        """),
    ("train_same_code_off_train_path_quiet", "pkg/eval/fast_eval.py", """
        import jax

        def bench(x):
            jax.block_until_ready(x)
        """, """
        import torch

        def bench(x):
            torch.cuda.synchronize()
        """),
    ("train_suppression_with_reason_works", "pkg/ops/als.py", """
        import numpy as np

        def barrier(checksum):
            # pio-lint: disable=train-unaccounted-sync -- this IS the instrument
            return float(np.asarray(checksum))
        """, """
        import torch

        def barrier(checksum):
            # pio-lint: disable=train-unaccounted-sync -- this IS the instrument
            return float(checksum.item())
        """),
    # serving-host-roundtrip
    ("roundtrip_host_argsort_and_full_fetch_fire", "pkg/models/foo/engine.py", """
        import numpy as np

        def predict(model, query):
            scores = np.asarray(model.device_scores)
            idx = np.argsort(-scores)
            return idx[: query.num]
        """, """
        import numpy as np

        def predict(model, query):
            scores = model.device_scores.cpu()
            idx = np.argsort(-scores)
            return idx[: query.num]
        """),
    ("roundtrip_nested_finalize_covered", "pkg/models/foo/engine.py", """
        import numpy as np

        def predict_batch_dispatch(model, queries):
            handle = model.dispatch(queries)

            def finalize():
                return np.argpartition(-np.asarray(handle), 10)

            return finalize
        """, """
        import numpy as np

        def predict_batch_dispatch(model, queries):
            handle = model.dispatch(queries)

            def finalize():
                return np.argpartition(-handle.cpu(), 10)

            return finalize
        """),
    ("roundtrip_fused_helper_and_host_topk_quiet", "pkg/models/foo/engine.py", """
        import numpy as np
        from predictionio_tpu.ops import topk

        def predict_batch_dispatch(model, queries):
            handle = topk.dot_top_k_async(
                model.table, model.vecs, None, 10
            )

            def finalize():
                scores, idx = topk.fetch_topk(handle)
                sk, si = topk.host_top_k(model.counts, None, 10)
                return scores, idx, sk, si

            return finalize
        """, """
        import numpy as np
        from predictionio_tpu_torch.ops import topk

        def predict_batch_dispatch(model, queries):
            handle = topk.dot_top_k_async(
                model.table, model.vecs, None, 10
            )

            def finalize():
                scores, idx = topk.fetch_topk(handle)
                sk, si = topk.host_top_k(model.counts, None, 10)
                return scores, idx, sk, si

            return finalize
        """),
    ("roundtrip_two_arg_asarray_host_idiom_quiet", "pkg/models/foo/engine.py", """
        import numpy as np

        def predict(model, query):
            vec = np.asarray(query.features, np.float32)
            return model.score(vec)
        """, """
        import torch

        def predict(model, query):
            vec = torch.tensor(query.features, dtype=torch.float32)
            return model.score(vec)
        """),
    ("roundtrip_training_code_in_engine_module_quiet", "pkg/models/foo/engine.py", """
        import numpy as np

        def train(ctx, data):
            return np.asarray(data.factors)
        """, """
        import torch

        def train(ctx, data):
            return data.factors.cpu()
        """),
    ("roundtrip_same_code_outside_engine_globs_quiet", "pkg/eval/fast_eval.py", """
        import numpy as np

        def predict(model, query):
            return np.argsort(-np.asarray(model.scores))
        """, """
        import numpy as np

        def predict(model, query):
            return np.argsort(-model.scores.cpu())
        """),
    ("roundtrip_offline_dispatch_path_covered", "pkg/workflow/batch_predict.py", """
        import numpy as np

        def run_pipeline(engine, components, models, source, sinks):
            def drain(pending):
                scores = np.asarray(pending.handle)
                return np.argsort(-scores)

            return drain
        """, """
        import numpy as np

        def run_pipeline(engine, components, models, source, sinks):
            def drain(pending):
                scores = pending.handle.cpu()
                return np.argsort(-scores)

            return drain
        """),
    ("roundtrip_engine_dispatch_batch_covered", "pkg/controller/engine.py", """
        import numpy as np

        def dispatch_batch(self, algorithms, serving, models, queries):
            def finalize():
                return np.argpartition(-np.asarray(models[0].scores), 10)

            return finalize
        """, """
        import numpy as np

        def dispatch_batch(self, algorithms, serving, models, queries):
            def finalize():
                return np.argpartition(-models[0].scores.cpu(), 10)

            return finalize
        """),
    ("roundtrip_tuning_scoring_path_covered", "pkg/tuning/cells.py", """
        import numpy as np

        def dispatch_scores(engine, algos, serving, models, queries):
            scores = np.asarray(models[0].device_scores)
            return np.argsort(-scores)
        """, """
        import numpy as np

        def dispatch_scores(engine, algos, serving, models, queries):
            scores = models[0].device_scores.cpu()
            return np.argsort(-scores)
        """),
    # mesh
    ("mesh_no_declarations_anywhere_silent", "predictionio_tpu/parallel/kernel.py", """
        from jax.sharding import PartitionSpec as P

        def spec():
            return P("whatever")
        """, """
        from predictionio_tpu_torch.parallel.mesh import ShardSpec

        def spec():
            return ShardSpec("whatever", 0, (8,), 0)
        """),
    ("mesh_collective_axis_mismatch_fires", "predictionio_tpu/parallel/kernel.py", """
        from jax import lax
        from jax.sharding import Mesh

        def build(devs):
            return Mesh(devs, ("data",))

        def reduce_shard(x):
            return lax.psum(x, "model")
        """, """
        from predictionio_tpu_torch.parallel import collectives
        from predictionio_tpu_torch.parallel.mesh import MeshSpec

        def build(devs):
            return MeshSpec((("data", -1),))

        def reduce_shard(x, mesh):
            return collectives.all_reduce(x, mesh, "model")
        """),
    ("mesh_collective_declared_and_variable_axis_quiet", "predictionio_tpu/parallel/kernel.py", """
        from jax import lax
        from jax.sharding import Mesh

        def build(devs):
            return Mesh(devs, ("data",))

        def reduce_shard(x, axis_var):
            a = lax.psum(x, "data")
            return lax.psum(a, axis_var)
        """, """
        from predictionio_tpu_torch.parallel import collectives
        from predictionio_tpu_torch.parallel.mesh import MeshSpec

        def build(devs):
            return MeshSpec((("data", -1),))

        def reduce_shard(x, mesh, axis_var):
            a = collectives.all_reduce(x, mesh, "data")
            return collectives.all_reduce(a, mesh, axis=axis_var)
        """),
    ("mesh_spec_string_declaration_counts", "predictionio_tpu/parallel/kernel.py", """
        from jax import lax

        def build():
            return make_mesh("data=8,model=2")

        def reduce_shard(x):
            return lax.pmean(x, "model")
        """, """
        from predictionio_tpu_torch.parallel import collectives

        def build():
            return make_mesh("data=8,model=2")

        def reduce_shard(x, mesh):
            return collectives.all_gather(x, mesh, "model")
        """),
    ("mesh_host_materialize_of_sharded_value_fires", "predictionio_tpu/parallel/ingest.py", """
        import numpy as np
        from jax.experimental.shard_map import shard_map

        def step(mesh, x, f):
            y = shard_map(f, mesh=mesh)(x)
            return np.asarray(y)
        """, """
        import numpy as np
        from predictionio_tpu_torch.parallel.collectives import reduce_scatter

        def step(mesh, x, f):
            y = reduce_scatter(f(x), mesh, "data")
            return np.asarray(y)
        """),
    ("mesh_two_arg_asarray_and_untainted_value_quiet", "predictionio_tpu/parallel/ingest.py", """
        import numpy as np
        from jax.experimental.shard_map import shard_map

        def step(mesh, x, f, host_rows):
            y = shard_map(f, mesh=mesh)(x)
            a = np.asarray(y, np.float32)
            b = np.asarray(host_rows)
            return a, b, y
        """, """
        import numpy as np
        from predictionio_tpu_torch.parallel.collectives import reduce_scatter

        def step(mesh, x, f, host_rows):
            y = reduce_scatter(f(x), mesh, "data")
            a = np.asarray(y, np.float32)
            b = np.asarray(host_rows)
            return a, b, y
        """),
    ("mesh_materialize_outside_sharded_modules_quiet", "predictionio_tpu/tools/notebook_helpers.py", """
        import numpy as np
        from jax.experimental.shard_map import shard_map

        def step(mesh, x, f):
            y = shard_map(f, mesh=mesh)(x)
            return np.asarray(y)
        """, """
        import numpy as np
        from predictionio_tpu_torch.parallel.collectives import reduce_scatter

        def step(mesh, x, f):
            y = reduce_scatter(f(x), mesh, "data")
            return np.asarray(y)
        """),
    ("mesh_topk_without_merge_fires", "predictionio_tpu/ops/score_sharded.py", """
        from jax import lax

        def local_winners(scores, k):
            return lax.top_k(scores, k)
        """, """
        import torch

        def local_winners(scores, k):
            return torch.topk(scores, k)
        """),
    ("mesh_topk_routed_through_pack_format_quiet", "predictionio_tpu/ops/score_sharded.py", """
        from jax import lax
        from predictionio_tpu.ops.topk import pack_batch

        def global_winners(scores, k):
            s, i = lax.top_k(scores, k)
            return pack_batch(s, i)
        """, """
        import torch
        from predictionio_tpu_torch.ops.topk import pack_batch

        def global_winners(scores, k):
            s, i = torch.topk(scores, k)
            return pack_batch(s, i)
        """),
    # the engine's suppression mechanics on a staging finding
    ("suppression_inline", "snippet.py", """
        import jax

        @jax.jit
        def f(x):
            if x > 0:  # pio-lint: disable=tracer-python-branch -- fixture
                return x
            return -x
        """, """
        import torch

        @torch.compile
        def f(x):
            if x > 0:  # pio-lint: disable=tracer-python-branch -- fixture
                return x
            return -x
        """),
    ("suppression_comment_on_previous_line", "snippet.py", """
        import jax

        @jax.jit
        def f(x):
            # pio-lint: disable=tracer-python-branch -- fixture
            if x > 0:
                return x
            return -x
        """, """
        import torch

        @torch.compile
        def f(x):
            # pio-lint: disable=tracer-python-branch -- fixture
            if x > 0:
                return x
            return -x
        """),
    ("suppression_file_level", "snippet.py", """
        # pio-lint: disable-file=tracer-python-branch
        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
        """, """
        # pio-lint: disable-file=tracer-python-branch
        import torch

        @torch.compile
        def f(x):
            if x > 0:
                return x
            return -x
        """),
    ("suppression_wrong_rule_id_is_stale", "snippet.py", """
        import jax

        @jax.jit
        def f(x):
            if x > 0:  # pio-lint: disable=tracer-host-cast
                return x
            return -x
        """, """
        import torch

        @torch.compile
        def f(x):
            if x > 0:  # pio-lint: disable=tracer-host-cast
                return x
            return -x
        """),
    ("suppression_standalone_comment_above_decorated_def", "snippet.py", """
        import jax

        def compile_variants(configs):
            out = []
            for cfg in configs:
                # pio-lint: disable=recompile-jit-in-loop -- one compile per config is the point here
                @jax.jit
                def step(x):
                    return x

                out.append(step)
            return out
        """, """
        import torch

        def compile_variants(configs):
            out = []
            for cfg in configs:
                # pio-lint: disable=recompile-jit-in-loop -- one compile per config is the point here
                @torch.compile
                def step(x):
                    return x

                out.append(step)
            return out
        """),
]


def _pair_params(pairs):
    return [pytest.param(*p[1:], id=p[0]) for p in pairs]


@pytest.mark.parametrize("display_path,jax_src,torch_src", _pair_params(SNIPPET_PAIRS))
def test_translated_case_fires_the_same_rules_at_the_same_lines(display_path, jax_src, torch_src):
    jax_active, jax_suppressed = jax_lint.analyze_source(textwrap.dedent(jax_src), display_path)
    port_active, port_suppressed = port_lint.analyze_source(
        textwrap.dedent(torch_src), display_path.replace("predictionio_tpu/", "predictionio_tpu_torch/"))
    assert _rule_lines(port_active) == _rule_lines(jax_active)
    assert _rule_lines(port_suppressed) == _rule_lines(jax_suppressed)


def test_enabled_filter_keeps_only_the_named_rule():
    config = {"jax": jax_lint.LintConfig(enabled=frozenset({"tracer-python-branch"})),
              "port": port_lint.LintConfig(enabled=frozenset({"tracer-python-branch"}))}
    body = "@{}\ndef f(x):\n    if x > 0:\n        return float(x)\n    return -x\n"
    jax_active, _ = jax_lint.analyze_source("import jax\n" + body.format("jax.jit"), "s.py", config["jax"])
    port_active, _ = port_lint.analyze_source("import torch\n" + body.format("torch.compile"), "s.py",
                                              config["port"])
    assert _rule_lines(port_active) == _rule_lines(jax_active) == [("tracer-python-branch", 4)]


# (id, {relpath: JAX source}, {relpath: torch source}, rule the case counts)
DEEP_JAX = """
    import numpy as np

    def fetch(pred):
        return np.asarray(pred).tolist()
    """
DEEP_TORCH = """
    import torch

    def fetch(pred):
        return pred.tolist()
    """
MESH_DECL_JAX = """
    from jax.sharding import Mesh

    def build(devs):
        return Mesh(devs, ("data", "model"))
    """
MESH_DECL_TORCH = """
    from predictionio_tpu_torch.parallel.mesh import MeshSpec

    def build(devs):
        return MeshSpec((("data", -1), ("model", 2)))
    """
TREE_PAIRS = [
    ("callgraph_two_calls_below_entry", {
        "pkg/data/api/handlers.py": """
            from pkg.util.mid import respond

            async def handle(req):
                return respond(req)
            """,
        "pkg/util/mid.py": """
            from pkg.util.deep import fetch

            def respond(req):
                return fetch(req)
            """,
        "pkg/util/deep.py": DEEP_JAX,
    }, {"pkg/util/deep.py": DEEP_TORCH}),
    ("callgraph_method_dispatch", {
        "pkg/data/api/handlers.py": """
            from pkg.core.engine import Engine

            async def handle(req):
                eng = Engine()
                return eng.respond(req)
            """,
        "pkg/core/engine.py": """
            import numpy as np

            class Engine:
                def respond(self, req):
                    return self._finish(req)

                def _finish(self, req):
                    return np.asarray(req)
            """,
    }, {"pkg/core/engine.py": """
            import torch

            class Engine:
                def respond(self, req):
                    return self._finish(req)

                def _finish(self, req):
                    return req.cpu()
            """}),
    ("callgraph_cycle_terminates", {
        "pkg/data/api/handlers.py": """
            from pkg.util.a import f

            async def handle(req):
                return f(req, 3)
            """,
        "pkg/util/a.py": """
            from pkg.util.b import g

            def f(x, depth):
                return g(x, depth)
            """,
        "pkg/util/b.py": """
            import numpy as np
            from pkg.util.a import f

            def g(x, depth):
                if depth:
                    return f(x, depth - 1)
                return np.asarray(x)
            """,
    }, {"pkg/util/b.py": """
            import torch
            from pkg.util.a import f

            def g(x, depth):
                if depth:
                    return f(x, depth - 1)
                return x.cpu()
            """}),
    ("callgraph_unreachable_helper_quiet", {
        "pkg/data/api/handlers.py": """
            async def handle(req):
                return req
            """,
        "pkg/util/deep.py": DEEP_JAX,
    }, {"pkg/util/deep.py": DEEP_TORCH}),
    ("mesh_unknown_axis_fires", {
        "pkg/parallel/mesh.py": MESH_DECL_JAX,
        "pkg/parallel/kernel.py": """
            from jax.sharding import PartitionSpec as P

            def spec():
                return P("data", "expert")
            """,
    }, {"pkg/parallel/mesh.py": MESH_DECL_TORCH, "pkg/parallel/kernel.py": """
            from predictionio_tpu_torch.parallel.mesh import ShardSpec

            def spec():
                return ShardSpec(axis="expert", dim=0, global_shape=(8, 4), start=0)
            """}),
    ("mesh_declared_axis_cross_module_quiet", {
        "pkg/parallel/mesh.py": MESH_DECL_JAX,
        "pkg/parallel/kernel.py": """
            from jax.sharding import PartitionSpec as P

            def spec():
                return P("data", "model")
            """,
    }, {"pkg/parallel/mesh.py": MESH_DECL_TORCH, "pkg/parallel/kernel.py": """
            from predictionio_tpu_torch.parallel.mesh import ShardSpec

            def spec():
                return ShardSpec(axis="model", dim=0, global_shape=(8, 4), start=0)
            """}),
]


@pytest.mark.parametrize("jax_files,torch_files", [pytest.param(j, t, id=i) for i, j, t in TREE_PAIRS])
def test_translated_tree_fires_the_same_rules_at_the_same_places(jax_files, torch_files, tmp_path):
    jax_report = jax_lint.analyze_paths([_write_tree(tmp_path / "jax", jax_files)])
    port_report = port_lint.analyze_paths([_write_tree(tmp_path / "port", {**jax_files, **torch_files})])

    def where(report, root):
        return sorted((f.rule, os.path.relpath(f.path, root), f.line) for f in report.findings)

    assert where(port_report, tmp_path / "port") == where(jax_report, tmp_path / "jax")


def test_serving_match_is_cwd_independent_in_both(tmp_path, monkeypatch):
    for pkg, src in (("jax", ref.SYNC_SNIPPET), ("port", DEEP_TORCH)):
        api = tmp_path / pkg / "pkg" / "data" / "api"
        api.mkdir(parents=True)
        (api / "handlers.py").write_text(textwrap.dedent(src))
    monkeypatch.chdir(tmp_path / "jax" / "pkg" / "data")
    jax_report = jax_lint.analyze_paths(["api"])
    monkeypatch.chdir(tmp_path / "port" / "pkg" / "data")
    port_report = port_lint.analyze_paths(["api"])
    assert _rule_lines(port_report.findings) == _rule_lines(jax_report.findings) == [
        ("hostsync-serving-path", 5)]


def test_only_the_declared_entry_is_in_scope_in_both():
    src = "import {mod}\n\ndef handle(model):\n    {sync}\n\ndef warmup(model):\n    {sync}\n"
    out = []
    for lint, mod, sync in ((jax_lint, "jax", "jax.block_until_ready(model)"),
                            (port_lint, "torch", "model.cpu()")):
        config = lint.LintConfig(entry_points=(
            lint.EntryPoint("serving", "*/controller/serving.py", function="handle"),))
        active, _ = lint.analyze_source(src.format(mod=mod, sync=sync), "pkg/controller/serving.py", config)
        out.append(_rule_lines(active))
    assert out[1] == out[0] == [("hostsync-serving-path", 4)]


# the port's staging forms the reference has no spelling for
@pytest.mark.parametrize("source,expected", [
    pytest.param("""
        import torch

        def capture(g, static_x):
            with torch.cuda.graph(g):
                if static_x.sum() > 0:
                    static_x.mul_(2)
        """, [("tracer-python-branch", 6)], id="branch_inside_a_cuda_graph_capture"),
    pytest.param("""
        import torch

        def capture(g, static_x):
            with torch.cuda.graph(g):
                static_x.mul_(2)
            return static_x.item()
        """, [], id="a_fetch_after_the_capture_quiet"),
    pytest.param("""
        import torch

        def _step(x):
            return x.sum().item()

        step = torch.cuda.make_graphed_callables(_step, (torch.ones(2),))
        """, [("tracer-host-cast", 5)], id="make_graphed_callables_by_name"),
    pytest.param("""
        import torch

        def serve(requests, g, static_x):
            for r in requests:
                with torch.cuda.graph(g):
                    static_x.mul_(r)
        """, [("recompile-jit-in-loop", 6)], id="capture_in_a_loop"),
    pytest.param("""
        import torch

        @torch.compile(dynamic=True)
        def f(x, n):
            return x * n

        def caller(v):
            return f(v, 3), f(v, "relu")
        """, [("recompile-unhashable-arg", 9)], id="dynamic_numbers_but_not_strings"),
    pytest.param("""
        import re

        def patterns(words):
            return [re.compile(w) for w in words]
        """, [], id="re_compile_is_not_torch_compile"),
])
def test_port_staging_forms(source, expected):
    active, _ = port_lint.analyze_source(textwrap.dedent(source), "snippet.py")
    assert _rule_lines(active) == expected


@pytest.mark.parametrize("source,expected", [
    pytest.param("""
        from predictionio_tpu_torch.obs import xray
        from predictionio_tpu_torch.parallel.collectives import all_to_all

        def step(mesh, x):
            y = all_to_all(x, mesh, "data", 0, 1)
            return y.cpu(), xray.device_fetch(y)
        """, [("mesh-host-materialize", 7), ("mesh-host-materialize", 7)], id="a_shard_fetched_whole"),
    pytest.param("""
        from predictionio_tpu_torch.obs import xray
        from predictionio_tpu_torch.parallel.collectives import all_gather, reduce_scatter

        def step(mesh, x):
            full = all_gather(reduce_scatter(x, mesh, "data"), mesh, "data")
            return xray.device_fetch(full).numpy()
        """, [], id="gathered_then_device_fetch"),
])
def test_port_shard_fetches(source, expected):
    active, _ = port_lint.analyze_source(textwrap.dedent(source), "pkg/parallel/ingest.py")
    assert _rule_lines(active) == expected


# ---------------------------------------------------------------------------
# the CLI: the reference's CLI cases, translated
# ---------------------------------------------------------------------------

CLI_FILES = {
    "error": ("import jax\n\n@jax.jit\ndef f(x):\n    if x > 0:\n        return x\n    return -x\n",
              "import torch\n\n@torch.compile\ndef f(x):\n    if x > 0:\n        return x\n    return -x\n"),
    "warning": ("import jax\n\ndef serve(reqs, fn):\n    for r in reqs:\n        jax.jit(fn)(r)\n",
                "import torch\n\ndef serve(reqs, fn):\n    for r in reqs:\n        torch.compile(fn)(r)\n"),
    "cast": ("import jax\n\n@jax.jit\ndef f(x):\n    return int(x)\n",
             "import torch\n\n@torch.compile\ndef f(x):\n    return int(x)\n"),
    "inventory": ("import jax\n\n@jax.jit\ndef f(x):\n"
                  "    return int(x)  # pio-lint: disable=tracer-host-cast -- benchmark harness\n"
                  "def g(x):\n    return x  # pio-lint: disable=tracer-host-cast -- stale leftover\n",
                  "import torch\n\n@torch.compile\ndef f(x):\n"
                  "    return int(x)  # pio-lint: disable=tracer-host-cast -- benchmark harness\n"
                  "def g(x):\n    return x  # pio-lint: disable=tracer-host-cast -- stale leftover\n"),
}


def _both_cli(tmp_path, capsys, kind, args):
    out = []
    for i, main in enumerate((jax_lint_main, port_lint_main)):
        path = tmp_path / f"{kind}_{i}.py"
        path.write_text(CLI_FILES[kind][i])
        rc = main([*args, str(path)])
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("kind,args,rc", [
    ("error", [], 1),
    ("warning", [], 0),
    ("warning", ["--strict"], 1),
    ("cast", ["--format", "json"], 1),
    ("cast", ["--format", "sarif"], 1),
    ("inventory", ["--report-suppressions"], 0),
])
def test_cli_exit_codes_and_reports_match(kind, args, rc, tmp_path, capsys):
    (jax_rc, jax_out), (port_rc, port_out) = _both_cli(tmp_path, capsys, kind, args)
    assert port_rc == jax_rc == rc
    if "json" in args:
        docs = [json.loads(o) for o in (jax_out, port_out)]
        assert [(f["rule"], f["line"], f["col"]) for f in docs[1]["findings"]] == \
            [(f["rule"], f["line"], f["col"]) for f in docs[0]["findings"]] == [("tracer-host-cast", 5, 11)]
        assert docs[1]["files_scanned"] == docs[0]["files_scanned"] == 1
    elif "sarif" in args:
        docs = [json.loads(o) for o in (jax_out, port_out)]
        assert [r["ruleId"] for r in docs[1]["runs"][0]["results"]] == ["tracer-host-cast"]
        regions = [d["runs"][0]["results"][0]["locations"][0]["physicalLocation"]["region"] for d in docs]
        assert regions[1] == regions[0] == {"startLine": 5, "startColumn": 12}
    elif "--report-suppressions" in args:
        for out in (jax_out, port_out):
            assert "benchmark harness" in out and "stale leftover" in out
            assert out.splitlines()[-1] == "2 suppression site(s), 1 stale"
    else:
        def rules_at(out):
            return re.findall(r":(\d+):\d+: \w+ \[([\w-]+)\]", out)

        assert rules_at(port_out) == rules_at(jax_out) != []


@pytest.mark.parametrize("args", [["/nonexistent/nowhere.py"], ["--rule", "tracer-pythn-branch"]],
                         ids=["missing_path", "unknown_rule"])
def test_cli_usage_errors_exit_two_in_both(args, tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    extra = [] if args[0].startswith("/") else [str(ok)]
    assert jax_lint_main(args + extra) == port_lint_main(args + extra) == 2
    capsys.readouterr()


def test_changed_with_a_clean_tree_exits_zero_in_both(tmp_path, capsys, monkeypatch):
    (tmp_path / "ok.py").write_text("x = 1\n")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", "-A")
    _git(tmp_path, "commit", "-qm", "s")
    monkeypatch.chdir(tmp_path)
    for main in (jax_lint_main, port_lint_main):
        assert main([str(tmp_path), "--changed"]) == 0
        assert "no changed python files" in capsys.readouterr().out


def test_changed_outside_git_exits_two_in_both(tmp_path, capsys, monkeypatch):
    """A checkout without .git (an archive copy): --changed refuses."""
    (tmp_path / "ok.py").write_text("x = 1\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GIT_CEILING_DIRECTORIES", str(tmp_path.parent))
    for main in (jax_lint_main, port_lint_main):
        assert main([str(tmp_path), "--changed"]) == 2
        assert "needs a git checkout" in capsys.readouterr().err


def test_pio_lint_verb_of_both_clis(tmp_path, capsys):
    from predictionio_tpu.tools.cli import main as jax_pio
    from predictionio_tpu_torch.tools.cli import main as port_pio

    out = []
    for main, (i, src) in ((jax_pio, (0, CLI_FILES["error"][0])), (port_pio, (1, CLI_FILES["error"][1]))):
        bad = tmp_path / f"bad_{i}.py"
        bad.write_text(src)
        assert main(["lint", str(bad)]) == 1
        out.append(capsys.readouterr().out)
    assert all("tracer-python-branch" in o for o in out)


# ---------------------------------------------------------------------------
# self-lint
# ---------------------------------------------------------------------------


def test_default_paths_are_the_port_and_examples():
    paths = default_lint_paths()
    assert paths[0] == PORT_PKG
    assert paths[1:] == [os.path.join(REPO_ROOT, "examples")]


def test_the_port_lints_clean_in_a_process_without_torch_numpy_or_jax():
    """Exit 0 with no finding (warnings included) and no stale
    suppression over the port and examples/, in a clean interpreter that
    loads none of torch, numpy, jax or the JAX package. The time limit is
    generous: the whole-program walk takes several seconds on a loaded
    host."""
    code = (
        "import json, sys\n"
        "from predictionio_tpu_torch.analysis import analyze_paths\n"
        "from predictionio_tpu_torch.analysis.cli import default_lint_paths, main\n"
        "rc = main(['--strict'])\n"
        "report = analyze_paths(default_lint_paths())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy', 'jax', 'predictionio_tpu'))\n"
        "print(json.dumps({'rc': rc, 'findings': len(report.findings), 'sites': len(report.suppression_sites),\n"
        "                  'stale': sum(not s.used for s in report.suppression_sites), 'loaded': bad}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO_ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["rc"] == 0, proc.stdout
    assert result["findings"] == 0 and result["stale"] == 0 and result["sites"] > 0
    assert result["loaded"] == []


def test_no_analyzer_module_imports_torch_numpy_jax_or_the_jax_package():
    import ast

    analysis = os.path.join(PORT_PKG, "analysis")
    for name in sorted(os.listdir(analysis)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(analysis, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(roots) & {"torch", "numpy", "jax", "predictionio_tpu"}, (name, roots)
