"""Mesh/sharding rules: the bug classes that pass every one-rank test and
only detonate across ranks.

Four rules, all conservative — they fire only on *literal* axis names and
provably per-rank values, because a false positive here would train people
to suppress the family before the multi-rank code even lands:

- ``mesh-unknown-axis``: a literal axis name in a ``ShardSpec`` (the
  port's placement record, ``parallel/mesh.py``) does not exist on any
  mesh the project constructs. ``Mesh.group``/``axis_size`` would quietly
  treat the axis as size 1 at run time; the linter raises it on the laptop.
- ``mesh-collective-axis``: a literal axis name passed to a collective of
  ``parallel/collectives.py`` (``all_gather``/``reduce_scatter``/
  ``all_to_all``/``all_reduce``/…) or a mesh axis query that no mesh
  declares — the collective would run over a group of one.
- ``mesh-host-materialize``: a host fetch (``.cpu()``/``.numpy()``/
  ``.tolist()``/``.item()``/one-arg ``np.asarray``/``device_fetch``) of a
  per-rank shard produced by a sharding collective inside ``parallel/``
  or ``ops/*_sharded.py``. The shard is this rank's block, not the
  result: the sanctioned fetch is ``all_gather`` then
  ``obs.xray.device_fetch``.
- ``mesh-topk-unmerged``: a per-shard ``torch.topk`` in a sharded module
  whose enclosing top-level function never routes results through the
  ``ops/topk`` pack format (``pack_batch``/``host_top_k``/…): per-shard
  winners that never merge are silently wrong answers, not errors.

Axis names are *declared* by literal ``MeshSpec((('data', -1),))``
constructions and ``MeshSpec`` field defaults, ``MeshSpec.parse(
"data=8,model=2")`` / ``make_mesh("…")`` spec strings, ``Mesh(("data",),
…)``, ``axis="data"``-style parameter defaults, and ``AXIS = "data"``
constants — collected over the whole project, so a kernel file using
``ShardSpec(axis="model", …)`` is fine as long as ANY module constructs a
mesh with a ``model`` axis. When the project declares no axis names at
all, the axis rules stay silent (nothing to check against).
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    ProjectState,
    Severity,
    matches_any_glob,
    register_checker,
    register_rule,
)

register_rule(
    "mesh-unknown-axis",
    "mesh",
    Severity.ERROR,
    "ShardSpec names a mesh axis no Mesh/MeshSpec in the project "
    "declares; a placement's axis must exist on the constructing mesh",
)

register_rule(
    "mesh-collective-axis",
    "mesh",
    Severity.ERROR,
    "collective (all_gather/reduce_scatter/all_to_all/all_reduce/...) "
    "names a mesh axis no Mesh/MeshSpec in the project declares; the "
    "axis name must match a mesh axis",
)

register_rule(
    "mesh-host-materialize",
    "mesh",
    Severity.ERROR,
    "host fetch (.cpu()/.numpy()/.tolist()/one-arg np.asarray/"
    "device_fetch) of a per-rank shard in a sharded module takes this "
    "rank's block for the whole; fetch through collectives.all_gather + "
    "obs.xray.device_fetch",
)

register_rule(
    "mesh-topk-unmerged",
    "mesh",
    Severity.ERROR,
    "per-shard torch.topk whose results never merge through the ops/topk "
    "pack format (pack_batch/host_top_k); per-shard winners are not "
    "global winners",
)


_SPEC_NAMES = frozenset({"ShardSpec"})
_MESH_NAMES = frozenset({"Mesh"})
_MESHSPEC_NAMES = frozenset({"MeshSpec"})
_SPEC_STRING_FNS = frozenset({"make_mesh", "parse"})
# collective / axis query -> positional index of its axis argument
# (parallel/collectives.py: fn(x, mesh, axis, ...); Mesh: meth(axis))
_COLLECTIVES = {
    "all_gather": 2,
    "reduce_scatter": 2,
    "all_to_all": 2,
    "ppermute": 2,
    "all_reduce": 2,
    "all_gather_grad": 2,
    "all_to_all_grad": 2,
    "ppermute_grad": 2,
    "all_reduce_grad": 2,
    "axis_index": 0,
    "axis_size": 0,
    "axis_ranks": 0,
}
_AXIS_KWARGS = frozenset({"axis", "axis_name"})
_AXIS_PARAM_NAMES = frozenset({"axis", "axis_name", "axis_names", "axes"})
_TOPK_MERGE_FNS = frozenset(
    {
        "pack_batch",
        "unpack_batch",
        "fetch_topk",
        "host_top_k",
        "merge_topk",
        "topk_merge",
        "merge_shards",
    }
)


def _str_constants(node: ast.AST) -> list[tuple[str, ast.AST]]:
    return [
        (n.value, n)
        for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    ]


def _spec_string_axes(value: str) -> list[str]:
    """Axis names out of a "data=8,model=2" mesh-spec string."""
    out = []
    for part in value.split(","):
        name = part.partition("=")[0].strip()
        if name.isidentifier():
            out.append(name)
    return out


def _collect_declared_axes(tree: ast.Module) -> set[str]:
    """Literal axis names this file declares (see module docstring)."""
    axes: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            last = astutil.last_component(node.func)
            if last in _MESH_NAMES:
                # Mesh(("data", "model"), sizes, ...) or names= kwarg
                sources = list(node.args[:1]) + [
                    kw.value
                    for kw in node.keywords
                    if kw.arg in ("axis_names", "names")
                ]
                for src in sources:
                    axes.update(v for v, _ in _str_constants(src))
            elif last in _MESHSPEC_NAMES:
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    axes.update(v for v, _ in _str_constants(arg))
            elif last in _SPEC_STRING_FNS:
                for arg in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str
                    ):
                        axes.update(_spec_string_axes(arg.value))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            pos = list(args.posonlyargs) + list(args.args)
            for a, default in zip(pos[len(pos) - len(args.defaults):], args.defaults):
                if a.arg in _AXIS_PARAM_NAMES:
                    axes.update(v for v, _ in _str_constants(default))
            for a, default in zip(args.kwonlyargs, args.kw_defaults):
                if default is not None and a.arg in _AXIS_PARAM_NAMES:
                    axes.update(v for v, _ in _str_constants(default))
        elif isinstance(node, ast.ClassDef) and node.name in _MESHSPEC_NAMES:
            # MeshSpec's field defaults: axes = (("data", -1),)
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    axes.update(v for v, _ in _str_constants(stmt.value))
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Name)
                    and "axis" in tgt.id.lower()
                    and isinstance(node.value, (ast.Constant, ast.Tuple, ast.List))
                ):
                    axes.update(v for v, _ in _str_constants(node.value))
    return axes


def _declared_axes(ctx: FileContext, state: ProjectState) -> set[str]:
    """Project-wide union of declared axis names, cached per graph."""
    if ctx.cache.get("_mesh_axes_graph") is state.graph:
        return ctx.cache["_mesh_axes"]
    axes: set[str] = set()
    for _path, tree in state.graph.file_trees():
        axes |= _collect_declared_axes(tree)
    ctx.cache["_mesh_axes"] = axes
    ctx.cache["_mesh_axes_graph"] = state.graph
    return axes


# a file can only fire the axis rules if one of these appears textually;
# the substring gate skips the full-tree walk for files with none
_AXIS_NEEDLES = tuple(_SPEC_NAMES) + tuple(_COLLECTIVES)


@register_checker
def check_mesh_axis_names(ctx: FileContext):
    """mesh-unknown-axis + mesh-collective-axis: literal axis names at use
    sites must be declared by SOME mesh construction in the project."""
    if not any(n in ctx.source for n in _AXIS_NEEDLES):
        return []
    state = ctx.project()
    declared = _declared_axes(ctx, state)
    if not declared:
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        last = astutil.last_component(node.func)
        if last in _SPEC_NAMES:
            # ShardSpec(axis, dim, global_shape, start): the axis alone
            axis_args = [kw.value for kw in node.keywords if kw.arg == "axis"]
            if not axis_args and node.args:
                axis_args = [node.args[0]]
            for arg in axis_args:
                if not isinstance(arg, ast.Constant):
                    continue
                for value, where in _str_constants(arg):
                    if value not in declared:
                        findings.append(
                            ctx.finding(
                                "mesh-unknown-axis",
                                where,
                                f"ShardSpec axis {value!r} is not "
                                "declared by any Mesh/MeshSpec in the "
                                f"project (declared: "
                                f"{sorted(declared)})",
                            )
                        )
        elif last in _COLLECTIVES:
            idx = _COLLECTIVES[last]
            axis_args = [
                kw.value for kw in node.keywords if kw.arg in _AXIS_KWARGS
            ]
            if not axis_args and len(node.args) > idx:
                axis_args = [node.args[idx]]
            for arg in axis_args:
                # literal names only: a variable axis arg is unknowable
                if not isinstance(arg, (ast.Constant, ast.Tuple, ast.List)):
                    continue
                for value, where in _str_constants(arg):
                    if value not in declared:
                        findings.append(
                            ctx.finding(
                                "mesh-collective-axis",
                                where,
                                f"collective {last}() names axis "
                                f"{value!r}, which no Mesh/MeshSpec in "
                                "the project declares (declared: "
                                f"{sorted(declared)})",
                            )
                        )
    return findings


# collectives whose result is this rank's block of a sharded tensor
_SHARD_PRODUCERS = frozenset(
    {"reduce_scatter", "all_to_all", "all_to_all_grad"}
)


def _is_sharded_producer_call(
    call: ast.Call, producer_names: frozenset[str]
) -> bool:
    """Does this call expression yield a per-rank shard?"""
    last = astutil.last_component(call.func)
    if last in _SHARD_PRODUCERS:
        return True
    if isinstance(call.func, ast.Name) and call.func.id in producer_names:
        return True
    return False


def _project_producer_names(
    ctx: FileContext, state: ProjectState
) -> frozenset[str]:
    """Project functions whose own bodies apply a sharding collective —
    calling them yields per-rank shards."""
    if ctx.cache.get("_mesh_producers_graph") is state.graph:
        return ctx.cache["_mesh_producers"]
    names: set[str] = set()
    for fn in state.graph.functions.values():
        for node in astutil.walk_skipping_nested_functions(fn.node.body):
            if isinstance(node, ast.Call):
                if astutil.last_component(node.func) in _SHARD_PRODUCERS:
                    names.add(fn.name)
                    break
    out = frozenset(names) - _SHARD_PRODUCERS
    ctx.cache["_mesh_producers"] = out
    ctx.cache["_mesh_producers_graph"] = state.graph
    return out


# the profiled fetch helpers: sanctioned only for a gathered value
_FETCH_HELPERS = frozenset({"device_fetch", "timed_fetch"})


def _materialize_label(call: ast.Call) -> str | None:
    """Label for a host fetch of the call's receiver or first argument."""
    label = astutil.sync_call_label(call)
    if label is not None and not label.endswith("synchronize()"):
        return label
    last = astutil.last_component(call.func)
    if last in _FETCH_HELPERS and call.args:
        return f"{last}()"
    return None


@register_checker
def check_mesh_host_materialize(ctx: FileContext):
    state = ctx.project()
    if not matches_any_glob(ctx.graph_path, ctx.config.mesh_sharded_globs):
        return []
    producers = _project_producer_names(ctx, state)
    findings: list[Finding] = []

    def scan(body: list[ast.stmt]) -> None:
        tainted: set[str] = set()
        nodes = list(astutil.walk_skipping_nested_functions(body))
        for node in nodes:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if _is_sharded_producer_call(node.value, producers):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
                        elif isinstance(tgt, (ast.Tuple, ast.List)):
                            tainted.update(
                                e.id
                                for e in tgt.elts
                                if isinstance(e, ast.Name)
                            )
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            label = _materialize_label(node)
            if label is None:
                continue
            # a method fetch copies its receiver, a function its argument
            if label.startswith("."):
                arg = node.func.value
            else:
                arg = node.args[0] if node.args else None
            hit = False
            if isinstance(arg, ast.Name) and arg.id in tainted:
                hit = True
            elif isinstance(arg, ast.Call) and _is_sharded_producer_call(
                arg, producers
            ):
                hit = True
            if hit:
                findings.append(
                    ctx.finding(
                        "mesh-host-materialize",
                        node,
                        f"{label} fetches a per-rank shard to the host "
                        "as if it were the whole result — gather it "
                        "first (collectives.all_gather) and fetch through "
                        "obs.xray.device_fetch, or keep it on the card",
                    )
                )

    scan(astutil.module_level_statements(ctx.tree))
    for fn in state.graph.functions_in(ctx.graph_path):
        scan(fn.node.body)
    return findings


@register_checker
def check_mesh_topk_unmerged(ctx: FileContext):
    """Per-shard top-k in sharded modules must meet the ops/topk pack
    format somewhere in the same top-level function (the merge point)."""
    if not matches_any_glob(ctx.graph_path, ctx.config.mesh_sharded_globs):
        return []
    findings: list[Finding] = []
    for node in ctx.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        topk_calls = []
        merges = False
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            last = astutil.last_component(sub.func)
            if last == "topk":
                topk_calls.append(sub)
            elif last in _TOPK_MERGE_FNS:
                merges = True
        if topk_calls and not merges:
            for call in topk_calls:
                findings.append(
                    ctx.finding(
                        "mesh-topk-unmerged",
                        call,
                        "per-shard topk result never merges through the "
                        "ops/topk pack format (pack_batch/host_top_k): "
                        "each shard's local winners are not the global "
                        "top-k — gather and re-select, or return packed "
                        "candidates",
                    )
                )
    return findings
