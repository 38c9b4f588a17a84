"""Storage-contract audit.

Every backend under ``data/storage/`` must structurally implement the full
abstract surface its base class declares in ``storage/base.py``. Runtime
``abc`` would catch this at instantiation — but backends with optional
dependencies (elasticsearch, hdfs, s3) may never be instantiated in CI, so
the drift shows up in production instead. This check is pure AST: it reads
``base.py`` next to the audited file, collects ``@abstractmethod`` names per
base class, then verifies each subclass (following ancestor chains defined
in the same file) defines every required method.
"""

from __future__ import annotations

import ast
import os

from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Severity,
    register_checker,
    register_rule,
)

register_rule(
    "storage-missing-method",
    "storage-contract",
    Severity.ERROR,
    "storage backend class does not implement the full abstract surface "
    "of its storage/base.py base class",
)


def _base_name(expr: ast.expr) -> str | None:
    """Last dotted component of a base-class expression; handles
    ``Apps``, ``base.Apps`` and ``Generic[T]``-style subscripts."""
    if isinstance(expr, ast.Subscript):
        expr = expr.value
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _is_abstract(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for dec in fn.decorator_list:
        name = _base_name(dec)
        if name in ("abstractmethod", "abstractproperty"):
            return True
    return False


def _abstract_surface(base_path: str) -> dict[str, set[str]]:
    """class name -> abstract method names declared in base.py."""
    with open(base_path, encoding="utf-8", errors="replace") as fh:
        tree = ast.parse(fh.read())
    surface: dict[str, set[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        methods = {
            sub.name
            for sub in node.body
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
            and _is_abstract(sub)
        }
        if methods:
            surface[node.name] = methods
    return surface


def _defined_methods(cls: ast.ClassDef) -> set[str]:
    out = set()
    for sub in cls.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(sub.name)
        elif isinstance(sub, ast.Assign):
            # `find = _find_impl` style aliasing still satisfies the contract
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


@register_checker
def check_storage_contract(ctx: FileContext):
    if not ctx.path:
        return []
    directory, filename = os.path.split(ctx.path)
    if os.path.basename(directory) != "storage" or filename in (
        "base.py",
        "__init__.py",
    ):
        return []
    base_path = os.path.join(directory, "base.py")
    if not os.path.exists(base_path):
        return []
    cache_key = ("storage-abstract-surface", base_path)
    if cache_key not in ctx.cache:
        try:
            ctx.cache[cache_key] = _abstract_surface(base_path)
        except (OSError, SyntaxError):
            ctx.cache[cache_key] = {}
    surface: dict[str, set[str]] = ctx.cache[cache_key]
    if not surface:
        return []

    local_classes = {
        node.name: node
        for node in ctx.tree.body
        if isinstance(node, ast.ClassDef)
    }
    findings: list[Finding] = []
    for cls in local_classes.values():
        # walk the local ancestor chain collecting contract bases and
        # locally defined methods (an intermediate local base may provide
        # part of the surface)
        required: set[str] = set()
        defined = _defined_methods(cls)
        queue = list(cls.bases)
        visited: set[str] = {cls.name}
        while queue:
            base = queue.pop()
            name = _base_name(base)
            if name is None or name in visited:
                continue
            visited.add(name)
            if name in surface:
                required |= surface[name]
            elif name in local_classes:
                ancestor = local_classes[name]
                defined |= _defined_methods(ancestor)
                queue.extend(ancestor.bases)
        missing = sorted(required - defined)
        if missing:
            findings.append(
                ctx.finding(
                    "storage-missing-method",
                    cls,
                    f"{cls.name!r} is missing abstract method(s) "
                    f"{', '.join(missing)} required by storage/base.py",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# raw pickle deserialization
# ---------------------------------------------------------------------------

register_rule(
    "storage-raw-pickle",
    "storage-contract",
    Severity.ERROR,
    "pickle.load(s) outside the checksummed model-io boundary: "
    "deserializing unverified bytes silently turns storage corruption or "
    "tampering into arbitrary code execution",
)

# the only files allowed to unpickle: both sit behind the PIOTPU02
# sha256-verified framing (workflow/model_io.py) or serve verified
# registry artifacts (registry/store.py)
_PICKLE_ALLOWED_SUFFIXES = (
    os.path.join("workflow", "model_io.py"),
    os.path.join("registry", "store.py"),
)


@register_checker
def check_raw_pickle(ctx: FileContext):
    if "ickle" not in ctx.source:  # pickle / cPickle / _pickle
        return []
    path = (ctx.path or ctx.display_path).replace("/", os.sep)
    if any(path.endswith(suffix) for suffix in _PICKLE_ALLOWED_SUFFIXES):
        return []
    pickle_modules = {"pickle", "cPickle", "_pickle"}
    # module names the pickle modules are bound to (incl. `import pickle
    # as pkl` aliases) and bare `load`/`loads` names imported from them
    module_names = set(pickle_modules)
    bare: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in pickle_modules:
                    module_names.add(alias.asname or alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module in pickle_modules:
            for alias in node.names:
                if alias.name in ("load", "loads"):
                    bare.add(alias.asname or alias.name)
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        hit = (
            isinstance(fn, ast.Attribute)
            and fn.attr in ("load", "loads")
            and isinstance(fn.value, ast.Name)
            and fn.value.id in module_names
        ) or (isinstance(fn, ast.Name) and fn.id in bare)
        if hit:
            findings.append(
                ctx.finding(
                    "storage-raw-pickle",
                    node,
                    "raw pickle deserialization; route model bytes through "
                    "workflow/model_io.py (sha256-verified PIOTPU02 framing) "
                    "or the registry store",
                )
            )
    return findings
