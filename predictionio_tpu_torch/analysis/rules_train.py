"""Training-path rules.

``train-unaccounted-sync``: a bare device->host sync inside a
training-loop module. The xray step profiler's contract is that the
per-phase timeline **tiles the train wall clock** and that device time is
explicitly accounted (``pio_train_device_seconds_total``, the
``deviceTimeFrac`` every manifest carries). A raw ``.item()``, ``.cpu()``,
``.numpy()``, ``.tolist()``, ``.to("cpu")``, ``torch.cuda.synchronize()``
or one-argument ``np.asarray`` of a tensor stalls the host for a device
round-trip that *no instrument sees* — the profile under-reports device
time and the roofline math silently rots. Sanctioned forms:

- ``obs.torchprof.timed_fetch(x, registry, where=…)``
- ``obs.xray.device_fetch(x, where=…)`` / ``TrainProfile.device_barrier``
- an inline suppression with a reason, for syncs that ARE the instrument
  (``ops/als.fetch_barrier``, the helpers above) or host-side
  ``.tolist()``/``.item()`` the heuristic can't prove harmless.

Scope: every function REACHABLE from a declared train entry point
(``LintConfig.entry_points``, category ``train`` — the training-loop
modules seed every def), plus module-level statements in those modules. A
sync inside a helper another module provides to the train loop is in scope
even though no glob names it. ``np.asarray`` is only flagged in its
one-argument form — the two-argument ``np.asarray(x, np.float32)`` idiom is
how this codebase converts *host* inputs, while the bare one-argument form
is exactly the device-readback idiom.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Severity,
    matches_any_glob,
    register_checker,
    register_rule,
)
from predictionio_tpu_torch.analysis.reachability import CATEGORY_TRAIN

register_rule(
    "train-unaccounted-sync",
    "hostsync",
    Severity.ERROR,
    "bare device->host sync (.item()/.tolist()/.cpu()/.numpy()/.to('cpu')/"
    "synchronize()/one-arg np.asarray) in a training-loop module; route it "
    "through obs.torchprof.timed_fetch or obs.xray.device_fetch so the "
    "stall lands in the train profile, or suppress with a reason",
)

_MESSAGE = (
    "is an unaccounted device->host sync on the "
    "training path; device time leaks out of the train "
    "profile — use obs.torchprof.timed_fetch / "
    "obs.xray.device_fetch (or suppress with a reason)"
)


@register_checker
def check_train_unaccounted_sync(ctx: FileContext):
    state = ctx.project()
    findings: list[Finding] = []
    train_globs = state.reach.entry_module_globs(CATEGORY_TRAIN)
    if matches_any_glob(ctx.graph_path, train_globs):
        for node in astutil.walk_skipping_nested_functions(
            astutil.module_level_statements(ctx.tree)
        ):
            if isinstance(node, ast.Call):
                label = astutil.sync_call_label(node)
                if label:
                    findings.append(
                        ctx.finding(
                            "train-unaccounted-sync",
                            node,
                            f"{label} {_MESSAGE}",
                        )
                    )
    for fn, origin in state.reach.iter_reachable_in_file(
        ctx.graph_path, CATEGORY_TRAIN
    ):
        note = state.reach.reach_note(fn, origin)
        for node in astutil.walk_skipping_nested_functions(fn.node.body):
            if not isinstance(node, ast.Call):
                continue
            label = astutil.sync_call_label(node)
            if label:
                findings.append(
                    ctx.finding(
                        "train-unaccounted-sync",
                        node,
                        f"{label} {_MESSAGE}{note}",
                    )
                )
    return findings
