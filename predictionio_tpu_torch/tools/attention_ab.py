"""Time kernels B2 and B3 of several checkouts on one card, in turns.

Run from the root of a checkout on a machine with a CUDA card::

    python -m predictionio_tpu_torch.tools.attention_ab --tree OLD --tree .

``OLD`` is the root of another checkout (its ``predictionio_tpu_torch``
package is enough). Each turn runs this file in a fresh process with that
tree first on ``sys.path``, so the process imports that tree's wrappers and
builds that tree's kernel sources into its own ``build/kernels/``. The
process times B2 at the scorer's [64, 1, 8, 32] and [64, 1, 200, 32] and B3
at [64, 1, 1024, 32], all causal, on seeded inputs: ``ms`` from
back-to-back eager calls and ``graph_ms`` from a replayed CUDA graph (both
from this checkout's ``utils/cuda_timing.py``). The turns go 0, 1, ..., 1, 0
unless ``--order`` says otherwise, and each prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

SHAPES = [
    ("fused_attention_block", (64, 1, 8, 32)),
    ("fused_attention_block", (64, 1, 200, 32)),
    ("flash_attention", (64, 1, 1024, 32)),
]


def _timing():
    """This checkout's utils/cuda_timing.py, loaded by path: the package on
    sys.path may be another checkout's."""
    path = Path(__file__).resolve().parents[1] / "utils" / "cuda_timing.py"
    spec = importlib.util.spec_from_file_location("_cuda_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure() -> list[dict]:
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import attention as A

    timing = _timing()
    rows = []
    for name, shape in SHAPES:
        wrapper = getattr(A, name)
        x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
        x = torch.from_numpy(x).cuda()

        def call():
            return wrapper(x, x, x, True)

        rows.append({"kernel": name, "shape": list(shape),
                     "ms": timing.event_ms(call, reps=200), "graph_ms": timing.graph_ms(call)})
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", required=True, help="checkout root")
    parser.add_argument("--order", help="comma-separated tree indices (default 0,1,...,1,0)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps({"kernels": measure()}), flush=True)
        return 0
    trees = [str(Path(t).resolve()) for t in args.tree]
    if args.order:
        order = [int(i) for i in args.order.split(",")]
    else:
        order = list(range(len(trees))) + list(reversed(range(len(trees))))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for turn, i in enumerate(order):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", "--tree", trees[i]],
            env={**os.environ, "PYTHONPATH": trees[i]}, cwd=trees[i],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            print(f"turn {turn} ({trees[i]}) failed:\n{proc.stderr}", file=sys.stderr)
            return 1
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": turn, "tree": trees[i], "gpu": gpu, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
