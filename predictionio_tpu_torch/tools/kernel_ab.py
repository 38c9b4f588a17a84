"""Time kernels B1, B2 and B3 of several checkouts on one card, in turns.

Run from the root of a checkout on a machine with a CUDA card::

    python -m predictionio_tpu_torch.tools.kernel_ab --tree OLD --tree .

``OLD`` is the root of another checkout (its ``predictionio_tpu_torch``
package is enough). Each turn runs this file in a fresh process with that
tree first on ``sys.path``, so the process imports that tree's wrappers and
builds that tree's kernel sources into its own ``build/kernels/``. The
process times, on seeded inputs:

- B1 (``batched_spd_solve_fused``) on ALS-shaped SPD systems (the Gram
  matrix of 3f random rows plus a ridge, drawn on the card from a seeded
  generator) at n = 138,001 and 27,001 with f = 32 (the ML-20M user and
  item sides) and n = 138,001 with f = 10 (the template default rank);
  with ``--b1-steps``, also its C entry at those CG step counts instead of
  f + 4, which splits its time into loads and steps;
- B2 at the scorer's [64, 1, 8, 32] and [64, 1, 200, 32] and B3 at
  [64, 1, 1024, 32], all causal.

Each gets ``ms`` from back-to-back eager calls and ``graph_ms`` from a
replayed CUDA graph (both from this checkout's ``utils/cuda_timing.py``).
With ``--sass``, each turn also counts, by opcode, the instructions of
one CG step in each register kernel of the tree's built B1 library: the
shortest loop of its SASS (``cuobjdump -sass``) that holds a shuffle. The turns go
0, 1, ..., 1, 0 unless ``--order`` says otherwise, and each prints one
JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

SPD_SHAPES = [(138_001, 32), (27_001, 32), (138_001, 10)]
ATTENTION_SHAPES = [
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


def spd_systems(torch, n: int, f: int, seed: int, reg: float = 0.05):
    """ALS-shaped SPD systems drawn on the card: A = GᵀG + reg·3f·I with G
    [n, 3f, f] standard normal, and b [n, f] standard normal."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn(n, 3 * f, f, generator=gen, device="cuda")
    A = torch.bmm(G.transpose(1, 2), G) + reg * 3 * f * torch.eye(f, device="cuda")
    return A.contiguous(), torch.randn(n, f, generator=gen, device="cuda")


def measure(b1_steps: list[int]) -> list[dict]:
    import numpy as np
    import torch

    from predictionio_tpu_torch.ops import attention as A
    from predictionio_tpu_torch.ops import spd_solve as S

    timing = _timing()
    rows = []
    for n, f in SPD_SHAPES:
        Asys, b = spd_systems(torch, n, f, seed=n + f)

        def solve():
            return S.batched_spd_solve_fused(Asys, b)

        rows.append({"kernel": "batched_spd_solve_fused", "shape": [n, f],
                     "ms": timing.event_ms(solve, reps=20), "graph_ms": timing.graph_ms(solve)})
        for steps in b1_steps:
            x = torch.empty_like(b)
            lib = S._library()

            def partial():
                # the current stream: graph_ms runs this on a side stream
                stream = torch.cuda.current_stream().cuda_stream
                rc = lib.pio_spd_cg_solve(Asys.data_ptr(), b.data_ptr(), x.data_ptr(), n, f,
                                          steps, stream)
                if rc != 0:
                    raise RuntimeError(f"spd_cg launch failed ({rc})")

            rows.append({"kernel": "batched_spd_solve_fused", "shape": [n, f], "steps": steps,
                         "graph_ms": timing.graph_ms(partial)})
        del Asys, b
    for name, shape in ATTENTION_SHAPES:
        wrapper = getattr(A, name)
        x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
        x = torch.from_numpy(x).cuda()

        def call():
            return wrapper(x, x, x, True)

        rows.append({"kernel": name, "shape": list(shape),
                     "ms": timing.event_ms(call, reps=200), "graph_ms": timing.graph_ms(call)})
    return rows


def step_counts(sass: str) -> dict:
    """Per register kernel (width, lanes per system, exact) of a
    ``cuobjdump -sass`` listing: the opcodes of its shortest loop (a
    backward branch) that holds a shuffle, counted."""
    counts = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        m = re.search(r"spd_cg_registersI((?:L[ib]\d+E)+)E", name)
        if not m:  # the register kernels: their steps unroll, so a count is per step
            continue
        args = ",".join(re.findall(r"L[ib](\d+)E", m.group(1)))
        code = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
        best = None
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if target and int(target.group(1), 16) < addr:
                loop = [o.split(".")[0] for a, o, _ in code if int(target.group(1), 16) <= a <= addr]
                if "SHFL" in loop and (best is None or len(loop) < len(best)):
                    best = loop
        if best:
            counts[f"registers<{args}>"] = {
                "instructions": len(best),
                **{op: best.count(op) for op in ("FFMA", "LDS", "STS", "SHFL", "MUFU")},
            }
    return counts


def sass_counts() -> dict:
    """step_counts of this process's built B1 library."""
    from predictionio_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path("spd_cg"))],
                          capture_output=True, text=True, check=True).stdout
    return step_counts(sass)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", required=True, help="checkout root")
    parser.add_argument("--order", help="comma-separated tree indices (default 0,1,...,1,0)")
    parser.add_argument("--b1-steps", default="",
                        help="comma-separated CG step counts at which to time B1's C entry too")
    parser.add_argument("--sass", action="store_true",
                        help="count the CG step's instructions in each tree's B1 build")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    steps = [int(s) for s in args.b1_steps.split(",") if s]
    if args.child:
        result = {"kernels": measure(steps)}
        if args.sass:
            result["b1_step_sass"] = sass_counts()
        print(json.dumps(result), flush=True)
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
            [sys.executable, str(Path(__file__).resolve()), "--child", "--tree", trees[i],
             "--b1-steps", args.b1_steps, *(["--sass"] if args.sass else [])],
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
