"""Device-free roofline from an analytic count of operations and bytes.

Port of ``predictionio_tpu/obs/costmodel.py``. The JAX package lowers each
jitted bucket and reads XLA's ``cost_analysis()``; eager PyTorch has no
compiler to ask, so this module counts each serving and training kernel's
work from its shapes: the floating-point operations of its algorithm, the
bytes of each input read once and each output written once (the bound the
kernel table in ``PERF.md`` uses), and, for attention, one exponential per
visible query-key pair. :func:`roofline_time_s` projects a count onto a
:class:`DeviceSpec` (``max(operations / peak, bytes / bandwidth)``).

Families: ``topk`` (the fused score -> mask -> top-k of ``ops/topk``),
``ann`` (probe -> gather -> score -> top-k of ``ann/search``), ``als`` (the
blocked ALS sweep and the CG solve it runs), ``twotower`` (the serving
towers) and ``kernels``: the three hand-written CUDA kernels, B1
(``spd_cg``), B2 (``attention_block``) and B3 (``flash_attention``), at the
main paths' shapes. ``chip_smoke.py`` computes every kernel's ``bound_ms``
through :func:`bound_ms`, so ``pio doctor --roofline`` and the kernel table
read the same bounds.

The port prices no dollars: the JAX package's ``costPer1kQueriesUsd``
needs a list price no committed source of this repo gives for the card.
Standard library only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak envelope of one card (data-sheet peaks: the floor of device
    time, not a prediction of achieved time)."""

    name: str
    peak_flops: float  # dense bf16 tensor-core FLOP/s
    peak_f32_flops: float  # f32 FLOP/s outside the tensor cores
    peak_bytes_per_s: float  # device memory bandwidth, B/s
    peak_exp_per_s: float  # special-function (exp) rate, 1/s
    memory_bytes: int

    def to_json_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def ops_rate(self, dtype: str) -> float:
        return self.peak_flops if dtype == "bf16" else self.peak_f32_flops


# H100 SXM data sheet: 989 TFLOP/s dense bf16, 67 TFLOP/s f32, HBM3 at
# 3.35 TB/s, 80 GB; the exp rate is the figure FlashAttention-3 uses
# (Shah et al. 2024)
DEVICE_SPECS: dict[str, DeviceSpec] = {
    "h100-sxm": DeviceSpec("h100-sxm", 989e12, 67e12, 3.35e12, 3.9e12, 80_000_000_000),
}
DEFAULT_DEVICE = "h100-sxm"


def _cost(family: str, kernel: str, flops: float, arg_bytes: int, out_bytes: int,
          dtype: str = "f32", exps: float = 0.0, **shape: Any) -> dict[str, Any]:
    nbytes = float(arg_bytes + out_bytes)
    return {
        "family": family,
        "kernel": kernel,
        "shape": shape,
        "dtype": dtype,
        "flops": float(flops),
        "exps": float(exps),
        "bytesAccessed": nbytes,
        "argBytes": int(arg_bytes),
        "outBytes": int(out_bytes),
        "arithmeticIntensity": float(flops) / max(nbytes, 1.0),
    }


# ------------------------------------------------------------- the kernels
def spd_cg_cost(n: int, f: int) -> dict[str, Any]:
    """B1: n SPD f x f systems by Jacobi-preconditioned CG, f + 4 steps; A
    and b read once, x written once, f32."""
    iters = f + 4
    flops = n * (2 * f * f + 6 * f + iters * (2 * f * f + 11 * f))
    return _cost("kernels", "spd_cg", flops, n * (f * f + f) * 4, n * f * 4, n=n, f=f)


def attention_cost(batch: int, heads: int, lq: int, lk: int, d: int, causal: bool,
                   shared_qkv: bool = False, elem_bytes: int = 4,
                   arg_bytes: int | None = None) -> dict[str, Any]:
    """B2/B3: one attention over [batch, heads, L, d]: each distinct input
    read once (``shared_qkv``: one tensor passed as q, k and v; or the
    caller's count of distinct input bytes, ``arg_bytes``), o written once;
    4·d bf16 tensor operations and one exponential per visible query-key
    pair (all of them, or under the causal mask sum_i min(i + 1, lk))."""
    bh = batch * heads
    pairs = sum(min(i + 1, lk) for i in range(lq)) if causal else lq * lk
    q_bytes = bh * lq * d * elem_bytes
    arg = q_bytes if shared_qkv else q_bytes + 2 * bh * lk * d * elem_bytes
    if arg_bytes is not None:
        arg = arg_bytes
    return _cost("kernels", "attention", 4 * bh * pairs * d, arg, q_bytes, dtype="bf16",
                 exps=bh * pairs, batch=batch, heads=heads, lq=lq, lk=lk, d=d, causal=causal,
                 shared_qkv=shared_qkv)


def bound_terms_ms(cost: dict[str, Any], spec: DeviceSpec | None = None) -> dict[str, float]:
    """The three floors of one kernel call in ms: bytes over bandwidth,
    operations over the dtype's peak, exponentials over the exp rate."""
    spec = spec or DEVICE_SPECS[DEFAULT_DEVICE]
    terms = {
        "bytes": cost["bytesAccessed"] / spec.peak_bytes_per_s * 1e3,
        "operations": cost["flops"] / spec.ops_rate(cost["dtype"]) * 1e3,
    }
    if cost.get("exps"):
        terms["exponentials"] = cost["exps"] / spec.peak_exp_per_s * 1e3
    return terms


def bound_ms(cost: dict[str, Any], spec: DeviceSpec | None = None) -> tuple[float, str, dict[str, float]]:
    """The least time the card could take: the largest floor, and what
    binds it ("bytes" or "operations"; exponentials count as operations)."""
    terms = bound_terms_ms(cost, spec)
    binding = max(terms, key=terms.get)
    return terms[binding], "bytes" if binding == "bytes" else "operations", terms


# the kernel table's shapes (PERF.md §6): (kernel, cost)
def kernel_costs() -> tuple[list[dict[str, Any]], int]:
    """B1, B2 and B3 at the main paths' shapes."""
    rows = [
        dict(spd_cg_cost(138_001, 32), kernel="spd_cg", label="ML-20M users"),
        dict(spd_cg_cost(27_001, 32), kernel="spd_cg", label="ML-20M items"),
        dict(spd_cg_cost(138_001, 10), kernel="spd_cg", label="spd_batch / similar-product users"),
        dict(spd_cg_cost(6_041, 160), kernel="spd_cg", label="ML-1M users, rank 160"),
        dict(attention_cost(4096, 2, 256, 256, 32, False), kernel="attention_block",
             label="two-tower training"),
        dict(attention_cost(64, 2, 256, 256, 32, False), kernel="attention_block",
             label="two-tower serving"),
        dict(attention_cost(64, 1, 200, 200, 32, True, shared_qkv=True), kernel="attention_block",
             label="sequential, context 200"),
        dict(attention_cost(64, 1, 1024, 1024, 32, True, shared_qkv=True), kernel="flash_attention",
             label="sequential, context 1024"),
    ]
    return rows, 1


# --------------------------------------------------------------- families
def topk_costs(*, n: int = 4096, f: int = 32, b: int = 32, q: int = 8, k: int = 10
               ) -> tuple[list[dict[str, Any]], int]:
    """The fused score -> mask -> top-k serving programs (``ops/topk``):
    a [b, f] x [f, n] product, the mask or weight elementwise work, top-k
    to a packed [b, 2, k] int32 answer."""
    out = b * 2 * k * 4
    mm = 2 * b * n * f
    table, vecs, mask, weights = n * f * 4, b * f * 4, b * n, n * 4
    qidx, qweight, scores = b * q * 4, b * q * 4, b * n * 4
    gather = 2 * b * q * f
    return [
        _cost("topk", "dot_top_k", mm + b * n, table + vecs + mask, out, n=n, f=f, b=b, k=k),
        _cost("topk", "dot_top_k_unmasked", mm, table + vecs, out, n=n, f=f, b=b, k=k),
        _cost("topk", "dot_top_k_weighted", mm + 2 * b * n, table + vecs + mask + weights, out,
              n=n, f=f, b=b, k=k),
        _cost("topk", "gather_sum_top_k", gather + mm + b * n, table + qidx + qweight + mask, out,
              n=n, f=f, b=b, q=q, k=k),
        _cost("topk", "gather_sum_top_k_weighted", gather + mm + 2 * b * n,
              table + qidx + qweight + mask + weights, out, n=n, f=f, b=b, q=q, k=k),
        _cost("topk", "mask_top_k", b * n, scores + mask, out, n=n, b=b, k=k),
    ], b


def ann_costs(*, c: int = 64, cap: int = 32, f: int = 32, b: int = 32, nprobe: int = 4, k: int = 10
              ) -> tuple[list[dict[str, Any]], int]:
    """The clustered ANN search (``ann/search``): centroid scores, the
    probed buckets gathered and scored, top-k."""
    flops = 2 * b * c * f + 2 * b * nprobe * cap * f
    arg = c * f * 4 + c * cap * f * 4 + c * cap * 4 + b * f * 4
    return [_cost("ann", "search", flops, arg, b * 2 * k * 4, c=c, cap=cap, f=f, b=b,
                  nprobe=nprobe, k=k)], b


def als_costs(*, rank: int = 16, n_users: int = 64, n_items: int = 64, nb: int = 32, d: int = 8,
              block_chunk: int = 8) -> tuple[list[dict[str, Any]], int]:
    """One ALS sweep (both half-steps over nb blocks of d ratings: the
    normal equations 2·d·k² + 2·d·k a row, then the CG solve of every
    row) and the batched CG solve it is built on."""
    k = rank
    normal = 2 * nb * (2 * d * k * k + 2 * d * k)
    solve_users = spd_cg_cost(n_users + 1, k)["flops"]
    solve_items = spd_cg_cost(n_items + 1, k)["flops"]
    tables = (n_users + 1) * k * 4 + (n_items + 1) * k * 4
    blocks = 2 * (nb * 4 + nb * d * (4 + 4 + 1))
    step = _cost("als", "als_step", normal + solve_users + solve_items, tables + blocks, tables,
                 rank=k, n_users=n_users, n_items=n_items, nb=nb, d=d)
    solve = dict(spd_cg_cost(n_users, k), family="als", kernel="spd_solve_cg")
    return [step, solve], n_users + n_items


def twotower_costs(*, n_users: int = 128, n_items: int = 256, embed_dim: int = 32,
                   hidden: tuple[int, ...] = (64,), out_dim: int = 16, b: int = 32
                   ) -> tuple[list[dict[str, Any]], int]:
    """The two serving towers: an embedding lookup, then the MLP
    (2·in·out a layer and row, plus the bias and activation)."""
    widths = [embed_dim, *hidden, out_dim]
    mlp = sum(2 * a * o + 2 * o for a, o in zip(widths, widths[1:]))
    params = sum(a * o + o for a, o in zip(widths, widths[1:])) * 4
    rows = []
    for name, vocab in (("embed_users", n_users), ("embed_items", n_items)):
        rows.append(_cost("twotower", name, b * mlp, vocab * embed_dim * 4 + params + b * 4,
                          b * out_dim * 4, vocab=vocab, b=b))
    return rows, b


FAMILY_BUILDERS: dict[str, Callable[[], tuple[list[dict[str, Any]], int]]] = {
    "topk": topk_costs,
    "ann": ann_costs,
    "als": als_costs,
    "twotower": twotower_costs,
    "kernels": kernel_costs,
}


# ---------------------------------------------------------------- roofline
def roofline_time_s(cost: dict[str, Any], spec: DeviceSpec) -> dict[str, Any]:
    """Roofline floor for one kernel call on ``spec``: the larger of
    compute time and memory time, with which wall it hit."""
    terms = bound_terms_ms(cost, spec)
    t_memory = terms["bytes"] / 1e3
    t_compute = max(v for name, v in terms.items() if name != "bytes") / 1e3
    return {
        "modelTimeS": max(t_compute, t_memory),
        "boundMs": max(t_compute, t_memory) * 1e3,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "ridgeIntensity": spec.ops_rate(cost["dtype"]) / spec.peak_bytes_per_s,
    }


def analyze(families: list[str] | None = None, device: str | DeviceSpec = DEFAULT_DEVICE
            ) -> dict[str, Any]:
    """The report behind ``pio doctor --roofline``: per-kernel operations,
    bytes, intensity and roofline floor, per-family totals and the floor
    of one query of the family's headline kernel."""
    spec = DEVICE_SPECS[device] if isinstance(device, str) else device
    unknown = [f for f in families or () if f not in FAMILY_BUILDERS]
    if unknown:
        raise ValueError(f"unknown families {unknown}; known: {sorted(FAMILY_BUILDERS)}")
    report: dict[str, Any] = {"device": spec.to_json_dict(), "families": {}, "errors": {}}
    for fam in families or list(FAMILY_BUILDERS):
        kernels, batch = FAMILY_BUILDERS[fam]()
        for cost in kernels:
            cost.update(roofline_time_s(cost, spec))
        total_flops = sum(c["flops"] for c in kernels)
        total_bytes = sum(c["bytesAccessed"] for c in kernels)
        report["families"][fam] = {
            "kernels": kernels,
            "batch": batch,
            "totalFlops": total_flops,
            "totalBytes": total_bytes,
            "arithmeticIntensity": total_flops / max(total_bytes, 1.0),
            "perQueryModelTimeS": kernels[0]["modelTimeS"] / max(batch, 1),
        }
    return report


def bench_fields(families: list[str] | None = None, device: str | DeviceSpec = DEFAULT_DEVICE
                 ) -> dict[str, Any]:
    """Flatten :func:`analyze` into ``roofline_*`` fields: per family, total
    gigaflops and megabytes, intensity and the per-query floor in us."""
    report = analyze(families=families, device=device)
    fields: dict[str, Any] = {"roofline_device": report["device"]["name"]}
    for fam, entry in report["families"].items():
        fields[f"roofline_{fam}_gflops"] = round(entry["totalFlops"] / 1e9, 6)
        fields[f"roofline_{fam}_mbytes"] = round(entry["totalBytes"] / 1e6, 6)
        fields[f"roofline_{fam}_ai"] = round(entry["arithmeticIntensity"], 4)
        fields[f"roofline_{fam}_per_query_us"] = round(entry["perQueryModelTimeS"] * 1e6, 6)
    return fields


__all__ = [
    "DEFAULT_DEVICE",
    "DEVICE_SPECS",
    "DeviceSpec",
    "FAMILY_BUILDERS",
    "als_costs",
    "analyze",
    "ann_costs",
    "attention_cost",
    "bench_fields",
    "bound_ms",
    "bound_terms_ms",
    "kernel_costs",
    "roofline_time_s",
    "spd_cg_cost",
    "topk_costs",
    "twotower_costs",
]
