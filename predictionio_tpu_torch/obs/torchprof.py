"""Device-side profiling hooks of the port: the kernel-build watcher and
the timed fetch.

Port of ``predictionio_tpu/obs/jaxprof.py``. The JAX module watches jit
caches, because a recompile on the serving path is the TPU server's hidden
cliff. Eager PyTorch has no jit cache; the one compile the port does is the
first-use ``nvcc`` build of a kernel (``ops/_build.py``), which takes
seconds and would stall whichever request first launched the kernel.
:class:`KernelBuildWatcher` exports those builds, so a build inside a
serving process shows on ``/metrics``:

- ``pio_kernel_builds_total{kernel}``: nvcc runs of this process;
- ``pio_kernel_build_seconds_total``: the wall seconds they took.

The JAX families ``pio_jit_cache_misses_total``, ``pio_jit_cache_size``,
``pio_jit_recompile_storm``, ``pio_xla_compile_events_total`` and
``pio_xla_compile_seconds_total`` have no counterpart and are not
registered.

:func:`timed_fetch` is the sanctioned host sync of algorithm code: it
copies a result to the host and accounts the wait into
``pio_device_stall_seconds_total{where}`` and the
``pio_device_fetch_seconds`` histogram (and, while a train profile
records, into the profile's current phase).
"""

from __future__ import annotations

import time
from typing import Any

from predictionio_tpu_torch.obs.metrics import MetricsRegistry

# the JAX families with no counterpart in eager PyTorch
JIT_FAMILIES_NOT_PORTED = (
    "pio_jit_cache_misses_total",
    "pio_jit_cache_size",
    "pio_jit_recompile_storm",
    "pio_xla_compile_events_total",
    "pio_xla_compile_seconds_total",
)


class KernelBuildWatcher:
    """Mirrors ``ops._build.build_counts`` into counters at scrape time
    (register :meth:`sample` as a registry collector)."""

    def __init__(self, registry: MetricsRegistry):
        self._builds = registry.counter(
            "pio_kernel_builds_total",
            "nvcc builds of the port's CUDA kernels in this process (first "
            "use of a kernel whose library is not on disk)",
            labelnames=("kernel",),
        )
        self._seconds = registry.counter(
            "pio_kernel_build_seconds_total",
            "wall seconds of this process's nvcc kernel builds",
        )

    def sample(self) -> None:
        from predictionio_tpu_torch.ops import _build

        total = 0.0
        for name, (n, seconds) in list(_build.build_counts.items()):
            self._builds.set_total(n, kernel=name)
            total += seconds
        self._seconds.set_total(total)


def kernel_launch_counts() -> dict[str, int]:
    """The launch counters of the port's CUDA kernel wrappers (each adds
    one where it launches its kernel): what a device trace's kernel
    events are held against."""
    from predictionio_tpu_torch.ops import attention, spd_solve

    return {
        "spd_cg": spd_solve.batched_spd_solve_fused.launches,
        "attention_block": attention.fused_attention_block.launches,
        "flash_attention": attention.flash_attention.launches,
    }


def _to_host(x: Any) -> Any:
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def timed_fetch(x: Any, registry: MetricsRegistry, where: str = "unspecified") -> Any:
    """Copy ``x`` (a tensor, or a list or tuple of them) to the host and
    account the wait (see the module docstring)."""
    t0 = time.perf_counter()
    out = _to_host(x)
    elapsed = time.perf_counter() - t0
    from predictionio_tpu_torch.obs import xray

    prof = xray.current_profile()
    if prof is not None:
        prof.note_device_time(elapsed)
    registry.counter(
        "pio_device_stall_seconds_total",
        "cumulative seconds spent blocked on device->host synchronization",
        labelnames=("where",),
    ).inc(elapsed, where=where)
    registry.histogram(
        "pio_device_fetch_seconds",
        "device->host fetch stall durations",
    ).observe(elapsed)
    return out


__all__ = ["JIT_FAMILIES_NOT_PORTED", "KernelBuildWatcher", "kernel_launch_counts", "timed_fetch"]
