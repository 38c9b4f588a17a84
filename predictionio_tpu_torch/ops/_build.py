"""Build the port's CUDA kernels with nvcc, and its host library with g++,
and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``). Libraries land in ``build/kernels/`` at the
checkout root, named by a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so an edited source never loads a stale build.

The host library ``csrc/pio_scan.cpp`` (JSONL scan, COO group-by,
cooccurrence top-N; ``utils/native.py``) compiles with ``g++ -O3 -shared
-fPIC -std=c++17`` into ``build/native/``, named by a hash of the source,
the flags and the first line of ``g++ --version``. It builds on the CPU
too: there is no python fallback.

Nothing here runs at import time: the CPU-only test environment has no
nvcc and still imports every module. Every build writes a temporary file
of its own process and renames it into place, so processes building at
once (test workers, ranks, fleet workers) never load half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "native"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.RLock()
_libs: dict[str, ctypes.CDLL] = {}
# the host build's own lock: a g++ build runs beside the nvcc builds
_host_lock = threading.Lock()
_host_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build this process ran
build_logs: dict[str, str] = {}
# nvcc runs of this process: kernel name -> (builds, wall seconds of the
# build() calls that ran them); obs/torchprof.py exports them
build_counts: dict[str, tuple[int, float]] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source on first use"
    )


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> float:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns the wall seconds spent. Holds
    the module lock (re-entrant: ``load`` holds it around this call), so
    two threads never build into one temporary file or update the build
    records at once."""
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((name, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        elapsed = time.perf_counter() - t0
        for name, *_ in jobs:
            n, seconds = build_counts.get(name, (0, 0.0))
            build_counts[name] = (n + 1, seconds + elapsed)
        if failed:
            raise KernelBuildError("kernel build failed: " + "\n".join(failed))
        return elapsed


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise KernelBuildError(
        "g++ not found on PATH: the host library (csrc/pio_scan.cpp) is built "
        "from source on first use"
    )


def host_compiler() -> str:
    """The first line of ``g++ --version``, which names the host build."""
    out = subprocess.run([_gxx(), "--version"], capture_output=True, text=True, check=True)
    return out.stdout.splitlines()[0]


def _host_lib_path(name: str, compiler: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join(HOST_FLAGS).encode())
    digest.update(compiler.encode())  # another compiler's ABI or codegen: another file
    return HOST_BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile_host(name: str, out: Path) -> None:
    if out.exists():
        return
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_gxx(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"host build failed: {name}.cpp (g++ exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_host(name: str) -> float:
    """Compile ``csrc/<name>.cpp`` with g++ unless its library exists.
    Returns the wall seconds spent; a failed build raises with g++'s
    output."""
    with _host_lock:
        t0 = time.perf_counter()
        _compile_host(name, _host_lib_path(name, host_compiler()))
        return time.perf_counter() - t0


def load_host(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cpp``, built on first use."""
    with _host_lock:
        lib = _host_libs.get(name)
        if lib is None:
            path = _host_lib_path(name, host_compiler())
            _compile_host(name, path)
            lib = ctypes.CDLL(str(path))
            _host_libs[name] = lib
        return lib
