"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers: a
build takes seconds, not minutes). Builds happen at first use, on the
machine with the card, into ``csrc/build/`` (listed in ``.gitignore``),
keyed by a hash of the sources and flags so a changed source rebuilds.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.

Every kernel function returns ``cudaGetLastError()``; :func:`check` raises
when it is not 0, so a refused launch (too many threads, too
much shared memory) is never mistaken for a result.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("swin_block", "conv3x3", "restormer_fused", "roll2d",
           "conv3x3_pair", "swin_pair")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

# the N widths K1's and K3's bf16 kernels are instantiated for
# (csrc/sm90_gemm.cuh: IRK_GEMM_WIDTHS); a slice runs at the first >= it
GEMM_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128, 184, 192, 256)
# shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448


class LaunchPlan(NamedTuple):
    """How a bf16 K1 or K3 launch covers its output: ``grid`` blocks of
    ``threads``; the output columns as ``slices`` slices of ``ns`` (an
    instantiated wgmma width); a ring of ``stages`` shared-memory stages;
    ``smem`` bytes of shared memory a block; ``chunk`` the 64-k blocks of
    K an A stage of K1 holds (0 where the kernel has no such stage)."""

    grid: int
    threads: int
    slices: int
    ns: int
    stages: int
    smem: int
    chunk: int = 0


def gemm_width(n: int) -> int:
    """The instantiated wgmma width a slice of ``n`` columns runs at."""
    for w in GEMM_WIDTHS:
        if w >= n:
            return w
    raise ValueError(f"no wgmma width holds {n} columns (at most 256)")


def gemm_slices(n: int) -> tuple[int, int]:
    """(slices, width): ``n`` columns as the fewest equal slices of at
    most 256 columns, each at its instantiated width."""
    k = -(-n // 256)
    return k, gemm_width(-(-n // k))


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, subprocess.Popen] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc


def _finish(name: str, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel (one nvcc each); return
    {name: compiler log} (``-Xptxas -v`` register and spill figures)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        for name, job in started.items():
            if job is not None:
                _finish(name, *job)
    return {n: build_log(n) for n in SOURCES}


def build_log(name: str) -> str:
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            job = _start(name)
            if job is not None:
                _finish(name, *job)
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def sm_count(device) -> int:
    """Streaming multiprocessors of the card holding ``device``."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")
