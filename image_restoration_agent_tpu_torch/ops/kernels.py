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
SOURCES = ("swin_block", "window_attention", "conv3x3", "restormer_fused",
           "roll2d", "conv3x3_pair", "swin_pair")
# ptxas compiles a source's kernels on as many threads as there are cores
# (--split-compile=0): the longest source, csrc/swin_block.cu, builds alone
# in 73 s instead of 118, its ptxas 20 s instead of 66 (profile_build.py)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-Xptxas", "--split-compile=0", "-lineinfo"]

# the N widths K1's and K3's bf16 kernels are instantiated for
# (csrc/sm90_gemm.cuh: IRK_GEMM_WIDTHS); a slice runs at the first >= it
GEMM_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128, 184, 192, 256)
# the N widths of the split-TF32 float32 kernels of K1 and K3
# (csrc/sm90_gemm.cuh: IRK_TF32_WIDTHS)
TF32_WIDTHS = (8, 16, 32, 48, 64, 96, 128)
# shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232448
# streaming multiprocessors of the H100 SXM (the plans' default)
H100_SMS = 132


class LaunchPlan(NamedTuple):
    """How a K1 or K3 launch covers its output: ``grid`` blocks of
    ``threads``; the output columns as ``slices`` slices of ``ns`` (an
    instantiated wgmma width); a ring of ``stages`` shared-memory stages;
    ``smem`` bytes of shared memory a block; ``chunk`` the 64-k blocks of
    K an A stage of the bf16 K1 holds (0 where the kernel has no such
    stage); ``tile`` the columns of the float32 K3's 128-pixel tile (0
    elsewhere) and ``split`` its K parts (1: no split)."""

    grid: int
    threads: int
    slices: int
    ns: int
    stages: int
    smem: int
    chunk: int = 0
    tile: int = 0
    split: int = 1


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


def tf32_width(n: int) -> int:
    """The split-TF32 width a float32 slice of ``n`` columns runs at."""
    for w in TF32_WIDTHS:
        if w >= n:
            return w
    raise ValueError(f"no TF32 width holds {n} columns (at most 128)")


def tf32_slices(n: int, widest: int = 128) -> tuple[int, int]:
    """(slices, width) of a float32 K1 or K3 for ``n`` output columns:
    equal slices of at most ``widest`` columns, among the fewest slice
    counts that fit and the next two the one with the fewest padded
    columns plus 32 a slice (each slice stages and splits its A again),
    then the fewest slices (540 as 6 x 96, 1280 as 10 x 128, 180 as 2 x
    96, 48 as 1 x 48)."""
    k0 = -(-n // widest)
    return min(((k * (tf32_width(-(-n // k)) + 32), k,
                 tf32_width(-(-n // k))) for k in range(k0, k0 + 3)))[1:]


def tf32_round(x):
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds:
    nearest, ties away from zero, the low 13 mantissa bits zero."""
    bits = x.contiguous().view(_torch().int32)
    return ((bits + 0x1000) & -8192).view(_torch().float32)


def tf32_split(w) -> list:
    """The split-TF32 parts of a weight, in float32: ``[wh]`` where ``w`` is
    TF32-exact (bf16 or fp16 weights by their type, with no pass over
    them; float32 weights holding bf16-rounded values), else ``[wh, wl]``
    with ``wh = tf32_round(w)`` and ``wl = w - wh``, exact in float32, so
    that ``wh + wl == w`` bit for bit."""
    torch = _torch()
    if w.dtype in (torch.bfloat16, torch.float16):
        return [w.float()]
    w = w.float()
    wh = tf32_round(w)
    wl = w - wh
    # a meta tensor (a traced model) has no values: both parts
    return [wh, wl] if w.is_meta or bool(wl.any()) else [wh]


def split_passes(parts: int, a_low: bool = True) -> int:
    """TF32 products a split-TF32 k step issues: ``xh wh``, ``xl wh`` where
    the activations have a low part, ``xh wl`` where the weights do."""
    return 1 + int(a_low) + int(parts == 2)


def _torch():
    import torch
    return torch


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


def function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, its
    prototype (``argtypes``, an int return) set at its first use: a
    wrapper's launch then does no ctypes set-up of its own."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def stream(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device (no
    ``torch.cuda.Stream`` object made)."""
    return _torch()._C._cuda_getCurrentRawStream(t.get_device())


def sm_count(device) -> int:
    """Streaming multiprocessors of the card holding ``device``."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")
