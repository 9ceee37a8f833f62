"""Seconds that ``nvcc`` takes on the kernel sources under
``image_restoration_agent_tpu_torch/csrc/``, on the machine with the card.

    python3 profile_build.py                     # each source alone
    python3 profile_build.py --parallel          # all at once, as build_all
    python3 profile_build.py --base swin_block   # ptxas on one thread

Each named source (default: every one in ``ops/kernels.SOURCES``) is
compiled with the build's flags (``ops/kernels.NVCC_FLAGS``) into a
temporary directory, one after another or, with ``--parallel``, all
started together as :func:`kernels.build_all` starts them. ``--base`` drops
ptxas's ``--split-compile`` (one thread a source). Each compile's phase
times (``nvcc --time``: cicc, ptxas, ...) are printed with its seconds,
one JSON line a source; a compile still running after ``--timeout``
seconds is killed and reported as such. Needs nvcc, not the card.
"""

from __future__ import annotations

import argparse
import csv
import json
import subprocess
import tempfile
import time
from pathlib import Path

from image_restoration_agent_tpu_torch.ops import kernels


def flags(base: bool) -> list[str]:
    out = list(kernels.NVCC_FLAGS)
    if base:
        i = out.index("--split-compile=0")
        del out[i - 1:i + 1]
    return out


def phases(path: Path) -> dict:
    """nvcc --time's CSV: {phase: ms}, summed over its rows."""
    out: dict = {}
    if not path.exists():
        return out
    with path.open() as f:
        for row in csv.reader(f):
            if len(row) > 6 and row[-1].strip() == "ms":
                name = row[1].strip()
                out[name] = out.get(name, 0.0) + float(row[-2])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(kernels.SOURCES))
    ap.add_argument("--parallel", action="store_true")
    ap.add_argument("--base", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    nvcc = kernels._nvcc()
    with tempfile.TemporaryDirectory(prefix="profile_build_") as td:
        tmp = Path(td)

        def start(name: str) -> subprocess.Popen:
            cmd = [nvcc, *flags(args.base), "--time", str(tmp / f"{name}.csv"),
                   "-o", str(tmp / f"{name}.so"),
                   str(kernels.CSRC / f"{name}.cu")]
            return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True)

        def report(name: str, p: subprocess.Popen, t0: float) -> None:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, args.timeout - (time.perf_counter() - t0)))
                rc = p.returncode
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate()
                rc, err = "killed", ""
            print(json.dumps({
                "source": f"csrc/{name}.cu", "rc": rc,
                "seconds": time.perf_counter() - t0,
                "parallel": args.parallel, "ptxas_threads":
                    1 if args.base else "all", "phases_ms": phases(
                        tmp / f"{name}.csv"), "error": err[-400:] if rc
                else ""}), flush=True)

        if args.parallel:
            t0 = time.perf_counter()
            procs = {n: start(n) for n in args.names}
            for name, p in procs.items():
                report(name, p, t0)
        else:
            for name in args.names:
                t0 = time.perf_counter()
                report(name, start(name), t0)


if __name__ == "__main__":
    main()
