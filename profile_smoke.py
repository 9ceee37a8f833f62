"""``chip_smoke.py`` under a stack sampler: where its seconds go.

    python3 profile_smoke.py [--out samples.json] [--every 0.2]

Runs ``chip_smoke.main()`` (no arguments: the whole run, on the card)
while a thread reads the main thread's stack every ``--every`` seconds
and counts, by phase (the ``name`` of chip_smoke's ``phase`` frame; "-"
outside one): the innermost ``chip_smoke.py`` line, the innermost frame
of the port package and the leaf frame. Each count times ``--every`` is
seconds. Writes {"phase" | "cs" | "pkg" | "leaf": [[key, count], ...]}
to ``--out`` (keys "phase|frame"), and exits with chip_smoke's code; its
output is chip_smoke's own. The sampler holds the interpreter's lock for
a few microseconds a sample.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading

PKG = "image_restoration_agent_tpu_torch/"


def sample(main_id: int, every: float, stop: threading.Event,
           counts: dict) -> None:
    while not stop.wait(every):
        f = sys._current_frames().get(main_id)
        stack = []
        while f is not None:
            stack.append(f)
            f = f.f_back
        phase, cs, pkg = "-", None, None
        for fr in stack:
            path, name = fr.f_code.co_filename, fr.f_code.co_name
            if cs is None and path.endswith("chip_smoke.py"):
                cs = f"{name}:{fr.f_lineno}"
            if pkg is None and PKG in path:
                pkg = f"{path.split(PKG)[-1]}:{name}"
            if name == "phase" and path.endswith("chip_smoke.py"):
                phase = fr.f_locals.get("name", "-")
                break
        leaf = (f"{stack[0].f_code.co_filename.split('/')[-1]}:"
                f"{stack[0].f_code.co_name}") if stack else "-"
        counts["phase"][phase] += 1
        counts["cs"][f"{phase}|{cs}"] += 1
        counts["pkg"][f"{phase}|{pkg}"] += 1
        counts["leaf"][f"{phase}|{leaf}"] += 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="samples.json")
    ap.add_argument("--every", type=float, default=0.2)
    args = ap.parse_args()
    sys.argv = [sys.argv[0]]  # chip_smoke's own parser: the whole run
    import chip_smoke

    counts = {k: collections.Counter()
              for k in ("phase", "cs", "pkg", "leaf")}
    stop = threading.Event()
    t = threading.Thread(target=sample, daemon=True, args=(
        threading.get_ident(), args.every, stop, counts))
    t.start()
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        t.join()
        with open(args.out, "w") as f:
            json.dump({k: v.most_common() for k, v in counts.items()}, f)


if __name__ == "__main__":
    sys.exit(main())
