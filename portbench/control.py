"""Readings that set a cell's limits (``portbench/checks/<workload>.json``).

    python3 portbench/control.py --workload <name> --seeds <n> ... \\
        [--control-seeds <n> ...]

For each seed, as a run sets it up (weights, input pool), the program
answers one request of every image of the pool, and the numbers of
:mod:`portbench.check` are read against the float32 reference: the lower
readings. For each control seed, the control, the reference computed in
TF32 (the nearest precision below the configuration's), is put in the
program's place and read the same way: the upper readings. One JSON line
per seed and kind. Runs on the card; not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def read_seed(cell, ref, shapes, engine, seed: int, device,
              program: bool = True, control: bool = False) -> dict:
    """{"program": readings, "control": readings} for one seed (each where
    asked), every image of the pool answered once."""
    from portbench import check, harness, traffic, weights

    cfg, mix = cell.config, cell.mix
    state = weights.make_state(shapes, cfg.get("gains", {}), seed, device)
    pool = traffic.make_pool(mix, seed, device)
    keys = [(hw, k) for hw in traffic.sizes(mix) for k in range(mix["pool"])]
    want = harness.reference_answers(cell, ref, state, pool, keys, device)
    out = {}
    if program:
        engine.set_weights(cfg["registry"], state)
        got = {key: engine.restore_array(pool[key[0]][key[1]],
                                         cfg["registry"]).image
               for key in keys}
        out["program"] = check.readings([(got[k], want[k]) for k in keys], 0,
                                        device)
    if control:
        got = harness.reference_answers(cell, ref, state, pool, keys, device,
                                        prec="tf32")
        out["control"] = check.readings([(got[k], want[k]) for k in keys], 0,
                                        device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    import torch

    from portbench import harness
    from image_restoration_agent_tpu_torch.engine import Engine

    dev = torch.device(args.device)
    cell = harness.load_cell(root, args.workload)
    ref = harness.reference_module(root, cell.config["reference"])
    shapes = harness.param_shapes(ref, cell.config["arch"])
    engine = Engine(device=dev, param_dtype=torch.float32)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        got = read_seed(cell, ref, shapes, engine, seed, dev,
                        program=seed in args.seeds,
                        control=seed in args.control_seeds)
        for kind, read in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **read,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
