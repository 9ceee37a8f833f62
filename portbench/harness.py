"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the metrics.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- the configuration's file (``configs[].file``): the registry name the
  program serves, the ``reference`` module of ``portbench/reference/``, its
  ``arch`` (the published constructor arguments), ``serving`` (the request
  semantics the reference works out again), ``gains`` (weight scales) and
  ``kernel_sources`` (the CUDA sources the cell's path loads);
- the traffic mix, ``portbench/traffic/<traffic>.json`` (:mod:`.traffic`);
- the limits of the check, ``portbench/checks/<workload>.json``;
- each metric's reader, ``portbench/metrics/<metric>.py``: ``read(run)``
  returns the number or None, and a per-layer reader that prices a module
  names it in ``MODULE`` and gives ``cost(call, run) -> (flop, bytes)``.

The program is the PyTorch and CUDA package; the harness drives its served
entry, ``Engine.restore_array``, and reads nothing else of it but the
module structure its hooks attach to.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable

from . import check, traffic, weights
from . import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "image_restoration_agent_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    reference: ModuleType
    requests: list = field(default_factory=list)  # (h, w, t0, t1, due, ok)
    window_s: float = 0.0
    setup_s: float = 0.0
    window_peak_bytes: int = 0
    trace: tracing.Trace | None = None
    hooks: tracing.RangeHooks | None = None
    shapes: dict = field(default_factory=dict)    # weight name -> shape
    peak: dict | None = None                      # card peaks (costs.PEAKS)

    @property
    def input_mp(self) -> float:
        return sum(r[0] * r[1] for r in self.requests if r[5]) / 1e6


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str) -> ModuleType:
    key = "portbench.metrics." + metric.replace(".", "__")
    if key in sys.modules:
        return sys.modules[key]
    return load_module(root / "portbench" / "metrics" / f"{metric}.py", key)


def reference_module(root: Path, name: str) -> ModuleType:
    key = f"portbench.reference.{name}"
    if key in sys.modules:
        return sys.modules[key]
    return load_module(root / "portbench" / "reference" / f"{name}.py", key)


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(x for x in bench["configs"] if x["name"] == w["config"])

    def listed(m):
        return m.get("workloads") is None or workload in m["workloads"]

    pb = root / "portbench"
    return Cell(
        name=workload,
        config=json.loads((root / c["file"]).read_text()),
        mix=json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((pb / "checks" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if listed(m)],
        per_layer=[m for m in bench["per_layer"] if listed(m)])


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that this process must not hold,
    compared whole (the program's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _window(engine, model, pool, sched, arr, seconds, limit, sync):
    """The closed (or open) loop: issue requests until ``seconds`` have
    passed and a deck of the mix is complete (or ``limit`` requests), each
    answer kept for the check."""
    requests, outputs, errors = [], [], []
    # the collector stays on, as it is in the served process: only what
    # set-up left behind is collected before the clock starts
    gc.collect()
    t_start = time.perf_counter()
    deck_done = True
    for (hw, k, last), due in zip(sched, arr):
        now = time.perf_counter() - t_start
        if limit and len(requests) >= limit:
            break
        if now >= seconds and deck_done:
            break
        deck_done = last
        if due > now:
            time.sleep(due - now)
        t0 = time.perf_counter() - t_start
        try:
            res = engine.restore_array(pool[hw][k], model)
            image, ok = res.image, True
        except (RuntimeError, ValueError, TypeError, KeyError) as e:
            image, ok = None, False
            errors.append(repr(e))
        t1 = time.perf_counter() - t_start
        requests.append((hw[0], hw[1], t0, t1, due, ok))
        outputs.append((hw, k, image))
    sync()
    return requests, outputs, errors, time.perf_counter() - t_start


def _latencies(requests) -> dict:
    """{"HxW": [p10, p50, p90, max] seconds} of the window's requests."""
    by = {}
    for h, w, t0, t1, _, ok in requests:
        if ok:
            by.setdefault(f"{h}x{w}", []).append(t1 - t0)
    out = {}
    for k, v in by.items():
        v.sort()
        out[k] = [v[int(q * (len(v) - 1))] for q in (0.1, 0.5, 0.9, 1.0)]
    return out


def reference_answers(cell: Cell, ref_mod, state, pool, keys, device,
                      prec: str = "float32") -> dict:
    """{(hw, k): uint8 answer} of the plain reference for each request."""
    import torch

    from .reference import ops, serve

    net = ref_mod.build(cell.config["arch"]).to(device)
    net.load_state_dict({k: v.to(device) for k, v in state.items()},
                        strict=True)
    answers = {}
    with torch.no_grad(), ops.precision(prec):
        for hw, k in keys:
            answers[(hw, k)] = serve.restore(
                pool[hw][k], cell.config["serving"],
                lambda x: net(x, prec), device)
    del net
    return answers


def param_shapes(ref_mod, arch: dict) -> dict:
    """{name: shape} of the reference's parameters, in order (built on the
    host with uninitialised storage)."""
    return {k: tuple(p.shape)
            for k, p in ref_mod.build(arch).named_parameters()}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             tamper: Callable | None = None, t_process: float | None = None,
             log=sys.stderr) -> dict:
    """One run; returns the result object (see README) with
    ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and,
    traced, ``breakdown``; ``checks`` comes last."""
    import torch

    from . import costs

    t_process = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cell = load_cell(root, workload)
    cfg, mix = cell.config, cell.mix
    ref_mod = reference_module(root, cfg["reference"])
    parts = {}

    t = time.perf_counter()
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.ops import kernels
    parts["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if cuda:
        for src in cfg.get("kernel_sources", []):
            kernels.load(src)
    parts["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    shapes = param_shapes(ref_mod, cfg["arch"])
    state = weights.make_state(shapes, cfg.get("gains", {}), seed, dev)
    engine = Engine(device=dev, param_dtype=torch.float32)
    engine.set_weights(cfg["registry"], state)
    model = engine.store.get(cfg["registry"])
    if tamper is not None:
        tamper(engine, model)
    sync()
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pool = traffic.make_pool(mix, seed, dev)
    parts["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    for hw in traffic.sizes(mix):
        engine.restore_array(pool[hw][0], cfg["registry"])
    sync()
    parts["warmup_s"] = time.perf_counter() - t
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = time.perf_counter() - t_process

    run = Run(cell=cell, reference=ref_mod, setup_s=setup_s, shapes=shapes)
    run.peak = costs.peaks(torch.cuda.get_device_name(dev)) \
        if cuda else None
    sched, arr = traffic.schedule(mix, seed), traffic.arrivals(mix, seed)
    labels = {getattr(reader(root, m["name"]), "MODULE", None)
              for m in cell.per_layer} - {None} if trace else set()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def go(limit):
        return _window(engine, cfg["registry"], pool, sched, arr, seconds,
                       limit, sync)

    if trace:
        run.hooks = tracing.RangeHooks(model, sorted(labels))
        try:
            (requests, outputs, errors, window_s), events = tracing.profile(
                lambda: go(mix.get("trace_requests")), dev.type)
        finally:
            run.hooks.remove()
        run.trace = tracing.reduce(events)
        del events
    else:
        requests, outputs, errors, window_s = go(None)
    run.requests, run.window_s = requests, window_s
    run.window_peak_bytes = torch.cuda.max_memory_allocated() \
        if cuda else 0
    peak_bytes = max(setup_peak, run.window_peak_bytes)

    # the program's state goes before the reference runs on the card
    del engine, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    keys = sorted({(hw, k) for hw, k, img in outputs if img is not None})
    answers = reference_answers(cell, ref_mod, state, pool, keys, dev)
    pairs = [(img, answers[(hw, k)]) for hw, k, img in outputs
             if img is not None]
    read = check.readings(pairs, bad=sum(1 for r in requests if not r[5]),
                          device=dev)
    check_s = time.perf_counter() - t
    correct, shown = check.verdict(read, cell.limits)
    correct = correct and bool(requests) and read["values"] > 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(root, m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": correct, "attempted": len(requests),
        "failed": sum(1 for r in requests if not r[5]),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else dev.type),
                   "count": 1, "memory_peak_bytes": int(peak_bytes)}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
        result["trace_unattributed_events"] = run.trace.unattributed
    result["setup_parts"] = parts
    result["request_s"] = _latencies(requests)
    result["check_s"] = check_s
    result["info"] = {k: read[k] for k in ("max_level_diff",
                                           "reference_unsaturated_pct")}
    result["errors"] = errors[:3]
    result["checks"] = shown
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    return result
