"""The traced run: ranges opened by module hooks, a ``torch.profiler``
trace of the card, and its reduction to what the per-layer metrics read.

A hooked module's forward runs inside a ``record_function`` range named
``pb:<module>``. Each device event (kernel, copy, memset) is tied through
the profiler's launch correlation to the host call that launched it; a
device event whose launch falls inside a range counts for that range's
module. No kernel names are used, so a renamed or split kernel keeps its
layer.
"""

from __future__ import annotations

import bisect
import json
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "pb:window"
PREFIX = "pb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class RangeHooks:
    """Forward hooks that open a ``pb:<label>`` range around each call of
    the modules whose ``module.qualname`` ends with a label, and record
    each call's module name, input shapes and keyword tensors' shapes."""

    def __init__(self, model, labels: list[str]):
        import torch

        self._rf = torch.profiler.record_function
        self.calls: dict[str, list] = defaultdict(list)
        self.forward_pixels = 0
        self._open: list = []
        self._handles = [model.register_forward_pre_hook(self._count)]
        for qname, mod in model.named_modules():
            path = f"{type(mod).__module__}.{type(mod).__qualname__}"
            for label in labels:
                if path.endswith(label):
                    self._handles += [
                        mod.register_forward_pre_hook(
                            self._enter(label, qname), with_kwargs=True),
                        mod.register_forward_hook(self._exit,
                                                  with_kwargs=True)]

    def _count(self, mod, args):
        b, h, w = args[0].shape[:3]
        self.forward_pixels += b * h * w

    def _enter(self, label, qname):
        def hook(mod, args, kwargs):
            rf = self._rf(PREFIX + label)
            rf.__enter__()
            self._open.append(rf)
            kw = {k: tuple(v.shape) for k, v in kwargs.items()
                  if hasattr(v, "shape")}
            self.calls[label].append((qname, tuple(args[0].shape), kw))
        return hook

    def _exit(self, mod, args, kwargs, out):
        self._open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self._handles:
            h.remove()


def profile(fn, device_kind: str):
    """Run ``fn`` inside a ``pb:window`` range under ``torch.profiler``
    (the card's activity too where there is one) and return (fn's result,
    the trace's events)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device_kind == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
        if device_kind == "cuda":
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, events


@dataclass
class Trace:
    """A traced window, in seconds."""

    window_s: float
    busy_s: float
    kernels: int
    memcpy_s: float
    layer_s: dict = field(default_factory=dict)  # label -> device seconds
    unattributed: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_names(host, points):
    """The innermost host event holding each time in ``points`` (sorted),
    or None."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    names, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        # a popped-out outer event can sit under a finished inner one
        inner = next((e for e in reversed(stack) if e[1] > t), None)
        names.append(inner[2] if inner else None)
    return names


def reduce(events: list[dict], top: int = 10) -> Trace | None:
    """Reduce a chrome trace to a :class:`Trace` (None without a window
    range)."""
    win = next((e for e in events if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        return None
    w0, w1, tid = win["ts"], win["ts"] + win["dur"], win.get("tid")
    launches, ranges, host, dev = {}, defaultdict(list), [], []
    for e in events:
        cat, ph = e.get("cat"), e.get("ph")
        if ph != "X":
            continue
        if cat in DEVICE_CATS:
            if e["ts"] < w1 and e["ts"] + e["dur"] > w0:
                dev.append(e)
            continue
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
        if cat == "user_annotation" and e["name"].startswith(PREFIX) \
                and e["name"] != WINDOW:
            ranges[e["name"][len(PREFIX):]].append((e["ts"],
                                                    e["ts"] + e["dur"]))
        if cat in HOST_CATS and e.get("tid") == tid and e is not win:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    starts = {k: sorted(v) for k, v in ranges.items()}
    keys = {k: [s for s, _ in v] for k, v in starts.items()}
    layer = defaultdict(float)
    by_name = defaultdict(float)
    unattributed = 0
    for e in dev:
        by_name[e["name"]] += e["dur"]
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            unattributed += 1
            continue
        for k, iv in starts.items():
            j = bisect.bisect_right(keys[k], t) - 1
            if j >= 0 and iv[j][0] <= t <= iv[j][1]:
                layer[k] += e["dur"]
                break
    busy = _union((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in dev)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    names = _host_names(host, sorted((a + b) / 2 for a, b in gaps))
    idle = defaultdict(float)
    for (a, b), n in zip(sorted(gaps, key=lambda g: g[0] + g[1]), names):
        idle[n or "host outside any recorded op"] += b - a
    us = 1e-6
    return Trace(
        window_s=(w1 - w0) * us,
        busy_s=sum(e - s for s, e in busy) * us,
        kernels=sum(1 for e in dev if e["cat"] == "kernel"),
        memcpy_s=sum(e["dur"] for e in dev if e["cat"] == "gpu_memcpy") * us,
        layer_s={k: v * us for k, v in layer.items()},
        unattributed=unattributed,
        device_ops=[[n[:120], v * us] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n[:120], v * us] for n, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]])
