"""The reduction of a profiler trace: launch correlation into hooked
ranges, the union of device intervals, idle gaps named by the host."""

from __future__ import annotations

import pytest

from portbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 1000),
    ev("user_annotation", "pb:models.x.Block", 10, 100),
    ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=2),
    ev("user_annotation", "pb:models.x.Conv", 200, 50),
    ev("cuda_runtime", "cudaLaunchKernel", 210, 5, corr=3),
    ev("cpu_op", "aten::copy_", 300, 400),
    ev("cuda_runtime", "cudaMemcpyAsync", 310, 5, corr=4),
    ev("cuda_runtime", "cudaLaunchKernel", 800, 5, corr=5),
    ev("kernel", "k_block_a", 30, 100, tid=7, corr=1),
    ev("kernel", "k_block_b", 100, 100, tid=7, corr=2),   # overlaps a
    ev("kernel", "k_conv", 220, 40, tid=7, corr=3),
    ev("gpu_memcpy", "Memcpy HtoD", 320, 80, tid=8, corr=4),
    ev("kernel", "k_outside", 810, 500, tid=7, corr=5),   # past the window
    ev("kernel", "k_unknown", 900, 10, tid=7, corr=99),
]


def test_reduce_attributes_unions_and_names_gaps():
    t = trace.reduce(EVENTS)
    us = 1e-6
    assert t.window_s == pytest.approx(1000 * us)
    # union: [30, 200) + [220, 260) + [320, 400) + [810, 1000) clipped
    assert t.busy_s == pytest.approx((170 + 40 + 80 + 190) * us)
    assert t.kernels == 5
    assert t.memcpy_s == pytest.approx(80 * us)
    assert t.layer_s["models.x.Block"] == pytest.approx(200 * us)
    assert t.layer_s["models.x.Conv"] == pytest.approx(40 * us)
    assert t.unattributed == 1
    assert t.device_ops[0] == ["k_outside", pytest.approx(500 * us)]
    idle = dict(t.idle_gaps)
    # gaps [0,30) [200,220) [260,320) [400,810), each named by the
    # innermost host event at its middle
    assert idle["pb:models.x.Block"] == pytest.approx(30 * us)
    assert idle["cudaLaunchKernel"] == pytest.approx(20 * us)
    assert idle["host outside any recorded op"] == pytest.approx(60 * us)
    assert idle["aten::copy_"] == pytest.approx(410 * us)


def test_reduce_without_a_window_is_none():
    assert trace.reduce(EVENTS[1:]) is None
