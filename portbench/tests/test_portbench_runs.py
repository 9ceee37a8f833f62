"""Whole runs of the harness on the CPU at tiny widths: the reference
agrees with the program's CPU path (band, whole and tiled requests), a
configuration, a mix and a metric dropped in as new files are found and
run, and a run with the timed path broken underneath comes out not
correct, once for each fault a serving cell can have."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from conftest import REPO, tiny_configs, write_cell
from portbench import harness

SEED = 2 ** 40 + 17


def run(root, workload, tamper=None, trace=False, seconds=1.0):
    return harness.run_cell(root, workload, SEED, seconds, trace,
                            device="cpu", tamper=tamper)


@pytest.mark.parametrize("workload", ["tsw.band", "trs.tiles"])
def test_reference_agrees_with_the_programs_cpu_path(tiny_root, workload):
    r = run(tiny_root, workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 2 and r["failed"] == 0
    assert r["checks"]["mismatch_pct"]["value"] < 0.05
    assert r["info"]["reference_unsaturated_pct"] > 50.0
    assert set(r["metrics"]) == {"mp_per_s", "setup_s"}  # no card: no peak
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_hooked_counts(tiny_root):
    r = run(tiny_root, "trs.tiles", trace=True)
    assert r["correct"]
    # 60x90 whole on a 128x128 canvas, 120x150 as 15 tiles of 64 on a
    # 128x256 canvas, in the seeded order
    ratio = r["metrics"]["tiling.work_ratio"]["value"]
    assert ratio > 1.0
    assert "breakdown" in r and r["device"]["window_s"] > 0
    # the CPU has no device trace: no device metric is reported
    assert "device.idle_pct" not in r["metrics"]
    assert "engine.copy_ms_per_mp" not in r["metrics"]


def test_new_config_mix_and_metric_are_found_as_files(tiny_root):
    pb = tiny_root / "portbench"
    (pb / "metrics" / "request.count_new.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append(dict(name="request.count_new", unit="1",
                                    better="higher", bound=0.05,
                                    source="host_clock"))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = tiny_configs()["restormer"]
    cfg["registry"] = "restormer_tiny"
    cfg["serving"].update(max_size=None, whole_pad_multiple=1)
    write_cell(tiny_root, "tnew.mix", "tnew", "t_new_mix", cfg,
               dict(sizes=[dict(h=72, w=64, weight=3)], pool=1,
                    content=dict(grid=8, shapes=3), degrade=None,
                    trace_requests=2))
    cell = harness.load_cell(tiny_root, "tnew.mix")
    assert cell.mix["sizes"][0]["weight"] == 3
    r = run(tiny_root, "tnew.mix")
    assert r["correct"], r["checks"]
    assert r["metrics"]["request.count_new"]["value"] == r["attempted"]


def _blocks(model, cls):
    return [m for m in model.modules() if type(m).__name__ == cls]


def identity_step(engine, model):
    """A step that returns its state unchanged: one Restormer block gives
    back its input."""
    blk = _blocks(model, "TransformerBlock")[2]
    blk.forward = lambda x: x


def identity_swin_step(engine, model):
    blk = _blocks(model, "SwinBlock")[1]
    blk.forward = lambda x, in_frame=0: (x, in_frame)


def half_batch(engine, model):
    """Half of each batch of tiles left out, the mean of the rest in its
    place."""
    fwd = model.forward

    def forward(x, *a, **k):
        n = x.shape[0]
        if n < 2:
            return fwd(x, *a, **k)
        y = fwd(x[: (n + 1) // 2], *a, **k)
        rest = y.mean(0, keepdim=True).expand(n - y.shape[0], *y.shape[1:])
        return torch.cat([y, rest])

    model.forward = forward


def altered_answer(engine, model):
    """An answer altered where it is produced: the model's output raised
    by three levels in one 32 x 32 patch of its first image."""
    fwd = model.forward

    def forward(x, *a, **k):
        y = fwd(x, *a, **k).clone()
        y[0, :32, :32] += 3.0 / 255.0
        return y

    model.forward = forward


@pytest.mark.parametrize("workload,fault", [
    ("trs.tiles", identity_step), ("tsw.band", identity_swin_step),
    ("trs.tiles", half_batch), ("trs.tiles", altered_answer),
    ("tsw.band", altered_answer)])
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, fault):
    r = run(tiny_root, workload, tamper=fault)
    assert r["attempted"] >= 2
    assert not r["correct"], r["checks"]


def test_a_request_that_raises_is_not_correct(tiny_root):
    def broken(engine, model):
        fwd, calls = model.forward, []

        def forward(x, *a, **k):
            calls.append(1)
            if len(calls) > 8:     # past the warm-up's forwards
                raise RuntimeError("planted")
            return fwd(x, *a, **k)
        model.forward = forward

    r = run(tiny_root, "trs.tiles", tamper=broken)
    assert r["failed"] > 0 and not r["correct"]
    assert r["checks"]["bad_answers"]["value"] == r["failed"]


def test_run_py_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "restormer_deblur.frames_720p", "--seed", str(SEED), "--seconds",
         "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert p.returncode != 0 and p.stdout == ""
