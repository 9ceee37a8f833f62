"""The control, the plain reference in TF32 put in the program's place,
comes out not correct under every cell's limits, at the cells' own widths
and at image sizes a test run can hold; the program itself passes there.
On the CPU TF32 is emulated (operands rounded to 10 mantissa bits); the
``gpu`` case uses the card's own TF32."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO
from portbench import check, control, harness

# one small request per image of the pool (bucketed to one 128 canvas)
SMALL = {"swinir_m_x4.sr_1080p": [dict(h=48, w=64, weight=1)],
         "restormer_deblur.frames_720p": [dict(h=96, w=128, weight=1)]}
SEED = 2 ** 35 + 99


def readings(workload, device, program=True):
    from image_restoration_agent_tpu_torch.engine import Engine

    cell = harness.load_cell(REPO, workload)
    cell.mix = dict(cell.mix, sizes=SMALL[workload], pool=1)
    ref = harness.reference_module(REPO, cell.config["reference"])
    shapes = harness.param_shapes(ref, cell.config["arch"])
    engine = Engine(device=device, param_dtype=torch.float32)
    return cell, control.read_seed(cell, ref, shapes, engine, SEED, device,
                                   program=program, control=True)


def limits(workload):
    return json.loads((REPO / "portbench" / "checks" /
                       f"{workload}.json").read_text())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_and_program_passes_on_the_cpu(workload):
    torch.set_num_threads(4)
    cell, got = readings(workload, torch.device("cpu"))
    ok_ctl, shown = check.verdict(got["control"], limits(workload))
    assert not ok_ctl, shown
    ok_prog, shown = check.verdict(got["program"], limits(workload))
    assert ok_prog, shown


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails_on_the_card(cuda, workload):
    cell, got = readings(workload, cuda)
    assert not check.verdict(got["control"], limits(workload))[0]
    assert check.verdict(got["program"], limits(workload))[0]
