"""The FLOP and byte counters against hand counts and against
``torch.utils.flop_counter`` on the plain references at tiny widths."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import REPO, tiny_configs
from portbench import costs, harness

SW = tiny_configs()["swin"]["arch"]
RS = tiny_configs()["restormer"]["arch"]


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_hand_counts():
    # SwinIR-M: qkv 180x540, proj 180x180, fc1 / fc2 180x360, attention
    # over 64 keys: 2 * 180 * 1440 + 4 * 64 * 180 a token
    assert costs.swin_block_flop(1, 180, 360, 8) == 518400 + 46080
    # Restormer level 1: C 48, one head, hidden 127
    mdta = 2 * (48 * 144 + 9 * 144 + 48 * 48 * 2 + 48 * 48)
    gdfn = 2 * (48 * 254 + 9 * 254 + 127 * 48)
    assert costs.restormer_block_flop(10, 48, 1, 127) == 10 * (mdta + gdfn)
    assert costs.conv3x3_flop(5, 180, 64) == 5 * 2 * 9 * 180 * 64
    assert costs.activation_bytes((2, 3), (4,)) == 40
    peak = costs.peaks("NVIDIA H100 80GB HBM3")
    assert peak["flops"] == 495e12 and costs.peaks("cpu") is None
    assert costs.least_s(495e12, 0, peak) == 1.0
    assert costs.least_s(0, 3.35e12, peak) == 1.0


def test_model_counts_match_the_flop_counter_on_the_references():
    root = REPO
    for name, arch, hw in (("swinir", SW, (16, 24)),
                           ("restormer", RS, (32, 48))):
        ref = harness.reference_module(root, name)
        net = ref.build(arch)
        for p in net.parameters():
            torch.nn.init.normal_(p, std=0.1)
        x = torch.rand(1, 3, *hw)
        with torch.no_grad():
            got = counted(lambda: net(x))
        assert got == ref.flops(arch, *hw), name


def test_block_counts_match_the_flop_counter():
    ref = harness.reference_module(REPO, "swinir")
    net = ref.build(SW)
    blk = net.layers[0].residual_group.blocks[1]
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.1)
    h, w, c = 16, 24, SW["embed_dim"]
    x = torch.rand(2, h * w, c)
    with torch.no_grad():
        got = counted(lambda: blk.run(x, h, w, "float32", {}))
    assert got == costs.swin_block_flop(2 * h * w, c, 2 * c, 8)
    rref = harness.reference_module(REPO, "restormer")
    rnet = rref.build(RS)
    rb = rnet.encoder_level2[0]
    c2 = 2 * RS["dim"]
    xr = torch.rand(1, c2, 8, 12)
    with torch.no_grad():
        got = counted(lambda: rb(xr, "float32"))
    assert got == costs.restormer_block_flop(96, c2, RS["heads"][1],
                                             int(c2 * 2.0))
