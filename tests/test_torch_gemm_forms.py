"""The bf16 weight forms and launch plans of K1 (token_linear) and K3
(conv3x3), on the CPU: the packed forms hold exactly the weights they were
made from, zero elsewhere; the plain paths give the same result on the
packed form as on the raw weights; and every served shape's launch plan
fits in a block's shared memory and covers each output element once."""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke

tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tkern = importlib.import_module("image_restoration_agent_tpu_torch.ops.kernels")
tsb = importlib.import_module("image_restoration_agent_tpu_torch.ops.swin_block")

torch.set_num_threads(1)

# every K3 conv the served paths and chip_smoke.py run: (B, H, W, Cin, Cout)
_BAND = (1, 552, 1920)
_HAT = chip_smoke.HAT_BATCH[:3]
_DENOISE = chip_smoke.DENOISE_CANVAS[:3]
K3_SHAPES = sorted(
    {(*_BAND, ci, co) for ci, co in ((3, 180), (180, 180), (180, 64))}
    | {(1, 24, 3840, 64, 256), (1, 24, 3840, 256, 12)}
    | {(*s[:3], 64, 256) for s in chip_smoke.HEAD_SHAPES}
    | {(*s[:3], 256, 12) for s in chip_smoke.HEAD_SHAPES}
    | {(*_HAT, ci, co) for ci, co in ((3, 180), (180, 180), (180, 60),
                                      (60, 180), (180, 64))}
    | {(*_DENOISE, ci, co) for ci, co in ((3, 180), (180, 180), (180, 3))}
    | {(1, h, w, ci, co) for _, ci, co, h, w in chip_smoke.RESTORMER_CONVS}
    | {(1, 384, 640, 96, 48), (1, 192, 320, 192, 96),
       (1, 192, 320, 192, 384)})

# every K1 weight on the served paths: (K, N) of qkv, proj, fc1, fc2 at
# C 180, over the band's, a HAT batch's and the denoise canvas's tokens
K1_WEIGHTS = ((180, 540), (180, 180), (180, 360), (360, 180))
K1_ROWS = (552 * 1920, int(np.prod(_HAT)), int(np.prod(_DENOISE)))


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("cin,cout", [(3, 3), (3, 48), (6, 5), (64, 12),
                                      (180, 60), (180, 180), (96, 3),
                                      (384, 768), (256, 12), (20, 70)])
def test_conv3x3_form_holds_the_weights(cin, cout):
    rng = np.random.default_rng(cin * 1000 + cout)
    w = _rand(rng, 3, 3, cin, cout)
    k = tconv.conv3x3_weights(w, None, torch.bfloat16)
    slices, ns = tkern.gemm_slices(cout)
    assert k.w.shape == (slices, -(-cin // 16), 9, 2, ns // 8, 8, 8)
    assert k.w.is_contiguous() and k.w.dtype == torch.bfloat16
    assert torch.equal(k.hwio, w.to(torch.bfloat16))
    # the padding is zero: no nonzero beyond the weight's own
    assert (k.w != 0).sum() == (w.to(torch.bfloat16) != 0).sum()


@pytest.mark.parametrize("k,n", [*K1_WEIGHTS, (8, 24), (48, 144), (36, 24),
                                 (512, 540), (4, 3), (1, 180)])
def test_kernel_matrix_holds_the_weights(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    w = _rand(rng, k, n)
    form = tsb.kernel_matrix(w, torch.bfloat16)
    slices, ns, _ = tsb.token_linear_slices(k, n)
    assert form.shape == (slices, -(-k // 64) * 8, ns // 8, 8, 8)
    assert form.is_contiguous() and form.dtype == torch.bfloat16
    assert torch.equal(tsb._dense(form, k, n), w.to(torch.bfloat16).float())
    assert (form != 0).sum() == (w.to(torch.bfloat16) != 0).sum()
    # float32 keeps the matrix as it is
    assert torch.equal(tsb.kernel_matrix(w, torch.float32), w)


def test_plain_paths_on_the_packed_forms_equal_the_raw_weights():
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 6, 10, 20).to(torch.bfloat16)
    w = _rand(rng, 3, 3, 20, 70) / 8
    b = _rand(rng, 70)
    res = _rand(rng, 1, 6, 10, 70).to(torch.bfloat16)
    k = tconv.conv3x3_weights(w, b, torch.bfloat16)
    for kw in (dict(), dict(act="lrelu", roll=3, res=res),
               dict(ln_pre=(1 + _rand(rng, 20) / 10, _rand(rng, 20) / 10))):
        assert torch.equal(tconv.conv3x3(x, k, **kw),
                           tconv.conv3x3_plain(x, w, b, **kw))
    a = _rand(rng, 40, 36).to(torch.bfloat16)
    wm = _rand(rng, 36, 540) / 6
    bm = _rand(rng, 540)
    ln = (1 + _rand(rng, 36) / 10, _rand(rng, 36) / 10)
    geom = (1, 4, 10, 2, -1)
    for kw in (dict(), dict(ln=ln, gelu="tanh", a_map=tsb.GATHER, geom=geom),
               dict(res=_rand(rng, 40, 540), r_map=tsb.GATHER,
                    o_map=tsb.SCATTER, geom=geom, out_dtype=torch.float32)):
        assert torch.equal(
            tsb.token_linear(a, tsb.kernel_matrix(wm, torch.bfloat16), bm,
                             **kw),
            tsb.token_linear_plain(a, wm.to(torch.bfloat16), bm, **kw))


@pytest.mark.parametrize("shape", K3_SHAPES,
                         ids=["x".join(map(str, s)) for s in K3_SHAPES])
def test_conv3x3_plan_fits_and_covers(shape):
    b, h, w, cin, cout = shape
    plan = tconv.conv3x3_plan(b, h, w, cin, cout)
    assert plan.smem <= tkern.SMEM_LIMIT and 2 <= plan.stages <= 4
    assert plan.smem == tconv.conv3x3_smem(plan.ns, plan.stages)
    assert plan.ns in tkern.GEMM_WIDTHS and plan.threads == 256
    # blocks: (batch, row pair, 64-pixel segment, channel slice), so the
    # output is covered once where each axis is cut into a partition
    rows, segs = -(-h // tconv.CONV_ROWS), -(-w // tconv.CONV_PIXELS)
    assert plan.grid == b * rows * segs * plan.slices
    assert (plan.slices - 1) * plan.ns < cout <= plan.slices * plan.ns
    assert plan.ns == tkern.gemm_width(-(-cout // plan.slices))
    k = tconv.conv3x3_weights(torch.zeros(3, 3, cin, cout), None,
                              torch.bfloat16)
    assert k.w.shape[0] == plan.slices and k.w.shape[4] * 8 == plan.ns


@pytest.mark.parametrize("k,n", K1_WEIGHTS)
@pytest.mark.parametrize("m", K1_ROWS)
def test_token_linear_plan_fits_and_covers(m, k, n):
    plan = tsb.token_linear_plan(m, k, n, sms=132)
    assert plan.smem <= tkern.SMEM_LIMIT and plan.stages >= 2
    assert plan.stages % 2 == 0  # the two producer-consumer pairs' stages
    assert plan.smem == tsb.token_linear_smem(k, plan.ns, plan.stages)
    assert plan.ns in tkern.GEMM_WIDTHS and plan.threads == 512
    assert plan.ns <= tsb.LINEAR_MAX_N
    assert (plan.slices - 1) * plan.ns < n <= plan.slices * plan.ns
    assert plan.grid % plan.slices == 0 and plan.grid <= 132
    # block g takes slice g % slices and walks the 64-row tiles
    # g // slices, + step, ...: every (tile, slice) exactly once
    tiles = -(-m // tsb.LINEAR_ROWS)
    step = plan.grid // plan.slices
    seen = np.zeros((tiles, plan.slices), np.int64)
    for g in range(plan.grid):
        seen[g // plan.slices::step, g % plan.slices] += 1
    assert (seen == 1).all()
    form = tsb.kernel_matrix(torch.zeros(k, n), torch.bfloat16)
    assert form.shape[0] == plan.slices and form.shape[2] * 8 == plan.ns


def test_served_slices_are_the_designed_ones():
    """qkv 540 as 3 x 184, fc1 360 as 2 x 184, proj 180 as 184, fc2 at
    K 360 as 2 x 96 (184 columns of K 360 leave no room for two A
    stages); Cout pads to 8 within a slice: 3 -> 8, 12 -> 16, 60 -> 64,
    180 -> 184, 768 -> 3 x 256."""
    assert [tsb.token_linear_slices(k, n)[:2] for k, n in K1_WEIGHTS] == \
        [(3, 184), (1, 184), (2, 184), (2, 96)]
    assert [tkern.gemm_slices(c) for c in (3, 12, 24, 48, 60, 180, 768)] \
        == [(1, 8), (1, 16), (1, 24), (1, 48), (1, 64), (1, 184), (3, 256)]
