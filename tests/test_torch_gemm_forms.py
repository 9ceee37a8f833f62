"""The bf16 weight forms and launch plans of K1 (token_linear), K3
(conv3x3) and K4 (gdfn_block), on the CPU: the packed forms hold exactly
the weights they were made from, zero elsewhere; the plain paths give the
same result on the packed form as on the raw weights; and every served
shape's launch plan fits in a block's shared memory and covers each output
element once."""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke

tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tkern = importlib.import_module("image_restoration_agent_tpu_torch.ops.kernels")
trf = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.restormer_fused")
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


# K4's widths: Restormer's levels (hidden int(2.66 C): 127, 255, 510, 1021,
# every one a ragged last chunk of 32) and the card tests' C 24
K4_WIDTHS = ((48, 127), (96, 255), (192, 510), (384, 1021), (24, 63))


def _gdfn_params(rng, c, hid, bias):
    b = (lambda n: _rand(rng, n)) if bias else (lambda n: None)
    return ((1 + _rand(rng, c) / 10, _rand(rng, c) / 10),
            _rand(rng, c, 2 * hid) / c ** 0.5, b(2 * hid),
            _rand(rng, 9, 2 * hid) / 3, b(2 * hid),
            _rand(rng, hid, c) / hid ** 0.5, b(c))


def _frag_unpack(f):
    """The (kp, np) matrix of a restormer_fused.frag_pack form."""
    ks, nt = f.shape[:2]
    w = f.reshape(ks, nt, 8, 4, 2, 2).permute(0, 4, 3, 5, 1, 2)
    return w.reshape(16 * ks, 8 * nt)


def _gdfn_unpacked(k, c, hid):
    """(w_in (C, 2 hid), w_out (hid, C)) read back from the packed forms,
    with the padding they carry: (w_in rows C16, columns nch*32 a group;
    w_out rows nch*32, the plan's columns)."""
    w_in = torch.cat([_frag_unpack(f) for f in k.w_in_f], dim=1)
    w_out = torch.cat([_frag_unpack(f) for f in k.w_out_f], dim=0)
    nch = k.nch
    # chunk i's 64 columns are x1 chunk i, then x2 chunk i
    grp = w_in.reshape(w_in.shape[0], nch, 2, 32).permute(0, 2, 1, 3)
    return grp.reshape(w_in.shape[0], 2, nch * 32), w_out


@pytest.mark.parametrize("c,hid", K4_WIDTHS)
def test_gdfn_forms_hold_the_weights(c, hid):
    rng = np.random.default_rng(c)
    g = _gdfn_params(rng, c, hid, bias=True)
    k = trf.gdfn_weights(*g, torch.bfloat16)
    plan = trf.gdfn_plan(c)
    nch, c16 = -(-hid // 32), -(-c // 16) * 16
    assert k.nch == nch
    assert k.w_in_f.shape == (nch, c16 // 16, 8, 32, 4)
    assert k.w_out_f.shape == (nch, 2, plan.cols // 8, 32, 4)
    for f in (k.w_in_f, k.w_out_f):
        assert f.is_contiguous() and f.dtype == torch.bfloat16
    w_in, w_out = _gdfn_unpacked(k, c, hid)
    wi = g[1].to(torch.bfloat16)
    assert torch.equal(w_in[:c, 0, :hid], wi[:, :hid])
    assert torch.equal(w_in[:c, 1, :hid], wi[:, hid:])
    assert torch.equal(w_out[:hid, :c], g[5].to(torch.bfloat16))
    # zero everywhere else: no nonzero beyond the weights' own
    assert (w_in != 0).sum() == (wi != 0).sum()
    assert (w_out != 0).sum() == (g[5].to(torch.bfloat16) != 0).sum()
    # f32 keeps no packed form
    k32 = trf.gdfn_weights(*g, torch.float32)
    assert k32.w_in_f is None and k32.w_out_f is None


@pytest.mark.parametrize("c,hid", [(48, 127), (24, 63)])
@pytest.mark.parametrize("fast", [False, True])
def test_gdfn_plain_on_the_packed_forms_equals_the_raw_weights(c, hid,
                                                               fast):
    rng = np.random.default_rng(c + 1)
    g = _gdfn_params(rng, c, hid, bias=True)
    k = trf.gdfn_weights(*g, torch.bfloat16)
    w_in, w_out = _gdfn_unpacked(k, c, hid)
    packed = list(g)
    packed[1] = torch.cat([w_in[:c, 0, :hid], w_in[:c, 1, :hid]], dim=1)
    packed[5] = w_out[:hid, :c]
    x = _rand(rng, 1, 8, 16, c).to(torch.bfloat16)
    assert torch.equal(trf.gdfn_block_plain(x, *packed, fast=fast),
                       trf.gdfn_block_plain(x, *g, fast=fast))


@pytest.mark.parametrize("shape", [s for _, s, _ in chip_smoke.RESTORMER_SHAPES]
                         + [(2, 24, 40, 48), (2, 19, 36, 96), (2, 8, 20, 384),
                            (2, 16, 128, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gdfn_plan_fits_and_covers(shape):
    """K4's bf16 plan: shared memory within a block's 227 KB; the tiles
    cover the canvas once; project_out's warp tiles (warp w: m16 rows
    mt (w % WM) .., n8 columns ntw (w // WM) ..) cover the tile's pixels
    x the plan's columns once, with 48 accumulators a thread."""
    b, h, w, c = shape
    p = trf.gdfn_plan(c)
    assert p.smem <= tkern.SMEM_LIMIT and p.threads <= 512
    hp = (p.th + 2) * (p.tw + 2)
    assert p.smem == 2 * (-(-hp // 16) * 16 * (-(-c // 16) * 16 + 8)
                          + hp * (2 * trf.CHUNK + 8)
                          + p.th * p.tw * (trf.CHUNK + 8))
    assert p.tw % 4 == 0 and p.mt * p.ntw * 4 == 48
    assert c <= p.cols == 8 * p.ntw * p.wn
    nw = p.threads // 32
    wm = nw // p.wn
    assert nw % p.wn == 0
    seen = np.zeros((p.th * p.tw, p.cols // 8), np.int64)
    for warp in range(nw):
        for i in range(p.mt):
            r0 = 16 * (p.mt * (warp % wm) + i)
            n0 = p.ntw * (warp // wm)
            seen[r0:r0 + 16, n0:n0 + p.ntw] += 1
    assert (seen == 1).all()
    cover = np.zeros((h, w), np.int64)
    for ty in range(-(-h // p.th)):
        for tx in range(-(-w // p.tw)):
            cover[ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw] += 1
    assert (cover == 1).all()


def test_gdfn_plans_are_the_designed_ones():
    """16x32 tiles up to C 48 (halo 1.20x the outputs), 16x16 at C 96,
    8x16 at C 192, 8x8 at C 384; C above 384 is refused."""
    assert [(p.th, p.tw, p.threads) for p in map(
        trf.gdfn_plan, (24, 48, 96, 192, 384))] == \
        [(16, 32, 512), (16, 32, 512), (16, 16, 512), (8, 16, 512),
         (8, 8, 512)]
    with pytest.raises(ValueError):
        trf.gdfn_plan(392)
