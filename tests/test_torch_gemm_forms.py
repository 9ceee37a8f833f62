"""The bf16 weight forms and launch plans of K1 (token_linear), K3
(conv3x3), K4 (gdfn_block), K5 (mdta_front), K7 (conv3x3_pair) and K8
(swin_pair_block), on the CPU: the packed forms hold exactly
the weights they were made from, zero elsewhere; the plain paths give the
same result on the packed form as on the raw weights; and every served
shape's launch plan fits in a block's shared memory and covers each output
element once (K5: each output pixel and each per-head gram element)."""

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


# K5's (C, heads): Restormer's four levels and its C 96 decoder / refinement
# stage (one head), and the card tests' C 24 with 2 heads (head width 12,
# padded to 16)
K5_WIDTHS = ((48, 1), (96, 2), (192, 4), (384, 8), (96, 1), (24, 2))


def _mdta_params(rng, c, heads, bias):
    b = (lambda n: _rand(rng, n)) if bias else (lambda n: None)
    return ((1 + _rand(rng, c) / 10, _rand(rng, c) / 10),
            _rand(rng, c, 3 * c) / c ** 0.5, b(3 * c),
            _rand(rng, 9, 3 * c) / 3, b(3 * c))


def _mdta_unpacked(k, c):
    """(C, 3C) w_qkv read back from the packed w_qkv_f: chunk i's 96
    columns are q, k and v chunk i; (the whole unpacked form, with its
    padding: rows C16, each group nch*32 columns)."""
    w = torch.cat([_frag_unpack(f) for f in k.w_qkv_f], dim=1)
    grp = w.reshape(w.shape[0], k.nch, 3, 32).permute(0, 2, 1, 3)
    grp = grp.reshape(w.shape[0], 3, k.nch * 32)
    return torch.cat([grp[:c, g, :c] for g in range(3)], dim=1), w


@pytest.mark.parametrize("c,heads", K5_WIDTHS)
def test_mdta_form_holds_the_weights(c, heads):
    rng = np.random.default_rng(c + heads)
    m = _mdta_params(rng, c, heads, bias=True)
    k = trf.mdta_weights(*m, _rand(rng, c, c), None, torch.ones(heads),
                         heads, torch.bfloat16)
    nch, c16 = -(-c // 32), -(-c // 16) * 16
    assert k.nch == nch
    assert k.w_qkv_f.shape == (nch, c16 // 16, 12, 32, 4)
    assert k.w_qkv_f.is_contiguous() and k.w_qkv_f.dtype == torch.bfloat16
    wq, whole = _mdta_unpacked(k, c)
    w16 = m[1].to(torch.bfloat16)
    assert torch.equal(wq, w16)
    # zero everywhere else: no nonzero beyond the weight's own
    assert (whole != 0).sum() == (w16 != 0).sum()
    k32 = trf.mdta_weights(*m, _rand(rng, c, c), None, torch.ones(heads),
                           heads, torch.float32)
    assert k32.w_qkv_f is None


@pytest.mark.parametrize("c,heads", K5_WIDTHS)
def test_mdta_plain_on_the_packed_form_equals_the_raw_weights(c, heads):
    rng = np.random.default_rng(c * 7 + heads)
    m = _mdta_params(rng, c, heads, bias=True)
    k = trf.mdta_weights(*m, _rand(rng, c, c), None, torch.ones(heads),
                         heads, torch.bfloat16)
    packed = list(m)
    packed[1] = _mdta_unpacked(k, c)[0]
    x = _rand(rng, 1, 6, 8, c).to(torch.bfloat16)
    for a, b in zip(trf.mdta_front_plain(x, *packed, heads),
                    trf.mdta_front_plain(x, *m, heads)):
        assert torch.equal(a, b)


def _gram_tile_of(wi, ch, mw, nw8):
    """csrc/restormer_fused.cu gram_tile_of: (head, first m16 tile, first
    n8 tile, m16 tiles, n8 tiles) of gram tile wi."""
    mh = -(-ch // 16)
    nm, nn = -(-mh // mw), -(-2 * mh // nw8)
    h, r = divmod(wi, nm * nn)
    mi0, nj0 = (r // nn) * mw, (r % nn) * nw8
    return h, mi0, nj0, min(mw, mh - mi0), min(nw8, 2 * mh - nj0)


# the five request shapes, the card tests' (2, 16, 128) C 24 canvas, and
# widths no served model has (ragged head widths, a gram whose tiles
# outnumber the warps): every shape the kernel takes gets a plan
K5_PLAN_SHAPES = [(s, hd) for _, s, hd in chip_smoke.RESTORMER_SHAPES] + [
    ((2, 16, 128, 24), 2), ((2, 19, 36, 96), 1), ((1, 20, 44, 100), 1),
    ((1, 12, 40, 512), 8), ((1, 8, 24, 384), 1), ((2, 8, 16, 8), 2)]


@pytest.mark.parametrize("shape,heads", K5_PLAN_SHAPES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_mdta_plan_fits_and_covers(shape, heads):
    """K5's bf16 plan: shared memory within a block's 227 KB; the blocks'
    runs of tiles cover the canvas once; the warps' gram tiles (slice gsl's
    warp w holds tile gsl*nw + w) cover every per-head gram element once,
    and every slice holds some."""
    b, h, w, c = shape
    p = trf.mdta_plan(c, heads)
    assert p.smem <= tkern.SMEM_LIMIT
    assert p.tw % 4 == 0 and p.th % 2 == 0 and (p.th * p.tw) % 16 == 0
    nw, ch = p.threads // 32, c // heads
    assert p.smem == trf.mdta_smem(c, heads, p.th, p.tw, nw)
    assert (p.mw, p.nw8, p.threads) in trf.GRAM_SHAPES
    # output pixels: block ib takes tiles ntiles*ib//nb .. ntiles*(ib+1)//nb
    ntx, nty = -(-w // p.tw), -(-h // p.th)
    nb = trf.mdta_blocks(b, ntx * nty, p.slices, 132)
    assert 1 <= nb * b * p.slices <= 132 or nb == 1
    cover = np.zeros((h, w), np.int64)
    for ib in range(nb):
        for tile in range(ntx * nty * ib // nb, ntx * nty * (ib + 1) // nb):
            ty, tx = divmod(tile, ntx)
            cover[ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw] += 1
    assert (cover == 1).all()
    assert p.slices == -(-p.tiles // nw) and (p.slices - 1) * nw < p.tiles
    gram = np.zeros((heads, -(-ch // 16) * 16, -(-ch // 16) * 16), np.int64)
    for wi in range(p.slices * nw):
        if wi >= p.tiles:
            continue
        hh, mi0, nj0, mw, nwe = _gram_tile_of(wi, ch, p.mw, p.nw8)
        assert 1 <= mw <= p.mw and 1 <= nwe <= p.nw8
        gram[hh, 16 * mi0:16 * (mi0 + mw), 8 * nj0:8 * (nj0 + nwe)] += 1
    assert (gram == 1).all()


def test_mdta_plans_are_the_designed_ones():
    """16x16 tiles up to C 48, 12x16 at C 96, 8x16 at C 192, 8x8 at C 384
    (the largest that fits); the fewest accumulators whose gram tiles the
    warps hold: 1x2 mma tiles at level 1 (9 gram tiles), 1x3 at level 2
    (12), 3x2 at level 3 and decoder1 (12), all in 384-thread blocks; 3x3
    at level 4 (16) in 512; width 12 pads to one 1x2 tile a head. A head
    of width 128 (18 3x3 tiles) takes two slices."""
    got = [(p.th, p.tw, p.threads, p.mw, p.nw8, p.tiles, p.slices)
           for p in (trf.mdta_plan(c, hd) for c, hd in K5_WIDTHS)]
    assert got == [(16, 16, 384, 1, 2, 9, 1), (12, 16, 384, 1, 3, 12, 1),
                   (8, 16, 384, 3, 2, 12, 1), (8, 8, 512, 3, 3, 16, 1),
                   (12, 16, 384, 3, 2, 12, 1), (16, 16, 384, 1, 2, 2, 1)]
    p = trf.mdta_plan(128, 1)
    assert (p.mw, p.nw8, p.threads, p.tiles, p.slices) == (3, 3, 512, 18, 2)
    with pytest.raises(ValueError):
        trf.mdta_plan(96, 5)


def test_gram_tile_plain_is_the_per_head_gram():
    """gram_tile's plain version (what it computes on a CPU tensor) is q_h^T
    k_h of each head's columns."""
    rng = np.random.default_rng(12)
    q = _rand(rng, 48, 24).to(torch.bfloat16)
    k = _rand(rng, 48, 24).to(torch.bfloat16)
    want = torch.einsum("pc,pd->cd", q[:, 12:].float(), k[:, 12:].float())
    got = trf.gram_tile(q, k, 2)
    assert got.shape == (2, 12, 12)
    assert torch.allclose(got[1], want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K7 (conv3x3_pair) and K8 (swin_pair_block): the bf16 packed forms


@pytest.mark.parametrize("cin,cmid,cout", [(64, 256, 12), (64, 256, 3),
                                           (64, 256, 32), (5, 7, 4),
                                           (32, 48, 32), (16, 130, 20)])
def test_conv3x3_pair_form_unpacks_to_the_weights(cin, cmid, cout):
    """K7's bf16 form: w1 as K3's packed order in 64-column slices (Cmid
    to 64, Cin to 16), w2 in one slice of Cout padded to 8 (Cmid to 64);
    unpacked it is exactly the raw weights and biases, and every padded
    entry is zero."""
    rng = np.random.default_rng(cin + cmid + cout)
    w1, b1 = _rand(rng, 3, 3, cin, cmid), _rand(rng, cmid)
    w2, b2 = _rand(rng, 3, 3, cmid, cout), _rand(rng, cout)
    k = tconv.conv3x3_pair_weights(w1, b1, w2, b2, torch.bfloat16)
    cmp, cip, cop = -(-cmid // 64) * 64, -(-cin // 16) * 16, -(-cout // 8) * 8
    assert k.w1.shape == (cmp // 64, cip // 16, 9, 2, 8, 8, 8)
    assert k.w2.shape == (1, cmp // 16, 9, 2, cop // 8, 8, 8)
    assert k.w1.is_contiguous() and k.w2.is_contiguous()
    a1, c1, a2, c2 = k.hwio
    assert torch.equal(a1, w1.to(torch.bfloat16))
    assert torch.equal(a2, w2.to(torch.bfloat16))
    assert torch.equal(c1, b1) and torch.equal(c2, b2)
    full1, full2 = tconv._unpack_taps(k.w1), tconv._unpack_taps(k.w2)
    assert full1.shape == (3, 3, cip, cmp) and full2.shape == (3, 3, cmp, cop)
    assert full1[:, :, cin:].abs().sum() == 0
    assert full1[..., cmid:].abs().sum() == 0
    assert full2[:, :, cmid:].abs().sum() == 0
    assert full2[..., cout:].abs().sum() == 0
    assert k.b1[cmid:].abs().sum() == 0 and k.b2[cout:].abs().sum() == 0


@pytest.mark.parametrize("c,heads", [(180, 6), (48, 2), (60, 6)])
def test_swin_pair_form_unpacks_to_the_weights(c, heads):
    """K8's bf16 form (swin_pair_weights): its five passes unpack exactly
    to the block's kernel-form matrices and biases (the attention scale
    already in q), every padded entry is zero, and its widths are one of
    the kernel's instantiations."""
    rng = np.random.default_rng(c + heads)
    hid, ws = 2 * c, 8
    w = dict(norm1_w=_rand(rng, c), norm1_b=_rand(rng, c),
             qkv_w=_rand(rng, 3 * c, c), qkv_b=_rand(rng, 3 * c),
             proj_w=_rand(rng, c, c), proj_b=_rand(rng, c),
             rpb_table=_rand(rng, (2 * ws - 1) ** 2, heads),
             norm2_w=_rand(rng, c), norm2_b=_rand(rng, c),
             fc1_w=_rand(rng, hid, c), fc1_b=_rand(rng, hid),
             fc2_w=_rand(rng, c, hid), fc2_b=_rand(rng, c))
    p = tsb.prepare_swin_params(**w, num_heads=heads, ws=ws,
                                dtype=torch.bfloat16)
    f = tsb.swin_pair_weights(p, heads)
    d = f.dims
    assert (d["nq"] // 2, d["nc"] // 2, d["nh"] // 4,
            d["hdp"] // 16) in tsb.PAIR_SHAPES
    assert f.wkv.shape[0] == 2 and f.w1.shape[0] == 2
    u = f.unpack()
    assert torch.equal(u["wqkv"], tsb._dense(p.wqkv, c, 3 * c))
    assert torch.equal(u["bqkv"], p.bqkv)
    assert torch.equal(u["wproj"], tsb._dense(p.wproj, c, c))
    assert torch.equal(u["bproj"], p.bproj)
    assert torch.equal(u["w1"], tsb._dense(p.w1, c, hid))
    assert torch.equal(u["b1"], p.b1)
    assert torch.equal(u["w2"], tsb._dense(p.w2, hid, c))
    assert torch.equal(u["b2"], p.b2)
    assert u["pads"].abs().sum() == 0
    assert torch.equal(f.ln1, torch.stack([p.ln1_w, p.ln1_b]))
    assert torch.equal(f.rpb, p.rpb)


def test_swin_pair_form_is_made_once_per_weight():
    """The form is kept on the block's qkv weight and remade after an
    in-place edit of any of its tensors."""
    rng = np.random.default_rng(3)
    c, heads, ws = 48, 2, 8
    w = dict(norm1_w=_rand(rng, c), norm1_b=_rand(rng, c),
             qkv_w=_rand(rng, 3 * c, c), qkv_b=_rand(rng, 3 * c),
             proj_w=_rand(rng, c, c), proj_b=_rand(rng, c),
             rpb_table=_rand(rng, (2 * ws - 1) ** 2, heads),
             norm2_w=_rand(rng, c), norm2_b=_rand(rng, c),
             fc1_w=_rand(rng, 2 * c, c), fc1_b=_rand(rng, 2 * c),
             fc2_w=_rand(rng, c, 2 * c), fc2_b=_rand(rng, c))
    p = tsb.prepare_swin_params(**w, num_heads=heads, ws=ws,
                                dtype=torch.bfloat16)
    f = tsb._pair_cached(p, heads, tsb.swin_pair_weights)
    assert tsb._pair_cached(p, heads, tsb.swin_pair_weights) is f
    p.b2.add_(1.0)
    g = tsb._pair_cached(p, heads, tsb.swin_pair_weights)
    assert g is not f and torch.equal(g.b2[:c], p.b2)
