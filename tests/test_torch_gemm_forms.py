"""The bf16 weight forms and launch plans of K1 (token_linear), K3
(conv3x3), K4 (gdfn_block), K5 (mdta_front), K7 (conv3x3_pair) and K8
(swin_pair_block), and the float32 split-TF32 forms and plans of K1, K3, K4
and K5, on the CPU: the packed forms hold exactly the weights they were made from,
zero elsewhere; the plain paths give the same result on the packed form as
on the raw weights; and every served shape's launch plan fits in a block's
shared memory and covers each output element once (K5: each output pixel
and each per-head gram element; the float32 K3: each output pixel and
channel once in each K part, the parts covering K once)."""

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
       (1, 192, 320, 192, 384)}
    | {(*key[1][:3], key[2], key[3])
       for forms, _ in chip_smoke.agent_kernel_shapes().values()
       for key in forms if key[0] == "conv3x3"})
# the Restormer block shapes of the agent's canvas: ((B, H, W, C), heads)
AGENT_BLOCKS = sorted({(key[1], key[2]) for forms, _ in
                       chip_smoke.agent_kernel_shapes().values()
                       for key in forms if key[0] == "block"})

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
                                 (512, 540), (4, 3), (1, 180), (1024, 256),
                                 (1028, 180)])
def test_kernel_matrix_holds_the_weights(k, n):
    rng = np.random.default_rng(k * 1000 + n)
    w = _rand(rng, k, n)
    form = tsb.kernel_matrix(w, torch.bfloat16)
    slices, ns, _ = tsb.token_linear_slices(k, n)
    assert form.shape == (slices, -(-k // 64) * 8, ns // 8, 8, 8)
    assert form.is_contiguous() and form.dtype == torch.bfloat16
    assert torch.equal(tsb._dense(form, k, n), w.to(torch.bfloat16).float())
    assert (form != 0).sum() == (w.to(torch.bfloat16) != 0).sum()
    # float32: the split-TF32 form holds the matrix bit for bit
    assert torch.equal(tsb._dense(tsb.kernel_matrix(w, torch.float32), k, n),
                       w)


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


# K past 512: RIDCP's fc2 (hidden 1024 -> C 256 at the 768x1280 request's
# 192x320 canvas), and the card tests' K 640 / 1028 at N 256 / 180
K1_WIDE = ((1024, 256), (640, 256), (1028, 256), (640, 180), (1028, 180))


@pytest.mark.parametrize("k,n", K1_WIDE)
@pytest.mark.parametrize("m", [192 * 320, 1000])
def test_token_linear_wide_k_plan_fits_and_covers(m, k, n):
    """Past K 512 an A stage holds a chunk of ``chunk`` 64-k blocks, not
    whole rows: the ring and the K x NS weight fit in shared memory, the
    chunks (at most 512 k each) cover K, at least four 64-k blocks of A are
    in flight, and the slices and tiles cover the output once."""
    plan = tsb.token_linear_plan(m, k, n, sms=132)
    kb = -(-k // 64)
    assert plan.smem <= tkern.SMEM_LIMIT and plan.stages >= 2
    assert plan.stages % 2 == 0
    assert 1 <= plan.chunk <= 8 and plan.chunk < kb
    assert plan.smem == tsb.token_linear_smem(k, plan.ns, plan.stages,
                                              plan.chunk)
    assert plan.stages * plan.chunk >= 4
    assert plan.ns in tkern.GEMM_WIDTHS and plan.threads == 512
    assert (plan.slices - 1) * plan.ns < n <= plan.slices * plan.ns
    assert plan.grid % plan.slices == 0 and plan.grid <= 132
    form = tsb.kernel_matrix(torch.zeros(k, n), torch.bfloat16)
    assert form.shape[0] == plan.slices and form.shape[2] * 8 == plan.ns


def test_k_up_to_512_keeps_whole_rows():
    """K <= 512 keeps its plan: one chunk, the whole (padded) row, and the
    shared memory the whole-row formula gives; RIDCP's fc1 (256 -> 1024)
    and qkv (256 -> 768) take it."""
    for k, n in (*K1_WEIGHTS, (256, 1024), (256, 768), (256, 256),
                 (512, 512)):
        plan = tsb.token_linear_plan(61440, k, n, sms=132)
        assert plan.chunk == -(-k // 64)
        assert plan.smem == tsb.token_linear_smem(k, plan.ns, plan.stages)
    assert tsb.token_linear_slices(1024, 256)[:2] == (4, 64)


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
    # f32 keeps the split-TF32 forms (test_gdfn_f32_form_splits_the_weights)
    k32 = trf.gdfn_weights(*g, torch.float32)
    assert k32.w_in_f.dtype == k32.w_out_f.dtype == torch.float32


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
                         + [s for s, _ in AGENT_BLOCKS]
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
    assert k32.w_qkv_f.dtype == torch.float32  # the split-TF32 form


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


# the five request shapes, the agent canvas's, the card tests' (2, 16, 128)
# C 24 canvas, and widths no served model has (ragged head widths, a gram
# whose tiles outnumber the warps): every shape the kernel takes gets a plan
K5_PLAN_SHAPES = [(s, hd) for _, s, hd in chip_smoke.RESTORMER_SHAPES] \
    + AGENT_BLOCKS + [
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


def _tf32_unpack(f):
    """(2, kp, np): wh and wl of a restormer_fused.tf32_frag_pack form (lane
    4g + t of k step ks, n8 tile nt holds wh[8ks + t], wh[8ks + t + 4],
    wl[8ks + t], wl[8ks + t + 4] of column 8nt + g)."""
    ks, nt = f.shape[:2]
    w = f.reshape(ks, nt, 8, 4, 2, 2).permute(4, 0, 5, 3, 1, 2)
    return w.reshape(2, 8 * ks, 8 * nt)


def _assert_split(parts, w):
    """wh is w rounded to TF32 (tf32_round) and wh + wl is w bit for bit."""
    wh, wl = parts
    assert torch.equal(wh, tkern.tf32_round(w))
    assert torch.equal(wh + wl, w)


@pytest.mark.parametrize("c,hid", K4_WIDTHS)
def test_gdfn_f32_form_splits_the_weights(c, hid):
    """K4's float32 forms: w_in_f (nch, C8/8, 8, 32, 4) holds each chunk's
    64 interleaved columns of w_in, w_out_f (nch, 4, NP/8, 32, 4) each
    chunk's 32 rows of w_out over the plan's NP columns, both split as wh =
    rna(w) and wl = w - wh, zero-padded (C8 = C rounded up to 8)."""
    rng = np.random.default_rng(c + 3)
    g = _gdfn_params(rng, c, hid, bias=True)
    k = trf.gdfn_weights(*g, torch.float32)
    plan = trf.gdfn_plan(c, torch.float32)
    nch, c8 = -(-hid // 32), -(-c // 8) * 8
    assert k.w_in_f.shape == (nch, c8 // 8, 8, 32, 4)
    assert k.w_out_f.shape == (nch, 4, plan.cols // 8, 32, 4)
    for f in (k.w_in_f, k.w_out_f):
        assert f.is_contiguous() and f.dtype == torch.float32
    w_in = torch.nn.functional.pad(trf._interleave(g[1], 2),
                                   (0, 0, 0, c8 - c))
    _assert_split(torch.cat([_tf32_unpack(f) for f in k.w_in_f], 2), w_in)
    w_out = torch.nn.functional.pad(g[5], (0, plan.cols - c,
                                           0, nch * 32 - hid))
    _assert_split(torch.cat([_tf32_unpack(f) for f in k.w_out_f], 1), w_out)


@pytest.mark.parametrize("c,heads", K5_WIDTHS)
def test_mdta_f32_form_splits_the_weights(c, heads):
    """K5's float32 form: w_qkv_f (nch, C8/8, 12, 32, 4) holds each chunk's
    96 interleaved q, k and v columns, split as wh = rna(w) and wl = w -
    wh, zero-padded."""
    rng = np.random.default_rng(c * 3 + heads)
    m = _mdta_params(rng, c, heads, bias=True)
    k = trf.mdta_weights(*m, _rand(rng, c, c), None, torch.ones(heads),
                         heads, torch.float32)
    nch, c8 = -(-c // 32), -(-c // 8) * 8
    assert k.w_qkv_f.shape == (nch, c8 // 8, 12, 32, 4)
    assert k.w_qkv_f.is_contiguous() and k.w_qkv_f.dtype == torch.float32
    w = torch.nn.functional.pad(trf._interleave(m[1], 3), (0, 0, 0, c8 - c))
    _assert_split(torch.cat([_tf32_unpack(f) for f in k.w_qkv_f], 2), w)


@pytest.mark.parametrize("shape", [s for _, s, _ in chip_smoke.RESTORMER_SHAPES]
                         + [s for s, _ in AGENT_BLOCKS]
                         + [(2, 24, 40, 48), (2, 19, 36, 96), (2, 8, 20, 384),
                            (2, 16, 128, 24), (8, 128, 128, 48)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gdfn_f32_plan_fits_and_covers(shape):
    """K4's float32 plan: shared memory within a block's 227 KB; the tiles
    cover the canvas once; project_out's warp tiles (warp w: m16 rows 2 (w
    % WM), + 1, n8 columns 3 (w // WM) ..) cover the tile's pixels x the
    plan's columns once, with 2 x 24 accumulators a thread (the running sum
    and a chunk's partial); the task shape is one the kernel takes."""
    b, h, w, c = shape
    p = trf.gdfn_plan(c, torch.float32)
    assert p.smem <= tkern.SMEM_LIMIT and p.threads == 512
    hp = (p.th + 2) * (p.tw + 2)
    assert p.smem == 4 * (-(-hp // 16) * 16 * (-(-c // 8) * 8 + 4)
                          + hp * (2 * trf.CHUNK + 8)
                          + p.th * p.tw * (trf.CHUNK + 4))
    assert p.tw % 4 == 0 and p.th % 2 == 0 and (p.mt, p.ntw) == (2, 3)
    assert c <= p.cols == 8 * p.ntw * p.wn
    assert 0 <= p.ts < len(trf.TF32_TASKS)
    nw = p.threads // 32
    wm = nw // p.wn
    assert nw % p.wn == 0 and p.th * p.tw == 32 * wm
    seen = np.zeros((p.th * p.tw, p.cols // 8), np.int64)
    for warp in range(nw):
        r0, n0 = 32 * (warp % wm), p.ntw * (warp // wm)
        seen[r0:r0 + 32, n0:n0 + p.ntw] += 1
    assert (seen == 1).all()
    cover = np.zeros((h, w), np.int64)
    for ty in range(-(-h // p.th)):
        for tx in range(-(-w // p.tw)):
            cover[ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("shape,heads", K5_PLAN_SHAPES
                         + [((8, 128, 128, 48), 1), ((1, 8, 24, 128), 1)],
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_mdta_f32_plan_fits_and_covers(shape, heads):
    """K5's float32 plan: shared memory within a block's 227 KB (the bytes
    mdta_tf32_smem counts); tiles of a multiple of 8 pixels (the gram's k
    step); the blocks' runs of tiles cover the canvas once; the warps' gram
    tiles cover every per-head gram element once."""
    b, h, w, c = shape
    p = trf.mdta_plan(c, heads, torch.float32)
    nw, ch = p.threads // 32, c // heads
    assert p.smem <= tkern.SMEM_LIMIT
    assert p.smem == trf.mdta_smem(c, heads, p.th, p.tw, nw, torch.float32)
    assert p.tw % 4 == 0 and p.th % 2 == 0 and (p.th * p.tw) % 8 == 0
    assert (p.mw, p.nw8, p.threads) in trf.GRAM_SHAPES
    ntx, nty = -(-w // p.tw), -(-h // p.th)
    nb = trf.mdta_blocks(b, ntx * nty, p.slices, 132)
    cover = np.zeros((h, w), np.int64)
    for ib in range(nb):
        for tile in range(ntx * nty * ib // nb, ntx * nty * (ib + 1) // nb):
            ty, tx = divmod(tile, ntx)
            cover[ty * p.th:(ty + 1) * p.th, tx * p.tw:(tx + 1) * p.tw] += 1
    assert (cover == 1).all()
    assert p.slices == -(-p.tiles // nw) and (p.slices - 1) * nw < p.tiles
    gram = np.zeros((heads, -(-ch // 16) * 16, -(-ch // 16) * 16), np.int64)
    for wi in range(min(p.tiles, p.slices * nw)):
        hh, mi0, nj0, mw, nwe = _gram_tile_of(wi, ch, p.mw, p.nw8)
        gram[hh, 16 * mi0:16 * (mi0 + mw), 8 * nj0:8 * (nj0 + nwe)] += 1
    assert (gram == 1).all()


def test_f32_plans_are_the_designed_ones():
    """Float32 staging halves the tiles: K4 16x16 up to C 48, 8x16 at C 96,
    8x8 at C 192, 4x8 at C 384; K5 8x16 at level 1, 8x8 at level 2 and
    the C 96 one-head decoder, 6x8 at level 3, 4x4 at level 4, with bf16's
    gram tiles and block sizes."""
    assert [(p.th, p.tw, p.wn) for p in (
        trf.gdfn_plan(c, torch.float32) for c in (24, 48, 96, 192, 384))] \
        == [(16, 16, 2), (16, 16, 2), (8, 16, 4), (8, 8, 8), (4, 8, 16)]
    got = [(p.th, p.tw, p.threads, p.mw, p.nw8, p.slices)
           for p in (trf.mdta_plan(c, hd, torch.float32)
                     for c, hd in K5_WIDTHS)]
    assert got == [(8, 16, 384, 1, 2, 1), (8, 8, 384, 1, 3, 1),
                   (6, 8, 384, 3, 2, 1), (4, 4, 512, 3, 3, 1),
                   (8, 8, 384, 3, 2, 1), (12, 16, 384, 1, 2, 1)]
    with pytest.raises(ValueError):
        trf.gdfn_plan(392, torch.float32)


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


# ---------------------------------------------------------------------------
# K7 and K8: the float32 split-TF32 forms and plans


@pytest.mark.parametrize("cin,cmid,cout", [(64, 256, 12), (5, 7, 4),
                                           (32, 48, 32), (16, 130, 20),
                                           (64, 256, 3)])
def test_conv3x3_pair_f32_form_splits_its_weights(cin, cmid, cout):
    """K7's float32 form: both weights in K3's float32 packed order, Cin to
    8, Cmid to 64, Cout to 8, 16 or 32, with two parts, wh = rna_tf32(w)
    and wl = w - wh (wh + wl == w bit for bit), every padded entry zero."""
    rng = np.random.default_rng(cin * cmid + cout)
    w1, b1 = _rand(rng, 3, 3, cin, cmid), _rand(rng, cmid)
    w2, b2 = _rand(rng, 3, 3, cmid, cout), _rand(rng, cout)
    k = tconv.conv3x3_pair_weights(w1, b1, w2, b2, torch.float32)
    cmp, cip = -(-cmid // 64) * 64, -(-cin // 8) * 8
    cop = tconv.pair_f32_coutp(cout)
    assert k.w1.shape == (cmp // 64, cip // 8, 2, 9, 2, 8, 8, 4)
    assert k.w2.shape == (1, cmp // 8, 2, 9, 2, cop // 8, 8, 4)
    for form, raw in ((k.w1, w1), (k.w2, w2)):
        wh, wl = (tconv._unpack_taps(form[:, :, i]) for i in range(2))
        assert torch.equal(wh, tkern.tf32_round(wh))
        full = wh + wl
        assert torch.equal(full[:, :, :raw.shape[2], :raw.shape[3]], raw)
        assert torch.equal(wh[:, :, :raw.shape[2], :raw.shape[3]],
                           tkern.tf32_round(raw))
        full[:, :, :raw.shape[2], :raw.shape[3]] = 0
        assert not full.any()
    a1, c1, a2, c2 = k.hwio
    assert torch.equal(a1, w1) and torch.equal(a2, w2)
    assert torch.equal(c1, b1) and torch.equal(c2, b2)
    assert k.b1[cmid:].abs().sum() == 0 and k.b2[cout:].abs().sum() == 0


@pytest.mark.parametrize("b,h,w", [(1, 1104, 3840), (1, 24, 3840),
                                   (2, 16, 200), (2, 24, 128)])
def test_conv3x3_pair_f32_plan_fits_and_covers_the_canvas(b, h, w):
    """K7's float32 launch at the lab's head shapes (the x4 head's second
    stage and its ring strip) and the card tests' ragged ones, by the
    kernel's own sizes and block decode (csrc/conv3x3_pair.cu: T_SMEM, the
    tile of blockIdx.x, columns fastest): the block's shared memory fits
    the card, and the 6 x 30 tiles cover every output pixel exactly once."""
    th, tw = tconv.PAIR_F32_ROWS, tconv.PAIR_F32_COLS
    halo = (th + 4) * (tw + 4)
    # barriers and the halo's sources, u (8 groups of the 8 x 32 ring's
    # 8-channel rows), three slots (a halo stage, 36 KB of weights)
    smem = (128 + -(-halo * 8 // 128) * 128 + 8 * (th + 2) * (tw + 2) * 32
            + 3 * (halo * 32 + 2 * 9 * 8 * tconv.PAIR_CHUNK * 4))
    assert smem == 211712 <= tkern.SMEM_LIMIT
    nty, ntx = -(-h // th), -(-w // tw)
    hits = torch.zeros(b, h, w, dtype=torch.int32)
    for bid in range(b * nty * ntx):
        y0, x0 = bid // ntx % nty * th, bid % ntx * tw
        hits[bid // (ntx * nty), y0:y0 + th, x0:x0 + tw] += 1
    assert bool((hits == 1).all())


def _pair_block_params(rng, c, heads, dtype, ws=8, hid=None):
    hid = hid or 2 * c
    w = dict(norm1_w=_rand(rng, c), norm1_b=_rand(rng, c),
             qkv_w=_rand(rng, 3 * c, c), qkv_b=_rand(rng, 3 * c),
             proj_w=_rand(rng, c, c), proj_b=_rand(rng, c),
             rpb_table=_rand(rng, (2 * ws - 1) ** 2, heads),
             norm2_w=_rand(rng, c), norm2_b=_rand(rng, c),
             fc1_w=_rand(rng, hid, c), fc1_b=_rand(rng, hid),
             fc2_w=_rand(rng, c, hid), fc2_b=_rand(rng, c))
    return tsb.prepare_swin_params(**w, num_heads=heads, ws=ws, dtype=dtype)


@pytest.mark.parametrize("c,heads", [(180, 6), (48, 2), (60, 6)])
def test_swin_pair_f32_form_splits_and_unpacks_to_the_weights(c, heads):
    """K8's float32 form (swin_pair_f32_weights) at every (C, heads) of
    PAIR_SHAPES: each product's weight packed as mma.sync fragments of its
    two TF32 parts (wh = rna_tf32(w), wh + wl == w bit for bit), unpacked
    exactly the block's matrices and biases (the scale in q), every padded
    entry zero."""
    rng = np.random.default_rng(c * heads)
    p = _pair_block_params(rng, c, heads, torch.float32)
    f = tsb.swin_pair_f32_weights(p, heads)
    for packed in f[:5]:
        assert packed.dim() == 4 and packed.shape[2:] == (32, 4)
        wh = tsb._frag_unpack(torch.stack(
            [packed[..., 0], packed[..., 1], torch.zeros_like(
                packed[..., 0]), torch.zeros_like(packed[..., 0])], -1))
        assert torch.equal(wh, tkern.tf32_round(wh))
        assert torch.equal(wh, tkern.tf32_round(tsb._frag_unpack(packed)))
    u = f.unpack()
    hid = 2 * c
    assert torch.equal(u["wqkv"], tsb._dense(p.wqkv, c, 3 * c))
    assert torch.equal(u["bqkv"], p.bqkv)
    assert torch.equal(u["wproj"], tsb._dense(p.wproj, c, c))
    assert torch.equal(u["bproj"], p.bproj)
    assert torch.equal(u["w1"], tsb._dense(p.w1, c, hid))
    assert torch.equal(u["b1"], p.b1)
    assert torch.equal(u["w2"], tsb._dense(p.w2, hid, c))
    assert torch.equal(u["b2"], p.b2)
    assert u["pads"].abs().sum() == 0
    assert torch.equal(f.ln2, torch.stack([p.ln2_w, p.ln2_b]))
    assert torch.equal(f.rpb, p.rpb)


@pytest.mark.parametrize("c,heads", [(180, 6), (48, 2), (60, 6), (96, 4),
                                     (192, 6)])
def test_swin_pair_f32_plan_fits_the_card(c, heads):
    """K8's float32 plan (pair_f32_dims) at PAIR_SHAPES' (C, heads) and two
    more: the head group is the most heads whose k | v fit beside X, Y and
    q, the block's shared memory fits the card (one block an SM), and
    fc1's chunk takes q's place. C 180 (SwinIR-M's band, 69 x 240 windows:
    one block each) takes groups of 3 heads."""
    d = tsb.pair_f32_dims(c, heads, 2 * c)
    assert d["smem"] <= tkern.SMEM_LIMIT
    assert heads % d["grp"] == 0 and d["hc"] == d["nq"]
    assert d["hidp"] % d["hc"] == 0 and d["hidp"] >= 2 * c
    assert d["kp"] % 8 == 0 and d["hdp"] % 8 == 0
    for g in range(d["grp"] + 1, heads + 1):  # no larger group fits
        if heads % g == 0:
            assert 256 * (2 * (d["kp"] + 4) + d["nq"] + 4 + max(
                2 * g * d["hdp"], d["kp"]) + 4) > tkern.SMEM_LIMIT
    if (c, heads) == (180, 6):
        assert d["grp"] == 3 and d["smem"] == 196608


@pytest.mark.parametrize("c,heads", [(256, 8), (240, 2)])
def test_swin_pair_f32_plan_refuses_what_cannot_fit(c, heads):
    """Four float32 regions of 64 rows at C 256 (the widest bf16 K8 takes)
    or one head's k | v at C 240 with 2 heads exceed the card's 227 KB:
    the plan raises, and so does the wrapper before any launch."""
    with pytest.raises(ValueError, match="does not fit"):
        tsb.pair_f32_dims(c, heads, 2 * c)


def test_swin_pair_f32_form_is_made_once_per_weight():
    """The float32 form, like the bf16 one, is kept on the block's qkv
    weight and remade after an in-place edit."""
    p = _pair_block_params(np.random.default_rng(4), 48, 2, torch.float32)
    f = tsb._pair_cached(p, 2, tsb.swin_pair_f32_weights)
    assert tsb._pair_cached(p, 2, tsb.swin_pair_f32_weights) is f
    p.b2.add_(1.0)
    g = tsb._pair_cached(p, 2, tsb.swin_pair_f32_weights)
    assert g is not f and torch.equal(g.b2[:48], p.b2)


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


# ---------------------------------------------------------------------------
# float32: the split-TF32 forms of K3 and K1 and the float32 K3 plan


def _low13(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def _split_parts(packed, dim):
    return [packed.select(dim, i) for i in range(packed.shape[dim])]


@pytest.mark.parametrize("cin,cout", [(3, 3), (3, 48), (6, 5), (20, 70),
                                      (180, 180), (96, 3), (512, 320),
                                      (64, 1280)])
@pytest.mark.parametrize("rounded", [False, True, "bf16"])
def test_conv3x3_f32_form_splits_the_weights(cin, cout, rounded):
    """The float32 K3 form is wh = rna_tf32(w) (low 13 mantissa bits zero)
    and wl = w - wh exactly, so hwio gives w back bit for bit; bf16-rounded
    weights, in float32 or as bf16 (DiffBIR's served form: its float32
    stages' weights are bf16 parameters), are TF32-exact and hold no wl."""
    rng = np.random.default_rng(cin * 1000 + cout)
    w = _rand(rng, 3, 3, cin, cout)
    if rounded:
        w = w.to(torch.bfloat16).float()
    src = w.to(torch.bfloat16) if rounded == "bf16" else w
    k = tconv.conv3x3_weights(src, None, torch.float32)
    nsl, ns = tconv.conv3x3_f32_slices(cout, k.parts)
    assert k.parts == (1 if rounded else 2)
    assert k.w.shape == (nsl, -(-cin // 8), k.parts, 9, 2, ns // 8, 8, 4)
    assert k.w.is_contiguous() and k.w.dtype == torch.float32
    assert torch.equal(k.hwio, w)
    assert k.hwio.view(torch.int32).equal(w.view(torch.int32))
    parts = _split_parts(k.w, 2)
    assert (_low13(parts[0]) == 0).all()
    wh = tconv._unpack_taps(parts[0])[:, :, :cin, :cout]
    if not rounded:
        wl = tconv._unpack_taps(parts[1])[:, :, :cin, :cout]
        assert torch.equal(wl, w - wh) and torch.equal(wh + wl, w)
        assert torch.equal(wh, tkern.tf32_round(w))
    else:
        assert torch.equal(wh, w)


@pytest.mark.parametrize("k,n", [*K1_WEIGHTS, (8, 24), (36, 24), (4, 3),
                                 (1, 180), (1024, 256), (1028, 180),
                                 (256, 1024), (33, 129)])
@pytest.mark.parametrize("rounded", [False, True, "bf16"])
def test_kernel_matrix_f32_splits_the_weights(k, n, rounded):
    """The float32 K1 form: slices of at most 96 columns, K in stages of
    32, wh with its low 13 bits zero and wl = w - wh exactly; _dense gives
    w back bit for bit; bf16-rounded weights (in float32 or as bf16) hold
    no wl."""
    rng = np.random.default_rng(k * 1000 + n + 7)
    w = _rand(rng, k, n)
    if rounded:
        w = w.to(torch.bfloat16).float()
    src = w.to(torch.bfloat16) if rounded == "bf16" else w
    form = tsb.kernel_matrix(src, torch.float32)
    nsl, ns = tkern.tf32_slices(n, tsb.LINEAR_F32_MAX_N)
    assert ns <= 96
    parts = 1 if rounded else 2
    assert form.shape == (nsl, -(-k // 32), parts, 8, ns // 8, 8, 4)
    assert form.is_contiguous() and form.dtype == torch.float32
    assert ns in tkern.TF32_WIDTHS and (nsl - 1) * ns < n <= nsl * ns
    assert tsb._dense(form, k, n).view(torch.int32).equal(
        w.view(torch.int32))
    hi = _split_parts(form, 2)[0]
    assert (_low13(hi) == 0).all()
    wh = tsb._dense(hi.unsqueeze(2).contiguous(), k, n)
    assert torch.equal(wh, tkern.tf32_round(w))
    if not rounded:
        wl = tsb._dense(_split_parts(form, 2)[1].unsqueeze(2).contiguous(),
                        k, n)
        assert torch.equal(wl, w - wh)


@pytest.mark.parametrize("v", [1.0, -1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                               1.0 + 3 * 2 ** -11, 2 - 2 ** -23, 1.5e-30,
                               -7.5e30, 0.0])
def test_tf32_round_is_nearest_ties_away(v):
    """tf32_round is cvt.rna.tf32.f32: nearest TF32 (10 mantissa bits),
    ties away from zero, the low 13 bits zero."""
    x = torch.tensor([v], dtype=torch.float32)
    got = float(tkern.tf32_round(x))
    m, e = np.frexp(np.float64(x.item()))
    q = np.float64(2.0 ** (e - 11))
    lo = np.floor(np.abs(np.float64(x.item())) / q) * q
    rem = np.abs(np.float64(x.item())) - lo
    want = np.sign(x.item()) * (lo + q if rem >= q / 2 else lo)
    assert got == float(want)


# the float32 K3 plan over canvases of width 16, 32, 136 and 1920 (a few
# rows: coverage is per column tile and row tile), Cin 3 to 2560, Cout 3
# to 1280, both weight forms
_F32_PLAN_CASES = [(2, 16, 16, 2560, 1280), (1, 32, 32, 2560, 1280),
                   (1, 16, 16, 640, 320), (2, 19, 136, 180, 180),
                   (1, 24, 136, 3, 48), (1, 8, 1920, 64, 3),
                   (1, 9, 1920, 180, 60), (3, 21, 32, 512, 512),
                   (1, 16, 16, 8, 1280), (8, 16, 136, 96, 192)]


@pytest.mark.parametrize("shape", _F32_PLAN_CASES,
                         ids=["x".join(map(str, s)) for s in _F32_PLAN_CASES])
@pytest.mark.parametrize("parts", [1, 2])
def test_conv3x3_f32_plan_fits_and_covers(shape, parts):
    """Every block of the float32 K3 plan, by the kernel's own decode
    (conv3x3_blocks): within one K part the blocks cover each output pixel
    and channel exactly once, the parts cover the input channels exactly
    once in contiguous ranges of at least four 8-channel chunks, the
    shared memory fits in 227 KB, and the form's slices are the plan's."""
    b, h, w, cin, cout = shape
    plan = tconv.conv3x3_plan(b, h, w, cin, cout, torch.float32,
                              parts=parts)
    assert plan.smem <= tkern.SMEM_LIMIT and 2 <= plan.stages <= 5
    assert plan.smem == tconv.conv3x3_f32_smem(plan.ns, parts, plan.stages)
    assert plan.ns in tkern.TF32_WIDTHS and plan.threads == 256
    assert plan.ns <= (128 if parts == 1 else 96)
    assert plan.tile in tconv.CONV_F32_TILE_COLS
    assert 1 <= plan.split <= tconv.CONV_F32_MAX_SPLIT
    seen: dict = {}
    for bb, y0, y1, x0, x1, n0, n1, c0, c1 in tconv.conv3x3_blocks(
            plan, b, h, w, cin, cout):
        cov = seen.setdefault((c0, c1), np.zeros((b, h, w, cout), np.uint8))
        if y0 < y1 and x0 < x1:
            cov[bb, y0:y1, x0:x1, n0:n1] += 1
    ranges = sorted(seen)
    assert len(ranges) == plan.split
    assert ranges[0][0] == 0 and ranges[-1][1] == cin
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    nc = -(-cin // 8)
    assert plan.split == 1 or nc // plan.split >= tconv.CONV_F32_MIN_CHUNKS
    for cov in seen.values():
        assert (cov == 1).all()
    if plan.split > 1:
        assert plan.grid <= 132
    wk = torch.zeros(3, 3, cin, cout)
    if parts == 2:
        wk[0, 0, 0, 0] = 1 + 2 ** -20
    k = tconv.conv3x3_weights(wk, None, torch.float32)
    assert k.parts == parts
    assert k.w.shape[0] == plan.slices and k.w.shape[5] * 8 == plan.ns


def test_conv3x3_f32_plan_splits_only_what_cannot_fill_the_card():
    """DiffBIR's UNet at 16 x 16 (2560 -> 1280, bf16-rounded weights) is
    10 slices of two tiles: split six ways into 120 blocks; its 32 x 32
    level (80 blocks) and the VAE's 512 x 512 level are not split."""
    p16 = tconv.conv3x3_plan(1, 16, 16, 2560, 1280, torch.float32, parts=1)
    assert (p16.slices, p16.ns, p16.split, p16.grid) == (10, 128, 6, 120)
    p32 = tconv.conv3x3_plan(1, 32, 32, 2560, 1280, torch.float32, parts=1)
    assert p32.split == 1
    p512 = tconv.conv3x3_plan(1, 512, 512, 512, 512, torch.float32, parts=1)
    assert p512.split == 1 and p512.grid == 64 * 32 * 4  # 8 x 16 tiles


@pytest.mark.parametrize("m,k,n", [(552 * 1920, 180, 540), (8192, 180, 360),
                                   (8192, 360, 180), (61440, 1024, 256),
                                   (1000, 36, 24), (7, 3, 5), (8192, 1028,
                                                               180)])
@pytest.mark.parametrize("parts", [1, 2])
def test_token_linear_f32_plan_fits(m, k, n, parts):
    """The float32 K1 plan: one block per (256-row tile, slice), a ring of
    2-6 stages of 32 k no deeper than K needs, within 227 KB; the form's
    slices are the plan's."""
    plan = tsb.token_linear_f32_plan(m, k, n, parts)
    assert plan.smem <= tkern.SMEM_LIMIT and 2 <= plan.stages <= 6
    assert plan.smem == tsb.token_linear_f32_smem(plan.ns, parts,
                                                  plan.stages)
    assert plan.grid == -(-m // 256) * plan.slices and plan.threads == 512
    assert plan.ns <= 96 and (plan.slices - 1) * plan.ns < n
    assert plan.stages <= max(2, -(-k // 32) + 1)
    form = tsb.kernel_matrix(torch.zeros(k, n), torch.float32)
    assert form.shape[0] == plan.slices and form.shape[4] * 8 == plan.ns
