"""The port's CUDA kernels against their plain versions on the card, at
small shapes. Marked ``gpu``: they skip without a card (decided inside the
fixture, never at import). On the card:
``python -m pytest -m gpu tests/test_torch_kernels.py``."""

import importlib
import math

import pytest
import torch

tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
trf = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.restormer_fused")
troll = importlib.import_module("image_restoration_agent_tpu_torch.ops.roll2d")
tkern = importlib.import_module("image_restoration_agent_tpu_torch.ops.kernels")
tsb = importlib.import_module("image_restoration_agent_tpu_torch.ops.swin_block")
twa = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.window_attention")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


def _block(gen, c, heads, ws, dtype, dev):
    hid = 2 * c
    w = dict(norm1_w=1 + _randn(gen, c, scale=0.1),
             norm1_b=_randn(gen, c, scale=0.1),
             qkv_w=_randn(gen, 3 * c, c, scale=c ** -0.5),
             qkv_b=_randn(gen, 3 * c, scale=0.1),
             proj_w=_randn(gen, c, c, scale=c ** -0.5),
             proj_b=_randn(gen, c, scale=0.1),
             rpb_table=_randn(gen, (2 * ws - 1) ** 2, heads, scale=0.5),
             norm2_w=1 + _randn(gen, c, scale=0.1),
             norm2_b=_randn(gen, c, scale=0.1),
             fc1_w=_randn(gen, hid, c, scale=c ** -0.5),
             fc1_b=_randn(gen, hid, scale=0.1),
             fc2_w=_randn(gen, c, hid, scale=hid ** -0.5),
             fc2_b=_randn(gen, c, scale=0.1))
    return tsb.prepare_swin_params(**{k: v.to(dev) for k, v in w.items()},
                                   num_heads=heads, ws=ws, dtype=dtype)


@pytest.mark.parametrize("ws,c,heads,hw", [
    (8, 180, 6, (32, 48)), (8, 180, 6, (24, 40)), (7, 48, 3, (21, 28)),
    (4, 8, 2, (16, 16))])
@pytest.mark.parametrize("dc_kind", ["zero", "neg", "pos"])
def test_swin_block_kernel_matches_plain_f32(cuda, ws, c, heads, hw,
                                            dc_kind):
    gen = torch.Generator().manual_seed(0)
    s = ws // 2
    dc = {"zero": 0, "neg": -s, "pos": s}[dc_kind]
    x = _randn(gen, 2, *hw, c).to(cuda)
    p = _block(gen, c, heads, ws, torch.float32, cuda)
    n = ws * ws
    bank = None if dc == 0 else torch.from_numpy(
        twa.shift_attention_mask(2 * ws, 2 * ws, ws, s)
        .reshape(2, 2, n, n)).to(cuda)
    kw = dict(num_heads=heads, ws=ws, dc=dc, mask_bank=bank)
    n0 = tsb.swin_block.launches
    got = tsb.swin_block(x, p, **kw)
    assert tsb.swin_block.launches == n0 + 1
    want = tsb.swin_block_plain(x, p, **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ws,c,heads,hw", [
    (8, 180, 6, (32, 48)), (8, 180, 6, (24, 40)), (7, 48, 3, (21, 28)),
    (4, 8, 2, (16, 16))])
@pytest.mark.parametrize("fast", [False, True])
def test_swin_block_kernel_bf16_within_rounding(cuda, ws, c, heads, hw,
                                                fast):
    """bf16 (tensor cores): the RMS error against the plain bf16 version is
    no larger than plain bf16's against plain f32 (the rounding control)."""
    gen = torch.Generator().manual_seed(2)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    state = gen.get_state()
    p16 = _block(gen, c, heads, ws, torch.bfloat16, cuda)
    gen.set_state(state)
    p32 = _block(gen, c, heads, ws, torch.float32, cuda)
    s = ws // 2
    n = ws * ws
    bank = torch.from_numpy(twa.shift_attention_mask(2 * ws, 2 * ws, ws, s)
                            .reshape(2, 2, n, n)).to(cuda)
    kw = dict(num_heads=heads, ws=ws, dc=-s, mask_bank=bank, fast=fast)
    x16 = x32.to(torch.bfloat16)
    got = tsb.swin_block(x16, p16, **kw).float()
    want = tsb.swin_block_plain(x16, p16, **kw).float()
    ref = tsb.swin_block_plain(x32, p32, **kw)
    rms = (got - want).square().mean().sqrt()
    ctrl = (want - ref).square().mean().sqrt()
    assert torch.isfinite(got).all() and rms <= ctrl, (rms, ctrl)


# H 19 is not a multiple of the bf16 kernel's two rows a block; Cout 3 and
# 12 pad to the 8- and 16-column wgmma widths, 768 splits into 3 x 256
@pytest.mark.parametrize("case", [
    dict(cin=3, cout=180), dict(cin=180, cout=180, roll=4, res=True),
    dict(cin=180, cout=180, ln=True, res=True),
    dict(cin=180, cout=64, act="lrelu"), dict(cin=20, cout=70, roll=-7),
    dict(cin=16, cout=16, act="lrelu2", roll=13), dict(cin=3, cout=3),
    dict(cin=64, cout=12), dict(cin=384, cout=768),
    dict(cin=180, cout=60, ln=True, roll=-5, act="lrelu")])
def test_conv3x3_kernel_matches_plain_f32(cuda, case):
    gen = torch.Generator().manual_seed(1)
    cin, cout = case["cin"], case["cout"]
    x = _randn(gen, 2, 19, 70, cin).to(cuda)
    w = _randn(gen, 3, 3, cin, cout, scale=(9 * cin) ** -0.5).to(cuda)
    b = _randn(gen, cout, scale=0.1).to(cuda)
    kw = dict(act=case.get("act"), roll=case.get("roll", 0))
    if case.get("res"):
        kw["res"] = _randn(gen, 2, 19, 70, cout).to(cuda)
    if case.get("ln"):
        kw["ln_pre"] = (1 + _randn(gen, cin, scale=0.1).to(cuda),
                        _randn(gen, cin, scale=0.1).to(cuda))
    got = tconv.conv3x3(x, w, b, **kw)
    want = tconv.conv3x3_plain(x, w, b, **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # bf16 (tensor cores): within the bf16 rounding control in RMS
    kw16 = dict(kw)
    if "res" in kw:
        kw16["res"] = kw["res"].to(torch.bfloat16)
    got16 = tconv.conv3x3(x.to(torch.bfloat16), w, b, **kw16).float()
    want16 = tconv.conv3x3_plain(x.to(torch.bfloat16), w, b, **kw16).float()
    rms = (got16 - want16).square().mean().sqrt()
    ctrl = (want16 - want).square().mean().sqrt()
    assert torch.isfinite(got16).all() and rms <= ctrl, (rms, ctrl)


@pytest.mark.parametrize("n", tkern.GEMM_WIDTHS)
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("a_in_registers", [False, True])
def test_gemm_tile_matches_matmul(cuda, n, k, a_in_registers):
    """One 64 x N x K tile through the Hopper GEMM core (wgmma, B by
    descriptor from the packed weight form, A by descriptor in the
    128-byte swizzle or from registers) against torch.matmul on the same
    bf16 values: float32 sums of exact products, so only the order of the
    sums differs."""
    gen = torch.Generator().manual_seed(n + k)
    a = _randn(gen, 64, k).to(torch.bfloat16)
    w = _randn(gen, k, n).to(torch.bfloat16)
    want = a.float() @ w.float()
    got = tsb.gemm_tile(a.to(cuda), w.to(cuda),
                        a_in_registers=a_in_registers)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


# the band's four K1 shapes (qkv 180 -> 540 gathered, proj 180 -> 180 with
# a gathered residual, fc1 180 -> 360 + GELU from float32 rows, fc2
# 360 -> 180 + residual scattered), a ragged M (240 and 1000 rows: not a
# multiple of 64) and every map mode
_TL_CASES = {
    "qkv": dict(k=180, n=540, ln=True, a_map=1),
    "proj": dict(k=180, n=180, res=True, r_map=1, out=torch.float32),
    "fc1_erf": dict(k=180, n=360, ln=True, gelu="erf", a32=True),
    "fc1_tanh": dict(k=180, n=360, ln=True, gelu="tanh", a32=True),
    "fc2": dict(k=360, n=180, res32=True, o_map=2),
    "ragged": dict(k=36, n=24, ln=True, gelu="tanh", m=1000),
    "ragged_maps": dict(k=48, n=144, ln=True, a_map=1, res=True, r_map=1,
                        o_map=2, ws=4)}


@pytest.mark.parametrize("name", sorted(_TL_CASES))
def test_token_linear_bf16_within_rounding(cuda, name):
    """bf16 K1 (wgmma) against its plain bf16 version, held to the bf16
    rounding control (plain bf16 against plain f32): RMS no larger, the
    largest error no larger than the control's plus one bf16 ulp at the
    output's largest magnitude."""
    case = _TL_CASES[name]
    gen = torch.Generator().manual_seed(7)
    k, n, ws = case["k"], case["n"], case.get("ws", 8)
    geom = (2, 3 * ws, 5 * ws, ws, -(ws // 2))
    m = case.get("m", geom[0] * geom[1] * geom[2])
    a32 = _randn(gen, m, k)
    w = _randn(gen, k, n, scale=k ** -0.5)
    b = _randn(gen, n, scale=0.1).to(cuda)
    ln = (1 + _randn(gen, k, scale=0.1).to(cuda),
          _randn(gen, k, scale=0.1).to(cuda)) if case.get("ln") else None
    res32 = _randn(gen, m, n).to(cuda)
    kw = dict(ln=ln, gelu=case.get("gelu"), a_map=case.get("a_map", 0),
              r_map=case.get("r_map", 0), o_map=case.get("o_map", 0),
              geom=None if m != geom[0] * geom[1] * geom[2] else geom,
              out_dtype=case.get("out", torch.bfloat16))
    a = a32.to(cuda) if case.get("a32") else a32.to(torch.bfloat16).to(cuda)
    res = None
    if case.get("res"):
        res = res32.to(torch.bfloat16)
    elif case.get("res32"):
        res = res32
    w16 = tsb.kernel_matrix(w, torch.bfloat16).to(cuda)
    w32 = tsb.kernel_matrix(w, torch.float32).to(cuda)
    n0 = tsb.token_linear.launches
    got = tsb.token_linear(a, w16, b, res=res, **kw).float()
    assert tsb.token_linear.launches == n0 + 1
    want = tsb.token_linear_plain(a, w16, b, res=res, **kw).float()
    ref = tsb.token_linear_plain(a.float(), w32, b, res=None if res is None
                                 else res.float(), **kw).float()
    d, dc = (got - want).abs(), (want - ref).abs()
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    assert torch.isfinite(got).all()
    assert d.square().mean().sqrt() <= dc.square().mean().sqrt(), name
    assert d.max() <= dc.max() + ulp, name


def _restormer_weights(gen, c, heads, ln_kind, bias, dev):
    hid = int(2.66 * c)
    ln = {"none": None, "biasfree": (1 + _randn(gen, c, scale=0.1),),
          "withbias": (1 + _randn(gen, c, scale=0.1),
                       _randn(gen, c, scale=0.1))}[ln_kind]

    def b(n):
        return _randn(gen, n, scale=0.1) if bias else None

    g = (ln, _randn(gen, c, 2 * hid, scale=c ** -0.5), b(2 * hid),
         _randn(gen, 9, 2 * hid, scale=1 / 3), b(2 * hid),
         _randn(gen, hid, c, scale=hid ** -0.5), b(c))
    m = (ln, _randn(gen, c, 3 * c, scale=c ** -0.5), b(3 * c),
         _randn(gen, 9, 3 * c, scale=1 / 3), b(3 * c),
         _randn(gen, c, c, scale=c ** -0.5), b(c),
         0.5 + torch.rand(heads, generator=gen))

    def to(ws):
        return tuple(None if w is None else
                     tuple(t.to(dev) for t in w) if isinstance(w, tuple)
                     else w.to(dev) for w in ws)
    return to(g), to(m)


# C 48 / 96 / 192 / 384 are Restormer's level widths, C 96 with one head
# its decoder / refinement stage (head width 96); 24 a width whose hidden
# channels (63) leave a ragged chunk and whose head width (12) pads to 16;
# 19x36, 12x40 and 8x20 ragged tiles
_RESTORMER_CASES = [(48, 1, (24, 40)), (96, 2, (19, 36)),
                    (384, 8, (8, 20)), (24, 2, (16, 128)),
                    (96, 1, (19, 36)), (192, 4, (12, 40))]
_RESTORMER_FORMS = [("withbias", False), ("none", False),
                    ("biasfree", True), ("withbias", True)]


def _close_or_within_rounding(got, want, ref32, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4 * float(
            want.abs().max()), rtol=0)
        return
    got, want = got.float(), want.float()
    rms = (got - want).square().mean().sqrt()
    ctrl = (want - ref32.float()).square().mean().sqrt()
    assert torch.isfinite(got).all() and rms <= ctrl, (rms, ctrl)


@pytest.mark.parametrize("c,heads,hw", _RESTORMER_CASES)
@pytest.mark.parametrize("ln_kind,bias", _RESTORMER_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdfn_kernel_matches_plain(cuda, c, heads, hw, ln_kind, bias,
                                   dtype):
    """K4 against gdfn_block_plain: f32 within 1e-4 x max|ref|; bf16 (tanh
    GELU) within the bf16 rounding control in RMS."""
    gen = torch.Generator().manual_seed(4)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    g, _ = _restormer_weights(gen, c, heads, ln_kind, bias, cuda)
    fast = dtype == torch.bfloat16
    x = x32.to(dtype)
    n0 = trf.gdfn_block.launches
    got = trf.gdfn_block(x, trf.gdfn_weights(*g, dtype), fast=fast)
    assert trf.gdfn_block.launches == n0 + 1 and got.dtype == dtype
    _close_or_within_rounding(got, trf.gdfn_block_plain(x, *g, fast=fast),
                              trf.gdfn_block_plain(x32, *g, fast=fast),
                              dtype)


# K5 alone: a head width of 128, whose 3x3 gram tiles outnumber the warps
# (two gram slices), and a ragged head width of 100 (padded to 112)
@pytest.mark.parametrize("c,heads,hw", _RESTORMER_CASES
                         + [(128, 1, (12, 40)), (100, 1, (10, 24))])
@pytest.mark.parametrize("ln_kind,bias", _RESTORMER_FORMS[::2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mdta_kernel_matches_plain(cuda, c, heads, hw, ln_kind, bias,
                                   dtype):
    """K5's v, gram and sums of squares, and the whole MDTA block, against
    the plain versions (rules as for K4); two launches give the same
    bits."""
    gen = torch.Generator().manual_seed(5)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    _, m = _restormer_weights(gen, c, heads, ln_kind, bias, cuda)
    x = x32.to(dtype)
    form = trf.mdta_weights(*m[:7], m[7], heads, dtype)
    n0 = trf.mdta_front.launches
    got = trf.mdta_front(x, form)
    assert trf.mdta_front.launches == n0 + 1
    assert all(torch.equal(a, b) for a, b in zip(got,
                                                 trf.mdta_front(x, form)))
    want = trf.mdta_front_plain(x, *m[:5], heads)
    ref32 = trf.mdta_front_plain(x32, *m[:5], heads)
    for a, b, r in zip(got, want, ref32):
        assert a.shape == b.shape and a.dtype == b.dtype
        _close_or_within_rounding(a, b, r, dtype)
    _close_or_within_rounding(trf.mdta_block(x, form),
                              trf.mdta_block_plain(x, *m, heads),
                              trf.mdta_block_plain(x32, *m, heads), dtype)


@pytest.mark.parametrize("p,c,heads", [(64, 48, 1), (128, 96, 1),
                                        (64, 96, 2), (32, 384, 8),
                                        (48, 24, 2), (16, 100, 1)])
def test_gram_tile_matches_matmul(cuda, p, c, heads):
    """K5's gram step alone (A = q_h^T and B = k_h by ldmatrix.trans from
    pixel-major tiles, at the gram tile K5 takes for (C, heads): 1x2, 3x2,
    1x3 and 3x3 mma tiles a warp across the cases; ragged head widths
    padded to 16) against torch.matmul on the same bf16 values: float32
    sums of exact products, so only the order of the sums differs."""
    gen = torch.Generator().manual_seed(p + c + heads)
    q = _randn(gen, p, c).to(torch.bfloat16)
    k = _randn(gen, p, c).to(torch.bfloat16)
    ch = c // heads
    want = torch.stack([q[:, h * ch:(h + 1) * ch].float().t()
                        @ k[:, h * ch:(h + 1) * ch].float()
                        for h in range(heads)])
    got = trf.gram_tile(q.to(cuda), k.to(cuda), heads)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 8, 8, 4, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tconv.conv3x3(x, torch.zeros(3, 3, 4, 4, device=cuda))
    qkv = torch.zeros(289 * 2, 3 * 8, device=cuda)
    rpb = torch.zeros(2, 289, 289, device=cuda)
    with pytest.raises(ValueError):  # N = 289 > 256
        tsb.window_attention(qkv, rpb, None, num_heads=2, nwy=1, nwx=2,
                             fast=False)
    qkv = torch.zeros(100 * 2, 3 * 9, device=cuda, dtype=torch.bfloat16)
    rpb = torch.zeros(3, 100, 100, device=cuda)
    with pytest.raises(ValueError):  # bf16 at N 100 with head width 3
        tsb.window_attention(qkv, rpb, None, num_heads=3, nwy=1, nwx=2,
                             fast=True)
    with pytest.raises(ValueError):  # shift 3 is not +-ws/2
        troll.roll2d(torch.zeros(1, 16, 16, 4, device=cuda), 3, ws=8)
    def gdfn(c, dtype):
        g = (None, torch.zeros(c, 16), None, torch.zeros(9, 16), None,
             torch.zeros(8, c), None)
        return trf.gdfn_weights(*(None if t is None else t.to(cuda)
                                  for t in g), dtype)

    with pytest.raises(ValueError):  # C = 6 is not a multiple of 4
        trf.gdfn_block(torch.zeros(1, 8, 8, 6, device=cuda),
                       gdfn(6, torch.float32), fast=False)
    with pytest.raises(ValueError):  # kernel form for another dtype
        trf.gdfn_block(torch.zeros(1, 8, 8, 8, device=cuda),
                       gdfn(8, torch.bfloat16), fast=False)


def _mask_kw(kind, ws, h, w, dev):
    """The K2 mask forms: none, the (2, 2, N, N) bank, the full (nW, N, N)
    shift mask (both read as their bit form), and a full mask of many
    values (read as float32)."""
    n, s = ws * ws, ws // 2
    if kind == "bank":
        return dict(bank=torch.from_numpy(twa.shift_attention_mask(
            2 * ws, 2 * ws, ws, s).reshape(2, 2, n, n)).to(dev), mask=None)
    if kind in ("mask", "values"):
        m = torch.from_numpy(twa.shift_attention_mask(h, w, ws, s))
        if kind == "values":
            m = m * (1 + torch.rand(m.shape, generator=torch.Generator()
                                    .manual_seed(ws)))
            assert tsb.mask_bits(m) is None
        return dict(bank=None, mask=m.to(dev))
    return dict(bank=None, mask=None)


# N 256 (HAT's window 16) at head widths 30 and 24, N 100 (a ragged query
# block and padded keys), N 64 (one block per window, every head), N 49
# (window 7: SwinIR's JPEG geometry, padded keys and query rows) and
# DehazeFormer's head width 12 at N 64; the bias dense or as the table
# the kernel rebuilds it from
@pytest.mark.parametrize("ws,c,heads", [(16, 180, 6), (16, 48, 2),
                                        (10, 40, 2), (8, 180, 6),
                                        (7, 180, 6), (8, 48, 4)])
@pytest.mark.parametrize("kind", ["none", "bank", "mask", "values"])
@pytest.mark.parametrize("dtype,fast", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
@pytest.mark.parametrize("bias", ["dense", "table"])
def test_window_attention_wide_and_mask_modes(cuda, ws, c, heads, kind,
                                              dtype, fast, bias):
    """K2 against window_attention_plain: f32 within 1e-4 x max|ref|; bf16
    within the rounding control in RMS."""
    gen = torch.Generator().manual_seed(6)
    n, h, w = ws * ws, 2 * ws, 4 * ws
    t = 2 * h * w
    qkv32 = _randn(gen, t, 3 * c).to(cuda)
    table = _randn(gen, (2 * ws - 1) ** 2, heads, scale=0.5).to(cuda)
    rpb = twa.relative_position_bias(table, ws).contiguous()
    kw = dict(num_heads=heads, nwy=h // ws, nwx=w // ws, fast=fast,
              **_mask_kw(kind, ws, h, w, cuda))
    bank = kw.pop("bank")
    qkv = qkv32.to(dtype)
    n0 = tsb.window_attention.launches
    got = tsb.window_attention(qkv, rpb, bank, **kw,
                               table=table if bias == "table" else None)
    assert tsb.window_attention.launches == n0 + 1 and got.dtype == dtype
    _close_or_within_rounding(
        got, tsb.window_attention_plain(qkv, rpb, bank, **kw),
        tsb.window_attention_plain(qkv32, rpb, bank, **kw), dtype)


@pytest.mark.parametrize("shape,ws", [((2, 32, 48, 180), 16),
                                      ((1, 16, 24, 3), 8),
                                      ((3, 8, 40, 5), 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roll2d_kernel_equals_torch_roll(cuda, shape, ws, dtype):
    """K6 against torch.roll, bit for bit, both signs (16-, 8-, 4- and
    2-byte units)."""
    gen = torch.Generator().manual_seed(7)
    x = _randn(gen, *shape).to(cuda, dtype)
    for shift in (ws // 2, -(ws // 2)):
        n0 = troll.roll2d.launches
        got = troll.roll2d(x, shift, ws=ws)
        assert troll.roll2d.launches == n0 + 1
        assert torch.equal(got, torch.roll(x, (shift, shift), dims=(1, 2)))


@pytest.mark.parametrize("ws,c,heads,hw", [(16, 180, 6, (32, 64)),
                                           (16, 48, 2, (32, 48)),
                                           (8, 180, 6, (24, 40))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swin_attn_block_kernel_matches_plain(cuda, ws, c, heads, hw,
                                              dtype):
    """HAT's half block (K1, K2, K1 scattered to the rolled frame) at dc 0
    and -ws/2 with the bank, against swin_attn_block_plain."""
    gen = torch.Generator().manual_seed(8)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    state = gen.get_state()
    p = _block(gen, c, heads, ws, dtype, cuda)
    gen.set_state(state)
    p32 = _block(gen, c, heads, ws, torch.float32, cuda)
    n, s = ws * ws, ws // 2
    bank = torch.from_numpy(twa.shift_attention_mask(2 * ws, 2 * ws, ws, s)
                            .reshape(2, 2, n, n)).to(cuda)
    x = x32.to(dtype)
    for dc, bk in ((0, None), (-s, bank)):
        kw = dict(num_heads=heads, ws=ws, dc=dc, mask_bank=bk,
                  fast=dtype == torch.bfloat16)
        n0 = tsb.swin_attn_block.launches
        got = tsb.swin_attn_block(x, p, **kw)
        assert tsb.swin_attn_block.launches == n0 + 1
        assert got.shape == x.shape and got.dtype == dtype
        _close_or_within_rounding(got, tsb.swin_attn_block_plain(x, p, **kw),
                                  tsb.swin_attn_block_plain(x32, p32, **kw),
                                  dtype)


@pytest.mark.parametrize("ws,c,heads", [(8, 180, 6), (16, 48, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wmsa_block_kernel_matches_plain(cuda, ws, c, heads, masked, dtype):
    """The partition route's block (K1, K2 full-mask mode, K1) against
    wmsa_block_plain, windows of a 3x5-window canvas, batch 2."""
    gen = torch.Generator().manual_seed(9)
    n, h, w = ws * ws, 3 * ws, 5 * ws
    x32 = _randn(gen, 2 * (h // ws) * (w // ws), n, c).to(cuda)
    state = gen.get_state()
    p = _block(gen, c, heads, ws, dtype, cuda)
    gen.set_state(state)
    p32 = _block(gen, c, heads, ws, torch.float32, cuda)
    mask = torch.from_numpy(twa.shift_attention_mask(
        h, w, ws, ws // 2)).to(cuda) if masked else None
    x = x32.to(dtype)
    n0 = tsb.wmsa_block.launches
    got = tsb.wmsa_block(x, p, num_heads=heads, mask=mask)
    assert tsb.wmsa_block.launches == n0 + 1 and got.dtype == dtype
    _close_or_within_rounding(
        got, tsb.wmsa_block_plain(x, p, num_heads=heads, mask=mask),
        tsb.wmsa_block_plain(x32, p32, num_heads=heads, mask=mask), dtype)


# DehazeFormer's head widths (12 at C 24 / 48, 16 at C 96) at N 64, and a
# 6-wide head of 2 (C 12); windows of a 3x5-window canvas, batch 2
@pytest.mark.parametrize("c,heads", [(24, 2), (48, 4), (96, 6), (12, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wmsa_kernel_matches_plain(cuda, c, heads, masked, dtype):
    """wmsa (K2 with the logit scale head_dim**-0.5, q unscaled) against
    wmsa_plain: f32 within 1e-4 x max|ref|; bf16 within the rounding
    control in RMS."""
    gen = torch.Generator().manual_seed(10)
    h, w = 24, 40
    nwb = 2 * (h // 8) * (w // 8)
    qkv32 = _randn(gen, nwb, 64, 3 * c, scale=1.5).to(cuda)
    rpb = _randn(gen, heads, 64, 64, scale=0.5).to(cuda)
    mask = torch.from_numpy(twa.shift_attention_mask(h, w, 8, 4)).to(
        cuda) if masked else None
    qkv = qkv32.to(dtype)
    n0, k0 = tsb.wmsa.launches, tsb.window_attention.launches
    got = tsb.wmsa(qkv, rpb, mask, num_heads=heads)
    assert tsb.wmsa.launches == n0 + 1
    assert tsb.window_attention.launches == k0 + 1
    assert got.shape == (nwb, 64, c) and got.dtype == dtype
    _close_or_within_rounding(
        got, tsb.wmsa_plain(qkv, rpb, mask, num_heads=heads),
        tsb.wmsa_plain(qkv32, rpb, mask, num_heads=heads), dtype)


# K7: the head's 64 -> 256 -> 12 at a width the 30-column tile divides and
# at ragged ones, a narrow Cin that takes the element-wise staging, and the
# LeakyReLU between the convs
@pytest.mark.parametrize("hw,cin,cmid,cout", [
    ((16, 240), 64, 256, 12), ((8, 136), 64, 256, 12), ((24, 128), 5, 7, 4),
    ((16, 200), 32, 48, 32)])
@pytest.mark.parametrize("act", [None, "lrelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_pair_kernel_matches_plain(cuda, hw, cin, cmid, cout, act,
                                           dtype):
    """K7 against conv3x3_pair_plain: one launch; f32 within 1e-4 x
    max|ref|, bf16 within the rounding control in RMS."""
    gen = torch.Generator().manual_seed(11)
    x32 = _randn(gen, 2, *hw, cin).to(cuda)
    w1 = _randn(gen, 3, 3, cin, cmid, scale=(9 * cin) ** -0.5).to(cuda)
    b1 = _randn(gen, cmid, scale=0.1).to(cuda)
    w2 = _randn(gen, 3, 3, cmid, cout, scale=(9 * cmid) ** -0.5).to(cuda)
    b2 = _randn(gen, cout, scale=0.1).to(cuda)
    x = x32.to(dtype)
    n0 = tconv.conv3x3_pair.launches
    got = tconv.conv3x3_pair(x, w1, b1, w2, b2, act_mid=act)
    assert tconv.conv3x3_pair.launches == n0 + 1
    assert got.shape == (2, *hw, cout) and got.dtype == dtype
    _close_or_within_rounding(
        got, tconv.conv3x3_pair_plain(x, w1, b1, w2, b2, act_mid=act),
        tconv.conv3x3_pair_plain(x32, w1, b1, w2, b2, act_mid=act), dtype)


# K8: SwinIR-M's width (C 180, 6 heads) and a narrow one (C 48, 2 heads,
# head width 24 padded to 32), 2 and 4 windows per row (the wrap to
# window 0), several windows per column, batch 2
@pytest.mark.parametrize("c,heads,hw", [(180, 6, (24, 32)),
                                        (48, 2, (16, 16)),
                                        (48, 2, (32, 32))])
@pytest.mark.parametrize("dc1", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swin_pair_block_kernel_matches_plain(cuda, c, heads, hw, dc1,
                                              dtype):
    """K8 against swin_pair_block_plain (two fast swin_block_plain): one
    launch, no swin_block launch; f32 within 1e-4 x max|ref|, bf16 within
    the rounding control in RMS."""
    gen = torch.Generator().manual_seed(12)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    state = gen.get_state()
    pa, pb = (_block(gen, c, heads, 8, dtype, cuda) for _ in range(2))
    gen.set_state(state)
    pa32, pb32 = (_block(gen, c, heads, 8, torch.float32, cuda)
                  for _ in range(2))
    bank = torch.from_numpy(twa.shift_attention_mask(16, 16, 8, 4)
                            .reshape(2, 2, 64, 64)).to(cuda)
    kw = dict(num_heads=heads, ws=8, dc1=dc1)
    x = x32.to(dtype)
    n0, s0 = tsb.swin_pair_block.launches, tsb.swin_block.launches
    got = tsb.swin_pair_block(x, pa, pb, bank, **kw)
    assert tsb.swin_pair_block.launches == n0 + 1
    assert tsb.swin_block.launches == s0
    assert got.shape == x.shape and got.dtype == dtype
    _close_or_within_rounding(
        got, tsb.swin_pair_block_plain(x, pa, pb, bank, **kw),
        tsb.swin_pair_block_plain(x32, pa32, pb32, bank, **kw), dtype)


# K7's product form (csrc/conv3x3_pair.cu): A read in place by a
# no-swizzle descriptor from pixel dx of the staged halo, B a packed stage
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("dx", [0, 1, 2])
def test_pair_conv_tile_matches_matmul(cuda, k, n, dx):
    """One 64-pixel K7 tile against torch.matmul on the same bf16 values:
    a wrong descriptor gives plausible garbage, not a fault."""
    gen = torch.Generator().manual_seed(k + n + dx)
    a = _randn(gen, 66, k).to(torch.bfloat16)
    w = _randn(gen, k, n).to(torch.bfloat16)
    want = a.float()[dx:dx + 64] @ w.float()
    got = tconv.pair_conv_tile(a.to(cuda), w.to(cuda), dx)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


# K7 in bf16 at the head's widths (64 -> 256) on widths the 62-column tile
# does not divide (968, 136) and 16 rows (not a multiple of its 6), Cout 3,
# 12 (the tail) and 32, with and without the LeakyReLU
@pytest.mark.parametrize("w", [968, 136])
@pytest.mark.parametrize("cout", [3, 12, 32])
@pytest.mark.parametrize("act", [None, "lrelu"])
def test_conv3x3_pair_bf16_ragged_tiles(cuda, w, cout, act):
    """K7 bf16 against conv3x3_pair_plain within the rounding control
    (RMS), batch 2, repeatable bits."""
    gen = torch.Generator().manual_seed(w + cout)
    cin, cmid = 64, 256
    x32 = _randn(gen, 2, 16, w, cin).to(cuda)
    w1 = _randn(gen, 3, 3, cin, cmid, scale=(9 * cin) ** -0.5).to(cuda)
    b1 = _randn(gen, cmid, scale=0.1).to(cuda)
    w2 = _randn(gen, 3, 3, cmid, cout, scale=(9 * cmid) ** -0.5).to(cuda)
    b2 = _randn(gen, cout, scale=0.1).to(cuda)
    x = x32.to(torch.bfloat16)
    k = tconv.conv3x3_pair_weights(w1, b1, w2, b2, torch.bfloat16)
    got = tconv.conv3x3_pair(x, k, act_mid=act)
    assert torch.equal(got, tconv.conv3x3_pair(x, k, act_mid=act))
    _close_or_within_rounding(
        got, tconv.conv3x3_pair_plain(x, w1, b1, w2, b2, act_mid=act),
        tconv.conv3x3_pair_plain(x32, w1, b1, w2, b2, act_mid=act),
        torch.bfloat16)


# K8's product pass (csrc/swin_pair.cu: pass): one warpgroup's column
# slice of a packed K x N weight streamed through the ring, at the band's
# passes (q 192, kv 384 split in two, proj / fc2 192, fc1 384, fc2's K 384
# is two 192-row tiles) and the narrow instantiations' widths
@pytest.mark.parametrize("k,n,n0,nw", [
    (192, 192, 0, 96), (192, 192, 96, 96), (192, 384, 192, 192),
    (192, 384, 0, 192), (64, 48, 24, 24), (128, 64, 32, 32),
    (256, 128, 64, 64), (64, 96, 48, 48)])
def test_pair_gemm_tile_matches_matmul(cuda, k, n, n0, nw):
    """One 64-row K8 pass against torch.matmul on the same bf16 values: a
    wrong descriptor, column offset or stage stride gives plausible
    garbage, not a fault."""
    gen = torch.Generator().manual_seed(k + n + n0)
    a = _randn(gen, 64, k).to(torch.bfloat16)
    w = _randn(gen, k, n).to(torch.bfloat16)
    want = a.float() @ w.float()[:, n0:n0 + nw]
    got = tsb.pair_gemm_tile(a.to(cuda), w.to(cuda), n0, nw)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


# K8 in bf16 at both widths' instantiations and the lightweight one (C 60,
# head width 10), with and without the bank, batch 2, the last window row
# and column wrapping to the first; f32 keeps the parent's kernel
@pytest.mark.parametrize("c,heads,hw", [(180, 6, (16, 32)),
                                        (60, 6, (24, 16)),
                                        (48, 2, (16, 48))])
@pytest.mark.parametrize("dc1", [0, 4])
@pytest.mark.parametrize("banked", [True, False])
def test_swin_pair_block_bf16_forms(cuda, c, heads, hw, dc1, banked):
    """K8 bf16 against swin_pair_block_plain within the rounding control
    (RMS), and repeatable bits: one launch each."""
    gen = torch.Generator().manual_seed(14)
    x32 = _randn(gen, 2, *hw, c).to(cuda)
    state = gen.get_state()
    pa, pb = (_block(gen, c, heads, 8, torch.bfloat16, cuda)
              for _ in range(2))
    gen.set_state(state)
    pa32, pb32 = (_block(gen, c, heads, 8, torch.float32, cuda)
                  for _ in range(2))
    bank = torch.from_numpy(twa.shift_attention_mask(16, 16, 8, 4)
                            .reshape(2, 2, 64, 64)).to(cuda) \
        if banked else None
    kw = dict(num_heads=heads, ws=8, dc1=dc1)
    x = x32.to(torch.bfloat16)
    got = tsb.swin_pair_block(x, pa, pb, bank, **kw)
    assert torch.equal(got, tsb.swin_pair_block(x, pa, pb, bank, **kw))
    _close_or_within_rounding(
        got, tsb.swin_pair_block_plain(x, pa, pb, bank, **kw),
        tsb.swin_pair_block_plain(x32, pa32, pb32, bank, **kw),
        torch.bfloat16)


@pytest.mark.parametrize("mode", ["stacked", "paired_perhead", "noattn",
                                  "base_noproj"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lab_strip_kernel_matches_plain(cuda, mode, dtype):
    """lab_strip (K1, K2 exact with the logit scale, K1; the probes drop
    K2 or the proj launch) against lab_strip_plain, batch 2, C 180."""
    kl = importlib.import_module(
        "image_restoration_agent_tpu_torch.lab.kernel_lab")
    gen = torch.Generator().manual_seed(13)
    c, heads = 180, 6
    x32 = _randn(gen, 2, 16, 32, c).to(cuda)
    wl = (1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1),
          _randn(gen, c, 3 * c, scale=c ** -0.5),
          _randn(gen, 3 * c, scale=0.1), _randn(gen, c, c, scale=c ** -0.5),
          _randn(gen, c, scale=0.1), _randn(gen, heads, 64, 64, scale=0.5))
    wl = tuple(t.to(cuda) for t in wl)
    x = x32.to(dtype)
    n0 = kl.lab_strip.launches
    got = kl.lab_strip(x, *wl, mode=mode)
    assert kl.lab_strip.launches == n0 + 1 and got.dtype == dtype
    _close_or_within_rounding(got, kl.lab_strip_plain(x, *wl, mode=mode),
                              kl.lab_strip_plain(x32, *wl, mode=mode), dtype)
