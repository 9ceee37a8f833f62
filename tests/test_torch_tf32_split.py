"""The split-TF32 product of the float32 K3 (conv3x3), K1 (token_linear),
K4 (gdfn_block) and K5 (mdta_front) kernels, emulated on the CPU with bit
masks, against the JAX package's float32 results: ``conv3x3_pallas``,
``gdfn_block_pallas`` and ``mdta_block_pallas`` in interpret mode (as their
own tests run them) and ``jnp.dot``.

The kernels split a float32 activation x in registers into xh = rna(x) (TF32:
10 mantissa bits, nearest, ties away from zero) and xl = rna(x - xh), take
the weight's parts from its form, wh = rna(w) and wl = w - wh (read by the
tensor cores as its top 19 bits: truncated to TF32), and sum xl wh + xh wl +
xh wh in float32. The emulation here does the same with integer masks on the
float32 bit patterns; each TF32 x TF32 product is exact, so a term's sum over
K is taken in float64 and the three terms are added in float32 in the
kernels' order. It must stay within the f32 rule the card is held to (max
error <= 1e-4 x max|ref|) at K up to 9 x 512, with LayerNorm-in, the folded
roll, the residual and both LeakyReLU slopes, and on bf16-rounded weights
(no wl: two products). Plain TF32 (xh wh alone) is the control the split
must beat.

K4 and K5 split the activations by integer ops (``common.cuh: split1``):
xl = x - xh is passed whole and read by the tensor cores as its top 19 bits
(``trunc``, not ``rna``). Their blocks are emulated whole in the kernels'
order: LN, the 1x1 in split TF32 with its bias, the ring outside the canvas
zero, the depthwise taps in float32; K4's erf gate and ``project_out`` a
chunk of 32 hidden channels at a time, each chunk's partial added in
float32 (hid 63: a ragged chunk), then the bias and the residual; K5's
per-head gram in split TF32 over runs of 256 pixels added in float32, the
sums of squares of the float32 q and k, and the port's plain epilogue.

K7 (conv3x3_pair) and K8 (swin_pair_block) split their activations the
same way, and are emulated whole in their kernels' order against
``conv3x3_pair_pallas`` and ``swin_pair_strip_pallas`` in interpret mode:
K7's conv1 a 64-channel Cmid chunk at a time, each 8-input-channel stage's
partial added in float32, conv2's partials a stage of 64 / NO 8-channel
chunks (NO: Cout padded to 8, 16 or 32) added in float32 across Cmid; K8's
blocks with every product (q, k, v, q k^T, p v, proj, fc1, fc2) split, k,
v and p split as the attention reads them, the fast numerics (base-2
logits clamped at 86.56, a reciprocal normalization, tanh-GELU), and fc2 a
chunk of nq hidden channels at a time, each partial added onto x1 in
float32."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_agent_tpu.ops.conv3x3 import (conv3x3_pair_pallas,
                                                     conv3x3_pallas)
from image_restoration_agent_tpu.ops.pallas_attention import (
    swin_pair_strip_pallas)
from image_restoration_agent_tpu.ops.window_attention import (
    relative_position_index, shift_attention_mask)
from image_restoration_agent_tpu.ops.restormer_fused import (
    gdfn_block_pallas, mdta_block_pallas)

tkern = importlib.import_module("image_restoration_agent_tpu_torch.ops.kernels")
tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tsb = importlib.import_module("image_restoration_agent_tpu_torch.ops.swin_block")
trf = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.restormer_fused")

torch.set_num_threads(1)

_SLOPES = {None: None, "lrelu": 0.01, "lrelu2": 0.2}


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half a TF32 ulp to the magnitude, clear the
    low 13 bits."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(
        torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand as the tensor cores read TF32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split_product(a: torch.Tensor, w: torch.Tensor, split: bool = True,
                  a_trunc: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N) as the float32 kernels compute it (split=False:
    plain TF32, xh wh alone; a_trunc: xl read as trunc(x - xh), K4's and
    K5's integer split)."""
    ah = rna(a)
    wh = rna(w)
    if not split:
        return (ah.double() @ wh.double()).float()
    al = trunc(a - ah) if a_trunc else rna(a - ah)
    wl = trunc(w - wh)
    acc = (al.double() @ wh.double()).float()
    if bool((wl != 0).any()):
        acc = acc + (ah.double() @ wl.double()).float()
    return acc + (ah.double() @ wh.double()).float()


def _layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def conv_emulated(x, w, b, *, act=None, res=None, roll=0, ln=None,
                  split=True):
    """conv3x3 (SAME, stride 1, channels-last) through split_product: the
    LayerNorm and the roll before the zero padding, then the 9 taps as one
    (pixels, 9 Cin) x (9 Cin, Cout) product; bias, activation, residual."""
    bsz, h, wd, cin = x.shape
    if ln is not None:
        x = _layer_norm(x, *ln)
    if roll:
        x = torch.roll(x, (roll, roll), dims=(1, 2))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, dy:dy + h, dx:dx + wd]
                        for dy in range(3) for dx in range(3)], dim=3)
    y = split_product(cols.reshape(-1, 9 * cin), w.reshape(9 * cin, -1),
                      split) + b
    if act is not None:
        y = F.leaky_relu(y, _SLOPES[act])
    y = y.reshape(bsz, h, wd, -1)
    return y if res is None else y + res


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# (cin, cout, options): LayerNorm-in, roll, residual, both slopes, a
# ragged Cin (3), K = 9 x 512
_CONV_CASES = {
    "plain": (16, 24, {}),
    "cin3": (3, 48, {}),
    "ln_pre": (48, 40, dict(ln=True)),
    "ln_pre_roll_res": (32, 32, dict(ln=True, roll=-4, res=True)),
    "roll_res": (24, 16, dict(roll=3, res=True)),
    "lrelu": (40, 24, dict(act="lrelu")),
    "lrelu2_roll": (16, 20, dict(act="lrelu2", roll=-5)),
    "k9x512": (512, 16, {}),
    "k9x512_rounded": (512, 24, dict(rounded=True, res=True)),
}


@pytest.mark.parametrize("name", sorted(_CONV_CASES))
def test_conv3x3_split_product_matches_jax(name):
    cin, cout, opt = _CONV_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    bsz, h, wd = 2, 8, 16
    x = _np(rng, bsz, h, wd, cin)
    w = _np(rng, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    if opt.get("rounded"):  # DiffBIR's served f32 weights: bf16 values
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    b = _np(rng, cout, scale=0.1)
    res = _np(rng, bsz, h, wd, cout) if opt.get("res") else None
    ln = (1 + _np(rng, cin, scale=0.1), _np(rng, cin, scale=0.1)) \
        if opt.get("ln") else None
    act, roll = opt.get("act"), opt.get("roll", 0)
    want = np.asarray(conv3x3_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act,
        interpret=True, res=None if res is None else jnp.asarray(res),
        roll=roll, ln_pre=None if ln is None else tuple(map(jnp.asarray, ln))))
    t = torch.from_numpy
    kw = dict(act=act, res=None if res is None else t(res), roll=roll,
              ln=None if ln is None else tuple(map(t, ln)))
    got = conv_emulated(t(x), t(w), t(b), **kw).numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * scale, (err, scale)
    # the port's form holds exactly the parts the emulation splits w into
    form = tconv.conv3x3_weights(t(w), t(b), torch.float32)
    assert form.parts == (1 if opt.get("rounded") else 2)
    assert torch.equal(form.hwio, t(w))


@pytest.mark.parametrize("k,n,a_kind", [(36, 24, "f32"), (180, 96, "f32"),
                                        (180, 96, "bf16"), (1024, 64, "f32"),
                                        (360, 40, "rounded_w")])
def test_linear_split_product_matches_jnp_dot(k, n, a_kind):
    """K1's product (bias added after) against jnp.dot in float32: float32
    rows, bf16 rows (exactly TF32: xl = 0), and bf16-rounded weights (wl =
    0), K up to 1024."""
    rng = np.random.default_rng(k + n)
    a = _np(rng, 200, k)
    if a_kind == "bf16":
        a = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    w = _np(rng, k, n, scale=k ** -0.5)
    if a_kind == "rounded_w":
        w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    b = _np(rng, n, scale=0.1)
    want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(w),
                              preferred_element_type=jnp.float32) + b)
    t = torch.from_numpy
    got = (split_product(t(a), t(w)) + t(b)).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    # the port's form: wh and, unless rounded, wl, giving w back exactly
    form = tsb.kernel_matrix(t(w), torch.float32)
    assert form.shape[2] == (1 if a_kind == "rounded_w" else 2)
    assert torch.equal(tsb._dense(form, k, n), t(w))


@pytest.mark.parametrize("k", [9 * 64, 9 * 512])
def test_split_beats_plain_tf32(k):
    """Against a float64 product, the split's error is far below plain
    TF32's (xh wh alone, about 2^-11 relative a product): the third pass
    is what keeps float32 accuracy."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(_np(rng, 128, k))
    w = torch.from_numpy(_np(rng, k, 32, scale=k ** -0.5))
    ref = a.double() @ w.double()
    e_split = float((split_product(a, w).double() - ref).abs().max())
    e_plain = float((split_product(a, w, split=False).double()
                     - ref).abs().max())
    e_f32 = float(((a @ w).double() - ref).abs().max())
    assert e_split * 100 < e_plain
    assert e_split <= 4 * e_f32 + 1e-6


def test_emulation_masks_are_the_ports():
    """The test's masks and the port's tf32_round agree bit for bit, and
    tf32_split gives wh + wl == w."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(_np(rng, 4096, scale=3.0))
    assert torch.equal(tkern.tf32_round(w).view(torch.int32),
                       rna(w).view(torch.int32))
    wh, wl = tkern.tf32_split(w)
    assert torch.equal(wh + wl, w) and torch.equal(wl, w - rna(w))
    assert tkern.tf32_split(w.to(torch.bfloat16).float())[0].equal(
        w.to(torch.bfloat16).float())


# K4 and K5: the blocks at the JAX package's fused-block test shape (the
# port's tests/test_torch_restormer.py): C 24, hid 63 (a ragged chunk)
_RB, _RH, _RW, _RC = 1, 16, 128, 24
_RHID = int(_RC * 2.66)


def _ln_f32(x, ln):
    """The fused blocks' LayerNorm (float32 two-pass, eps 1e-5): None,
    (scale,) BiasFree (mean kept), (scale, bias)."""
    if ln is None:
        return x
    mu = x.mean(-1, keepdim=True)
    rs = torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + 1e-5)
    return x * rs * ln[0] if len(ln) == 1 else (x - mu) * rs * ln[0] + ln[1]


def _one_by_one_taps(x, ln, w, b, w_dw, b_dw, split):
    """LN, the 1x1 in split TF32 (+ bias), the depthwise taps on its output
    with the ring outside the canvas zero (+ bias), float32."""
    bsz, h, wd, c = x.shape
    u = split_product(_ln_f32(x, ln).reshape(-1, c), w, split, a_trunc=True)
    if b is not None:
        u = u + b
    f = u.shape[-1]
    d = F.conv2d(u.reshape(bsz, h, wd, f).permute(0, 3, 1, 2),
                 w_dw.t().reshape(f, 1, 3, 3), padding=1,
                 groups=f).permute(0, 2, 3, 1)
    return d if b_dw is None else d + b_dw


def gdfn_emulated(x, ln, w_in, b_in, w_dw, b_dw, w_out, b_out, split=True):
    """K4's float32 kernel: project_out a chunk of 32 hidden channels at a
    time, each chunk's partial added in float32."""
    hid = w_out.shape[0]
    d = _one_by_one_taps(x, ln, w_in, b_in, w_dw, b_dw, split)
    x1, x2 = d[..., :hid], d[..., hid:]
    gate = (0.5 * x1 * (1 + torch.erf(x1 * 2 ** -0.5)) * x2).reshape(-1, hid)
    acc = torch.zeros(gate.shape[0], x.shape[-1])
    for i in range(0, hid, trf.CHUNK):
        acc = acc + split_product(gate[:, i:i + trf.CHUNK],
                                  w_out[i:i + trf.CHUNK], split, a_trunc=True)
    if b_out is not None:
        acc = acc + b_out
    return acc.reshape(x.shape) + x


def mdta_emulated(x, ln, w_qkv, b_qkv, w_dw, b_dw, w_proj, b_proj, temp,
                  heads, split=True):
    """K5's float32 kernel and the plain epilogue: the gram over runs of
    256 pixels, each run's q_h^T k_h in split TF32 added in float32."""
    bsz, h, wd, c = x.shape
    ch = c // heads
    d = _one_by_one_taps(x, ln, w_qkv, b_qkv, w_dw, b_dw, split)
    q, k, v = d[..., :c], d[..., c:2 * c], d[..., 2 * c:]
    qf, kf = q.reshape(bsz, -1, heads, ch), k.reshape(bsz, -1, heads, ch)
    gram = torch.zeros(bsz, heads, ch, ch)
    for p0 in range(0, qf.shape[1], 256):
        for hh in range(heads):
            for bb in range(bsz):
                gram[bb, hh] += split_product(
                    qf[bb, p0:p0 + 256, hh].t(), kf[bb, p0:p0 + 256, hh],
                    split, a_trunc=True)
    ssq = torch.stack([q.square().sum(dim=(1, 2)),
                       k.square().sum(dim=(1, 2))], dim=1)
    return trf.mdta_epilogue(x, v, gram, ssq, temp, w_proj, b_proj, heads)


def _fused_inputs(seed, ln_kind, bias, n_in, n_out):
    rng = np.random.default_rng(seed)
    c = _RC
    x = _np(rng, _RB, _RH, _RW, c)
    ln = {"none": None, "biasfree": (1 + _np(rng, c, scale=0.1),),
          "withbias": (1 + _np(rng, c, scale=0.1),
                       _np(rng, c, scale=0.1))}[ln_kind]
    b = (lambda n: _np(rng, n, scale=0.1)) if bias else (lambda n: None)
    w = (_np(rng, c, n_in, scale=c ** -0.5), b(n_in),
         _np(rng, 9, n_in, scale=1 / 3), b(n_in),
         _np(rng, n_out, c, scale=n_out ** -0.5), b(c))
    return x, ln, w


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _errors(want, emulate):
    """The split emulation's and plain TF32's largest errors against the
    JAX result, and its largest magnitude."""
    scale = float(np.abs(want).max())
    e_split = float(np.abs(emulate(True).numpy() - want).max())
    e_plain = float(np.abs(emulate(False).numpy() - want).max())
    return e_split, e_plain, scale


_FUSED_FORMS = [("none", False), ("biasfree", False), ("withbias", False),
                ("none", True), ("biasfree", True), ("withbias", True)]


@pytest.mark.parametrize("ln_kind,bias", _FUSED_FORMS)
def test_gdfn_split_matches_pallas(ln_kind, bias):
    """K4's float32 block emulated against gdfn_block_pallas (f32, erf
    GELU, interpret mode): within the f32 rule, and plain TF32 well
    outside the split's error."""
    x, ln, (wi, bi, wd, bd, wo, bo) = _fused_inputs(
        30 + 2 * _FUSED_FORMS.index((ln_kind, bias)), ln_kind, bias,
        2 * _RHID, _RHID)
    want = np.asarray(gdfn_block_pallas(
        jnp.asarray(x), None if ln is None else tuple(map(jnp.asarray, ln)),
        jnp.asarray(wi).reshape(1, 1, _RC, 2 * _RHID), _j(bi),
        jnp.asarray(wd).reshape(3, 3, 1, 2 * _RHID), _j(bd),
        jnp.asarray(wo).reshape(1, 1, _RHID, _RC), _j(bo),
        fastmath=False, interpret=True))
    tl = None if ln is None else tuple(map(_t, ln))
    e_split, e_plain, scale = _errors(want, lambda split: gdfn_emulated(
        _t(x), tl, _t(wi), _t(bi), _t(wd), _t(bd), _t(wo), _t(bo), split))
    assert e_split <= 1e-4 * scale, (e_split, scale)
    assert e_split * 10 < e_plain, (e_split, e_plain)


@pytest.mark.parametrize("ln_kind,bias", _FUSED_FORMS)
@pytest.mark.parametrize("heads", [1, 2])
def test_mdta_split_matches_pallas(heads, ln_kind, bias):
    """K5's float32 front emulated, with the port's epilogue, against
    mdta_block_pallas (f32, interpret mode): within the f32 rule, and plain
    TF32 well outside the split's error."""
    x, ln, (wq, bq, wd, bd, wp, bp) = _fused_inputs(
        50 + 2 * _FUSED_FORMS.index((ln_kind, bias)) + heads, ln_kind, bias,
        3 * _RC, _RC)
    temp = (np.random.default_rng(heads).random(heads) + 0.5).astype(
        np.float32)
    want = np.asarray(mdta_block_pallas(
        jnp.asarray(x), None if ln is None else tuple(map(jnp.asarray, ln)),
        jnp.asarray(wq).reshape(1, 1, _RC, 3 * _RC), _j(bq),
        jnp.asarray(wd).reshape(3, 3, 1, 3 * _RC), _j(bd),
        jnp.asarray(wp).reshape(1, 1, _RC, _RC), _j(bp), jnp.asarray(temp),
        num_heads=heads, interpret=True))
    tl = None if ln is None else tuple(map(_t, ln))
    e_split, e_plain, scale = _errors(want, lambda split: mdta_emulated(
        _t(x), tl, _t(wq), _t(bq), _t(wd), _t(bd), _t(wp), _t(bp),
        _t(temp), heads, split))
    assert e_split <= 1e-4 * scale, (e_split, scale)
    assert e_split * 10 < e_plain, (e_split, e_plain)


# ---------------------------------------------------------------------------
# K7 and K8 (the lab kernels)


def _taps(z):
    """(B, H, W, C) -> (pixels, 9, C): each pixel's 3 x 3 SAME window."""
    bsz, h, wd, c = z.shape
    zp = F.pad(z, (0, 0, 1, 1, 1, 1))
    return torch.stack([zp[:, dy:dy + h, dx:dx + wd] for dy in range(3)
                        for dx in range(3)], dim=3).reshape(-1, 9, c)


def conv_pair_emulated(x, w1, b1, w2, b2, act=None, split=True):
    """K7's float32 kernel (csrc/conv3x3_pair.cu: conv3x3_pair_tf32_kernel):
    conv1 a 64-channel Cmid chunk at a time, each 8-input-channel stage's
    9-tap partial added in float32; u = act(u + b1) with zero padding
    around the canvas; conv2's partials a stage of 64 / NO 8-channel Cmid
    chunks, added in float32 across Cmid; then + b2."""
    bsz, h, wd, cin = x.shape
    cmid, cout = w1.shape[3], w2.shape[3]
    cx = _taps(x)
    u = torch.zeros(cx.shape[0], cmid)
    for m0 in range(0, cmid, tconv.PAIR_CHUNK):
        m1 = min(m0 + tconv.PAIR_CHUNK, cmid)
        for c0 in range(0, cin, 8):
            kc = min(8, cin - c0)
            u[:, m0:m1] = u[:, m0:m1] + split_product(
                cx[:, :, c0:c0 + kc].reshape(-1, 9 * kc),
                w1[:, :, c0:c0 + kc, m0:m1].reshape(9 * kc, m1 - m0), split,
                a_trunc=True)
    u = u + b1
    if act is not None:
        u = F.leaky_relu(u, _SLOPES[act])
    cu = _taps(u.reshape(bsz, h, wd, cmid))
    stage = 8 * (64 // tconv.pair_f32_coutp(cout))
    y = torch.zeros(cu.shape[0], cout)
    for c0 in range(0, cmid, stage):
        kc = min(stage, cmid - c0)
        y = y + split_product(cu[:, :, c0:c0 + kc].reshape(-1, 9 * kc),
                              w2[:, :, c0:c0 + kc].reshape(9 * kc, cout),
                              split, a_trunc=True)
    return (y + b2).reshape(bsz, h, wd, cout)


# (cin, cmid, cout): the head's widths cut down (Cout 12: NO 16), a ragged
# Cmid chunk (80 = 64 + 16) and a ragged Cin stage (5), Cout 32 and 3
_PAIR_CASES = {"head": (16, 64, 12), "ragged": (5, 80, 3),
               "cout32": (24, 48, 32)}


@pytest.mark.parametrize("act", [None, "lrelu"])
@pytest.mark.parametrize("name", sorted(_PAIR_CASES))
def test_conv3x3_pair_split_matches_pallas(name, act):
    """K7's float32 kernel emulated against conv3x3_pair_pallas (f32,
    interpret mode) at (2, 8, 128): within the f32 rule, and plain TF32
    well outside the split's error; its weight form holds both parts."""
    cin, cmid, cout = _PAIR_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + (act is None))
    x = _np(rng, 2, 8, 128, cin)
    w1 = _np(rng, 3, 3, cin, cmid, scale=(9 * cin) ** -0.5)
    b1 = _np(rng, cmid, scale=0.1)
    w2 = _np(rng, 3, 3, cmid, cout, scale=(9 * cmid) ** -0.5)
    b2 = _np(rng, cout, scale=0.1)
    want = np.asarray(conv3x3_pair_pallas(
        *map(jnp.asarray, (x, w1, b1, w2, b2)), act_mid=act, interpret=True))
    t = torch.from_numpy
    e_split, e_plain, scale = _errors(want, lambda split: conv_pair_emulated(
        t(x), t(w1), t(b1), t(w2), t(b2), act, split))
    assert e_split <= 1e-4 * scale, (e_split, scale)
    assert e_split * 10 < e_plain, (e_split, e_plain)
    form = tconv.conv3x3_pair_weights(t(w1), t(b1), t(w2), t(b2),
                                      torch.float32)
    assert form.w1.shape[2] == form.w2.shape[2] == 2
    assert all(torch.equal(a, t(b)) for a, b in zip(form.hwio,
                                                    (w1, b1, w2, b2)))


_PWS = 4
_PN = _PWS * _PWS


def _block_ref(rng, c, heads):
    """Reference-layout (torch nn.Linear) weights of one block, hidden 2C,
    and their JAX strip 13-tuple."""
    def mat(o, i):
        return _np(rng, o, i, scale=i ** -0.5)

    w = dict(norm1_w=1 + _np(rng, c, scale=0.1), norm1_b=_np(rng, c,
                                                               scale=0.1),
             qkv_w=mat(3 * c, c), qkv_b=_np(rng, 3 * c, scale=0.1),
             proj_w=mat(c, c), proj_b=_np(rng, c, scale=0.1),
             rpb_table=_np(rng, (2 * _PWS - 1) ** 2, heads, scale=0.5),
             norm2_w=1 + _np(rng, c, scale=0.1), norm2_b=_np(rng, c,
                                                               scale=0.1),
             fc1_w=mat(2 * c, c), fc1_b=_np(rng, 2 * c, scale=0.1),
             fc2_w=mat(c, 2 * c), fc2_b=_np(rng, c, scale=0.1))
    rpb = w["rpb_table"][relative_position_index(_PWS).reshape(-1)]
    rpb = rpb.reshape(_PN, _PN, heads).transpose(2, 0, 1)
    strip = (w["norm1_w"], w["norm1_b"], w["qkv_w"].T, w["qkv_b"],
             w["proj_w"].T, w["proj_b"], rpb, w["norm2_w"], w["norm2_b"],
             w["fc1_w"].T, w["fc1_b"], w["fc2_w"].T, w["fc2_b"])
    return w, tuple(jnp.asarray(a) for a in strip)


def swin_block_emulated(x, p, heads, dc, bank, hc, split=True):
    """One block of K8's float32 kernel on the whole canvas (each window's
    rows as the kernel computes them): LN1, q, k, v, q k^T, p v, proj, fc1
    and fc2 in split TF32; fc2 a chunk of ``hc`` hidden channels at a time,
    each partial added onto x1 in float32; the output in the rolled frame."""
    b, h, w, c = x.shape
    ws, hd = _PWS, c // heads

    def prod(a, m):
        return split_product(a, m, split, a_trunc=True)

    def ln(v, g, bt):
        mu = v.mean(-1, keepdim=True)
        var = (v - mu).square().mean(-1, keepdim=True)
        return (v - mu) * torch.rsqrt(var + 1e-5) * g + bt

    xr = torch.roll(x, (dc, dc), dims=(1, 2)) if dc else x
    xw = tsb.window_partition(xr, ws).reshape(-1, c)
    qkv = prod(ln(xw, p.ln1_w, p.ln1_b), tsb._dense(p.wqkv, c, 3 * c)) \
        + p.bqkv
    q, k, v = qkv.reshape(-1, _PN, 3, heads, hd).permute(2, 0, 3, 1, 4)
    s = prod(q, k.transpose(-1, -2)) + p.rpb
    if bank is not None:
        s = s + tsb._bank_per_window(bank, h // ws, w // ws).repeat(
            b, 1, 1)[:, None]
    e = torch.exp2(torch.clamp(s * tsb.LOG2E, max=tsb.EXP2_CLAMP))
    o = prod(e * (1.0 / e.sum(-1, keepdim=True)), v)
    o = o.permute(0, 2, 1, 3).reshape(-1, c)
    x1 = prod(o, tsb._dense(p.wproj, c, c)) + p.bproj + xw
    y2 = ln(x1, p.ln2_w, p.ln2_b)
    hid = p.b1.shape[0]
    w1, w2 = tsb._dense(p.w1, c, hid), tsb._dense(p.w2, hid, c)
    for h0 in range(0, hid, hc):
        hdn = prod(y2, w1[:, h0:h0 + hc]) + p.b1[h0:h0 + hc]
        hdn = 0.5 * hdn * (1.0 + torch.tanh(
            0.7978845608 * (hdn + 0.044715 * hdn * hdn * hdn)))
        x1 = x1 + prod(hdn, w2[h0:h0 + hc])
    o = (x1 + p.b2).reshape(b, h // ws, w // ws, ws, ws, c)
    return o.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@pytest.mark.parametrize("dc1", [0, _PWS // 2])
@pytest.mark.parametrize("c,heads,hw", [(8, 2, (16, 16)), (12, 2, (16, 32))])
def test_swin_pair_split_matches_pallas(c, heads, hw, dc1):
    """K8's float32 kernel emulated (block A through roll(x, dc1), block B
    at -ws/2 with the mask bank) against swin_pair_strip_pallas (f32,
    interpret mode): within the f32 rule, and plain TF32 well outside the
    split's error. C 12 takes two fc2 chunks (hid 24, chunk nq 16)."""
    rng = np.random.default_rng(c * 10 + dc1)
    x = _np(rng, 1, *hw, c)
    (wa, ja), (wb, jb) = (_block_ref(rng, c, heads) for _ in range(2))
    bank = shift_attention_mask(2 * _PWS, 2 * _PWS, _PWS, _PWS // 2)
    bank = bank.reshape(2, 2, _PN, _PN).astype(np.float32)
    want = np.asarray(swin_pair_strip_pallas(
        jnp.asarray(x), ja, jb, jnp.asarray(bank), num_heads=heads, ws=_PWS,
        dc1=dc1, interpret=True))
    pa, pb = (tsb.prepare_swin_params(
        **{k: torch.from_numpy(v) for k, v in w.items()}, num_heads=heads,
        ws=_PWS, dtype=torch.float32) for w in (wa, wb))
    hc = tsb.pair_f32_dims(c, heads, 2 * c)["hc"]
    tb = torch.from_numpy(bank)

    def emulate(split):
        a = swin_block_emulated(torch.from_numpy(x), pa, heads, dc1, None,
                                hc, split)
        return swin_block_emulated(a, pb, heads, -_PWS // 2, tb, hc, split)

    e_split, e_plain, scale = _errors(want, emulate)
    assert e_split <= 1e-4 * scale, (e_split, scale)
    assert e_split * 10 < e_plain, (e_split, e_plain)
