"""The split-TF32 product of the float32 K3 (conv3x3) and K1 (token_linear)
kernels, emulated on the CPU with bit masks, against the JAX package's
float32 results: ``conv3x3_pallas`` in interpret mode (as its own tests run
it) and ``jnp.dot``.

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
must beat."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from image_restoration_agent_tpu.ops.conv3x3 import conv3x3_pallas

tkern = importlib.import_module("image_restoration_agent_tpu_torch.ops.kernels")
tconv = importlib.import_module("image_restoration_agent_tpu_torch.ops.conv3x3")
tsb = importlib.import_module("image_restoration_agent_tpu_torch.ops.swin_block")

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


def split_product(a: torch.Tensor, w: torch.Tensor,
                  split: bool = True) -> torch.Tensor:
    """(M, K) @ (K, N) as the float32 kernels compute it (split=False:
    plain TF32, xh wh alone)."""
    ah = rna(a)
    wh = rna(w)
    if not split:
        return (ah.double() @ wh.double()).float()
    al = rna(a - ah)
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
