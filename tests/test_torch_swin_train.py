"""Training through the Swin kernels: K1 ``token_linear`` (each prologue
and epilogue), K2 ``window_attention`` (bank, full mask, logit scale,
table), K6 ``roll2d`` and the wrappers built on them (``mlp_block``,
``swin_block``, ``swin_attn_block``, ``wmsa_block``, ``wmsa``), each
value and every input's gradient against ``jax.vjp`` of the JAX package's
XLA counterpart at the same inputs; then whole SwinIR losses (x4 with the
pixel-shuffle head, and denoising) against ``jax.value_and_grad``, and the
``Trainer`` after ``validate``. Every float32 gradient within ``TOL`` x
its largest magnitude (``test_torch_autograd.py``). HAT, DehazeFormer and
RIDCP are in ``test_torch_swin_family_train.py``."""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu.train.losses import \
    charbonnier_loss as jcharb
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.ops.roll2d import roll2d
from image_restoration_agent_tpu_torch.ops.window_attention import \
    relative_position_bias
from image_restoration_agent_tpu_torch.train import charbonnier_loss
from test_torch_autograd import TOL, _close, _randomize

jwa = importlib.import_module(
    "image_restoration_agent_tpu.ops.window_attention")
jsw = importlib.import_module("image_restoration_agent_tpu.models.swinir")
tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")

torch.set_num_threads(1)

B, H, W, WS, C, HEADS = 2, 8, 8, 4, 8, 2
N = WS * WS


def _draw(seed, *shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _check_vjp(jfn, tfn, args, seed=99):
    """``jfn`` (jnp) and ``tfn`` (torch) of the same float32 ``args``: the
    values, and the gradients of every argument under one random
    cotangent, each within ``TOL`` x its largest magnitude. Returns the
    port's gradients."""
    out, pull = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    cot = _draw(seed, *out.shape)
    want = pull(jnp.asarray(cot))
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    got = tfn(*leaves)
    _close(got, np.asarray(out), "value")
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, np.asarray(w), f"grad of argument {i}")
    return grads


def _jln(x, g, b):
    """The JAX package's XLA LayerNorm (``WindowAttentionLayer``)."""
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + 1e-5) * g + b


# ---------------------------------------------------------------------------
# K1 token_linear

K1_CASES = {
    "plain": dict(),
    "ln_gather": dict(ln=True, a_map=tsb.GATHER, dc=-2),
    "erf": dict(ln=True, gelu="erf"),
    "tanh": dict(gelu="tanh"),
    "res_gather_scatter": dict(res=True, r_map=tsb.GATHER,
                               o_map=tsb.SCATTER, dc=2),
    "k1024_res": dict(k=1024, res=True),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_token_linear_gradients_match_jax(case):
    """K1 over the 128 rows of a 2 x 8 x 8 canvas in window order (window
    4), its weight given as the (K, N) matrix the form was made from:
    LayerNorm and the rolled gather in the prologue, erf/tanh GELU, the
    gathered residual and the scatter in the epilogue, and K 1024 (RIDCP's
    fc2, the card's chunked-K form); gradients in the rows, the weight,
    the bias, the LayerNorm's parameters and the residual."""
    cfg = K1_CASES[case]
    m, k, n = B * H * W, cfg.get("k", C), 12
    geom = (B, H, W, WS, cfg.get("dc", 0))
    maps = {key: tsb._row_map(m, cfg.get(key, tsb.IDENTITY), geom,
                              "cpu").numpy()
            for key in ("a_map", "r_map", "o_map")}
    args = [_draw(1, m, k), _draw(2, k, n, scale=k ** -0.5),
            _draw(3, n, scale=0.1)]
    if cfg.get("ln"):
        args += [_draw(4, k, scale=0.1, shift=1.0), _draw(5, k, scale=0.1)]
    if cfg.get("res"):
        args += [_draw(6, m, n)]
    gelu = cfg.get("gelu")

    def jfn(a, w, b, *rest):
        y = a[maps["a_map"]]
        if cfg.get("ln"):
            y, rest = _jln(y, rest[0], rest[1]), rest[2:]
        v = y @ w + b
        if gelu:
            v = jax.nn.gelu(v, approximate=gelu == "tanh")
        if cfg.get("res"):
            v = v + rest[0][maps["r_map"]]
        return jnp.zeros((m, n), jnp.float32).at[maps["o_map"]].set(v)

    def tfn(a, w, b, *rest):
        ln = None
        if cfg.get("ln"):
            ln, rest = (rest[0], rest[1]), rest[2:]
        return tsb.token_linear(
            a, tsb.kernel_matrix(w.detach(), torch.float32), b, ln=ln,
            gelu=gelu, res=rest[0] if cfg.get("res") else None, geom=geom,
            a_map=cfg.get("a_map", tsb.IDENTITY),
            r_map=cfg.get("r_map", tsb.IDENTITY),
            o_map=cfg.get("o_map", tsb.IDENTITY), params=w)

    _check_vjp(jfn, tfn, args)


def test_token_linear_form_alone_passes_the_gradient_to_the_rows_only():
    """Without ``params`` the kernel form is a constant: the rows and the
    bias get their gradients, the form none."""
    a = torch.randn(16, 8, requires_grad=True)
    w = torch.randn(8, 4)
    b = torch.randn(4, requires_grad=True)
    out = tsb.token_linear(a, tsb.kernel_matrix(w, torch.float32), b)
    ga, gb = torch.autograd.grad(out.square().sum(), [a, b])
    a2 = a.detach().requires_grad_(True)
    b2 = b.detach().requires_grad_(True)
    ra, rb = torch.autograd.grad((a2 @ w + b2).square().sum(), [a2, b2])
    torch.testing.assert_close(ga, ra)
    torch.testing.assert_close(gb, rb)


# ---------------------------------------------------------------------------
# K2 window_attention

K2_MODES = ("none", "bank", "mask", "table_bank")


@pytest.mark.parametrize("mode", K2_MODES)
def test_window_attention_gradients_match_jax(mode):
    """K2 over the 8 windows of a 2 x 8 x 8 canvas (window 4, 2 heads of
    width 4) at the logit scale ``hd**-0.5``, against the JAX package's
    ``ops/window_attention.window_attention`` with the bias table: no mask,
    the (2, 2, N, N) shift bank (JAX: the full mask it stands for), the
    full (nW, N, N) mask, and the bank with the table as K2's side input.
    Gradients in qkv and the table (through the differentiable gather of
    ``relative_position_bias``)."""
    shift = WS // 2
    full = jwa.shift_attention_mask(H, W, WS, shift)
    bank = jwa.shift_attention_mask(2 * WS, 2 * WS, WS, shift).reshape(
        2, 2, N, N)
    jmask = None if mode == "none" else jnp.asarray(full)
    args = [_draw(7, B * (H // WS) * (W // WS), N, 3 * C),
            _draw(8, (2 * WS - 1) ** 2, HEADS)]
    scale = (C // HEADS) ** -0.5

    def jfn(qkv, table):
        return jwa.window_attention(qkv, HEADS, table, WS, jmask)

    def tfn(qkv, table):
        kw = dict(num_heads=HEADS, nwy=H // WS, nwx=W // WS, fast=False,
                  scale=scale)
        if mode == "mask":
            kw["mask"] = torch.from_numpy(full)
        if mode == "table_bank":
            kw["table"] = table.detach()
        out = tsb.window_attention(
            qkv.reshape(-1, 3 * C), relative_position_bias(table, WS),
            torch.from_numpy(bank) if "bank" in mode else None, **kw)
        return out.reshape(qkv.shape[0], N, C)

    _check_vjp(jfn, tfn, args)


# ---------------------------------------------------------------------------
# the wrappers


def _jblock(shift):
    """The JAX package's SwinBlock on its XLA route and a randomized
    parameter tree for a (B, H, W, C) canvas."""
    jm = jsw.SwinBlock(C, HEADS, WS, shift, mlp_ratio=2.0,
                       attention_impl="xla")
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros((B, H, W, C))))
    return jm, _randomize(tree, 21 + shift)


ATTN_KEYS = ("norm_scale", "norm_bias", "qkv_kernel", "qkv_bias_p",
             "proj_kernel", "proj_bias_p", "relative_position_bias_table")
MLP_KEYS = ("norm2_scale", "norm2_bias", "fc1_kernel", "fc1_bias",
            "fc2_kernel", "fc2_bias")


def _leaves(tree):
    p = tree["params"]
    return [np.asarray(p["attn"][k]) for k in ATTN_KEYS] + \
        [np.asarray(p[k]) for k in MLP_KEYS]


def _jtree(leaves):
    attn = dict(zip(ATTN_KEYS, leaves[:7]))
    return {"params": {"attn": attn, **dict(zip(MLP_KEYS, leaves[7:]))}}


def _ref(leaves):
    """The port's reference tensors from the JAX leaves (Dense kernels
    (in, out) -> ``nn.Linear`` weights (out, in))."""
    n1s, n1b, wq, bq, wp, bp, tab, n2s, n2b, w1, b1, w2, b2 = leaves
    return tsb.SwinBlockRef(n1s, n1b, wq.t(), bq, wp.t(), bp, tab, n2s, n2b,
                            w1.t(), b1, w2.t(), b2)


def _attn_ref(leaves):
    """The reference tensors of an attention half alone (the seven
    attention leaves; the MLP's unused)."""
    hid = 2 * C
    return _ref([*leaves, torch.ones(C), torch.zeros(C), torch.zeros(C, hid),
                 torch.zeros(hid), torch.zeros(hid, C), torch.zeros(C)])


def _form(ref):
    return tsb.prepare_swin_params(**ref._asdict(), num_heads=HEADS, ws=WS,
                                   dtype=torch.float32)


@pytest.mark.parametrize("shift", [0, WS // 2], ids=["dc0", "dc-ws/2"])
def test_swin_block_gradients_match_jax(shift):
    """``swin_block`` (K1, K2, K1 and ``mlp_block``'s two K1 on the card)
    at dc 0 and at dc -ws/2 with the shift bank, against the JAX
    package's ``SwinBlock`` on its XLA route (the partition route, frame
    0: the port's output is rolled back by the shift); gradients in the
    canvas and in all thirteen reference tensors, the attention scale
    folded into the q columns differentiably."""
    jm, tree = _jblock(shift)
    bank = None
    if shift:
        bank = torch.from_numpy(jwa.shift_attention_mask(
            2 * WS, 2 * WS, WS, shift).reshape(2, 2, N, N))

    def jfn(x, *leaves):
        return jm.apply(_jtree(leaves), x)[0]

    def tfn(x, *leaves):
        ref = _ref(leaves)
        y = tsb.swin_block(x, _form(ref), num_heads=HEADS, ws=WS, dc=-shift,
                           mask_bank=bank, ref=ref)
        return torch.roll(y, (shift, shift), dims=(1, 2))

    _check_vjp(jfn, tfn, [_draw(20, B, H, W, C), *_leaves(tree)])


@pytest.mark.parametrize("shift", [0, WS // 2], ids=["dc0", "dc-ws/2"])
def test_swin_attn_block_and_roll2d_gradients_match_jax(shift):
    """HAT's attention half: ``swin_attn_block`` read through dc -shift
    and, shifted, ``roll2d`` (K6) back by +shift, against the JAX
    package's ``WindowAttentionLayer`` on its XLA route between the
    partition route's rolls (its HAB); gradients in the canvas and the
    seven attention tensors."""
    jm = jsw.WindowAttentionLayer(C, WS, HEADS, attention_impl="xla")
    xw0 = jnp.zeros((B * (H // WS) * (W // WS), N, C))
    full = jwa.shift_attention_mask(H, W, WS, shift)
    tree = _randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), xw0, None)), 31 + shift)
    bank = None
    if shift:
        bank = torch.from_numpy(jwa.shift_attention_mask(
            2 * WS, 2 * WS, WS, shift).reshape(2, 2, N, N))

    def jfn(x, *leaves):
        y = jnp.roll(x, (-shift, -shift), axis=(1, 2))
        yw = jwa.window_partition(y, WS).reshape(-1, N, C)
        yw = jm.apply({"params": dict(zip(ATTN_KEYS, leaves))}, yw,
                      None if full is None else jnp.asarray(full))
        y = jwa.window_reverse(yw.reshape(-1, WS, WS, C), WS, H, W)
        return jnp.roll(y, (shift, shift), axis=(1, 2))

    def tfn(x, *leaves):
        ref = _attn_ref(leaves)
        y = tsb.swin_attn_block(x, _form(ref), num_heads=HEADS, ws=WS,
                                dc=-shift, mask_bank=bank, ref=ref)
        return roll2d(y, shift, WS) if shift else y

    _check_vjp(jfn, tfn, [_draw(30, B, H, W, C),
                          *(np.asarray(tree["params"][k])
                            for k in ATTN_KEYS)])


def test_wmsa_block_gradients_match_jax():
    """SwinIR's partition route: ``wmsa_block`` over the windows of a
    shifted canvas with the full (nW, N, N) mask, against
    ``WindowAttentionLayer`` on its XLA route; gradients in the windows and
    the seven attention tensors."""
    jm = jsw.WindowAttentionLayer(C, WS, HEADS, attention_impl="xla")
    full = jwa.shift_attention_mask(H, W, WS, WS // 2)
    xw = _draw(40, B * (H // WS) * (W // WS), N, C)
    tree = _randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(xw), jnp.asarray(full))), 41)

    def jfn(xw, *leaves):
        return jm.apply({"params": dict(zip(ATTN_KEYS, leaves))}, xw,
                        jnp.asarray(full))

    def tfn(xw, *leaves):
        ref = _attn_ref(leaves)
        return tsb.wmsa_block(xw, _form(ref), num_heads=HEADS,
                              mask=torch.from_numpy(full), ref=ref)

    _check_vjp(jfn, tfn, [xw, *(np.asarray(tree["params"][k])
                                for k in ATTN_KEYS)])


@pytest.mark.parametrize("scatter", [False, True], ids=["rows", "scatter"])
def test_mlp_block_gradients_match_jax(scatter):
    """``mlp_block`` (two K1 on the card) against the JAX package's XLA MLP
    half of ``SwinBlock`` (its LayerNorm, erf-GELU), over rows, and over
    rows in window order scattered to the canvas; gradients in the rows
    and the six reference tensors (``nn.Linear`` layouts given as the
    ``params``)."""
    hid = 2 * C
    args = [_draw(50, B * H * W, C), _draw(51, C, scale=0.1, shift=1.0),
            _draw(52, C, scale=0.1), _draw(53, C, hid, scale=C ** -0.5),
            _draw(54, hid, scale=0.1), _draw(55, hid, C, scale=hid ** -0.5),
            _draw(56, C, scale=0.1)]

    def jfn(x, g, b, w1, b1, w2, b2):
        y = jax.nn.gelu(_jln(x, g, b) @ w1 + b1, approximate=False)
        out = x + (y @ w2 + b2)
        if scatter:
            return jwa.window_reverse(out.reshape(-1, WS, WS, C), WS, H, W)
        return out

    def tfn(x, g, b, w1, b1, w2, b2):
        params = (g, b, w1.t(), b1, w2.t(), b2)
        form = (g.detach(), b.detach(),
                tsb.kernel_matrix(w1.detach(), torch.float32), b1.detach(),
                tsb.kernel_matrix(w2.detach(), torch.float32), b2.detach())
        return tsb.mlp_block(x, *form, params=params,
                             scatter=(B, H, W, WS) if scatter else None)

    _check_vjp(jfn, tfn, args)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_wmsa_gradients_match_jax(masked):
    """DehazeFormer's ``wmsa`` (K2 with the logit scale, q unscaled) against
    the JAX package's XLA window MHSA (``DFWindowAttention``'s math, the
    bias given as an input), with and without a full mask; gradients in
    qkv and in the (heads, N, N) bias, which in DehazeFormer comes out of
    its bias MLP."""
    full = jwa.shift_attention_mask(H, W, WS, WS // 2)
    hd = C // HEADS
    nwb = B * (H // WS) * (W // WS)
    args = [_draw(60, nwb, N, 3 * C), _draw(61, HEADS, N, N)]

    def jfn(qkv, rpb):
        q, k, v = qkv.reshape(nwb, N, 3, HEADS, hd).transpose(2, 0, 3, 1, 4)
        s = jnp.einsum("whnd,whmd->whnm", q * hd ** -0.5, k) + rpb[None]
        if masked:
            nw = full.shape[0]
            s = (s.reshape(nwb // nw, nw, HEADS, N, N)
                 + jnp.asarray(full)[None, :, None]).reshape(s.shape)
        out = jnp.einsum("whnm,whmd->whnd", jax.nn.softmax(s, axis=-1), v)
        return out.transpose(0, 2, 1, 3).reshape(nwb, N, C)

    def tfn(qkv, rpb):
        return tsb.wmsa(qkv, rpb, torch.from_numpy(full) if masked else None,
                        num_heads=HEADS)

    _check_vjp(jfn, tfn, args)


@pytest.mark.parametrize("shift", [WS // 2, -WS // 2], ids=["+", "-"])
def test_roll2d_gradient_is_the_roll_back(shift):
    """K6 ``roll2d`` by +-ws/2: value and gradient against ``jnp.roll``."""
    _check_vjp(lambda x: jnp.roll(x, (shift, shift), axis=(1, 2)),
               lambda x: roll2d(x, shift, WS), [_draw(70, B, H, W, C)])


# ---------------------------------------------------------------------------
# whole models


def family_grads(name, x, y, seed, cfg=None, prep=None, zero=(), tol=TOL):
    """The Charbonnier loss of the registered model ``name`` (``cfg``
    overrides) and every parameter's gradient, the port's against
    ``jax.value_and_grad`` of the JAX model (under ``jax.jit``, on its XLA
    route), with the JAX leaves redrawn by ``_randomize`` and carried over
    by ``convert.from_jax``. ``prep(tree, grads)`` adjusts the drawn tree
    (``grads`` False) and the JAX gradient tree (``grads`` True), e.g. where
    the JAX tree holds one tensor twice. Each gradient within ``tol`` x its
    largest magnitude, but those whose names match a pattern of ``zero``:
    zero in exact arithmetic, both sides' within ``TOL`` x the model's
    largest gradient. A parameter the port leaves without a gradient must
    be one the model names ``gradient_free``, with a JAX gradient of
    exactly 0. Returns (port model, loss, the largest error over max|g|
    of the compared gradients)."""
    cfg = cfg or {}
    jm = jbuild(name, **cfg)
    tree = _randomize(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *x.shape[1:])))), seed)
    if prep is not None:
        tree = prep(tree, False)
    loss_j, g_j = jax.jit(jax.value_and_grad(
        lambda p: jcharb(jm.apply(p, jnp.asarray(x)), jnp.asarray(y))))(tree)
    if prep is not None:
        g_j = prep(g_j, True)

    tm = build_model(name, device="cpu", **cfg)
    tm.load_state_dict(from_jax(tree), strict=True)
    loss_t = charbonnier_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    want = from_jax(jax.tree.map(np.asarray, g_j))
    named = dict(tm.named_parameters())
    assert sorted(want) == sorted(named)
    free = tuple(getattr(tm, "gradient_free", ()))
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for n, p in named.items():
        ref = want[n].numpy()
        if p.grad is None:
            assert n.startswith(free), f"no gradient reached {n}"
            assert not ref.any(), n
            continue
        got = p.grad.numpy()
        if any(re.search(z, n) for z in zero):
            assert max(np.abs(got).max(), np.abs(ref).max()) <= TOL * top, n
            continue
        scale = max(float(np.abs(ref).max()), 1e-30)
        worst = max(worst, float(np.abs(got - ref).max()) / scale)
        np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0,
                                   err_msg=n)
    return tm, loss_t.item(), worst


def _pair(seed, b, h, w, scale=1):
    rng = np.random.default_rng(seed)
    return (rng.random((b, h, w, 3), dtype=np.float32),
            rng.random((b, h * scale, w * scale, 3), dtype=np.float32))


def test_swinir_x4_loss_gradients_match_jax():
    """``swinir_tiny`` (x4, pixel-shuffle head) at a 16 px LR canvas, batch
    2: above the head's 12 px context, so the composed conv and its
    recomputed border ring both run, each upsample conv and ``conv_last``
    on the gradient's path; every Swin block on the strip route (K1, K2)."""
    x, y = _pair(80, 2, 16, 16, 4)
    tm, _, _ = family_grads("swinir_tiny", x, y, 81)
    assert all(p.grad is not None for p in tm.parameters())


def test_swinir_denoise_loss_gradients_match_jax():
    """``swinir_tiny`` as a denoiser (no upsampler, global residual) at 16
    px, batch 2, within 5e-5 x max|g|: measured 2.0e-5, on the first
    block's bias table, whose gradient sums 2 images x 4 windows x 64 x 64
    logit gradients of both signs. Against the JAX model in float64 the
    port's float32 gradients are within 3.1e-5 there and JAX's own float32
    within 1.3e-5: float32 summation, not a fault."""
    x, y = _pair(82, 2, 16, 16)
    family_grads("swinir_tiny", x, y, 83,
                 cfg=dict(upscale=1, upsampler=""), tol=5e-5)


# ---------------------------------------------------------------------------
# the Trainer


def test_trainer_validate_then_fit_trains_every_swinir_parameter(
        tmp_path, monkeypatch):
    """``Trainer.validate`` (under ``no_grad``: it keeps the head's composed
    form) and then training: the gradients after ``validate`` match those
    of the sequential head (every upsample conv and ``conv_last`` run
    alone, exact everywhere, no composed form), none is None (the composed
    head is rebuilt from the live parameters under grad), and ``fit`` on a
    16 px LR crop (64 px HQ) moves every parameter and lowers the loss."""
    from image_restoration_agent_tpu_torch.models import swinir as msw
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)

    rng = np.random.default_rng(90)
    hq = rng.random((4, 64, 64, 3), dtype=np.float32)
    lq = hq.reshape(4, 16, 4, 16, 4, 3).mean(axis=(2, 4))

    def grads(model):
        loss = charbonnier_loss(model(torch.from_numpy(lq[:2])),
                                torch.from_numpy(hq[:2]))
        return torch.autograd.grad(loss, list(model.parameters()),
                                   allow_unused=True)

    model = build_model("swinir_tiny", device="cpu", seed=3)
    tr = Trainer(model, TrainConfig(total_iters=12, batch_size=4,
                                    base_lr=2e-3, log_freq=1),
                 work_dir=tmp_path, device="cpu")
    state = tr.init_state()
    tr.validate(state, [(lq[0], hq[0])])
    assert model._head is not None
    fused = grads(model)
    with monkeypatch.context() as mp:
        mp.setattr(msw, "fused_pixelshuffle_head",
                   lambda x, *a, **k: a[4](x))
        seq = grads(model)
    for (n, _), a, b in zip(model.named_parameters(), fused, seq):
        assert a is not None, n
        _close(a, b.numpy(), n)

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tr.fit(iter([(lq, hq)] * 12), state)
    losses = [h["loss"] for h in tr.history]
    assert len(losses) == 12 and losses[-1] < losses[0]
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    assert still == []
