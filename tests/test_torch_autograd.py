"""Gradients through the port's kernels (``ops/autograd.py``): K3
``conv3x3`` with each epilogue, ``Conv``, K4 ``gdfn_block`` and K5
``mdta_front`` (through ``mdta_block``) against ``jax.vjp`` of the JAX
package's XLA route at the same inputs, every float32 gradient within
1e-5 x its largest magnitude; a whole ``nafnet_small`` loss against
``jax.value_and_grad``; every lab kernel (no trained path runs one, and
none has a backward) raising under autograd, naming itself, also through
the ``Trainer``; serving graph-free; and the JAX package's own fault
pinned: ``jax.grad`` cannot pass through its Pallas conv. The Swin
family's kernels' gradients are ``test_torch_swin_train.py``'s."""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.models import build_model as jbuild
from image_restoration_agent_tpu.models.common import Conv as JConv
from image_restoration_agent_tpu.models.common import RestormerLayerNorm
from image_restoration_agent_tpu.models.restormer import GDFN, MDTABlock
from image_restoration_agent_tpu_torch.convert import from_jax
from image_restoration_agent_tpu_torch.models import build_model
from image_restoration_agent_tpu_torch.models.common import Conv
from image_restoration_agent_tpu_torch.ops.conv3x3 import (conv3x3,
                                                           conv3x3_weights)

jc3 = importlib.import_module("image_restoration_agent_tpu.ops.conv3x3")
trf = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.restormer_fused")
tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")

torch.set_num_threads(1)
TOL = 1e-5


def _randomize(tree, seed):
    """Every leaf of a JAX parameter tree redrawn: kernels at fan-in scale,
    norm scales and temperatures near 1, biases small (no zero leaf, so
    every gradient is exercised)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(x.shape).astype(np.float32)
        if x.ndim >= 2:
            return n / np.sqrt(np.prod(x.shape[:-1]))
        if "weight" in name or "temperature" in name or "scale" in name:
            return 1 + 0.1 * n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0,
                               err_msg=what)


def _leaf(t):
    return torch.from_numpy(np.array(t, np.float32)).requires_grad_(True)


# ---------------------------------------------------------------------------
# K3


EPILOGUES = {
    "plain": dict(),
    "lrelu": dict(act="lrelu"),
    "lrelu2": dict(act="lrelu2"),
    "res": dict(res=True),
    "roll": dict(roll=-4),
    "ln_pre": dict(ln=True),
    "all": dict(act="lrelu", res=True, roll=4, ln=True),
}


@pytest.mark.parametrize("form", [False, True], ids=["raw", "form"])
@pytest.mark.parametrize("epi", list(EPILOGUES))
def test_conv3x3_gradients_match_jax(epi, form):
    """K3 through ``ops/autograd.py`` (raw HWIO weights, or the kernel form
    with its source weights as ``params``) against ``jax.vjp`` of the JAX
    ``Conv`` module's XLA route with the same epilogue: x, the weights,
    the bias, the residual and the LayerNorm's scale and bias."""
    cfg = EPILOGUES[epi]
    rng = np.random.default_rng(1)
    b, h, w, cin, cout = 2, 8, 16, 6, 5
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    jm = JConv(cout, act=cfg.get("act"))
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    res = rng.standard_normal((b, h, w, cout)).astype(np.float32) \
        if cfg.get("res") else None
    ln = (1 + 0.1 * rng.standard_normal(cin).astype(np.float32),
          0.1 * rng.standard_normal(cin).astype(np.float32)) \
        if cfg.get("ln") else None
    roll = cfg.get("roll", 0)
    cot = rng.standard_normal((b, h, w, cout)).astype(np.float32)

    def jf(x, p, r, lnp):
        return jm.apply(p, x, res=r, roll=roll, ln_pre=lnp)

    want, vjp = jax.vjp(jf, jnp.asarray(x), params,
                        None if res is None else jnp.asarray(res),
                        None if ln is None else tuple(map(jnp.asarray, ln)))
    gx, gp, gr, gln = vjp(jnp.asarray(cot))

    tx = _leaf(x)
    tw = _leaf(params["params"]["Conv_0"]["kernel"])
    tb = _leaf(params["params"]["Conv_0"]["bias"])
    tr = None if res is None else _leaf(res)
    tln = None if ln is None else tuple(map(_leaf, ln))
    kw = dict(act=cfg.get("act"), res=tr, roll=roll, ln_pre=tln)
    if form:
        y = conv3x3(tx, conv3x3_weights(tw, tb, torch.float32),
                    params=(tw, tb), **kw)
    else:
        y = conv3x3(tx, tw, tb, **kw)
    _close(y, want, "forward")
    y.backward(torch.from_numpy(cot))
    _close(tx.grad, gx, "x")
    _close(tw.grad, gp["params"]["Conv_0"]["kernel"], "weight")
    _close(tb.grad, gp["params"]["Conv_0"]["bias"], "bias")
    if res is not None:
        _close(tr.grad, gr, "res")
    if ln is not None:
        _close(tln[0].grad, gln[0], "ln scale")
        _close(tln[1].grad, gln[1], "ln bias")


def test_conv3x3_form_alone_passes_the_gradient_to_x_only():
    """A kernel form without ``params`` is a constant: x gets its gradient,
    nothing else is asked for."""
    rng = np.random.default_rng(3)
    x = _leaf(rng.standard_normal((1, 8, 8, 4)))
    w = torch.from_numpy(rng.standard_normal((3, 3, 4, 4)).astype(
        np.float32))
    y = conv3x3(x, conv3x3_weights(w, None, torch.float32))
    y.square().sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    conv3x3(xr, w).square().sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=0)


@pytest.mark.parametrize("shuffle, act", [(1, None), (1, "lrelu2"),
                                          (2, None)])
def test_conv_module_gradients_match_jax(shuffle, act):
    """``models.common.Conv`` (cached kernel form, parameters as the
    differentiable inputs) against the JAX ``Conv``'s XLA route with the
    same shuffle epilogue; the weight and bias get JAX's gradients."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cout = 3  # after the shuffle; the conv itself has cout * shuffle**2
    jm = JConv(cout * shuffle * shuffle, act=act, shuffle=shuffle)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    cot_shape = (2, 8 * shuffle, 8 * shuffle, cout)
    cot = rng.standard_normal(cot_shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x, p: jm.apply(p, x), jnp.asarray(x), params)
    gx, gp = vjp(jnp.asarray(cot))

    m = Conv(4, cout * shuffle * shuffle, act=act, shuffle=shuffle)
    sd = from_jax({"intro": params["params"]})  # NAFNet's conv rule
    m.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    tx = _leaf(x)
    y = m(tx)
    _close(y, want, "forward")
    y.backward(torch.from_numpy(cot))
    g = from_jax({"intro": gp["params"]})
    _close(tx.grad, gx, "x")
    _close(m.weight.grad, g["intro.weight"], "weight")
    _close(m.bias.grad, g["intro.bias"], "bias")


# ---------------------------------------------------------------------------
# K4 and K5 against the JAX XLA route of the block halves


class _FfnHalf(fnn.Module):
    """``x + GDFN(LN(x))``: the JAX TransformerBlock's XLA FFN half."""

    bias: bool
    bias_free: bool

    @fnn.compact
    def __call__(self, x):
        y = RestormerLayerNorm(bias_free=self.bias_free, name="norm2")(x)
        return x + GDFN(2.66, self.bias, name="ffn")(y)


class _AttnHalf(fnn.Module):
    """``x + MDTA(LN(x))``: the JAX TransformerBlock's XLA attention half."""

    heads: int
    bias: bool
    bias_free: bool

    @fnn.compact
    def __call__(self, x):
        y = RestormerLayerNorm(bias_free=self.bias_free, name="norm1")(x)
        return x + MDTABlock(self.heads, self.bias, name="attn")(y)


def _k(tree, *path):
    for p in path:
        tree = tree[p]
    return tree


def _ln_leaves(p, name, bias_free):
    return (_leaf(p[name]["weight"]),) if bias_free else (
        _leaf(p[name]["weight"]), _leaf(p[name]["bias"]))


def _conv_leaves(p, *path, bias):
    c = _k(p, *path, "Conv_0")
    kern = np.asarray(c["kernel"])
    return kern, (_leaf(c["bias"]) if bias else None)


@pytest.mark.parametrize("bias_free", [False, True], ids=["withbias",
                                                          "biasfree"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_gdfn_block_gradients_match_jax(bias, bias_free):
    """K4 (``gdfn_block`` with its form and the source weights as
    ``params``) against ``jax.vjp`` of the XLA route: x, the LayerNorm,
    project_in, the depthwise taps, project_out and the biases."""
    rng = np.random.default_rng(6)
    c = 8
    x = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    jm = _FfnHalf(bias, bias_free)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x, p: jm.apply(p, x), jnp.asarray(x), params)
    gx, gp = vjp(jnp.asarray(cot))
    p, g = params["params"], gp["params"]

    ln = _ln_leaves(p, "norm2", bias_free)
    wi, bi = _conv_leaves(p, "ffn", "project_in", bias=bias)
    wd, bd = _conv_leaves(p, "ffn", "dwconv", bias=bias)
    wo, bo = _conv_leaves(p, "ffn", "project_out", bias=bias)
    wi, wd, wo = _leaf(wi[0, 0]), _leaf(wd.reshape(9, -1)), _leaf(wo[0, 0])
    tp = (ln, wi, bi, wd, bd, wo, bo)
    tx = _leaf(x)
    y = trf.gdfn_block(tx, trf.gdfn_weights(*tp, torch.float32),
                       fast=False, params=tp)
    _close(y, want, "forward")
    y.backward(torch.from_numpy(cot))
    _close(tx.grad, gx, "x")
    _close(ln[0].grad, g["norm2"]["weight"], "ln scale")
    if not bias_free:
        _close(ln[1].grad, g["norm2"]["bias"], "ln bias")
    f = g["ffn"]
    _close(wi.grad, f["project_in"]["Conv_0"]["kernel"][0, 0], "w_in")
    _close(wd.grad, f["dwconv"]["Conv_0"]["kernel"].reshape(9, -1), "w_dw")
    _close(wo.grad, f["project_out"]["Conv_0"]["kernel"][0, 0], "w_out")
    if bias:
        for t, mod in ((bi, "project_in"), (bd, "dwconv"),
                       (bo, "project_out")):
            _close(t.grad, f[mod]["Conv_0"]["bias"], mod + " bias")


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_mdta_block_gradients_match_jax(bias, heads):
    """K5 (``mdta_front`` through ``mdta_block`` with the source weights as
    ``params``, its three outputs into the plain epilogue) against
    ``jax.vjp`` of the XLA route: x, the LayerNorm, qkv, the depthwise
    taps, the temperature, project_out and the biases."""
    rng = np.random.default_rng(8)
    c = 8
    x = rng.standard_normal((2, 8, 16, c)).astype(np.float32)
    jm = _AttnHalf(heads, bias, False)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 9)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda x, p: jm.apply(p, x), jnp.asarray(x), params)
    gx, gp = vjp(jnp.asarray(cot))
    p, g = params["params"], gp["params"]

    ln = _ln_leaves(p, "norm1", False)
    wq, bq = _conv_leaves(p, "attn", "qkv", bias=bias)
    wd, bd = _conv_leaves(p, "attn", "qkv_dwconv", bias=bias)
    wp, bp = _conv_leaves(p, "attn", "project_out", bias=bias)
    wq, wd, wp = _leaf(wq[0, 0]), _leaf(wd.reshape(9, -1)), _leaf(wp[0, 0])
    temp = _leaf(p["attn"]["temperature"])
    tp = (ln, wq, bq, wd, bd, wp, bp, temp)
    tx = _leaf(x)
    y = trf.mdta_block(tx, trf.mdta_weights(*tp, heads, torch.float32), tp)
    _close(y, want, "forward")
    y.backward(torch.from_numpy(cot))
    _close(tx.grad, gx, "x")
    _close(ln[0].grad, g["norm1"]["weight"], "ln scale")
    _close(ln[1].grad, g["norm1"]["bias"], "ln bias")
    a = g["attn"]
    _close(wq.grad, a["qkv"]["Conv_0"]["kernel"][0, 0], "w_qkv")
    _close(wd.grad, a["qkv_dwconv"]["Conv_0"]["kernel"].reshape(9, -1),
           "w_dw")
    _close(wp.grad, a["project_out"]["Conv_0"]["kernel"][0, 0], "w_proj")
    _close(temp.grad, a["temperature"], "temperature")
    if bias:
        for t, mod in ((bq, "qkv"), (bd, "qkv_dwconv"),
                       (bp, "project_out")):
            _close(t.grad, a[mod]["Conv_0"]["bias"], mod + " bias")


def test_mdta_front_outputs_all_carry_gradients():
    """Each of K5's three outputs (v, the gram, the sums of squares) passes
    its own cotangent back, as its plain version's autograd does."""
    rng = np.random.default_rng(10)
    c, heads = 8, 2
    params = (( _leaf(1 + 0.1 * rng.standard_normal(c)),
                _leaf(0.1 * rng.standard_normal(c))),
              _leaf(rng.standard_normal((c, 3 * c)) / 3), None,
              _leaf(rng.standard_normal((9, 3 * c)) / 3), None)
    x = rng.standard_normal((1, 8, 16, c)).astype(np.float32)
    form = trf.mdta_weights(*params, _leaf(np.eye(c)), None,
                            torch.ones(heads), heads, torch.float32)
    leaves = [params[0][0], params[0][1], params[1], params[3]]
    for i in range(3):
        tx = _leaf(x)
        out = trf.mdta_front(tx, form, params)[i]
        got = torch.autograd.grad(out.square().sum(), [tx, *leaves])
        tx2 = _leaf(x)
        ref = trf.mdta_front_plain(tx2, *params, num_heads=heads)[i]
        want = torch.autograd.grad(ref.square().sum(), [tx2, *leaves])
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# whole models


def test_nafnet_small_loss_gradients_match_jax():
    """A whole ``nafnet_small`` (width 8) Charbonnier loss: value and every
    parameter's gradient against ``jax.value_and_grad``, the JAX gradient
    tree carried to the port's names and layouts by ``convert.from_jax``
    (every NAFNet leaf's transform is a pure relayout: conv transposes and
    the beta/gamma reshape). beta and gamma are drawn non-zero, so every
    block's convs get a gradient."""
    from image_restoration_agent_tpu.train.losses import \
        charbonnier_loss as jcharb
    from image_restoration_agent_tpu_torch.train import charbonnier_loss

    cfg = dict(width=8, enc_blk_nums=(1,), dec_blk_nums=(1,))
    rng = np.random.default_rng(11)
    x = rng.random((2, 16, 16, 3), dtype=np.float32)
    y = rng.random((2, 16, 16, 3), dtype=np.float32)
    jm = jbuild("nafnet_small", **cfg)
    params = _randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 12)
    loss_j, g_j = jax.value_and_grad(
        lambda p: jcharb(jm.apply(p, jnp.asarray(x)), jnp.asarray(y)))(
            params)

    tm = build_model("nafnet_small", device="cpu", **cfg)
    tm.load_state_dict(from_jax(params), strict=True)
    loss_t = charbonnier_loss(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-6)
    want = from_jax(g_j)
    named = dict(tm.named_parameters())
    assert sorted(want) == sorted(named)
    for name, p in named.items():
        assert p.grad is not None, name
        _close(p.grad, want[name].numpy(), name)


@pytest.mark.parametrize("name, hw", [("restormer_tiny", (16, 128)),
                                      ("nafnet_small", (16, 16))])
def test_no_parameter_is_left_without_a_gradient(name, hw):
    """After ``backward()`` every parameter of a trained family has a
    gradient: K3 (``intro``, ``ending``, Restormer's convs), K4 and K5
    (Restormer's fused level-1 blocks at W 128) pass theirs on."""
    m = build_model(name, device="cpu")
    x = torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(0))
    assert m.encoder_level1[0].fused(torch.zeros(1, *hw, 8)) \
        if name == "restormer_tiny" else True
    m(x).square().mean().backward()
    missing = [n for n, p in m.named_parameters() if p.grad is None]
    assert missing == []


# ---------------------------------------------------------------------------
# kernels without a backward raise; serving records no graph


def _swin_case():
    c, heads, ws = 8, 2, 4
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g) * 0.3

    p = tsb.prepare_swin_params(
        norm1_w=1 + r(c), norm1_b=r(c), qkv_w=r(3 * c, c), qkv_b=r(3 * c),
        proj_w=r(c, c), proj_b=r(c), rpb_table=r((2 * ws - 1) ** 2, heads),
        norm2_w=1 + r(c), norm2_b=r(c), fc1_w=r(2 * c, c), fc1_b=r(2 * c),
        fc2_w=r(c, 2 * c), fc2_b=r(c), num_heads=heads, ws=ws,
        dtype=torch.float32)
    return c, heads, ws, p


def _no_grad_kernels():
    from image_restoration_agent_tpu_torch.lab.kernel_lab import lab_strip
    from image_restoration_agent_tpu_torch.ops.conv3x3 import conv3x3_pair

    c, heads, ws, p = _swin_case()
    x = torch.rand(1, 8, 8, c, requires_grad=True)
    rpb = torch.zeros(heads, ws * ws, ws * ws)
    return {
        "conv3x3_pair": lambda: conv3x3_pair(
            torch.rand(1, 8, 128, 4, requires_grad=True),
            torch.rand(3, 3, 4, 4), torch.rand(4), torch.rand(3, 3, 4, 2),
            torch.rand(2)),
        "swin_pair_block": lambda: tsb.swin_pair_block(
            torch.rand(1, 8, 16, c, requires_grad=True), p, p,
            torch.zeros(2, 2, ws * ws, ws * ws), num_heads=heads, ws=ws,
            dc1=0),
        "lab_strip": lambda: lab_strip(
            x, p.ln1_w, p.ln1_b, torch.rand(c, 3 * c), torch.rand(3 * c),
            torch.rand(c, c), torch.rand(c), rpb, num_heads=heads, ws=ws),
    }


@pytest.mark.parametrize("kernel", list(_no_grad_kernels()))
def test_kernel_without_backward_raises_under_autograd(kernel):
    """Every kernel wrapper without a backward raises a RuntimeError naming
    itself where grad is enabled and an operand requires grad (never a
    silently dropped gradient), and runs under ``torch.no_grad()``."""
    call = _no_grad_kernels()[kernel]
    with pytest.raises(RuntimeError, match=rf"^{kernel}: "):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()


class _PairNet(torch.nn.Module):
    """A trainable model whose forward runs the lab kernel K7
    (``conv3x3_pair``) on its parameters."""

    def __init__(self):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.randn(3, 3, 3, 4) * 0.2)
        self.b1 = torch.nn.Parameter(torch.zeros(4))
        self.w2 = torch.nn.Parameter(torch.randn(3, 3, 4, 3) * 0.2)
        self.b2 = torch.nn.Parameter(torch.zeros(3))

    def forward(self, x):
        from image_restoration_agent_tpu_torch.ops.conv3x3 import \
            conv3x3_pair
        return conv3x3_pair(x, self.w1, self.b1, self.w2, self.b2)


def test_trainer_names_the_lab_kernel_without_a_gradient(tmp_path):
    """A model that runs a lab kernel (no backward) given to the Trainer
    raises naming the kernel, on the train step's path; the same model
    serves under ``torch.no_grad()``."""
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)

    model = _PairNet()
    tr = Trainer(model, TrainConfig(total_iters=1), work_dir=tmp_path,
                 device="cpu")
    x = np.random.default_rng(0).random((1, 8, 128, 3), dtype=np.float32)
    with pytest.raises(RuntimeError, match=r"^conv3x3_pair: "):
        tr.fit(iter([(x, x)]))
    with torch.no_grad():
        assert torch.isfinite(model(torch.from_numpy(x))).all()


def test_engine_serves_without_a_graph(monkeypatch):
    """The Engine runs its model calls under ``torch.no_grad()``: NAFNet
    and Restormer, whose forwards record graphs where grad is enabled,
    record none when served."""
    from image_restoration_agent_tpu_torch.engine import Engine

    seen = []
    eng = Engine(device="cpu")
    img = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
    for name in ("nafnet_small", "restormer_tiny"):
        model = eng.store.get(name)
        handle = model.register_forward_hook(
            lambda m, a, out: seen.append(out.requires_grad))
        eng.restore_array(img, name)
        handle.remove()
    assert seen and not any(seen)


# ---------------------------------------------------------------------------
# the reference's fault, pinned


def test_jax_pallas_conv_has_no_gradient_is_pinned():
    """``jax.grad`` through the JAX package's own TPU conv kernel
    (``conv3x3_pallas``, here in interpret mode) raises: ``pallas_call``
    has no JVP rule for it, so the JAX Trainer trains Conv only on the XLA
    route, never on the kernel it serves with. The port's K3 has a
    backward (the tests above)."""
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.standard_normal((1, 8, 128, 8)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((3, 3, 8, 8)).astype(np.float32))
    out = jc3.conv3x3_pallas(x, w, interpret=True)
    assert out.shape == (1, 8, 128, 8)
    with pytest.raises(AssertionError):
        jax.grad(lambda w: jc3.conv3x3_pallas(x, w, interpret=True).sum())(w)
