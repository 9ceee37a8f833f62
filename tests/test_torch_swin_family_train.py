"""Whole-model losses of the other Swin-kernel families against
``jax.value_and_grad`` of the JAX package's models on their XLA route:
HAT (``swin_attn_block``, ``roll2d``, ``mlp_block``, the CAB's K3 and
OCAB), DehazeFormer (``wmsa`` with the bias MLP's gradient) and RIDCP
(SwinIR's RSTBs with K1 at K 4C, DCNv2, the VQ's gather). The loss and
every parameter's gradient, each within ``TOL`` x its largest magnitude
unless a test states otherwise (``test_torch_swin_train.family_grads``)."""

import jax
import numpy as np
import torch

from test_torch_swin_train import _pair, family_grads

torch.set_num_threads(1)


def _tie_hat_norms(tree, add):
    """The JAX HAB holds ``norm1`` twice: its attention layer's
    ``norm_scale``/``norm_bias`` and the CAB branch's ``norm1``. The port's
    one ``norm1`` takes both; ``convert.from_jax`` refuses copies that
    differ. On parameters the attention layer's copy is set to ``norm1``'s;
    on gradients (``add``) both take their sum, the port's gradient."""
    tree = jax.tree.map(np.asarray, tree)

    def walk(d):
        if not isinstance(d, dict):
            return
        if "attn" in d and "norm1" in d and "norm_scale" in d["attn"]:
            a, n = d["attn"], d["norm1"]
            for ak, nk in (("norm_scale", "scale"), ("norm_bias", "bias")):
                v = a[ak] + n[nk] if add else n[nk]
                a[ak], n[nk] = v, v
        for v in d.values():
            walk(v)

    walk(tree)
    return tree


def test_hat_loss_gradients_match_jax():
    """``hat_tiny`` with two HABs a group (unshifted, then shifted by 4:
    ``roll2d`` on the gradient's path) at a 16 px LR canvas (x4, batch 2):
    each HAB's ``norm1`` gradient is the sum of the JAX tree's two
    copies'."""
    x, y = _pair(100, 2, 16, 16, 4)
    family_grads("hat_tiny", x, y, 101, cfg=dict(depths=(2, 2)),
                 prep=_tie_hat_norms)


def test_dehazeformer_loss_gradients_match_jax():
    """``dehazeformer_tiny`` at 32 x 32, batch 2: window attention (``wmsa``)
    in the three stages that run it, shifted and not, its bias from the
    meta MLP, whose parameters get their gradient through K2's. The bias
    of the MLP's last layer adds one constant to every logit of a head, to
    which the softmax is invariant: its gradient is zero in exact
    arithmetic, on both sides rounding noise below 1e-5 x the model's
    largest gradient."""
    x, y = _pair(102, 2, 32, 32)
    tm, _, _ = family_grads("dehazeformer_tiny", x, y, 103,
                            zero=(r"\.attn\.meta\.2\.bias$",))
    metas = [n for n, p in tm.named_parameters()
             if ".attn.meta.0." in n and p.grad.abs().max() > 0]
    assert metas


def _shift_dcn_bias(tree, grads):
    """The warp's DCN bias drawn around 1, not 0: the fusion
    ``r + warped * mean(r) / (mean(warped) + 1e-8)`` has a pole at
    mean(warped) = 0, and near it float32 gradients lose their digits (at
    bias ~ N(0, 0.1) JAX's own float32 gradients differ from its float64
    ones by up to 7e-3 relative, the port's from JAX's by 2.5e-2)."""
    if grads:
        return tree
    return jax.tree_util.tree_map_with_path(
        lambda p, a: a + 1.0 if "dcn_bias" in jax.tree_util.keystr(p)
        else a, tree)


def test_ridcp_loss_gradients_match_jax():
    """``ridcp_tiny`` at 32 x 32, batch 2 (the fusion's means run over the
    batch): its RSTB (K1, K2; fc2 at K 4C), DCNv2, the GroupNorm
    ResBlocks and the codebook's gather. The first conv of each ResBlock
    feeds a GroupNorm, which removes its bias: that gradient is zero in
    exact arithmetic. The quantizer's input conv and HQ prior reach the
    loss only through the ``argmin`` and ``out_conv`` not at all: they are
    the model's ``gradient_free`` parameters, with no gradient in the port
    and exactly 0 in JAX; every other parameter has one."""
    x, y = _pair(104, 2, 32, 32)
    tm, _, _ = family_grads("ridcp_tiny", x, y, 105, prep=_shift_dcn_bias,
                            zero=(r"\.conv\.2\.bias$",))
    none = sorted(n for n, p in tm.named_parameters() if p.grad is None)
    assert none == ["before_quant_group.0.bias", "before_quant_group.0.weight",
                    "out_conv.bias", "out_conv.weight",
                    "quantize_group.0.weight"]
    assert tm.quantize_group[0].embedding.weight.grad.abs().max() > 0
