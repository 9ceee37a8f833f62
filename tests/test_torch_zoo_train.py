"""Whole-model losses of the zoo behind the default toolboxes against
``jax.value_and_grad`` of the JAX package's models on their XLA route:
X-Restormer (K4 and K5 on its fused level, OCAB), MPRNet, MAXIM (two and
three stages), DRBNet and IFAN, whose forwards record a graph since the
Swin slice (every stride-1 3x3 conv on K3). The loss and every
parameter's gradient, each within ``TOL`` x its largest magnitude
(``test_torch_swin_train.family_grads``)."""

import jax
import pytest
import torch

from test_torch_swin_train import _pair, family_grads

torch.set_num_threads(1)


def _half_gain(tree, grads):
    """Every matrix and kernel leaf at half its fan-in draw. At gain 1 the
    random X-Restormer and MAXIM-S3 grow their activations through their
    levels and stages (MAXIM-S3's output reaches 121), and a few small
    gradients are sums of large terms of both signs, whose float32 digits
    are lost on both sides: X-Restormer's channel-attention temperature
    3.4e-4 x max|g| from JAX's, MAXIM-S3's last-stage RCAB conv 1.4e-3,
    where JAX's own float32 gradient is 1.4e-3 from its float64 one. At
    half gain both stay within 1e-5 (measured 8.1e-6 and 6.9e-6)."""
    if grads:
        return tree
    return jax.tree.map(lambda a: a * 0.5 if a.ndim >= 2 else a, tree)


def test_xrestormer_loss_gradients_match_jax():
    """``xrestormer_tiny`` at 64 x 128, batch 2: level 1 at W 128 takes
    the fused route (K5 ``mdta_front``, K4 ``gdfn_block``, their forms
    side inputs and the parameters' views differentiated), the other
    levels the unfused one; OCAB in plain PyTorch. Drawn at half gain
    (``_half_gain``)."""
    x, y = _pair(110, 2, 64, 128)
    tm, _, _ = family_grads("xrestormer_tiny", x, y, 111, prep=_half_gain)
    blk = tm.encoder_level1[0]
    assert blk.fused(torch.zeros(1, 64, 128, blk.norm1.body.weight.numel()))


@pytest.mark.parametrize("name, cfg, hw, prep", [
    ("mprnet_tiny", {}, (32, 64), None),
    ("maxim_tiny", {"num_stages": 2}, (32, 64), None),
    ("maxim_tiny", {"num_stages": 3}, (32, 64), _half_gain),
    ("drbnet_tiny", {}, (32, 48), None),
    ("ifan_tiny", {}, (32, 48), None),
], ids=["mprnet", "maxim_s2", "maxim_s3", "drbnet", "ifan"])
def test_zoo_loss_gradients_match_jax(name, cfg, hw, prep):
    """MPRNet, MAXIM-S2/S3 (S3 at half gain, ``_half_gain``), DRBNet and
    IFAN at their test canvases, batch 2: no forward of theirs runs under
    ``no_grad`` any more."""
    x, y = _pair(120, 2, *hw)
    tm, _, _ = family_grads(name, x, y, 121, cfg=cfg, prep=prep)
    assert all(p.grad is not None for p in tm.parameters())
