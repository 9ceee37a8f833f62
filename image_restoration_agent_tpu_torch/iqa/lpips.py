"""LPIPS (Learned Perceptual Image Patch Similarity), v0.1 'alex'
(counterpart of ``image_restoration_agent_tpu/iqa/lpips.py``).

- ScalingLayer: the input in [-1, 1], shifted and scaled by fixed
  per-channel constants;
- the AlexNet feature trunk (5 conv stages, a tap after each ReLU, a
  VALID 3x3 / 2 max pool before stages 1 and 2);
- per-tap unit normalization over channels (eps 1e-10 on the norm), the
  squared difference, a learned non-negative 1x1 conv head without bias,
  the spatial mean, and the sum over taps.

Parameter names are the ``lpips`` package's: the trunk under
``net.slice{1-5}`` at torchvision's feature indices (``net.slice1.0``,
``net.slice2.3``, ``net.slice3.6``, ``net.slice4.8``, ``net.slice5.10``)
and the heads as ``lin{0-4}.model.1.weight`` (1, C, 1, 1). The
ScalingLayer's constants are buffers that a state dict does not carry.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..device import exact_f32

# ScalingLayer constants (LPIPS v0.1)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet 'features': (torchvision index, out, kernel, stride, pad) of each
# conv, by slice; a max pool (3, 2) leads slices 2 and 3
_ALEX = ((0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
         (8, 256, 3, 1, 1), (10, 256, 3, 1, 1))


class AlexFeatures(nn.Module):
    """AlexNet conv trunk returning the 5 post-ReLU taps of (B, C, H, W)
    input."""

    def __init__(self):
        super().__init__()
        cin = 3
        for k, (idx, cout, ks, s, p) in enumerate(_ALEX):
            mods = OrderedDict()
            if k in (1, 2):
                mods[str(idx - 1)] = nn.MaxPool2d(3, 2)
            mods[str(idx)] = nn.Conv2d(cin, cout, ks, s, p)
            mods[str(idx + 1)] = nn.ReLU()
            setattr(self, f"slice{k + 1}", nn.Sequential(mods))
            cin = cout

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for k in range(len(_ALEX)):
            x = getattr(self, f"slice{k + 1}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    def __init__(self, chn_in: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(chn_in, 1, 1, bias=False))


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """``lpips(img0, img1)`` of (B, H, W, 3) images in [0, 1] -> (B,)."""

    def __init__(self):
        super().__init__()
        self.net = AlexFeatures()
        for k, (_, cout, *_) in enumerate(_ALEX):
            setattr(self, f"lin{k}", NetLinLayer(cout))
        self.register_buffer(
            "shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer(
            "scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        if x0.is_cuda:
            exact_f32()

        def prep(x):
            return (2.0 * x.permute(0, 3, 1, 2) - 1.0 - self.shift) \
                / self.scale

        total = 0.0
        for k, (a, b) in enumerate(zip(self.net(prep(x0)),
                                       self.net(prep(x1)))):
            d = torch.square(_unit_normalize(a) - _unit_normalize(b))
            # the 1x1 conv without bias: a channel-weighted sum
            w = getattr(self, f"lin{k}").model[1].weight.view(1, -1, 1, 1)
            total = total + torch.sum(d * w, dim=1).mean(dim=(1, 2))
        return total
