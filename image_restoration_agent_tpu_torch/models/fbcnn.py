"""FBCNN, channels-last (counterpart of
``image_restoration_agent_tpu/models/fbcnn.py``), with the reference's
state-dict names (``network_fbcnn.py``): ``m_head``, ``m_down{1,2,3}``,
``m_body_encoder``, ``m_body_decoder``, ``qf_pred``, ``qf_embed``,
``to_gamma_{1,2,3}``, ``to_beta_{1,2,3}``, ``m_up{3,2,1}``, ``m_tail``.

Blind JPEG artifact removal: a 4-level conv U-Net whose decoder is
modulated by a quality factor, predicted from the bottleneck (ResBlocks ->
mean -> MLP -> sigmoid) or pinned by the caller (``fbcnn_qf5`` /
``fbcnn_qf90``). The QF embedding gives each decoder level a (gamma, beta)
pair: ``x + gamma * res(x) + beta``. Every 3x3 conv runs through
:class:`Conv` (K3 on the card), as the JAX package sends them to its TPU
kernel; the 2x2 stride-2 downs, the 2x2 stride-2 transposed ups and the
MLPs are library calls there and here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import exact_f32
from .common import Conv
from .nafnet import Conv2x2Down
from .registry import ModelSpec, register_model


class ResBlock(nn.Module):
    """``x + conv(relu(conv(x)))``; ``res`` is the reference's
    Sequential(conv, ReLU, conv)."""

    def __init__(self, c: int):
        super().__init__()
        self.res = nn.Sequential(Conv(c, c), nn.ReLU(), Conv(c, c))

    def residual(self, x: torch.Tensor, res=None) -> torch.Tensor:
        return self.res[2](F.relu(self.res[0](x)), res=res)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.residual(x, res=x)


class QFAttention(ResBlock):
    """``x + gamma * res(x) + beta`` with per-channel (B, C) gamma, beta."""

    def forward(self, x, gamma, beta):
        return x + gamma[:, None, None, :] * self.residual(x) \
            + beta[:, None, None, :]


class ConvT2x2(nn.Module):
    """The reference's ``ConvTranspose2d(cin, cout, 2, 2)`` (weight (Cin,
    Cout, 2, 2)) on a channels-last tensor (a library call)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               self.bias.to(x.dtype), stride=2)
        return y.permute(0, 2, 3, 1)


class SpatialMean(nn.Module):
    """(B, H, W, C) -> (B, C): the reference's AdaptiveAvgPool2d(1) and
    Flatten."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))


def _mlp(dims: Sequence[int], final: nn.Module) -> list[nn.Module]:
    """Linear layers with ReLU between them and ``final`` after the last."""
    out: list[nn.Module] = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [nn.Linear(a, b), final if i == len(dims) - 2 else nn.ReLU()]
    return out


class FBCNN(nn.Module):
    def __init__(self, nc: Sequence[int] = (64, 128, 256, 512), nb: int = 4,
                 out_channels: int = 3):
        super().__init__()
        self.m_head = Conv(3, nc[0])
        for k in (1, 2, 3):
            setattr(self, f"m_down{k}", nn.Sequential(
                *[ResBlock(nc[k - 1]) for _ in range(nb)],
                Conv2x2Down(nc[k - 1], nc[k])))
        self.m_body_encoder = nn.Sequential(
            *[ResBlock(nc[3]) for _ in range(nb)])
        self.m_body_decoder = nn.Sequential(
            *[ResBlock(nc[3]) for _ in range(nb)])
        self.qf_pred = nn.Sequential(
            *[ResBlock(nc[3]) for _ in range(nb)], SpatialMean(),
            nn.Identity(), *_mlp((nc[3], 512, 512, 1), nn.Sigmoid()))
        self.qf_embed = nn.Sequential(*_mlp((1, 512, 512, 512), nn.ReLU()))
        for k in (1, 2, 3):
            setattr(self, f"to_gamma_{k}", nn.Sequential(
                nn.Linear(512, nc[k - 1]), nn.Sigmoid()))
            setattr(self, f"to_beta_{k}", nn.Sequential(
                nn.Linear(512, nc[k - 1]), nn.Tanh()))
            setattr(self, f"m_up{k}", nn.ModuleList(
                [ConvT2x2(nc[k], nc[k - 1])]
                + [QFAttention(nc[k - 1]) for _ in range(nb)]))
        self.m_tail = Conv(nc[0], out_channels)

    def forward(self, x: torch.Tensor,
                qf_input: Optional[float] = None) -> torch.Tensor:
        if x.is_cuda and x.dtype == torch.float32:
            exact_f32()
        b, h, w, _ = x.shape
        ph, pw = (-h) % 8, (-w) % 8
        if ph or pw:  # replication pad (reference ReplicationPad2d)
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="replicate").permute(0, 2, 3, 1)
        x1 = self.m_head(x)
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        y = self.m_body_encoder(x4)
        qf = self.qf_pred(y)
        y = self.m_body_decoder(y)
        if qf_input is not None:
            qf = torch.full((b, 1), float(qf_input), dtype=y.dtype,
                            device=y.device)
        emb = self.qf_embed(qf)
        y = y + x4
        for k, skip in ((3, x3), (2, x2), (1, x1)):
            up = getattr(self, f"m_up{k}")
            gamma = getattr(self, f"to_gamma_{k}")(emb)
            beta = getattr(self, f"to_beta_{k}")(emb)
            y = up[0](y)
            for blk in up[1:]:
                y = blk(y, gamma, beta)
            y = y + skip
        return self.m_tail(y)[:, :h, :w, :]


class PinnedQF(FBCNN):
    """FBCNN with a fixed quality-factor input (the reference's fbcnn_5 /
    fbcnn_90), under the same state-dict names."""

    def __init__(self, qf: float, **kw):
        super().__init__(**kw)
        self.qf = qf

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x, qf_input=self.qf)


for _name, _qf in (("fbcnn_blind", None), ("fbcnn_qf5", 5 / 100.0),
                   ("fbcnn_qf90", 90 / 100.0)):
    register_model(ModelSpec(
        name=_name,
        build=FBCNN if _qf is None else
        (lambda qf: (lambda **kw: PinnedQF(qf, **kw)))(_qf),
        subtasks=("jpeg compression artifact removal",),
        pad_multiple=8, pad_kind="edge",
        tile=None,
        config=dict(),
    ))

register_model(ModelSpec(
    name="fbcnn_tiny",
    build=FBCNN,
    subtasks=("jpeg compression artifact removal",),
    pad_multiple=8, pad_kind="edge",
    tile=None,
    config=dict(nc=(8, 12, 16, 24), nb=1),
))
