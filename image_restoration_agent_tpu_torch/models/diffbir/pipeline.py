"""DiffBIR's two-stage generative SR pipeline (counterpart of
``image_restoration_agent_tpu/models/diffbir/pipeline.py``; reference
``model_service/super_resolution/DiffBIR/model_serving.py:77-131``).

A degradation-removal SwinIR (pixel-unshuffle-8 input, nearest+conv x8
head; ``preprocess_model``) cleans the x4 bicubic upsample of the input;
the condition encoder (``cond_encoder``) turns the clean image into the
ControlNet's hint latent; a spaced DDPM sample of the SD2.1-class
ControlLDM (``control_model``, ``model.diffusion_model``) makes the
latent; the VAE (``first_stage_model``) decodes it; a wavelet color fix
puts the clean image's low frequencies under the generated detail.

Text conditioning is the constant ``empty_context`` (the OpenCLIP
empty-prompt embedding, 77 x 1024): a reference checkpoint's
``cond_stage_model`` is consumed once by
:func:`convert.from_jax.extract_empty_context` and not kept.

Dtypes under bfloat16 weights, as the JAX package's promotions give them:
the resize, stage 1 and the condition encoder run bf16 (K1, K2 and K3 in
bf16); the sampler's latent is float32, so the ControlNet, the UNet and
the VAE decoder run float32 arithmetic on bf16-rounded weights (K3's f32
path); the wavelet fix runs in float32. (The JAX pipeline raises there
under bf16 weights: its blur kernel is float32 and the clean image bf16,
and ``conv_general_dilated`` refuses mixed dtypes.)

Each forward draws its noise from a ``torch.Generator`` seeded 231 on the
input's device unless given the draws (the JAX package's ``PRNGKey(231)``
default), so a request is deterministic on a given device.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...device import exact_f32
from ...core.resize import resize_bicubic_jax
from ..registry import ModelSpec, register_model
from ..swinir import SwinIR
from .sampler import SpacedSampler
from .unet import ControlNet, UNetModel
from .vae import AutoencoderKL, CondEncoder

NOISE_SEED = 231


def wavelet_blur(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Dilated 3x3 binomial blur per channel of (B, H, W, C), zero padding
    ``radius``, dilation ``radius`` (the reference wavelet_fix kernel)."""
    if x.is_cuda and x.dtype == torch.float32:
        exact_f32()
    k = torch.tensor([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=torch.float32,
                     device=x.device) / 16.0
    c = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype).expand(c, 1, 3, 3),
                 padding=radius, dilation=radius, groups=c)
    return y.permute(0, 2, 3, 1)


def wavelet_decompose(x: torch.Tensor, levels: int = 5):
    high = torch.zeros_like(x)
    low = x
    for i in range(levels):
        blurred = wavelet_blur(low, 2 ** i)
        high = high + (low - blurred)
        low = blurred
    return high, low


def wavelet_color_fix(content: torch.Tensor,
                      style: torch.Tensor) -> torch.Tensor:
    """The generated detail (high frequencies of ``content``) over the
    clean image's colors (low frequencies of ``style``), in float32."""
    c_high, _ = wavelet_decompose(content.float())
    _, s_low = wavelet_decompose(style.float())
    return c_high + s_low


class _Diffusion(nn.Module):
    """Holds the denoiser under the reference's ``model.diffusion_model``."""

    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


class DiffBIRPipeline(nn.Module):
    """End to end: (B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3) float32."""

    def __init__(self, sr_scale: int = 4, num_steps: int = 50,
                 context_len: int = 77, context_dim: int = 1024,
                 model_channels: int = 320, num_head_channels: int = 64,
                 swin_depths: Sequence[int] = (6,) * 8, swin_dim: int = 180,
                 vae_ch: int = 128):
        super().__init__()
        self.sr_scale, self.num_steps = sr_scale, num_steps
        heads = 6 if swin_dim % 6 == 0 else 2
        self.preprocess_model = SwinIR(
            embed_dim=swin_dim, depths=tuple(swin_depths),
            num_heads=(heads,) * len(swin_depths), window_size=8,
            upscale=8, upsampler="nearest+conv", unshuffle_scale=8,
            img_range=1.0, patch_norm=True)
        self.first_stage_model = AutoencoderKL(ch=vae_ch)
        self.cond_encoder = CondEncoder(ch=vae_ch)
        self.model = _Diffusion(UNetModel(
            model_channels=model_channels,
            num_head_channels=num_head_channels, context_dim=context_dim))
        self.control_model = ControlNet(
            model_channels=model_channels,
            num_head_channels=num_head_channels, context_dim=context_dim)
        self.empty_context = nn.Parameter(
            torch.empty(1, context_len, context_dim))

    def clean(self, lq: torch.Tensor) -> torch.Tensor:
        """Stage 1 alone (degradation removal), in ``lq``'s dtype."""
        if self.sr_scale > 1:
            _, h, w, _ = lq.shape
            lq = resize_bicubic_jax(lq, h * self.sr_scale, w * self.sr_scale)
        return torch.clamp(self.preprocess_model(lq), 0.0, 1.0)

    def eps(self, x: torch.Tensor, hint: torch.Tensor, t: torch.Tensor,
            context: torch.Tensor) -> torch.Tensor:
        control = self.control_model(x, hint, t, context)
        return self.model.diffusion_model(x, t, context, control=control)

    @torch.no_grad()
    def forward(self, lq: torch.Tensor,
                noise: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        """Restores ``lq`` with ``self.num_steps`` sampler steps, the draws
        from a generator seeded 231 on ``lq``'s device; ``noise`` (x_T and
        one draw per step, float32 of the latent's shape) replaces them."""
        clean = self.clean(lq)
        cond = self.cond_encoder(clean * 2.0 - 1.0)
        b = clean.shape[0]
        context = self.empty_context.expand(b, *self.empty_context.shape[1:])
        dev = lq.device
        generator = None
        if noise is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(NOISE_SEED)
        z = SpacedSampler().sample(
            lambda x, t: self.eps(x, cond, t, context), tuple(cond.shape),
            device=dev, generator=generator, num_steps=self.num_steps,
            noise=noise)
        out = self.first_stage_model.decode(z)
        out = torch.clamp((out + 1.0) / 2.0, 0.0, 1.0)
        return wavelet_color_fix(out, clean)


register_model(ModelSpec(
    name="diffbir", build=lambda **kw: DiffBIRPipeline(**kw),
    subtasks=("super-resolution",), scale=4,
    pad_multiple=64, pad_kind="reflect", tile=None, config=dict(),
))

register_model(ModelSpec(
    name="diffbir_tiny", build=lambda **kw: DiffBIRPipeline(**kw),
    subtasks=("super-resolution",), scale=4,
    pad_multiple=16, pad_kind="reflect", tile=None,
    config=dict(num_steps=2, swin_depths=(1,), swin_dim=16,
                model_channels=32, num_head_channels=16, vae_ch=32,
                context_dim=64, context_len=8),
))
