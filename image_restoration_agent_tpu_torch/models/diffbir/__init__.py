"""DiffBIR (counterpart of ``image_restoration_agent_tpu/models/diffbir``):
stage-1 SwinIR, the VAE and condition encoder, the SD2.1-class UNet and
ControlNet, the spaced sampler and the pipeline that registers ``diffbir``
and ``diffbir_tiny``."""

from .pipeline import DiffBIRPipeline
from .sampler import SpacedSampler, space_timesteps
from .unet import ControlNet, UNetModel
from .vae import AutoencoderKL, CondEncoder

__all__ = ["AutoencoderKL", "CondEncoder", "UNetModel", "ControlNet",
           "SpacedSampler", "space_timesteps", "DiffBIRPipeline"]
