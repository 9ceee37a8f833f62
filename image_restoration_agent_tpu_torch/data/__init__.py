from .degrade import (
    DEGRADE_OPS, apply_degradation, synthesize_combo, lowres, add_noise,
    add_jpeg_artifacts, darken, add_haze, add_motion_blur, add_defocus_blur,
    add_rain,
)

__all__ = [
    "DEGRADE_OPS", "apply_degradation", "synthesize_combo",
    "lowres", "add_noise", "add_jpeg_artifacts", "darken", "add_haze",
    "add_motion_blur", "add_defocus_blur", "add_rain",
]
