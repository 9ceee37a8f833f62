from .synthetic_goldens import (GOLDEN_ROOT, build_state, fill_tensor,
                                load_golden, psnr)

__all__ = ["GOLDEN_ROOT", "build_state", "fill_tensor", "load_golden",
           "psnr"]
