from .synthetic_goldens import (GOLDEN_ROOT, build_state, fill_tensor,
                                list_synthetic_goldens, load_golden,
                                materialize_synthetic_weights, psnr)

__all__ = ["GOLDEN_ROOT", "build_state", "fill_tensor",
           "list_synthetic_goldens", "load_golden",
           "materialize_synthetic_weights", "psnr"]
