from .exploration import exhaust_sequences, explore_fail_rates, expected_tree_counts
from .distill import distill_experience
from .eval_harness import compute_scores, compare_methods
from .synthetic_goldens import (GOLDEN_ROOT, build_state, fill_tensor,
                                list_synthetic_goldens, load_golden,
                                materialize_synthetic_weights, psnr,
                                run_synthetic_golden, validate_synthetic)

__all__ = [
    "exhaust_sequences", "explore_fail_rates", "expected_tree_counts",
    "distill_experience", "compute_scores", "compare_methods",
    "GOLDEN_ROOT", "build_state", "fill_tensor", "list_synthetic_goldens",
    "load_golden", "materialize_synthetic_weights", "psnr",
    "run_synthetic_golden", "validate_synthetic",
]
