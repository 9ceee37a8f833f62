from .from_jax import (diffbir_checkpoint_state, extract_empty_context,
                       from_jax, read_flat_npz, strip_block_params,
                       write_flat_npz)

__all__ = ["diffbir_checkpoint_state", "extract_empty_context", "from_jax",
           "read_flat_npz", "strip_block_params", "write_flat_npz"]
