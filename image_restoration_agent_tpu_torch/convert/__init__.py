from .from_jax import (from_jax, read_flat_npz, strip_block_params,
                       write_flat_npz)

__all__ = ["from_jax", "read_flat_npz", "strip_block_params",
           "write_flat_npz"]
