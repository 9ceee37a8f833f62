from .from_jax import from_jax, strip_block_params

__all__ = ["from_jax", "strip_block_params"]
