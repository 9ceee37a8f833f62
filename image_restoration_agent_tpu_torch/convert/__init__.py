from .from_jax import from_jax

__all__ = ["from_jax"]
