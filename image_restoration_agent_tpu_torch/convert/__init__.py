from .from_jax import (diffbir_checkpoint_state, extract_empty_context,
                       from_jax, read_flat_npz, strip_block_params,
                       write_flat_npz)
from .maxim_rules import convert_maxim, maxim_name_map
from .torch_import import load_torch_checkpoint, read_state, reference_state

__all__ = ["convert_maxim", "diffbir_checkpoint_state",
           "extract_empty_context", "from_jax", "load_torch_checkpoint",
           "maxim_name_map", "read_flat_npz", "read_state",
           "reference_state", "strip_block_params", "write_flat_npz"]
