"""Parallelism (counterpart of ``image_restoration_agent_tpu/parallel``):
process-group meshes, the sharded train step, tile-parallel and
halo-exchange inference, and the multi-rank dry run."""

from .halo_tiling import halo_pad_height, tiled_apply_halo
from .mesh import (Mesh, init_distributed, local_mesh, make_global_mesh,
                   make_mesh)
from .tile_parallel import tiled_apply_sharded
from .train_step import (TrainState, UpdateRule, make_sharded_train_step,
                         make_train_state, param_sharding_rule)

__all__ = [
    "Mesh", "make_mesh", "local_mesh", "init_distributed",
    "make_global_mesh", "tiled_apply_sharded", "tiled_apply_halo",
    "halo_pad_height", "TrainState", "UpdateRule", "make_train_state",
    "make_sharded_train_step", "param_sharding_rule",
]
