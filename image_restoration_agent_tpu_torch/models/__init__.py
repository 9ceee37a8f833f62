from .registry import (MODEL_REGISTRY, ModelSpec, build_model, get_spec,
                       list_models, register_model)

# model modules register themselves on import
from . import dehazeformer as _dehazeformer  # noqa: F401
from . import hat as _hat  # noqa: F401
from . import restormer as _restormer  # noqa: F401
from . import swinir as _swinir  # noqa: F401

__all__ = ["MODEL_REGISTRY", "ModelSpec", "register_model", "build_model",
           "list_models", "get_spec"]
