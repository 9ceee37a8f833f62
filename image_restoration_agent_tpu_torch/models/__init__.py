from .registry import (MODEL_REGISTRY, ModelSpec, build_model, get_spec,
                       list_models, register_model)

# model modules register themselves on import
from . import dehazeformer as _dehazeformer  # noqa: F401
from . import diffbir as _diffbir  # noqa: F401
from . import drbnet as _drbnet  # noqa: F401
from . import fbcnn as _fbcnn  # noqa: F401
from . import hat as _hat  # noqa: F401
from . import ifan as _ifan  # noqa: F401
from . import maxim as _maxim  # noqa: F401
from . import mprnet as _mprnet  # noqa: F401
from . import nafnet as _nafnet  # noqa: F401
from . import restormer as _restormer  # noqa: F401
from . import ridcp as _ridcp  # noqa: F401
from . import swinir as _swinir  # noqa: F401
from . import xrestormer as _xrestormer  # noqa: F401

__all__ = ["MODEL_REGISTRY", "ModelSpec", "register_model", "build_model",
           "list_models", "get_spec"]
