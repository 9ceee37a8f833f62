from .engine import Engine, RestorationResult
from .weights import WeightStore

__all__ = ["Engine", "RestorationResult", "WeightStore"]
