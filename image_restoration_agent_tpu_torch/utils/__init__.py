from .logger import get_logger
from .misc import sorted_glob

__all__ = ["get_logger", "sorted_glob"]
