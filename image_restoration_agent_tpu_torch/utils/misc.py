"""Small helpers (the port's copy of
``image_restoration_agent_tpu/utils/misc.py``, reference
AgenticIR/utils/misc.py).

The JAX package's ``enable_persistent_compile_cache`` points XLA's
compilation cache at a directory; PyTorch has no such cache to point. The
port's counterpart is the CUDA kernels' build directory
(``image_restoration_agent_tpu_torch/csrc/build/``, keyed by a hash of the
sources), which ``cli.py warmup`` fills and which survives restarts.
"""

from __future__ import annotations

import base64
from pathlib import Path


def sorted_glob(directory: Path, pattern: str = "*") -> list[Path]:
    return sorted(Path(directory).glob(pattern))


def encode_image_base64(path: Path) -> str:
    return base64.b64encode(Path(path).read_bytes()).decode()
