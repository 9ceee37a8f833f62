"""Scorer: the six-metric harness (counterpart of
``image_restoration_agent_tpu/iqa/scorer.py``, which rebuilds the
reference's ``AgenticIR/utils/scorer.py``).

FR metrics PSNR, SSIM and LPIPS against an HQ image, with an x4 MATLAB
bicubic upsample of whichever side is smaller so SR outputs align; NR
metrics MANIQA, CLIP-IQA and MUSIQ on the image alone. Each learned metric
runs its port (``iqa/lpips.py``, ``maniqa.py``, ``clipiqa.py``,
``musiq.py``) where an instance or state is passed in, or where its
converted weights are in the port's ``weights/`` (``lpips_alex.npz``,
``maniqa.npz``, ``musiq.npz``: the reference-named state dicts that
``convert-weights`` writes), loaded on first use; otherwise that metric
reports None. CLIP-IQA has no default file: it needs its instance.
Everything runs on ``device``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..core.io import load_image, to_float
from ..core.resize import resize_matlab
from ..device import resolve_device
from .metrics import psnr, ssim

FR_METRICS = ("psnr", "ssim")
NR_METRICS = ("maniqa", "clipiqa", "musiq")

_WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
_DEFAULT_LPIPS = _WEIGHTS / "lpips_alex.npz"


def _state(path: Path) -> dict:
    from ..convert.torch_import import read_state
    return {k: torch.as_tensor(v) for k, v in read_state(path).items()}


class Scorer:
    def __init__(self, metrics: tuple[str, ...] = FR_METRICS,
                 lpips_state: dict | None = None,
                 lpips_path: str | Path | None = None, clipiqa=None,
                 maniqa=None, musiq=None,
                 device: str | torch.device = "cuda"):
        self.metrics = metrics
        self.device = resolve_device(device)
        self._lpips_state = lpips_state
        self._lpips_path = Path(lpips_path) if lpips_path else _DEFAULT_LPIPS
        self._lpips_model = None
        self._clipiqa = clipiqa  # iqa.clipiqa.ClipIQA, needs CLIP weights
        self._maniqa = maniqa    # iqa.maniqa.ManiqaScorer
        self._musiq = musiq      # iqa.musiq.MusiqScorer
        self._nr_loaded = False

    def _load_default_nr(self) -> None:
        """Build MANIQA and MUSIQ scorers from converted weights in the
        port's ``weights/``, once."""
        if self._nr_loaded:
            return
        self._nr_loaded = True
        if self._maniqa is None and (_WEIGHTS / "maniqa.npz").exists():
            from .maniqa import ManiqaScorer
            self._maniqa = ManiqaScorer(_state(_WEIGHTS / "maniqa.npz"),
                                        device=self.device)
        if self._musiq is None and (_WEIGHTS / "musiq.npz").exists():
            from .musiq import MusiqScorer
            self._musiq = MusiqScorer(_state(_WEIGHTS / "musiq.npz"),
                                      device=self.device)

    @torch.no_grad()
    def _lpips(self, img: torch.Tensor, ref: torch.Tensor) -> float | None:
        if self._lpips_model is None:
            if self._lpips_state is None:
                if not self._lpips_path.exists():
                    return None
                self._lpips_state = _state(self._lpips_path)
            from .lpips import LPIPS
            model = LPIPS()
            model.load_state_dict(self._lpips_state, strict=True)
            self._lpips_model = model.to(self.device).eval()
        return float(self._lpips_model(img[None], ref[None])[0])

    @staticmethod
    def _align(img: np.ndarray, ref: np.ndarray):
        """x4 upsample the smaller side where the shapes differ by exactly
        4x (the reference's scorer.py:56-62)."""
        if img.shape == ref.shape:
            return img, ref
        if img.shape[0] * 4 == ref.shape[0]:
            img = resize_matlab(torch.from_numpy(
                np.ascontiguousarray(img, np.float32)), scale=4).numpy()
        elif ref.shape[0] * 4 == img.shape[0]:
            ref = resize_matlab(torch.from_numpy(
                np.ascontiguousarray(ref, np.float32)), scale=4).numpy()
        if img.shape != ref.shape:
            raise ValueError(f"unalignable shapes {img.shape} vs {ref.shape}")
        return img, ref

    def __call__(self, img_path: str | Path, ref_path: str | Path) -> dict:
        img = to_float(load_image(img_path))
        ref = to_float(load_image(ref_path))
        return self.score_arrays(img, ref)

    def score_arrays(self, img: np.ndarray, ref: np.ndarray) -> dict:
        img, ref = self._align(img, ref)
        dev = {}

        def on_device(name, a):
            if name not in dev:
                dev[name] = torch.from_numpy(
                    np.ascontiguousarray(a, np.float32)).to(self.device)
            return dev[name]

        out: dict[str, float | None] = {}
        for m in self.metrics:
            if m == "psnr":
                out[m] = float(psnr(on_device("img", img),
                                    on_device("ref", ref)))
            elif m == "ssim":
                out[m] = float(ssim(on_device("img", img),
                                    on_device("ref", ref)))
            elif m == "lpips":
                out[m] = self._lpips(on_device("img", img),
                                     on_device("ref", ref))
            elif m == "clipiqa" and self._clipiqa is not None:
                out[m] = float(self._clipiqa(img))
            elif m in ("maniqa", "musiq"):
                self._load_default_nr()
                fn = self._maniqa if m == "maniqa" else self._musiq
                out[m] = float(fn(img)) if fn is not None else None
            else:
                out[m] = None
        return out
