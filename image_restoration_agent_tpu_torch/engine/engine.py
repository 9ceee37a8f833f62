"""Single-process multi-model restoration engine (counterpart of
``image_restoration_agent_tpu/engine/engine.py``).

One process holds the model registry, a weight store with device-memory
LRU residency, and a cache of built serving pipelines keyed by
(model, bucketed shape, tile config). Arbitrary request sizes are padded up
to the model's pad multiple and then to a bucket grid (default 128 px).

Band mode (``ModelSpec.band_mode``, the SwinIR-M x4 serving path): the
canvas is padded to the strip-chunkable width the JAX engine uses and
served as full-width row bands with a 16 px overlap, the x4 head emitting
packed RGB, then blended and cropped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..convert.torch_import import BUFFERS, read_state
from ..core.io import load_image, save_image, to_float
from ..core.tiling import plan_tiles, tiled_apply
from ..device import resolve_device
from ..models import build_model
from ..models.registry import MODEL_REGISTRY, get_spec
from ..ops.swin_block import pad_width_for_strips
from .weights import WeightStore



@dataclasses.dataclass
class RestorationResult:
    image: np.ndarray          # uint8 RGB
    model: str
    seconds: float
    input_shape: tuple
    output_shape: tuple
    random_init: bool = False  # True if the model ran with unloaded weights
    nonfinite: int = 0         # NaN/inf values in the model output


def device_memory_budget(device: torch.device, reserve_fraction: float = 0.3,
                         fallback: int = 12 * 1024 ** 3) -> int:
    """Weight-residency budget from the serving device: (1 -
    reserve_fraction) of its memory less what is in use, read with
    ``torch.cuda.mem_get_info``; a 12 GiB constant on the CPU."""
    if device.type != "cuda":
        return fallback
    free, total = torch.cuda.mem_get_info(device)
    usable = int(total * (1.0 - reserve_fraction)) - int(total - free)
    return max(usable, 1024 ** 3)


def _bucket(size: int, bucket: int, multiple: int) -> int:
    """Round up to the bucket grid, keeping the model's pad multiple."""
    b = max(bucket, multiple)
    b = b - (b % multiple) if b % multiple else b
    return -(-size // b) * b


class Engine:
    """In-process serving runtime for the port's model zoo."""

    def __init__(self, weight_dir: Optional[Path] = None, *,
                 device: str | torch.device = "cuda",
                 param_dtype: torch.dtype = torch.float32,
                 hbm_budget_bytes: Optional[int] = None,
                 shape_bucket: int = 128, default_batch: int = 4,
                 allow_random_init: Optional[bool] = None):
        self.device = resolve_device(device)
        self.weight_dir = Path(weight_dir) if weight_dir else None
        self.param_dtype = param_dtype
        self.shape_bucket = shape_bucket
        self.default_batch = default_batch
        # random weights only when built without a weight_dir, unless asked
        self.allow_random_init = (self.weight_dir is None
                                  if allow_random_init is None
                                  else allow_random_init)
        self.random_init_models: set[str] = set()
        self._states: dict[str, dict] = {}
        self.store = WeightStore(
            self._load_model,
            device_memory_budget(self.device) if hbm_budget_bytes is None
            else hbm_budget_bytes)
        self._pipelines: dict[tuple, tuple[Callable, int]] = {}
        self.call_log: list[dict] = []
        self.last_trace: Optional[Path] = None  # written by profile()

    # ---------------- weights ----------------

    def set_weights(self, name: str, state: dict) -> None:
        """Serve ``name`` with a reference-named state dict (numpy arrays or
        tensors); replaces a resident copy."""
        self._states[name] = state
        self.store.drop(name)

    def _load_model(self, name: str) -> torch.nn.Module:
        state = self._states.get(name)
        if state is None and self.weight_dir is not None:
            for suffix in (".pth", ".npz"):
                if (self.weight_dir / f"{name}{suffix}").exists():
                    state = read_state(self.weight_dir / f"{name}{suffix}")
                    break
        model = build_model(name, device="cpu")
        if state is not None:
            sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
                  if not k.endswith(BUFFERS)}
            model.load_state_dict(sd, strict=True)
        elif not self.allow_random_init:
            raise FileNotFoundError(
                f"no weights for model '{name}' under {self.weight_dir}; "
                "pass allow_random_init=True to serve random weights")
        else:
            logging.getLogger(__name__).warning(
                "model '%s': no weights found - serving RANDOM weights "
                "(for tests and dry runs only)", name)
            self.random_init_models.add(name)
        return model.to(device=self.device, dtype=self.param_dtype)

    # ---------------- inference ----------------

    def _pipeline(self, name: str, h: int, w: int, tile, overlap: int,
                  batch: int, ensemble_times: int = 0):
        key = (name, h, w, tile, overlap, batch, ensemble_times)
        built = self._pipelines.get(key)
        if built is not None:
            return built
        spec = get_spec(name)
        band = tile is None and spec.band_mode and not ensemble_times
        pad_to = band_tile = None
        packed_c = 1
        if band:
            ph = -(-h // spec.pad_multiple) * spec.pad_multiple
            pw = pad_width_for_strips(w)
            ov = 16
            n_bands = max(2, -(-(ph * pw) // 1_100_000))
            bh = -(-(ph + (n_bands - 1) * ov) // n_bands // 8) * 8
            pad_to, band_tile, overlap, batch = (ph, pw), (bh, pw), ov, 1
            packed_c = 3 if spec.scale > 1 else 1
        pad_multiple = spec.pad_multiple if tile is not None \
            else max(spec.pad_multiple, spec.whole_pad_multiple)
        dtype = self.param_dtype
        fwd_kw = {"packed_output": True} if packed_c > 1 else {}

        def one(model, img):
            def fwd(tiles):
                return model(tiles.to(dtype), **fwd_kw).float()

            return tiled_apply(
                fwd, img, tile=band_tile if band else tile,
                overlap=overlap, scale=spec.scale, batch=batch,
                pad_multiple=pad_multiple, pad_mode=spec.pad_mode,
                pad_kind=spec.pad_kind, pad_to=pad_to, packed_c=packed_c)

        def pipeline(model, img):
            if not ensemble_times:
                return one(model, img)
            # geometric self-ensemble: average over rotations (+ flips)
            outs = [torch.rot90(one(model, torch.rot90(img, k, (0, 1))),
                                4 - k, (0, 1)) for k in range(4)]
            if ensemble_times == 8:
                f = torch.flip(img, (1,))
                outs += [torch.flip(torch.rot90(
                    one(model, torch.rot90(f, k, (0, 1))), 4 - k, (0, 1)),
                    (1,)) for k in range(4)]
            return sum(outs) / len(outs)

        built = (pipeline, packed_c)
        self._pipelines[key] = built
        return built

    def restore_array(self, img: np.ndarray, model_name: str,
                      tile="auto", overlap: Optional[int] = None,
                      batch: Optional[int] = None, ensemble: bool = False,
                      ensemble_times: int = 8) -> RestorationResult:
        """Restore a float [0,1] (H, W, 3) array; pads to the shape-bucket
        grid so arbitrary sizes reuse built pipelines."""
        spec = get_spec(model_name)
        h0, w0 = img.shape[:2]
        if tile == "auto":
            tile = spec.tile
            if tile is None and spec.max_size is not None \
                    and max(h0, w0) > spec.max_size:
                tile = spec.fallback_tile
                if overlap is None:
                    overlap = 16
        if overlap is None:
            overlap = spec.tile_overlap

        t0 = time.perf_counter()
        hb = _bucket(h0, self.shape_bucket, spec.pad_multiple)
        wb = _bucket(w0, self.shape_bucket, spec.pad_multiple)
        if batch is None:
            batch = self.default_batch
            if tile is not None and min(hb, wb) > tile:
                n_tiles = plan_tiles(max(hb, tile), max(wb, tile), tile,
                                     overlap).num_tiles
                batch = min(range(1, 9), key=lambda b: ((-n_tiles) % b, -b))
        if (hb, wb) != (h0, w0):
            pad_kind = "symmetric" if min(h0, w0) >= max(hb - h0, wb - w0) \
                else "edge"
            img = np.pad(img, ((0, hb - h0), (0, wb - w0), (0, 0)),
                         mode=pad_kind)

        model = self.store.get(model_name)
        fn, packed_c = self._pipeline(model_name, hb, wb, tile, overlap,
                                      batch, ensemble_times if ensemble
                                      else 0)
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            self.device)
        # serving records no graph, whatever the family: the models' own
        # forwards leave grad on so that they can be trained
        with torch.no_grad():
            out = fn(model, x)
        nonfinite = int((~torch.isfinite(out)).sum())
        if packed_c > 1:  # packed RGB: a free row-major view back to NHWC
            out = out.reshape(out.shape[0], out.shape[1] // packed_c,
                              packed_c)
        out = out[: h0 * spec.scale, : w0 * spec.scale]
        # the reference's clamp + round to uint8, on the device: the copy to
        # the host moves a quarter of the bytes
        image = torch.round(out.clamp(0.0, 1.0) * 255.0).clamp(0, 255) \
            .to(torch.uint8).cpu().numpy()
        dt = time.perf_counter() - t0
        self.call_log.append({"model": model_name, "h": h0, "w": w0,
                              "seconds": dt})
        return RestorationResult(
            image=image, model=model_name, seconds=dt,
            input_shape=(h0, w0), output_shape=image.shape[:2],
            random_init=model_name in self.random_init_models,
            nonfinite=nonfinite)

    def warmup(self, models: list[str], sizes: list[tuple[int, int]],
               ensemble: bool = False) -> list[dict]:
        """Walk each (model, HxW) through the real restore path on a zero
        image, loading weights and building pipelines (and, on the first
        call, the CUDA kernels) before traffic arrives."""
        records = []
        for name in models:
            for h, w in sizes:
                n0 = len(self._pipelines)
                t0 = time.perf_counter()
                self.restore_array(np.zeros((h, w, 3), np.float32), name,
                                   ensemble=ensemble)
                records.append({
                    "model": name, "h": h, "w": w,
                    "seconds": round(time.perf_counter() - t0, 3),
                    "built": len(self._pipelines) > n0,
                    "random_init": name in self.random_init_models})
        return records

    def restore_file(self, input_path: str | Path, output_path: str | Path,
                     model_name: str, **kw) -> RestorationResult:
        img = to_float(load_image(input_path))
        res = self.restore_array(img, model_name, **kw)
        save_image(res.image, output_path)
        return res

    # ---------------- observability ----------------

    @contextlib.contextmanager
    def profile(self, log_dir: str | Path):
        """``torch.profiler`` trace context around engine calls: CPU
        activity, and the card's kernels and copies where the engine runs
        on one; on exit, also when the body raises, a Chrome trace
        (``trace_<pid>_<n>.json``) is written under ``log_dir``. Yields the
        engine."""
        from torch.profiler import ProfilerActivity, profile

        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        try:
            with prof:
                try:
                    yield self
                finally:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        finally:
            # the trace is written whether or not the body raised: a
            # failing request is when it is most wanted
            n = len(list(log_dir.glob(f"trace_{os.getpid()}_*.json")))
            self.last_trace = log_dir / f"trace_{os.getpid()}_{n}.json"
            prof.export_chrome_trace(str(self.last_trace))

    def status(self) -> dict:
        """Engine health snapshot."""
        budget = self.store.budget_bytes
        pressure = self.store.resident_bytes / budget if budget else 0.0
        if pressure > 0.9 or self.store.evictions:
            logging.getLogger("engine").warning(
                "device memory eviction pressure: %.0f%% of %.1f GiB weight "
                "budget resident, %d evictions so far", pressure * 100,
                budget / 1024 ** 3, len(self.store.evictions))
        return {
            "device": self.device.type,
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "models_registered": len(MODEL_REGISTRY),
            "models_resident": self.store.resident,
            "resident_bytes": self.store.resident_bytes,
            "hbm_budget_bytes": budget,
            "hbm_pressure": round(pressure, 4),
            "evictions": list(self.store.evictions),
            "built_pipelines": len(self._pipelines),
            "calls": len(self.call_log),
            "random_init_models": sorted(self.random_init_models),
        }
