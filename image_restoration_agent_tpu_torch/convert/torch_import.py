"""Reference torch checkpoints -> the port's state dicts (counterpart of
``image_restoration_agent_tpu/convert/torch_import.py``).

The port's modules carry the reference parameter names and layouts, so a
reference checkpoint needs no renaming or transposes, which the JAX
package's rule sets exist for. What is left of them is here:

- :func:`load_torch_checkpoint`: the ``.pth`` loader with the reference's
  wrapper selection (``params_ema`` / ``params`` / ``state_dict`` /
  ``model``, SwinIR model_serving.py:113-121), always with
  ``weights_only=True``;
- :data:`BUFFERS`: the buffers a reference state dict holds and the port
  recomputes (SwinIR-class ``relative_position_index`` and ``attn_mask``,
  HAT's, DehazeFormer's), which the JAX rule sets drop;
- :data:`FAMILY_KEYS`: each rule set's remaining drops and renames (CLIP's
  ``input_resolution`` / ``context_length`` / ``vocab_size``, the
  Combiner's ``logit_scale``, timm ViT's ``norm`` / ``head`` under
  MANIQA, LPIPS's ``scaling_layer``; LPIPS's two naming schemes in the
  wild); DiffBIR's drops and ``empty_context`` are
  :func:`convert.from_jax.diffbir_checkpoint_state`;
- :func:`read_state`: the state dict of a weight file, a ``.pth`` or the
  ``.npz`` that ``convert.manifest.convert_checkpoint`` writes.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

#: the wrapper keys a reference checkpoint may nest its state dict under
WRAPPER_KEYS = ("params_ema", "params", "state_dict", "model")

#: reference buffers, not parameters (SwinIR's, HAT's, DehazeFormer's),
#: matched as key suffixes
BUFFERS = ("relative_position_index", "attn_mask",
           "relative_position_index_SA", "relative_position_index_OCA",
           "relative_positions")

# LPIPS: torchvision AlexNet's feature indices -> the lpips package's
# slice{1-5} (lpips_rules there)
_ALEX_SLICE = {0: 1, 3: 2, 6: 3, 8: 4, 10: 5}

#: rule set -> (patterns of keys dropped, (pattern, replacement) renames)
FAMILY_KEYS: dict[str, tuple[tuple[str, ...], tuple]] = {
    "clip_rules": ((r"input_resolution|context_length|vocab_size",), ()),
    "combiner_rules": ((r"logit_scale",), ()),
    "lpips_rules": ((r"scaling_layer\..*",), (
        (r"features\.(\d+)\.", lambda m: "net.slice%d.%s." % (
            _ALEX_SLICE[int(m.group(1))], m.group(1))),
        (r"lins\.([0-4])\.", r"lin\1."))),
    # the timm ViT's final norm and head: MANIQA reads blocks 6-9 before
    # them (iqa_rules._vit_rules there)
    "maniqa_rules": ((r"vit\.norm\.(weight|bias)",
                      r"vit\.head\.(weight|bias)"), ()),
}


def load_torch_checkpoint(path: str | Path,
                          param_key: Optional[str] = "auto"
                          ) -> dict[str, np.ndarray]:
    """Load a ``.pth`` into {name: np.ndarray}, honoring the reference's
    wrapper selection: ``"auto"`` unwraps the first of
    :data:`WRAPPER_KEYS` present, another key unwraps that key.

    Only ``weights_only=True`` (safe unpickling): a checkpoint that
    pickles arbitrary objects raises. bfloat16 tensors are widened to
    float32 (numpy has no bfloat16)."""
    try:
        raw = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(f"{path} is not loadable with weights_only=True "
                         f"(safe unpickling): {e}") from e
    if param_key == "auto":
        for key in WRAPPER_KEYS:
            if isinstance(raw, dict) and isinstance(raw.get(key), dict):
                raw = raw[key]
                break
    elif param_key and isinstance(raw, dict) and param_key in raw:
        raw = raw[param_key]

    def arr(v):
        if isinstance(v, torch.Tensor):
            v = v.detach()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    return {k: arr(v) for k, v in raw.items()}


def reference_state(state: dict, rules: Optional[str] = None,
                    keep=()) -> dict:
    """``state`` without :data:`BUFFERS` (except those named in ``keep``:
    the port's MANIQA holds its Swin blocks' index buffers) and with rule
    set ``rules``'s drops and renames (:data:`FAMILY_KEYS`) applied."""
    drops, renames = FAMILY_KEYS.get(rules, ((), ()))
    keep = set(keep)
    out = {}
    for k, v in state.items():
        if (k.endswith(BUFFERS) and k not in keep) \
                or any(re.fullmatch(p, k) for p in drops):
            continue
        for pat, rep in renames:
            k = re.sub("^" + pat, rep, k)
        out[k] = v
    return out


def read_state(path: str | Path) -> dict[str, np.ndarray]:
    """A reference-named state dict from a weight file: a ``.pth`` (the
    wrappers unwrapped) or a state-dict ``.npz`` (what
    ``convert.manifest.convert_checkpoint`` writes)."""
    path = Path(path)
    if path.suffix != ".npz":
        return load_torch_checkpoint(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
