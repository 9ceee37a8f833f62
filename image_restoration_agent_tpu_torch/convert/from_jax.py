"""Carry the JAX package's SwinIR and Restormer parameters across to the
port.

:func:`from_jax` takes a JAX parameter pytree (nested dicts of numpy
arrays, with or without the top-level ``"params"``) and returns the port's
state dict under the reference names. The family is read from the tree's
top-level keys (Restormer has ``encoder_level1_0``). It is the inverse of
``image_restoration_agent_tpu/convert/torch_import.py``:

- ``swinir_rules`` (KAIR names): conv kernels (kh, kw, I, O) -> (O, I, kh,
  kw); linear kernels (I, O) -> (O, I); ``upsample{i}`` ->
  ``upsample.{2i}`` (the reference Upsample is a Sequential of [conv,
  PixelShuffle] pairs), ``upsample_direct`` -> ``upsample.0``,
  ``conv_up{i}`` -> ``conv_up{i+1}``;
- ``restormer_rules`` (``restormer_arch.py`` names): conv kernels as above,
  depthwise kernels (3, 3, 1, C) -> (C, 1, 3, 3), temperature (heads,) ->
  (heads, 1, 1), ``encoder_level1_0`` -> ``encoder_level1.0``,
  ``norm1/weight`` -> ``norm1.body.weight``, ``down1_2/conv`` ->
  ``down1_2.body.0``, ``patch_embed`` -> ``patch_embed.proj``;
- ``hat_rules`` (``hat_arch.py`` names, detected by the ``hab0`` blocks):
  the top-level and RHAG convs as SwinIR's, ``layer{i}/hab{j}`` ->
  ``layers.{i}.residual_group.blocks.{j}`` (``conv_block/c1``, ``c2``,
  ``ca1``, ``ca2`` -> ``conv_block.cab.0``, ``.2``, ``.3.attention.1``,
  ``.3.attention.3``) and ``layer{i}/ocab`` -> ``...overlap_attn``. The
  JAX HAB holds two copies of the reference ``norm1`` (its attention
  layer's ``norm_scale`` / ``norm_bias`` and the CAB branch's
  ``norm1``); both map to the one ``norm1``, and a tree whose copies
  differ is refused.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _linear(w):
    return np.transpose(w, (1, 0))


def _same(w):
    return w


_BLOCK = r"layer(\d+)/block(\d+)"
_REF_BLOCK = r"layers.\1.residual_group.blocks.\2"

# (JAX path regex, reference-name template, transform)
_RULES = [
    (r"conv_first/Conv_0/kernel", "conv_first.weight", _conv),
    (r"conv_first/Conv_0/bias", "conv_first.bias", _same),
    (r"patch_embed_norm/scale", "patch_embed.norm.weight", _same),
    (r"patch_embed_norm/bias", "patch_embed.norm.bias", _same),
    (rf"{_BLOCK}/attn/norm_scale", rf"{_REF_BLOCK}.norm1.weight", _same),
    (rf"{_BLOCK}/attn/norm_bias", rf"{_REF_BLOCK}.norm1.bias", _same),
    (rf"{_BLOCK}/norm2_scale", rf"{_REF_BLOCK}.norm2.weight", _same),
    (rf"{_BLOCK}/norm2_bias", rf"{_REF_BLOCK}.norm2.bias", _same),
    (rf"{_BLOCK}/attn/relative_position_bias_table",
     rf"{_REF_BLOCK}.attn.relative_position_bias_table", _same),
    (rf"{_BLOCK}/attn/qkv_kernel", rf"{_REF_BLOCK}.attn.qkv.weight",
     _linear),
    (rf"{_BLOCK}/attn/qkv_bias_p", rf"{_REF_BLOCK}.attn.qkv.bias", _same),
    (rf"{_BLOCK}/attn/proj_kernel", rf"{_REF_BLOCK}.attn.proj.weight",
     _linear),
    (rf"{_BLOCK}/attn/proj_bias_p", rf"{_REF_BLOCK}.attn.proj.bias", _same),
    (rf"{_BLOCK}/fc1_kernel", rf"{_REF_BLOCK}.mlp.fc1.weight", _linear),
    (rf"{_BLOCK}/fc1_bias", rf"{_REF_BLOCK}.mlp.fc1.bias", _same),
    (rf"{_BLOCK}/fc2_kernel", rf"{_REF_BLOCK}.mlp.fc2.weight", _linear),
    (rf"{_BLOCK}/fc2_bias", rf"{_REF_BLOCK}.mlp.fc2.bias", _same),
    (r"layer(\d+)/conv/Conv_0/kernel", r"layers.\1.conv.weight", _conv),
    (r"layer(\d+)/conv/Conv_0/bias", r"layers.\1.conv.bias", _same),
    (r"norm/scale", "norm.weight", _same),
    (r"norm/bias", "norm.bias", _same),
    (r"conv_after_body/Conv_0/kernel", "conv_after_body.weight", _conv),
    (r"conv_after_body/Conv_0/bias", "conv_after_body.bias", _same),
    (r"conv_before_upsample/Conv_0/kernel", "conv_before_upsample.0.weight",
     _conv),
    (r"conv_before_upsample/Conv_0/bias", "conv_before_upsample.0.bias",
     _same),
    (r"conv_last/Conv_0/kernel", "conv_last.weight", _conv),
    (r"conv_last/Conv_0/bias", "conv_last.bias", _same),
    (r"upsample_direct/Conv_0/kernel", "upsample.0.weight", _conv),
    (r"upsample_direct/Conv_0/bias", "upsample.0.bias", _same),
    (r"conv_hr/Conv_0/kernel", "conv_hr.weight", _conv),
    (r"conv_hr/Conv_0/bias", "conv_hr.bias", _same),
]


def _temperature(w):
    return np.reshape(w, (-1, 1, 1))


_STAGE = (r"(encoder_level[123]|latent|decoder_level[123]|refinement)"
          r"_(\d+)")

# (JAX path regex, reference-name template, transform); depthwise kernels
# (3, 3, 1, C) take the conv transpose to (C, 1, 3, 3)
_RESTORMER_RULES = [
    (r"patch_embed/Conv_0/(kernel|bias)", r"patch_embed.proj.\1", None),
    (r"(output|skip_conv)/Conv_0/(kernel|bias)", r"\1.\2", None),
    (r"(reduce_chan_level[23])/Conv_0/(kernel|bias)", r"\1.\2", None),
    (r"(down1_2|down2_3|down3_4|up4_3|up3_2|up2_1)/conv/Conv_0/(kernel)",
     r"\1.body.0.\2", None),
    (rf"{_STAGE}/norm([12])/(weight|bias)", r"\1.\2.norm\3.body.\4",
     _same),
    (rf"{_STAGE}/attn/temperature", r"\1.\2.attn.temperature",
     _temperature),
    (rf"{_STAGE}/(attn|ffn)/(\w+)/Conv_0/(kernel|bias)", r"\1.\2.\3.\4.\5",
     None),
]


_HAB = r"layer(\d+)/hab(\d+)"
_REF_HAB = r"layers.\1.residual_group.blocks.\2"
_OCAB = r"layer(\d+)/ocab"
_REF_OCAB = r"layers.\1.residual_group.overlap_attn"
_CAB = {"c1": "cab.0", "c2": "cab.2", "ca1": "cab.3.attention.1",
        "ca2": "cab.3.attention.3"}

# (JAX path regex, reference-name template, transform), before _RULES
_HAT_RULES = [
    (rf"{_HAB}/(?:attn/norm_scale|norm1/scale)", rf"{_REF_HAB}.norm1.weight",
     _same),
    (rf"{_HAB}/(?:attn/norm_bias|norm1/bias)", rf"{_REF_HAB}.norm1.bias",
     _same),
    (rf"{_HAB}/attn/relative_position_bias_table",
     rf"{_REF_HAB}.attn.relative_position_bias_table", _same),
    (rf"{_HAB}/attn/(qkv|proj)_kernel", rf"{_REF_HAB}.attn.\3.weight",
     _linear),
    (rf"{_HAB}/attn/(qkv|proj)_bias_p", rf"{_REF_HAB}.attn.\3.bias", _same),
    (rf"{_HAB}/norm2/scale", rf"{_REF_HAB}.norm2.weight", _same),
    (rf"{_HAB}/norm2/bias", rf"{_REF_HAB}.norm2.bias", _same),
    (rf"{_HAB}/(fc[12])/kernel", rf"{_REF_HAB}.mlp.\3.weight", _linear),
    (rf"{_HAB}/(fc[12])/bias", rf"{_REF_HAB}.mlp.\3.bias", _same),
    (rf"{_OCAB}/relative_position_bias_table",
     rf"{_REF_OCAB}.relative_position_bias_table", _same),
    (rf"{_OCAB}/(norm[12])/scale", rf"{_REF_OCAB}.\2.weight", _same),
    (rf"{_OCAB}/(norm[12])/bias", rf"{_REF_OCAB}.\2.bias", _same),
    (rf"{_OCAB}/(qkv|proj)/kernel", rf"{_REF_OCAB}.\2.weight", _linear),
    (rf"{_OCAB}/(qkv|proj)/bias", rf"{_REF_OCAB}.\2.bias", _same),
    (rf"{_OCAB}/(fc[12])/kernel", rf"{_REF_OCAB}.mlp.\2.weight", _linear),
    (rf"{_OCAB}/(fc[12])/bias", rf"{_REF_OCAB}.mlp.\2.bias", _same),
]


def _hat_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(rf"{_HAB}/conv_block/(c1|c2|ca1|ca2)/Conv_0/"
                     r"(kernel|bias)", path)
    if m:
        i, j, conv, leaf = m.groups()
        return (f"layers.{i}.residual_group.blocks.{j}.conv_block."
                f"{_CAB[conv]}.{'weight' if leaf == 'kernel' else 'bias'}",
                _conv if leaf == "kernel" else _same)
    for pattern, tpl, fn in _HAT_RULES:
        m = re.fullmatch(pattern, path)
        if m:
            return m.expand(tpl), fn
    return _ref_name(path)


def _restormer_name(path: str) -> tuple[str, object]:
    for pattern, tpl, fn in _RESTORMER_RULES:
        m = re.fullmatch(pattern, path)
        if m:
            name = m.expand(tpl)
            if fn is None:  # a conv leaf: kernel -> weight, bias unchanged
                leaf = name.rsplit(".", 1)[1]
                fn = _conv if leaf == "kernel" else _same
                name = name[: -len(leaf)] + (
                    "weight" if leaf == "kernel" else "bias")
            return name, fn
    raise KeyError(f"unmapped JAX parameter: {path}")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _ref_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(r"upsample(\d+)/Conv_0/(kernel|bias)", path)
    if m:
        i, leaf = int(m.group(1)), m.group(2)
        return (f"upsample.{2 * i}."
                f"{'weight' if leaf == 'kernel' else 'bias'}",
                _conv if leaf == "kernel" else _same)
    m = re.fullmatch(r"conv_up(\d+)/Conv_0/(kernel|bias)", path)
    if m:
        i, leaf = int(m.group(1)), m.group(2)
        return (f"conv_up{i + 1}.{'weight' if leaf == 'kernel' else 'bias'}",
                _conv if leaf == "kernel" else _same)
    for pattern, tpl, fn in _RULES:
        m = re.fullmatch(pattern, path)
        if m:
            return m.expand(tpl), fn
    raise KeyError(f"unmapped JAX parameter: {path}")


def from_jax(params) -> dict[str, torch.Tensor]:
    """The port's reference-named state dict from JAX SwinIR, HAT or
    Restormer params."""
    if "params" in params:
        params = params["params"]
    rename = _ref_name
    if "encoder_level1_0" in params:
        rename = _restormer_name
    elif "hab0" in params.get("layer0", {}):
        rename = _hat_name
    out = {}
    for path, value in _flatten(params):
        name, fn = rename(path)
        t = torch.from_numpy(
            np.ascontiguousarray(fn(value)).astype(np.float32))
        if name in out and not torch.equal(out[name], t):
            raise ValueError(f"{path}: the JAX tree's two copies of {name} "
                             "differ; the reference has one")
        out[name] = t
    return out
