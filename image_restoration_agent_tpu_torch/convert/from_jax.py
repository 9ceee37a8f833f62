"""Carry the JAX package's SwinIR, HAT, Restormer and DehazeFormer
parameters across to the port.

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
  differ is refused;
- ``dehazeformer_rules`` (reference ``dehazeformer.py`` names, detected by
  ``patch_unembed``): ``layer{i}_blk{j}`` -> ``layer{i+1}.blocks.{j}``;
  conv kernels as above (the depthwise (5, 5, 1, C) -> (C, 1, 5, 5) by the
  same transpose); the bias MLP's ``meta_fc1`` / ``meta_fc2`` ->
  ``attn.attn.meta.0`` / ``.2`` (linear); ``mlp_fc1`` / ``mlp_fc2`` ->
  ``mlp.mlp.0`` / ``.2``; RLN ``norm1/weight`` (C,) -> ``norm1.weight`` (1,
  C, 1, 1); ``fusion{k}/mlp1`` / ``mlp2`` -> ``fusion{k}.mlp.0`` / ``.2``;
  the ``patch_split`` / ``patch_unembed`` convs -> ``.proj.0``. The JAX
  tree has ``norm1`` only in attention blocks and no ``norm2``, as the
  port's modules; the reference's ``relative_positions`` buffers are
  recomputed, not carried;
- ``nafnet_rules`` (``NAFNet_arch.py`` names, detected by ``intro``):
  ``enc{i}_blk{j}`` / ``dec{i}_blk{j}`` / ``mid_blk{i}`` ->
  ``encoders.i.j`` / ``decoders.i.j`` / ``middle_blks.i``, ``sca_conv`` ->
  ``sca.1``, ``down{i}`` -> ``downs.i``, ``up{i}`` -> ``ups.i.0``; ``beta``
  and ``gamma`` (C,) -> (1, C, 1, 1);
- ``fbcnn_rules_for`` (``network_fbcnn.py`` names, detected by
  ``qf_embed``; the pinned-QF models' tree sits under ``inner``):
  ``down{l}_res{i}`` -> ``m_down{l+1}.{i}.res``, ``down{l}_stride`` ->
  ``m_down{l+1}.{nb}``, ``up{l}_t`` -> ``m_up{l+1}.0``, ``up{l}_qf{i}`` ->
  ``m_up{l+1}.{i+1}.res``, ``qf_pred_mlp/fc{k}`` -> ``qf_pred.{nb+2+2k}``,
  ``qf_embed/fc{k}`` -> ``qf_embed.{2k}``, ``c1`` / ``c2`` -> ``res.0`` /
  ``res.2``. The transposed conv's Flax kernel (2, 2, I, O), applied with
  ``transpose_kernel=False``, is torch's (I, O, 2, 2) with both taps
  flipped;
- the degradation classifier (``iqa/classifier.py``, detected by
  ``feat_fc``): the Flax names kept, ``kernel`` -> ``weight`` (conv and
  linear transposes), GroupNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..ops.swin_block import SwinBlockParams, kernel_params


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


def _rln(w):
    return np.reshape(w, (1, -1, 1, 1))


# (JAX path regex, reference-name template): a ".kernel" leaf is a conv
# kernel unless the rule says linear
_DF_RULES = [
    (r"patch_embed/Conv_0/(kernel|bias)", r"patch_embed.proj.\1"),
    (r"patch_unembed/Conv_0/(kernel|bias)", r"patch_unembed.proj.0.\1"),
    (r"(patch_merge[12])/Conv_0/(kernel|bias)", r"\1.proj.\2"),
    (r"(patch_split[12])/Conv_0/(kernel|bias)", r"\1.proj.0.\2"),
    (r"(skip[12])/Conv_0/(kernel|bias)", r"\1.\2"),
    (r"(fusion[12])/mlp1/Conv_0/kernel", r"\1.mlp.0.kernel"),
    (r"(fusion[12])/mlp2/Conv_0/kernel", r"\1.mlp.2.kernel"),
]
# inside layer{i}_blk{j}/, mapped under layer{i+1}.blocks.{j}.
_DF_BLOCK_RULES = [
    (r"attn/(conv|V|QK|proj)/Conv_0/(kernel|bias)", r"attn.\1.\2"),
    (r"attn/attn/meta_fc1/(kernel|bias)", r"attn.attn.meta.0.\1"),
    (r"attn/attn/meta_fc2/(kernel|bias)", r"attn.attn.meta.2.\1"),
    (r"norm1/(weight|bias)", r"norm1.\1"),
    (r"norm1/(meta[12])/Conv_0/(kernel|bias)", r"norm1.\1.\2"),
    (r"mlp_fc1/Conv_0/(kernel|bias)", r"mlp.mlp.0.\1"),
    (r"mlp_fc2/Conv_0/(kernel|bias)", r"mlp.mlp.2.\1"),
]


def _dehazeformer_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(r"layer(\d+)_blk(\d+)/(.+)", path)
    rules, prefix = _DF_RULES, ""
    if m:
        rules = _DF_BLOCK_RULES
        prefix = f"layer{int(m.group(1)) + 1}.blocks.{m.group(2)}."
        path = m.group(3)
    for pattern, tpl in rules:
        mm = re.fullmatch(pattern, path)
        if not mm:
            continue
        name = prefix + mm.expand(tpl)
        if name.endswith(".kernel"):
            return name[:-len("kernel")] + "weight", (
                _linear if ".meta." in name else _conv)
        return name, _rln if name.endswith(("norm1.weight", "norm1.bias")) \
            else _same
    raise KeyError(f"unmapped JAX parameter: {prefix}{path}")


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


def _conv_leaf(name: str) -> tuple[str, object]:
    """``<module>.kernel`` -> (``<module>.weight``, the conv transpose);
    ``<module>.bias`` unchanged."""
    if name.endswith(".kernel"):
        return name[:-len("kernel")] + "weight", _conv
    return name, _same


def _beta_gamma(w):
    return np.reshape(w, (1, -1, 1, 1))




def _nafnet_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(r"(intro|ending)/Conv_0/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"{m.group(1)}.{m.group(2)}")
    m = re.fullmatch(r"down(\d+)/Conv_0/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"downs.{m.group(1)}.{m.group(2)}")
    m = re.fullmatch(r"up(\d+)/Conv_0/kernel", path)
    if m:
        return f"ups.{m.group(1)}.0.weight", _conv
    m = re.fullmatch(r"(?:(enc|dec)(\d+)_blk(\d+)|mid_blk(\d+))/(.+)", path)
    if not m:
        raise KeyError(f"unmapped JAX parameter: {path}")
    kind, lvl, j, mid, rest = m.groups()
    prefix = (f"middle_blks.{mid}." if mid is not None else
              f"{'encoders' if kind == 'enc' else 'decoders'}.{lvl}.{j}.")
    if rest in ("beta", "gamma"):
        return prefix + rest, _beta_gamma
    mm = re.fullmatch(r"(norm[12])/(weight|bias)", rest)
    if mm:
        return prefix + f"{mm.group(1)}.{mm.group(2)}", _same
    mm = re.fullmatch(r"(conv[1-5]|sca_conv)/Conv_0/(kernel|bias)", rest)
    if mm:
        conv = "sca.1" if mm.group(1) == "sca_conv" else mm.group(1)
        return _conv_leaf(prefix + f"{conv}.{mm.group(2)}")
    raise KeyError(f"unmapped JAX parameter: {path}")


def _conv_t(w):
    return np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _fbcnn_namer(nb: int):
    def name(path: str) -> tuple[str, object]:
        m = re.fullmatch(r"(head|tail)/Conv_0/(kernel|bias)", path)
        if m:
            return _conv_leaf(f"m_{m.group(1)}.{m.group(2)}")
        m = re.fullmatch(r"down(\d)_stride/Conv_0/(kernel|bias)", path)
        if m:
            return _conv_leaf(f"m_down{int(m.group(1)) + 1}.{nb}."
                              f"{m.group(2)}")
        m = re.fullmatch(r"up(\d)_t/(kernel|bias)", path)
        if m:
            return (f"m_up{int(m.group(1)) + 1}.0."
                    f"{'weight' if m.group(2) == 'kernel' else 'bias'}",
                    _conv_t if m.group(2) == "kernel" else _same)
        m = re.fullmatch(r"(?:(down|up)(\d)_(?:res|qf)|(body_enc|body_dec|"
                         r"qf_pred_res))(\d+)/(c[12])/Conv_0/(kernel|bias)",
                         path)
        if m:
            side, lvl, trunk, i, conv, leaf = m.groups()
            i = int(i)
            if trunk is not None:
                owner = {"body_enc": "m_body_encoder", "body_dec":
                         "m_body_decoder", "qf_pred_res": "qf_pred"}[trunk]
            else:  # m_up's index 0 is the transposed conv
                owner, i = f"m_{side}{int(lvl) + 1}", i + (side == "up")
            return _conv_leaf(f"{owner}.{i}.res.{'0' if conv == 'c1' else '2'}"
                              f".{leaf}")
        m = re.fullmatch(r"(qf_pred_mlp|qf_embed|to_gamma_\d|to_beta_\d)/"
                         r"fc(\d)/(kernel|bias)", path)
        if m:
            mlp, k, leaf = m.group(1), int(m.group(2)), m.group(3)
            idx = {"qf_pred_mlp": nb + 2 + 2 * k, "qf_embed": 2 * k}.get(mlp, k)
            owner = "qf_pred" if mlp == "qf_pred_mlp" else mlp
            return (f"{owner}.{idx}.{'weight' if leaf == 'kernel' else 'bias'}",
                    _linear if leaf == "kernel" else _same)
        raise KeyError(f"unmapped JAX parameter: {path}")
    return name


def _classifier_name(path: str) -> tuple[str, object]:
    module, leaf = path.split("/")
    if leaf == "scale":
        return f"{module}.weight", _same
    if leaf == "kernel":
        return f"{module}.weight", _conv if module.startswith("conv") \
            else _linear
    return f"{module}.{leaf}", _same


def from_jax(params) -> dict[str, torch.Tensor]:
    """The port's reference-named state dict from JAX SwinIR, HAT,
    Restormer, DehazeFormer, NAFNet, FBCNN or degradation-classifier
    params."""
    if "params" in params:
        params = params["params"]
    if "inner" in params:  # FBCNN with a pinned quality factor
        params = params["inner"]
    rename = _ref_name
    if "encoder_level1_0" in params:
        rename = _restormer_name
    elif "hab0" in params.get("layer0", {}):
        rename = _hat_name
    elif "patch_unembed" in params:
        rename = _dehazeformer_name
    elif "intro" in params:
        rename = _nafnet_name
    elif "qf_embed" in params:
        rename = _fbcnn_namer(sum(k.startswith("down0_res") for k in params))
    elif "feat_fc" in params:
        rename = _classifier_name
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


def strip_block_params(blk, *, num_heads: int,
                       dtype: torch.dtype) -> SwinBlockParams:
    """The port's kernel form (:class:`SwinBlockParams`) of one block given
    as the JAX strip / pair kernels' 13-tuple ``(ln_scale, ln_bias, wqkv
    (C, 3C), bqkv, wproj (C, C), bproj, rpb (heads, N, N), ln2w, ln2b, w1
    (C, hidden), b1, w2 (hidden, C), b2)`` of arrays (matrices applied as
    ``x @ w``); the attention scale is folded into q as
    :func:`prepare_swin_params` folds it."""
    if len(blk) != 13:
        raise ValueError(f"a strip block is a 13-tuple, not {len(blk)}")
    ts = [torch.from_numpy(np.asarray(a, np.float32)) for a in blk]
    return kernel_params(*ts, num_heads=num_heads, dtype=dtype)


def write_flat_npz(params, path) -> None:
    """Write a JAX parameter tree given as numpy (nested dicts, e.g. an
    orbax restore) as one ``.npz`` with its paths joined by dots
    (``conv0.kernel``), values unchanged."""
    if "params" in params:
        params = params["params"]
    np.savez(path, **{p.replace("/", "."): v for p, v in _flatten(params)})


def read_flat_npz(path) -> dict:
    """The nested parameter tree of a :func:`write_flat_npz` file."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split(".")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
