"""Carry the JAX package's parameters across to the port.

:func:`from_jax` takes a JAX parameter pytree (nested dicts of numpy
arrays, with or without the top-level ``"params"``) and returns the port's
state dict under the reference names. The family is read from the tree's
top-level keys: X-Restormer by the ``spatial_attn`` of
``encoder_level1_0`` (checked first: its other top-level names are
Restormer's), Restormer by ``encoder_level1_0``, HAT by ``layer0/hab0``,
DehazeFormer by ``patch_unembed``, NAFNet by ``intro``, FBCNN by
``qf_embed``, the classifier by ``feat_fc`` (V3, V5) or ``head`` (V1),
MPRNet by ``stage1_encoder``, MAXIM by ``stage0_input_conv_0``, IFAN by
``dme_in``, DRBNet by ``conv4_4_pre`` (IFAN has no ``conv4_4_pre``), RIDCP
by ``quantize``, CLIP, the Combiner, the retrieval stand-in, LPIPS,
MANIQA, MUSIQ and a bare ViT by the names listed below, SwinIR otherwise.
It is the inverse of ``image_restoration_agent_tpu/convert/torch_import.py``:

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
- the degradation classifier (``iqa/classifier.py``; V3 and V5 detected
  by ``feat_fc``, V1 by ``conv0``, ``gn0`` and ``head``): the Flax names
  kept, ``kernel`` -> ``weight`` (conv and linear transposes), GroupNorm
  ``scale`` -> ``weight``, V5's ``thresh0`` and ``thresh_deltas``
  unchanged;
- ``xrestormer_rules`` (``xrestormer_arch.py`` names): Restormer's
  top-level rules; per block ``norm1``..``norm4`` -> ``.body``,
  ``channel_attn`` / ``channel_ffn`` / ``spatial_ffn`` convs as Restormer's,
  ``spatial_attn/{qkv,project_out}``, ``spatial_attn/rel_height`` ->
  ``spatial_attn.rel_pos_emb.rel_height`` (and ``rel_width``);
- ``mprnet_rules`` (``MPRNet.py`` names): a CAB's ``c1`` / ``act`` / ``c2``
  / ``ca/du1`` / ``ca/du2`` -> ``body.0`` / ``body.1`` (the PReLU slope, ()
  -> (1,)) / ``body.2`` / ``CA.conv_du.0`` / ``CA.conv_du.2``;
  ``enc{l}_cab{i}`` -> ``encoder_level{l+1}.{i}``, ``dec{l}_cab{i}`` ->
  ``decoder_level{l+1}.{i}``, ``down0`` / ``down1`` -> ``down12`` /
  ``down23.down.1``, ``up*/conv`` -> ``up*.up.1`` (``up_enc2a`` / ``b`` ->
  ``up_enc2.0`` / ``.1``), ``orb{n}_cab{i}`` / ``orb{n}_conv`` ->
  ``orb{n}.body.{i}`` / ``.body.{num_cab}``, ``shallow_feat{k}_conv`` /
  ``_cab`` -> ``shallow_feat{k}.0`` / ``.1``;
- ``drbnet_rules`` (``DRBNet.py`` names): encoder convs ``conv{i}_{j}`` ->
  ``.0``, ``conv4_4_pre`` / ``_post`` / ``_r{1,2}`` -> ``conv4_4.0`` /
  ``.3`` / ``.{1,2}.stem.0``, ``up{s}_kernel`` / ``up{s}_res`` (s = 8, 4,
  2, 1) -> ``upconv{3,2,1,0}_kernel`` / ``_res`` (the kernel head's 1x1 a
  bare conv), ``upconv{l}_u/t`` -> ``upconv{l}_u.0`` (the transposed
  conv's flip), ``upconv{l}_r{k}`` -> ``upconv{l}_{k}.stem.0``;
- ``ifan_rules`` (``IFAN.py`` names): ``dme_*``, ``conv4_4_*``, ``F_*``,
  ``conv_res_*`` -> the members of the ``DME``, ``conv4_4``, ``F`` and
  ``conv_res`` Sequentials, ``stem{i}_{a,b}`` -> ``stem.{i}.{0,2}``;
- ``ridcp_rules`` (``dehaze_vq_weight_arch.py`` names, detected by
  ``quantize``): ``in_conv`` -> ``multiscale_encoder.in_conv``,
  ``enc{i}_down`` / ``enc{i}_res{j}`` -> ``multiscale_encoder.blocks.{i}.0``
  / ``.{j+1}``, ``enc_swin{i}`` -> ``multiscale_encoder.blocks.{D}
  .swin_blks.{i}`` (the RSTB leaves as SwinIR's), ``before_quant`` ->
  ``before_quant_group.0``, ``quantize/codebook`` / ``hq_weight`` ->
  ``quantize_group.0.embedding.weight`` / ``.weight``, ``after_quant`` ->
  ``after_quant_group.0.conv``, ``dec{i}_conv`` / ``dec{i}_res{j}`` ->
  ``decoder_group.{i}.block.1`` / ``.{j+2}``, ``resid{i}_*`` ->
  ``multiscale_decoder.upsampler.{i}.*`` likewise, ``warp{i}/offset_feat``
  / ``conv_offset`` / ``dcn_kernel`` / ``dcn_bias`` ->
  ``multiscale_decoder.warp.{i}.offset`` / ``.dcn.conv_offset`` /
  ``.dcn.weight`` (a conv transpose) / ``.dcn.bias``; a ResBlock's
  ``gn1`` / ``c1`` / ``gn2`` / ``c2`` -> ``conv.0.norm`` / ``conv.2`` /
  ``conv.3.norm`` / ``conv.5``;
- MAXIM (Flax upstream, no torch reference): the JAX package's module
  names kept with ``/Conv_0`` dropped, ``kernel`` -> ``weight`` (Dense
  (I, O) -> (O, I), Conv (kh, kw, I, O) -> (O, I, kh, kw), the
  ``y_up`` / ``dec{i}_up`` ConvTranspose with its flip), LayerNorm
  ``scale`` -> ``weight``;
- DiffBIR (detected by ``control_model``; the reference checkpoint's
  names, ``convert/torch_import.py:diffbir_rules`` there): ``/Conv_0``
  dropped, kernels by rank (Dense (I, O) -> (O, I), Conv as above), norm
  ``scale`` -> ``weight``; ``diffusion_model`` -> ``model.diffusion_model``
  and ``control_model``: ``time_fc{1,2}`` -> ``time_embed.{0,2}``,
  ``in_conv`` -> ``input_blocks.0.0``, ``down{l}_res{b}`` / ``_attn{b}``
  -> ``input_blocks.{1 + l(nrb+1) + b}.{0,1}``, ``down{l}_downsample`` ->
  ``input_blocks.{1 + l(nrb+1) + nrb}.0.op``, ``mid_res1`` / ``mid_attn``
  / ``mid_res2`` -> ``middle_block.{0,1,2}``, ``up{l}_res{b}`` /
  ``_attn{b}`` -> ``output_blocks.{(L-1-l)(nrb+1) + b}.{0,1}``,
  ``up{l}_upsample`` -> that level's last entry's ``.{1 or 2}.conv``,
  ``out_norm`` / ``out_conv`` -> ``out.{0,2}``, ``zero{i}/conv`` /
  ``zero_mid/conv`` -> ``zero_convs.{i}.0`` / ``middle_block_out.0``; in a
  ResBlock ``in_norm`` / ``in_conv`` / ``emb_proj`` / ``out_norm`` /
  ``out_conv`` / ``skip`` -> ``in_layers.0`` / ``.2`` / ``emb_layers.1``
  / ``out_layers.0`` / ``.3`` / ``skip_connection``, in a transformer
  ``block0`` -> ``transformer_blocks.0``, ``to_out`` -> ``to_out.0``,
  ``ff_in`` / ``ff_out`` -> ``ff.net.0.proj`` / ``ff.net.2``; the VAE's
  ``down{i}_block{j}`` / ``up{i}_block{j}`` -> ``down.{i}.block.{j}`` /
  ``up.{i}.block.{j}``, ``down{i}_downsample`` / ``up{i}_upsample`` ->
  ``.downsample.conv`` / ``.upsample.conv``, ``mid_block1`` / ``mid_attn``
  / ``mid_block2`` -> ``mid.block_1`` / ``mid.attn_1`` / ``mid.block_2``;
  ``preprocess_model`` as SwinIR's, its unshuffled ``conv_first`` ->
  ``conv_first.1``; ``empty_context`` unchanged. The JAX pipeline never
  runs the VAE's encoder, so its tree has no
  ``first_stage_model.encoder`` or ``quant_conv``, which a reference
  checkpoint holds.

- the retrieval and quality families (the JAX converter's ``clip_rules``,
  ``combiner_rules``, ``lpips_rules``, ``maniqa_rules`` and
  ``musiq_rules``, inverted). CLIP (detected by ``visual`` and ``text``):
  ``visual/layer{l}_{b}`` -> ``visual.layer{l}.{b}``, ``down_conv`` /
  ``down_bn`` -> ``downsample.0`` / ``.1``, FrozenBN ``scale`` / ``bias`` /
  ``mean`` / ``var`` -> ``weight`` / ``bias`` / ``running_mean`` /
  ``running_var`` (plus ``num_batches_tracked`` 0), ``text/block{i}`` ->
  ``transformer.resblocks.{i}`` (``in_proj`` kernel -> ``attn.in_proj_weight``,
  ``out_proj`` -> ``attn.out_proj``, ``c_fc`` / ``c_proj`` -> ``mlp.*``),
  ``text/token_embedding`` -> ``token_embedding.weight``, and
  ``logit_scale`` (absent there) ln 100. The Combiner (``ds_hidden``):
  ``text_projection`` -> ``text_projection_layer`` (and the image's),
  ``ds_hidden`` / ``ds_out`` -> ``dynamic_scalar.0`` / ``.3``. The
  retrieval stand-in (``image_tower``): Flax names under ``image_tower``,
  ``caption_embedding``, the Combiner's under ``combiner``. LPIPS
  (``net`` and ``lin0``): ``net/conv{k}`` -> ``net.slice{k+1}.{0, 3, 6,
  8, 10}``, ``lin{k}`` (C,) -> ``lin{k}.model.1.weight`` (1, C, 1, 1).
  ViT (``pos_embed``): timm's names (``patch_embed.proj``,
  ``blocks.{i}.attn.qkv`` / ``attn.proj`` / ``mlp.fc1``...). MANIQA
  (``tablock1_0``): the ViT under ``vit.``, ``tablock{1,2}_{i}`` ->
  ``tablock{1,2}.{i}``, ``swin{s}/layer{l}_block{b}`` ->
  ``swintransformer{s}.layers.{l}.blocks.{b}`` (``qkv``, ``proj``, the
  bias table under ``attn``, ``fc1`` / ``fc2`` under ``mlp``, plus the
  ``attn.relative_position_index`` buffer), ``fc_score{0,1}`` /
  ``fc_weight{0,1}`` -> ``fc_score.{0,3}`` / ``fc_weight.{0,3}``. MUSIQ
  (``hse_embedding``): flat names, ``block{i}`` -> ``blocks.{i}`` as the
  ViT's.

A reference DiffBIR checkpoint (``general_full_v1.ckpt``) loads into the
port through :func:`diffbir_checkpoint_state`: it drops what the JAX
converter drops (``cond_stage_model.*``, the LDM schedule buffers, the EMA
shadows, SwinIR's index and mask buffers) and fills ``empty_context`` from
the checkpoint's own ``cond_stage_model`` (:func:`extract_empty_context`).
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


def _conv_leaf(name: str, kernel_fn=_conv) -> tuple[str, object]:
    """``<module>.kernel`` -> (``<module>.weight``, ``kernel_fn``, the conv
    transpose by default); ``<module>.bias`` unchanged."""
    if name.endswith(".kernel"):
        return name[:-len("kernel")] + "weight", kernel_fn
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


_XSTAGE = (r"(encoder_level[123]|latent|decoder_level[123]|refinement)"
           r"_(\d+)")


def _xrestormer_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(rf"{_XSTAGE}/(.+)", path)
    if not m:
        return _restormer_name(path)  # the top-level convs are Restormer's
    blk, rest = f"{m.group(1)}.{m.group(2)}", m.group(3)
    mm = re.fullmatch(r"(norm[1-4])/(weight|bias)", rest)
    if mm:
        return f"{blk}.{mm.group(1)}.body.{mm.group(2)}", _same
    if rest == "channel_attn/temperature":
        return f"{blk}.channel_attn.temperature", _temperature
    mm = re.fullmatch(r"spatial_attn/(rel_height|rel_width)", rest)
    if mm:
        return f"{blk}.spatial_attn.rel_pos_emb.{mm.group(1)}", _same
    mm = re.fullmatch(r"(channel_attn|channel_ffn|spatial_ffn|spatial_attn)"
                      r"/(\w+)/Conv_0/(kernel|bias)", rest)
    if mm:
        return _conv_leaf(f"{blk}.{mm.group(1)}.{mm.group(2)}."
                          f"{mm.group(3)}")
    raise KeyError(f"unmapped JAX parameter: {path}")


def _prelu(w):
    return np.reshape(w, (1,))


def _mprnet_cab(prefix: str, rest: str, path: str) -> tuple[str, object]:
    """One CAB's leaves (``c1``, ``act``, ``c2``, ``ca/du1``, ``ca/du2``)
    under the reference ``<prefix>.body.{0,1,2}`` / ``.CA.conv_du.{0,2}``."""
    if rest == "act/alpha":
        return f"{prefix}.body.1.weight", _prelu
    mm = re.fullmatch(r"(c1|c2|ca/du1|ca/du2)/Conv_0/kernel", rest)
    if not mm:
        raise KeyError(f"unmapped JAX parameter: {path}")
    ref = {"c1": "body.0", "c2": "body.2", "ca/du1": "CA.conv_du.0",
           "ca/du2": "CA.conv_du.2"}[mm.group(1)]
    return f"{prefix}.{ref}.weight", _conv


def _mprnet_namer(num_cab: int):
    def name(path: str) -> tuple[str, object]:
        m = re.fullmatch(r"shallow_feat(\d)_(conv|cab)/(.+)", path)
        if m:
            if m.group(2) == "conv":
                return f"shallow_feat{m.group(1)}.0.weight", _conv
            return _mprnet_cab(f"shallow_feat{m.group(1)}.1", m.group(3),
                               path)
        m = re.fullmatch(r"(stage[12]_encoder)/enc(\d)_cab(\d+)/(.+)", path)
        if m:
            return _mprnet_cab(f"{m.group(1)}.encoder_level"
                               f"{int(m.group(2)) + 1}.{m.group(3)}",
                               m.group(4), path)
        m = re.fullmatch(r"(stage[12]_decoder)/dec(\d)_cab(\d+)/(.+)", path)
        if m:
            return _mprnet_cab(f"{m.group(1)}.decoder_level"
                               f"{int(m.group(2)) + 1}.{m.group(3)}",
                               m.group(4), path)
        m = re.fullmatch(r"(stage[12]_decoder/skip_attn\d)/(.+)", path)
        if m:
            return _mprnet_cab(m.group(1).replace("/", "."), m.group(2),
                               path)
        m = re.fullmatch(r"stage3_orsnet/orb(\d)_cab(\d+)/(.+)", path)
        if m:
            return _mprnet_cab(f"stage3_orsnet.orb{m.group(1)}.body."
                               f"{m.group(2)}", m.group(3), path)
        m = re.fullmatch(r"stage3_orsnet/orb(\d)_conv/Conv_0/kernel", path)
        if m:
            return (f"stage3_orsnet.orb{m.group(1)}.body.{num_cab}.weight",
                    _conv)
        m = re.fullmatch(r"(stage[12]_encoder)/csff_(enc|dec)(\d)/Conv_0/"
                         r"kernel", path)
        if m:
            return (f"{m.group(1)}.csff_{m.group(2)}{int(m.group(3)) + 1}"
                    ".weight", _conv)
        m = re.fullmatch(r"(stage[12]_encoder)/down([01])/conv/Conv_0/kernel",
                         path)
        if m:
            down = ("down12", "down23")[int(m.group(2))]
            return f"{m.group(1)}.{down}.down.1.weight", _conv
        m = re.fullmatch(r"(stage[12]_decoder|stage3_orsnet)/"
                         r"(up21|up32|up_enc1|up_dec1|up_enc2a|up_enc2b|"
                         r"up_dec2a|up_dec2b)/conv/Conv_0/kernel", path)
        if m:
            up = m.group(2)
            if up[-1] in "ab":
                up = f"{up[:-1]}.{'01'[up[-1] == 'b']}"
            return f"{m.group(1)}.{up}.up.1.weight", _conv
        m = re.fullmatch(r"(sam12/conv\d|sam23/conv\d|concat12|concat23|tail|"
                         r"stage3_orsnet/conv_(?:enc|dec)\d)/Conv_0/kernel",
                         path)
        if m:
            return f"{m.group(1).replace('/', '.')}.weight", _conv
        raise KeyError(f"unmapped JAX parameter: {path}")
    return name


_DRB_SCALE = {"8": "3", "4": "2", "2": "1", "1": "0"}


def _drbnet_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(r"(conv\d_\d)/Conv_0/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"{m.group(1)}.0.{m.group(2)}")
    m = re.fullmatch(r"conv4_4_(pre|post)/c0/Conv_0/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"conv4_4.{'0' if m.group(1) == 'pre' else '3'}"
                          f".0.{m.group(2)}")
    m = re.fullmatch(r"(conv4_4|upconv\d)_r([12])/c([12])/Conv_0/"
                     r"(kernel|bias)", path)
    if m:
        owner = (f"conv4_4.{m.group(2)}" if m.group(1) == "conv4_4"
                 else f"{m.group(1)}_{m.group(2)}")
        return _conv_leaf(f"{owner}.stem.0."
                          f"{'0' if m.group(3) == '1' else '2'}.{m.group(4)}")
    m = re.fullmatch(r"(upconv\d)_u/t/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"{m.group(1)}_u.0.{m.group(2)}", _conv_t)
    m = re.fullmatch(r"up(\d)_(kernel|res)/c(\d)/Conv_0/(kernel|bias)", path)
    if m:
        scale, head, i, leaf = m.groups()
        tail = "" if head == "kernel" and i == "2" else ".0"
        return _conv_leaf(f"upconv{_DRB_SCALE[scale]}_{head}.{i}{tail}.{leaf}")
    m = re.fullmatch(r"(img_d\d_feature)/c(\d)/Conv_0/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"{m.group(1)}.{m.group(2)}.0.{m.group(3)}")
    raise KeyError(f"unmapped JAX parameter: {path}")


# IFAN's JAX heads -> the reference Sequentials' members
_IFAN_HEADS = {"dme_in": "DME.0.0", "dme_out": "DME.3",
               "conv_dme": "conv_DME.0", "conv4_4_in": "conv4_4.0.0",
               "conv4_4_out": "conv4_4.3.0", "F_in": "F.0.0",
               "F_out": "F.3", "conv_res_in": "conv_res.0.0",
               "conv_res_out": "conv_res.2.0", "out_res": "out_res.0"}
_IFAN_RES = {"dme_res1": "DME.1", "dme_res2": "DME.2",
             "conv4_4_res1": "conv4_4.1", "conv4_4_res2": "conv4_4.2",
             "F_res1": "F.1", "F_res2": "F.2", "conv_res_mid": "conv_res.1"}


def _ifan_name(path: str) -> tuple[str, object]:
    m = re.fullmatch(r"(k?conv\d_\d)/Conv_0/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"{m.group(1)}.0.{m.group(2)}")
    m = re.fullmatch(r"(\w+)/Conv_0/(kernel|bias)", path)
    if m and m.group(1) in _IFAN_HEADS:
        return _conv_leaf(f"{_IFAN_HEADS[m.group(1)]}.{m.group(2)}")
    m = re.fullmatch(r"(\w+)/stem(\d)_([ab])/Conv_0/(kernel|bias)", path)
    if m:
        owner = _IFAN_RES.get(m.group(1), m.group(1))
        return _conv_leaf(f"{owner}.stem.{m.group(2)}."
                          f"{'0' if m.group(3) == 'a' else '2'}.{m.group(4)}")
    m = re.fullmatch(r"(upconv\d)_u/t/(kernel|bias)", path)
    if m:
        return _conv_leaf(f"{m.group(1)}_u.0.{m.group(2)}", _conv_t)
    raise KeyError(f"unmapped JAX parameter: {path}")


# a RIDCP ResBlock's JAX leaves -> the reference's Sequential members
_RIDCP_RES = {"gn1/scale": "conv.0.norm.weight",
              "gn1/bias": "conv.0.norm.bias",
              "gn2/scale": "conv.3.norm.weight",
              "gn2/bias": "conv.3.norm.bias",
              "c1/Conv_0/kernel": "conv.2.kernel",
              "c1/Conv_0/bias": "conv.2.bias",
              "c2/Conv_0/kernel": "conv.5.kernel",
              "c2/Conv_0/bias": "conv.5.bias"}
_RIDCP_TOP = {"in_conv": "multiscale_encoder.in_conv",
              "before_quant/Conv_0": "before_quant_group.0",
              "after_quant/Conv_0": "after_quant_group.0.conv",
              "out_conv/Conv_0": "out_conv",
              "residual_conv/Conv_0": "residual_conv"}


def _ridcp_namer(depth: int):
    enc = "multiscale_encoder.blocks"

    def name(path: str) -> tuple[str, object]:
        m = re.fullmatch(r"enc_swin(\d+)/(.*)", path)
        if m:  # the RSTB's leaves under SwinIR's names, moved
            ref, fn = _ref_name(f"layer{m.group(1)}/{m.group(2)}")
            return (f"{enc}.{depth}.swin_blks." + ref[len("layers."):], fn)
        m = re.fullmatch(r"(.*)/(kernel|bias)", path)
        if m and m.group(1) in _RIDCP_TOP:
            return _conv_leaf(f"{_RIDCP_TOP[m.group(1)]}.{m.group(2)}")
        if path == "quantize/codebook":
            return "quantize_group.0.embedding.weight", _same
        if path == "quantize/hq_weight":
            return "quantize_group.0.weight", _same
        m = re.fullmatch(r"(enc|dec|resid)(\d+)_(down|conv|res\d)/(.*)", path)
        if m:
            kind, i, part, rest = m.groups()
            owner = {"enc": f"{enc}.{i}", "dec": f"decoder_group.{i}.block",
                     "resid": f"multiscale_decoder.upsampler.{i}"}[kind]
            if part in ("down", "conv"):
                return _conv_leaf(f"{owner}.{'0' if part == 'down' else '1'}"
                                  f".{rest.split('/')[-1]}")
            j = int(part[3:]) + (1 if kind == "enc" else 2)
            return _conv_leaf(f"{owner}.{j}.{_RIDCP_RES[rest]}")
        m = re.fullmatch(r"warp(\d+)/(.*)", path)
        if m:
            i, rest = m.groups()
            owner = f"multiscale_decoder.warp.{i}"
            leaf = {"offset_feat/Conv_0/kernel": "offset.kernel",
                    "offset_feat/Conv_0/bias": "offset.bias",
                    "conv_offset/Conv_0/kernel": "dcn.conv_offset.kernel",
                    "conv_offset/Conv_0/bias": "dcn.conv_offset.bias",
                    "dcn_kernel": "dcn.kernel", "dcn_bias": "dcn.bias"}
            if rest in leaf:
                return _conv_leaf(f"{owner}.{leaf[rest]}")
        raise KeyError(f"unmapped JAX parameter: {path}")

    return name


def _rank_kernel(w):
    """A Flax kernel by rank: Conv (kh, kw, I, O) or Dense (I, O)."""
    return _conv(w) if w.ndim == 4 else _linear(w)


def _maxim_name(path: str) -> tuple[str, object]:
    *mods, leaf = path.replace("/Conv_0/", "/").split("/")
    name = ".".join(mods)
    if leaf == "scale":
        return f"{name}.weight", _same
    transposed = re.fullmatch(r"y_up|stage\d+_dec\d+_up", mods[-1])
    return _conv_leaf(f"{name}.{leaf}",
                      _conv_t if transposed else _rank_kernel)


_SD_PARTS = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
             "emb_proj": "emb_layers.1", "out_norm": "out_layers.0",
             "out_conv": "out_layers.3", "skip": "skip_connection",
             "block0": "transformer_blocks.0", "to_out": "to_out.0",
             "ff_in": "ff.net.0.proj", "ff_out": "ff.net.2"}
_VAE_MID = {"mid_block1": "mid.block_1", "mid_attn": "mid.attn_1",
            "mid_block2": "mid.block_2"}


def _unshuffled_first(sd: dict, prefix: str = "") -> None:
    """SwinIR with a pixel-unshuffled input: its ``conv_first`` takes more
    channels than ``conv_last`` gives back, and the reference names it
    ``conv_first.1`` (a ``Sequential(PixelUnshuffle, Conv2d)``)."""
    w, last = sd.get(prefix + "conv_first.weight"), \
        sd.get(prefix + "conv_last.weight")
    if w is not None and last is not None and w.shape[1] != last.shape[0]:
        for leaf in ("weight", "bias"):
            sd[f"{prefix}conv_first.1.{leaf}"] = sd.pop(
                f"{prefix}conv_first.{leaf}")


def _diffbir_namer(params):
    unet = params["diffusion_model"]
    nrb = sum(bool(re.fullmatch(r"down0_res\d+", k)) for k in unet)
    levels = sum(bool(re.fullmatch(r"down\d+_res0", k)) for k in unet)
    attn = {int(k[4:-6]) for k in unet if re.fullmatch(r"down\d+_attn0", k)}

    def unet_top(mod: str) -> str:
        if mod in ("time_fc1", "time_fc2"):
            return f"time_embed.{2 * (int(mod[-1]) - 1)}"
        if mod == "in_conv":
            return "input_blocks.0.0"
        if mod in ("mid_res1", "mid_attn", "mid_res2"):
            return "middle_block." + {"mid_res1": "0", "mid_attn": "1",
                                      "mid_res2": "2"}[mod]
        if mod in ("out_norm", "out_conv"):
            return "out.0" if mod == "out_norm" else "out.2"
        if mod == "zero_mid":
            return "middle_block_out.0"
        m = re.fullmatch(r"zero(\d+)", mod)
        if m:
            return f"zero_convs.{m.group(1)}.0"
        m = re.fullmatch(r"(down|up)(\d+)_(res|attn|downsample|upsample)"
                         r"(\d*)", mod)
        if not m:
            raise KeyError(mod)
        side, lvl, kind, b = m.group(1), int(m.group(2)), m.group(3), \
            m.group(4)
        if side == "down":
            idx = 1 + lvl * (nrb + 1) + (nrb if kind == "downsample"
                                         else int(b))
            return f"input_blocks.{idx}." + {"res": "0", "attn": "1",
                                             "downsample": "0.op"}[kind]
        idx = (levels - 1 - lvl) * (nrb + 1) + (nrb if kind == "upsample"
                                                 else int(b))
        sub = {"res": "0", "attn": "1",
               "upsample": f"{2 if lvl in attn else 1}.conv"}[kind]
        return f"output_blocks.{idx}.{sub}"

    def vae_part(mods: list[str]) -> list[str]:
        out = [mods[0]]
        for mod in mods[1:]:
            m = re.fullmatch(r"(down|up)(\d+)_(block|downsample|upsample)"
                             r"(\d*)", mod)
            if m:
                side, i, kind, j = m.groups()
                out.append(f"{side}.{i}." + (f"block.{j}" if kind == "block"
                                             else f"{kind}.conv"))
            else:
                out.append(_VAE_MID.get(mod, mod))
        return out

    def name(path: str) -> tuple[str, object]:
        if path == "empty_context":
            return path, _same
        top, *mods, leaf = path.replace("/Conv_0", "").split("/")
        if top == "preprocess_model":
            ref, fn = _ref_name(path[len(top) + 1:])
            return f"{top}.{ref}", fn
        if top in ("diffusion_model", "control_model"):
            prefix = "model.diffusion_model" if top == "diffusion_model" \
                else top
            inner = mods[1:]
            if mods[0].startswith("zero"):  # ZeroConv's own nn.Conv
                inner = inner[1:]
            mods = [prefix, unet_top(mods[0])] + [_SD_PARTS.get(m, m)
                                                  for m in inner]
        elif top in ("first_stage_model", "cond_encoder"):
            mods = [top] + vae_part(mods)
        else:
            raise KeyError(f"unmapped JAX parameter: {path}")
        mod = ".".join(mods)
        if leaf == "scale":
            return f"{mod}.weight", _same
        if leaf == "kernel":
            return f"{mod}.weight", _rank_kernel
        return f"{mod}.{leaf}", _same

    return name


def _classifier_name(path: str) -> tuple[str, object]:
    if "/" not in path:  # the V5 head's thresholds
        return path, _same
    module, leaf = path.split("/")
    if leaf == "scale":
        return f"{module}.weight", _same
    if leaf == "kernel":
        return f"{module}.weight", _conv if module.startswith("conv") \
            else _linear
    return f"{module}.{leaf}", _same


def _flax_leaf(module: str, leaf: str) -> tuple[str, object]:
    """A Dense, Conv or norm leaf under the port name ``module``: kernels
    by rank, ``scale`` -> ``weight``."""
    if leaf == "kernel":
        return f"{module}.weight", _rank_kernel
    if leaf == "scale":
        return f"{module}.weight", _same
    return f"{module}.{leaf}", _same


_COMBINER = {"text_projection": "text_projection_layer",
             "image_projection": "image_projection_layer",
             "combiner_layer": "combiner_layer",
             "output_layer": "output_layer",
             "ds_hidden": "dynamic_scalar.0", "ds_out": "dynamic_scalar.3"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _combiner_name(path: str, prefix: str = "") -> tuple[str, object]:
    module, leaf = path.split("/")
    return _flax_leaf(prefix + _COMBINER[module], leaf)


def _standin_name(path: str) -> tuple[str, object]:
    top, *rest = path.split("/")
    if top == "combiner":
        return _combiner_name("/".join(rest), "combiner.")
    if top == "image_tower":
        module, leaf = rest
        return _flax_leaf(f"image_tower.{module}", leaf)
    return path, _same  # caption_embedding


def _clip_name(path: str) -> tuple[str, object]:
    """CLIP (``clip_rules`` there, inverted): the published checkpoint's
    names."""
    top, *mods, leaf = path.split("/")
    if top == "visual":
        m = re.fullmatch(r"layer(\d+)_(\d+)", mods[0])
        if m:
            mods = [f"layer{m.group(1)}", m.group(2)] + [
                {"down_conv": "downsample.0", "down_bn": "downsample.1"}
                .get(x, x) for x in mods[1:]]
        module = ".".join(["visual"] + mods)
        if re.search(r"(^|\.)(bn\d|downsample\.1)$", module):
            return f"{module}.{_BN[leaf]}", _same
        if leaf == "positional_embedding":
            return f"{module}.{leaf}", _same
        return _flax_leaf(module, leaf)
    if not mods:  # token_embedding, positional_embedding, text_projection
        return (f"{leaf}.weight" if leaf == "token_embedding" else leaf,
                _same)
    if mods[0] == "ln_final":
        return _flax_leaf("ln_final", leaf)
    i = mods[0][len("block"):]
    blk = f"transformer.resblocks.{i}"
    part = mods[1]
    if part == "in_proj":
        if leaf == "kernel":
            return f"{blk}.attn.in_proj_weight", _linear
        return f"{blk}.attn.in_proj_bias", _same
    module = {"out_proj": "attn.out_proj", "c_fc": "mlp.c_fc",
              "c_proj": "mlp.c_proj"}.get(part, part)
    return _flax_leaf(f"{blk}.{module}", leaf)


def _clip_extras(sd: dict) -> None:
    """What the JAX tree does not hold: every BatchNorm's
    ``num_batches_tracked`` (0) and ``logit_scale``, which the JAX package
    drops and its CLIP-IQA fixes at 100 (so ln 100 here)."""
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0)
    sd["logit_scale"] = torch.tensor(float(np.log(100.0)))


def _vit_name(path: str, prefix: str = "") -> tuple[str, object]:
    """timm ViT names (``iqa_rules._vit_rules`` there, inverted)."""
    top, *mods = path.split("/")
    if top in ("cls_token", "pos_embed"):
        return prefix + top, _same
    if top == "patch_embed":
        return _flax_leaf(f"{prefix}patch_embed.proj", mods[0])
    i = top[len("block"):]
    *inner, leaf = mods
    module = {"qkv": "attn.qkv", "proj": "attn.proj"}.get(
        inner[0], ".".join(inner))
    return _flax_leaf(f"{prefix}blocks.{i}.{module}", leaf)


def _maniqa_name(path: str) -> tuple[str, object]:
    """The official MANIQA checkpoint's names (``maniqa_rules`` there,
    inverted)."""
    top, *mods = path.split("/")
    if top == "vit":
        return _vit_name("/".join(mods), "vit.")
    m = re.fullmatch(r"(tablock[12])_(\d+)", top)
    if m:
        return _flax_leaf(f"{m.group(1)}.{m.group(2)}.{mods[0]}", mods[1])
    m = re.fullmatch(r"swin([12])", top)
    if m:
        mm = re.fullmatch(r"layer(\d+)_block(\d+)", mods[0])
        blk = (f"swintransformer{m.group(1)}.layers.{mm.group(1)}.blocks."
               f"{mm.group(2)}")
        part = mods[1]
        if part == "relative_position_bias_table":
            return f"{blk}.attn.{part}", _same
        module = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
                  "fc2": "mlp.fc2"}.get(part, part)
        return _flax_leaf(f"{blk}.{module}", mods[2])
    m = re.fullmatch(r"(fc_score|fc_weight)([01])", top)
    if m:
        return _flax_leaf(f"{m.group(1)}.{3 * int(m.group(2))}", mods[0])
    return _flax_leaf(top, mods[0])  # conv1, conv2


def _maniqa_extras(sd: dict) -> None:
    """Each Swin block's ``attn.relative_position_index`` buffer, which the
    official state dict holds and the JAX tree recomputes."""
    from ..ops.window_attention import relative_position_index
    for k in [k for k in sd if k.endswith(".relative_position_bias_table")]:
        ws = (int(round(sd[k].shape[0] ** 0.5)) + 1) // 2
        sd[k[:-len("bias_table")] + "index"] = torch.from_numpy(
            relative_position_index(ws).astype(np.int64))


def _musiq_name(path: str) -> tuple[str, object]:
    """The flat names of ``musiq_rules`` there."""
    top, *mods = path.split("/")
    if top.startswith("block"):
        return _vit_name(path)
    if not mods:  # hse_embedding, scale_embedding, cls_token
        return top, _same
    return _flax_leaf(top, mods[0])  # patch_proj, norm, head


def _lpips_name(path: str) -> tuple[str, object]:
    """The ``lpips`` package's names: ``net/conv{k}`` -> ``net.slice{k+1}
    .{torchvision index}``, ``lin{k}`` (C,) -> ``lin{k}.model.1.weight``
    (1, C, 1, 1)."""
    top, *mods = path.split("/")
    if top.startswith("lin"):
        return f"{top}.model.1.weight", lambda w: w.reshape(1, -1, 1, 1)
    k = int(mods[0][len("conv"):])
    idx = (0, 3, 6, 8, 10)[k]
    return _flax_leaf(f"net.slice{k + 1}.{idx}", mods[1])


def from_jax(params) -> dict[str, torch.Tensor]:
    """The port's state dict from JAX SwinIR, HAT, Restormer, X-Restormer,
    DehazeFormer, NAFNet, FBCNN, MPRNet, MAXIM, DRBNet, IFAN, RIDCP,
    DiffBIR, degradation-classifier (V1, V3, V5), CLIP, Combiner,
    retrieval stand-in, LPIPS, ViT, MANIQA or MUSIQ params."""
    if "params" in params:
        params = params["params"]
    if "inner" in params:  # FBCNN with a pinned quality factor
        params = params["inner"]
    rename = _namer(params)
    out = {}
    for path, value in _flatten(params):
        name, fn = rename(path)
        t = torch.from_numpy(
            np.ascontiguousarray(fn(value)).astype(np.float32))
        if name in out and not torch.equal(out[name], t):
            raise ValueError(f"{path}: the JAX tree's two copies of {name} "
                             "differ; the reference has one")
        out[name] = t
    if rename is _ref_name:
        _unshuffled_first(out)
    elif "control_model" in params:
        _unshuffled_first(out, "preprocess_model.")
    elif rename is _clip_name:
        _clip_extras(out)
    elif rename is _maniqa_name:
        _maniqa_extras(out)
    return out


def _namer(params):
    """``path -> (port name, layout transform)`` for the family of the JAX
    tree ``params`` (read from its top-level keys)."""
    rename = _ref_name
    if "spatial_attn" in params.get("encoder_level1_0", {}):
        rename = _xrestormer_name  # X-Restormer has Restormer's top level
    elif "encoder_level1_0" in params:
        rename = _restormer_name
    elif "hab0" in params.get("layer0", {}):
        rename = _hat_name
    elif "patch_unembed" in params:
        rename = _dehazeformer_name
    elif "intro" in params:
        rename = _nafnet_name
    elif "qf_embed" in params:
        rename = _fbcnn_namer(sum(k.startswith("down0_res") for k in params))
    elif "feat_fc" in params or {"conv0", "gn0", "head"} <= params.keys():
        rename = _classifier_name  # V3 and V5 by feat_fc, V1 by its head
    elif "stage1_encoder" in params:
        rename = _mprnet_namer(sum(
            k.startswith("orb1_cab") for k in params["stage3_orsnet"]))
    elif "stage0_input_conv_0" in params:
        rename = _maxim_name
    elif "dme_in" in params:
        rename = _ifan_name
    elif "conv4_4_pre" in params:
        rename = _drbnet_name
    elif "quantize" in params:
        rename = _ridcp_namer(sum(k.endswith("_down") for k in params))
    elif "control_model" in params:
        rename = _diffbir_namer(params)
    elif "visual" in params and "text" in params:
        rename = _clip_name
    elif "ds_hidden" in params:
        rename = _combiner_name
    elif "image_tower" in params:
        rename = _standin_name
    elif "lin0" in params and "net" in params:
        rename = _lpips_name
    elif "tablock1_0" in params:
        rename = _maniqa_name
    elif "hse_embedding" in params:
        rename = _musiq_name
    elif "pos_embed" in params and "patch_embed" in params:
        rename = _vit_name
    return rename


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


# ---------------------------------------------------------------------------
# a reference DiffBIR checkpoint

# what a reference checkpoint holds beside the pipeline's weights: the
# OpenCLIP text stack, the LDM schedule buffers, the EMA shadows, SwinIR's
# index and mask buffers (the JAX converter's drops, torch_import.py
# diffbir_rules and swinir_rules)
_DIFFBIR_DROPS = (r"cond_stage_model\..*", r"betas", r"alphas_cumprod.*",
                  r"sqrt_.*", r"log_.*", r"posterior_.*", r"lvlb_weights",
                  r"logvar", r"model_ema\..*", r"lq_.*", r"scale_factor",
                  r"preprocess_model\..*relative_position_index",
                  r"preprocess_model\..*attn_mask")


def extract_empty_context(state: dict, context_length: int = 77,
                          sot: int = 49406, eot: int = 49407,
                          penultimate: bool = True,
                          heads: int | None = None) -> np.ndarray:
    """The OpenCLIP empty-prompt conditioning from a DiffBIR / SD2.1
    checkpoint's own ``cond_stage_model`` weights, in numpy float32 (no
    open_clip): FrozenOpenCLIPEmbedder(layer="penultimate") on the tokens
    [SOT, EOT, 0...]: token and position embeddings, every resblock but
    the last with a causal mask (exact GELU), then ``ln_final``. Returns
    the (context_length, width) array that fills ``empty_context``
    (``convert/torch_import.py:extract_empty_context`` there)."""
    from scipy.special import erf  # exact GELU (open_clip nn.GELU)

    p = "cond_stage_model.model."

    def arr(key):
        return np.asarray(state[p + key], np.float32)

    tok, pos = arr("token_embedding.weight"), arr("positional_embedding")
    width = tok.shape[1]
    heads = heads or max(1, width // 64)
    hd = width // heads
    ids = np.zeros(context_length, np.int64)
    ids[0], ids[1] = sot, eot
    x = tok[ids] + pos[:context_length]

    def ln(x, prefix):
        w, b = arr(prefix + ".weight"), arr(prefix + ".bias")
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-5) * w + b

    def split(t):
        return t.reshape(context_length, heads, hd).transpose(1, 0, 2)

    n_layers = 0
    while f"{p}transformer.resblocks.{n_layers}.ln_1.weight" in state:
        n_layers += 1
    mask = np.triu(np.full((context_length, context_length), -np.inf), 1)
    for i in range(n_layers - (1 if penultimate else 0)):
        rb = f"transformer.resblocks.{i}"
        y = ln(x, rb + ".ln_1")
        qkv = y @ arr(rb + ".attn.in_proj_weight").T \
            + arr(rb + ".attn.in_proj_bias")
        q, k, v = np.split(qkv, 3, axis=-1)
        lg = split(q) @ split(k).transpose(0, 2, 1) / np.sqrt(hd) \
            + mask[None]
        lg = lg - lg.max(-1, keepdims=True)
        e = np.exp(lg)
        a = e / e.sum(-1, keepdims=True)
        o = (a @ split(v)).transpose(1, 0, 2).reshape(context_length, width)
        x = x + o @ arr(rb + ".attn.out_proj.weight").T \
            + arr(rb + ".attn.out_proj.bias")
        y = ln(x, rb + ".ln_2")
        h = y @ arr(rb + ".mlp.c_fc.weight").T + arr(rb + ".mlp.c_fc.bias")
        h = 0.5 * h * (1.0 + erf(h / np.sqrt(2.0)))
        x = x + h @ arr(rb + ".mlp.c_proj.weight").T \
            + arr(rb + ".mlp.c_proj.bias")
    return ln(x, "ln_final")


def diffbir_checkpoint_state(state: dict,
                             context_length: int = 77) -> dict:
    """The port's ``DiffBIRPipeline`` state dict from a reference DiffBIR
    checkpoint's (its names are the port's): the keys the JAX converter
    drops are dropped, and ``empty_context`` (1, context_length, width) is
    computed from the checkpoint's ``cond_stage_model``. The result loads
    with ``load_state_dict(..., strict=True)``. This is the loader for the
    reference checkpoint (``general_full_v1.ckpt``, which carries every
    component, stage 1 included); nothing calls it until that file is in
    the repository."""
    ctx = extract_empty_context(state, context_length)
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
           if not any(re.fullmatch(p, k) for p in _DIFFBIR_DROPS)}
    out["empty_context"] = torch.from_numpy(
        np.ascontiguousarray(ctx[None], np.float32))
    return out
