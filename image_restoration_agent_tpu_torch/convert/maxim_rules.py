"""MAXIM checkpoint conversion: the official Flax checkpoint -> the port's
state dict (counterpart of ``image_restoration_agent_tpu/convert/
maxim_rules.py``).

The reference vendors the upstream JAX MAXIM (executor/dehazing/tools/maxim/
maxim/models/maxim.py); its released checkpoints are ``.npz`` files with
flat ``opt/target/<module>/<param>`` keys (run_eval.py:104-113
recover_tree). :func:`maxim_name_map`, the port's copy of the JAX
package's map, renames the upstream module paths to the JAX package's; the
port's MAXIM keeps those names (``models/maxim.py``), so
:func:`convert.from_jax.from_jax` finishes the job: ``kernel`` ->
``weight`` with the Dense, Conv and ConvTranspose transposes, LayerNorm
``scale`` -> ``weight``.

Name quirks captured here (from the reference module structure):
- unnamed submodules use flax auto-names (Conv_0/ConvTranspose_0/Dense_0 ...)
  counted per parent module per class,
- encoder/decoder RCABs are named ``channel_attention_block_1{g}`` (no
  underscore: g=0 -> "channel_attention_block_10"), while bottleneck RDCABs
  are ``channel_attention_block_1_{g}``,
- all 2*depth^2-per-stage UpSampleRatio modules share one auto-counter on
  the top-level MAXIM module, ordered: per stage, first the cross-gating
  skip loop (i = depth-1..0, j = 0..depth-1), then the decoder loop.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

#: the released checkpoints' prefix of the parameter tree
NPZ_PREFIX = "opt/target/"


# ---------------- submodule maps ----------------

def _gmlp_axis(ref_prefix: str, my_prefix: str) -> dict:
    """Grid/BlockGmlpLayer -> AxisGmlp."""
    gate_unit = ("GridGatingUnit" if "Grid" in ref_prefix
                 else "BlockGatingUnit")
    return {
        f"{ref_prefix}/LayerNorm": f"{my_prefix}/norm",
        f"{ref_prefix}/in_project": f"{my_prefix}/in_project",
        f"{ref_prefix}/{gate_unit}/intermediate_layernorm":
            f"{my_prefix}/gate/norm",
        f"{ref_prefix}/{gate_unit}/Dense_0": f"{my_prefix}/gate/proj",
        f"{ref_prefix}/out_project": f"{my_prefix}/out_project",
    }


def _mab(ref_prefix: str, my_prefix: str) -> dict:
    """ResidualSplitHeadMultiAxisGmlpLayer -> MAB."""
    out = {
        f"{ref_prefix}/LayerNorm_in": f"{my_prefix}/norm_in",
        f"{ref_prefix}/in_project": f"{my_prefix}/in_project",
        f"{ref_prefix}/out_project": f"{my_prefix}/out_project",
    }
    out.update(_gmlp_axis(f"{ref_prefix}/GridGmlpLayer",
                          f"{my_prefix}/grid_gmlp"))
    out.update(_gmlp_axis(f"{ref_prefix}/BlockGmlpLayer",
                          f"{my_prefix}/block_gmlp"))
    return out


def _rcab(ref_prefix: str, my_prefix: str) -> dict:
    return {
        f"{ref_prefix}/LayerNorm": f"{my_prefix}/norm",
        f"{ref_prefix}/conv1": f"{my_prefix}/conv1/Conv_0",
        f"{ref_prefix}/conv2": f"{my_prefix}/conv2/Conv_0",
        f"{ref_prefix}/channel_attention/Conv_0": f"{my_prefix}/ca/c1/Conv_0",
        f"{ref_prefix}/channel_attention/Conv_1": f"{my_prefix}/ca/c2/Conv_0",
    }


def _rdcab(ref_prefix: str, my_prefix: str) -> dict:
    return {
        f"{ref_prefix}/LayerNorm": f"{my_prefix}/norm",
        f"{ref_prefix}/channel_mixing/Dense_0": f"{my_prefix}/fc1",
        f"{ref_prefix}/channel_mixing/Dense_1": f"{my_prefix}/fc2",
        f"{ref_prefix}/channel_attention/Conv_0": f"{my_prefix}/ca/c1/Conv_0",
        f"{ref_prefix}/channel_attention/Conv_1": f"{my_prefix}/ca/c2/Conv_0",
    }


def _gating_weights(ref_prefix: str, my_prefix: str) -> dict:
    """GetSpatialGatingWeights -> SpatialGatingWeights."""
    return {
        f"{ref_prefix}/LayerNorm_in": f"{my_prefix}/norm_in",
        f"{ref_prefix}/in_project": f"{my_prefix}/in_project",
        f"{ref_prefix}/Dense_0": f"{my_prefix}/grid_proj",
        f"{ref_prefix}/Dense_1": f"{my_prefix}/block_proj",
        f"{ref_prefix}/out_project": f"{my_prefix}/out_project",
    }


def _cgb(ref_prefix: str, my_prefix: str, upsample_y: bool) -> dict:
    out = {
        f"{ref_prefix}/Conv_0": f"{my_prefix}/x_proj/Conv_0",
        f"{ref_prefix}/Conv_1": f"{my_prefix}/y_proj/Conv_0",
        f"{ref_prefix}/LayerNorm_x": f"{my_prefix}/norm_x",
        f"{ref_prefix}/in_project_x": f"{my_prefix}/in_project_x",
        f"{ref_prefix}/LayerNorm_y": f"{my_prefix}/norm_y",
        f"{ref_prefix}/in_project_y": f"{my_prefix}/in_project_y",
        f"{ref_prefix}/out_project_x": f"{my_prefix}/out_project_x",
        f"{ref_prefix}/out_project_y": f"{my_prefix}/out_project_y",
    }
    if upsample_y:
        out[f"{ref_prefix}/ConvTranspose_0"] = f"{my_prefix}/y_up"
    out.update(_gating_weights(f"{ref_prefix}/SplitHeadMultiAxisGating_x",
                               f"{my_prefix}/gating_x"))
    out.update(_gating_weights(f"{ref_prefix}/SplitHeadMultiAxisGating_y",
                               f"{my_prefix}/gating_y"))
    return out


# ---------------- full-model map ----------------

def maxim_name_map(num_stages: int = 2, depth: int = 3, num_groups: int = 2,
                   num_bottleneck_blocks: int = 2,
                   num_supervision_scales: int = 1) -> dict[str, str]:
    """Module-path map (reference -> repo) for one MAXIM configuration."""
    m: dict[str, str] = {}
    upsample_idx = 0
    for s in range(num_stages):
        for i in range(num_supervision_scales):
            m[f"stage_{s}_input_conv_{i}"] = f"stage{s}_input_conv_{i}/Conv_0"
            if s > 0:
                m.update(_cgb(f"stage_{s}_input_fuse_sam_{i}",
                              f"stage{s}_input_fuse_sam_{i}",
                              upsample_y=False))

        for i in range(depth):
            ref = f"stage_{s}_encoder_block_{i}"
            my = f"stage{s}_enc{i}"
            m[f"{ref}/Conv_0"] = f"{my}_in/Conv_0"
            m[f"{ref}/Conv_1"] = f"{my}_down/Conv_0"
            for g in range(num_groups):
                m.update(_mab(f"{ref}/SplitHeadMultiAxisGmlpLayer_{g}",
                              f"{my}_mab{g}"))
                m.update(_rcab(f"{ref}/channel_attention_block_1{g}",
                               f"{my}_rcab{g}"))
            if s > 0:
                m.update(_cgb(f"{ref}/cross_gating_block", f"{my}_xgate",
                              upsample_y=False))

        for i in range(num_bottleneck_blocks):
            ref = f"stage_{s}_global_block_{i}"
            my = f"stage{s}_bn{i}"
            m[f"{ref}/input_proj"] = f"{my}_in/Conv_0"
            for g in range(num_groups):
                m.update(_mab(f"{ref}/SplitHeadMultiAxisGmlpLayer_{g}",
                              f"{my}_mab{g}"))
                m.update(_rdcab(f"{ref}/channel_attention_block_1_{g}",
                                f"{my}_rdcab{g}"))

        # cross-gated multi-scale skips (+ their UpSampleRatio signals)
        for i in reversed(range(depth)):
            for j in range(depth):
                m[f"UpSampleRatio_{upsample_idx}/Conv_0"] = \
                    f"stage{s}_sig{i}_from{j}/Conv_0"
                upsample_idx += 1
            m.update(_cgb(f"stage_{s}_cross_gating_block_{i}",
                          f"stage{s}_xgate{i}", upsample_y=True))

        # decoder (+ its UpSampleRatio signals)
        for i in reversed(range(depth)):
            for j in range(depth):
                m[f"UpSampleRatio_{upsample_idx}/Conv_0"] = \
                    f"stage{s}_dsig{i}_from{j}/Conv_0"
                upsample_idx += 1
            ref = f"stage_{s}_decoder_block_{i}"
            my = f"stage{s}_dec{i}"
            m[f"{ref}/ConvTranspose_0"] = f"{my}_up"
            inner = f"{ref}/UNetEncoderBlock_0"
            m[f"{inner}/Conv_0"] = f"{my}_in/Conv_0"
            for g in range(num_groups):
                m.update(_mab(f"{inner}/SplitHeadMultiAxisGmlpLayer_{g}",
                              f"{my}_mab{g}"))
                m.update(_rcab(f"{inner}/channel_attention_block_1{g}",
                               f"{my}_rcab{g}"))

            for i_sup in range(num_supervision_scales):
                if i != i_sup:
                    continue
                if s < num_stages - 1:
                    sam_ref = f"stage_{s}_supervised_attention_module_{i}"
                    sam_my = f"stage{s}_sam_{i}"
                    m[f"{sam_ref}/Conv_0"] = f"{sam_my}/conv1/Conv_0"
                    m[f"{sam_ref}/Conv_1"] = f"{sam_my}/conv_img/Conv_0"
                    m[f"{sam_ref}/Conv_2"] = f"{sam_my}/conv_gate/Conv_0"
                else:
                    m[f"stage_{s}_output_conv_{i}"] = \
                        f"stage{s}_output_conv_{i}/Conv_0"
    return m


def read_maxim_npz(path: str | Path) -> dict[str, np.ndarray]:
    """The ``<module>/<param>`` leaves of an official MAXIM ``.npz`` (its
    ``opt/target/`` subtree; optimizer state and step counters skipped)."""
    with np.load(path) as z:
        out = {k[len(NPZ_PREFIX):]: z[k] for k in z.files
               if k.startswith(NPZ_PREFIX)}
    if not out:
        raise KeyError(f"{path}: no '{NPZ_PREFIX}' parameters (not an "
                       "official MAXIM checkpoint)")
    return out


def convert_maxim(ref: str | Path | dict, **config) -> dict[str, torch.Tensor]:
    """The port's MAXIM state dict from an official checkpoint: a ``.npz``
    path, or its ``<module>/<param>`` leaves as a flat dict. ``config`` is
    the name map's (``num_stages``, ``depth``, ``num_groups``,
    ``num_bottleneck_blocks``, ``num_supervision_scales``). Raises if a
    reference leaf has no mapping."""
    from .from_jax import from_jax

    flat = read_maxim_npz(ref) if isinstance(ref, (str, Path)) else ref
    name_map = maxim_name_map(**config)
    tree: dict = {}
    unmapped = []
    for key, val in flat.items():
        mod, _, leaf = key.rpartition("/")
        my_mod = name_map.get(mod)
        if my_mod is None:
            unmapped.append(key)
            continue
        node = tree
        parts = f"{my_mod}/{leaf}".split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    if unmapped:
        raise KeyError(f"unmapped reference params: {sorted(unmapped)[:10]} "
                       f"(+{max(0, len(unmapped) - 10)} more)")
    return from_jax({"params": tree})


def name_map_config(model_config: dict) -> dict:
    """The :func:`maxim_name_map` arguments of a registered MAXIM's
    build config (the model's defaults where the config leaves them)."""
    keys = {"num_stages": 2, "depth": 3, "num_groups": 2,
            "num_bottleneck_blocks": 2, "num_supervision_scales": 1}
    return {k: model_config.get(k, d) for k, d in keys.items()}
