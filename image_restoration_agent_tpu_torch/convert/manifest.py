"""Weight-acquisition manifest: reference checkpoint -> the port's weights
(counterpart of ``image_restoration_agent_tpu/convert/manifest.py``; its
entries are the JAX package's, copied).

The reference ships per-model ``download_ckpts`` scripts under
``AgentApp/weights/<subtask>/<Model>/``; the manifest maps every serving
model (and auxiliary network) to the checkpoint FILE the reference serves
from, where to get it, and the JAX package's rule set for it (``None``:
MAXIM's Flax name map, :mod:`convert.maxim_rules`).

:func:`convert_checkpoint` runs one entry once the file is on disk
(downloads are left to the operator) and writes the port's format: the
reference-named state dict as ``<out_dir>/<model>.npz``, which
``Engine(weight_dir=out_dir)`` serves and the scorer and the retrieval
embedder read. The JAX package's template check becomes
``load_state_dict(strict=True)`` on the port's own module. CLI: ``python
-m image_restoration_agent_tpu_torch.cli convert-weights <model> --ckpt
<file> [--out <dir>]``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

@dataclasses.dataclass(frozen=True)
class WeightEntry:
    model: str                  # registry name (models/registry.py)
    ckpt_file: str              # filename the reference serves from
    source: str                 # reference download URL (folder or file)
    rules: Optional[str]        # the JAX package's rule set (None =>
    #                             MAXIM's Flax name-map converter)
    param_key: str = "auto"     # torch dict key selection (params/params_ema)
    rules_kwargs: dict = dataclasses.field(default_factory=dict)
    notes: str = ""


# Sources are the reference's own download locations:
# AgentApp/weights/**/download_ckpt*(.py|.sh) and the model zoo READMEs.
_GD = "https://drive.google.com/drive/folders/"

MANIFEST: tuple[WeightEntry, ...] = (
    # --- SwinIR (denoise 15/50, JPEG 40, classical SR x4) ---
    WeightEntry("swinir_denoise_15",
                "005_colorDN_DFWB_s128w8_SwinIR-M_noise15.pth",
                _GD + "14HceLBiKbMYK0OxiIjAdtCwBN8C86714", "swinir_rules"),
    WeightEntry("swinir_denoise_50",
                "005_colorDN_DFWB_s128w8_SwinIR-M_noise50.pth",
                _GD + "14HceLBiKbMYK0OxiIjAdtCwBN8C86714", "swinir_rules"),
    WeightEntry("swinir_jpeg_40",
                "006_colorCAR_DFWB_s126w7_SwinIR-M_jpeg40.pth",
                _GD + "14HceLBiKbMYK0OxiIjAdtCwBN8C86714", "swinir_rules"),
    WeightEntry("swinir_sr_x4",
                "001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth",
                _GD + "14HceLBiKbMYK0OxiIjAdtCwBN8C86714", "swinir_rules"),
    # --- Restormer (4 task checkpoints share the arch) ---
    WeightEntry("restormer", "motion_deblurring.pth",
                _GD + "1Qwsjyny54RZWa7zC4Apg7exixLBo4uF0",
                "restormer_rules",
                notes="also gaussian_color_denoising_sigma*.pth / "
                      "single_image_defocus_deblurring.pth / deraining.pth "
                      "from the same Restormer release folders"),
    # --- NAFNet (arch registered by the reference's X-Restormer repo:
    #     xrestormer/archs/NAFNet_arch.py; published SIDD denoise ckpt) ---
    WeightEntry("nafnet", "NAFNet-SIDD-width32.pth",
                _GD + "1cOzNxE0eQjyOBBrQcDe-dB9kymuDf2RK", "nafnet_rules",
                param_key="params"),
    # --- X-Restormer (5 task checkpoints) ---
    WeightEntry("xrestormer", "dehaze_300k.pth",
                _GD + "16WxegSAN_sescgrfW4ZMO4b6TcR_7T24",
                "xrestormer_rules",
                notes="also denoise_300k / derain_155k / deblur_300k / "
                      "sr_300k from the X-Restormer release folder"),
    # --- HAT SR x4 ---
    WeightEntry("hat_sr_x4", "HAT_SRx4_ImageNet-pretrain.pth",
                _GD + "1HpmReFfoUqUbnAOQ7rvOeNU3uf_m69w0", "hat_rules"),
    # --- MPRNet (denoise/deblur/derain) ---
    WeightEntry("mprnet", "model_denoising.pth",
                _GD + "1iVRX9Alw2uJXkXIhkyGc0C5m7hxjTY_d", "mprnet_rules"),
    # --- MAXIM (already-Flax .npz checkpoints; name-map converter) ---
    WeightEntry("maxim_s3", "maxim_s3_dehazing_sots-indoor.npz",
                "gs://gresearch/maxim/ckpt/", None,
                notes="convert_maxim() consumes the Flax .npz directly; "
                      "S-2 variants for denoise/deblur/derain"),
    # --- DehazeFormer ---
    WeightEntry("dehazeformer_b", "dehazeformer-b.pth",
                _GD + "1gnQiI_7Dvy-ZdQUVYXt7pW0EFQkpK39B",
                "dehazeformer_rules", param_key="state_dict"),
    # --- RIDCP ---
    WeightEntry("ridcp", "pretrained_RIDCP.pth",
                _GD + "1vGImev9LdagttXE_nN1gZGVstVTRVQHt", "ridcp_rules"),
    # --- FBCNN ---
    WeightEntry("fbcnn_blind", "fbcnn_color.pth",
                "https://github.com/jiaxi-jiang/FBCNN/releases/download/"
                "v1.0/fbcnn_color.pth", "fbcnn_rules_for"),
    # --- IFAN ---
    WeightEntry("ifan", "IFAN.pytorch",
                "https://www.dropbox.com/s/qohhmr9p81u0syi/checkpoints.zip",
                "ifan_rules"),
    # --- DRBNet ---
    WeightEntry("drbnet", "single_image_defocus_deblurring.ckpt",
                "https://github.com/lingyanruan/DRBNet", "drbnet_rules"),
    # --- DiffBIR stage-1 SwinIR + SD components ---
    WeightEntry("diffbir", "general_full_v1.ckpt",
                "https://huggingface.co/lxq007/DiffBIR/resolve/main/"
                "general_full_v1.ckpt", "diffbir_rules",
                notes="single file carries VAE + UNet + ControlNet + "
                      "stage-1 SwinIR; OpenCLIP empty-prompt context is "
                      "extracted at convert time (see diffbir converter)"),
    # --- retrieval: CLIP RN50x4 + trained Combiner + BPE vocab ---
    WeightEntry("clip_rn50x4", "RN50x4.pt",
                "https://openaipublic.azureedge.net/clip/models/"
                "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263"
                "205fdd/RN50x4.pt", "clip_rules",
                param_key="state_dict",
                notes="the CLIP4CIR fine-tune (saved_state_dict['CLIP']) "
                      "converts with the same rules; the BPE merges file "
                      "bpe_simple_vocab_16e6.txt.gz ships in the openai/"
                      "CLIP repo and is read by retrieval/tokenizer.py"),
    WeightEntry("combiner", "combiner.pt",
                "per CLIP4CIR release / retrival_database training run",
                "combiner_rules", param_key="Combiner"),
    # --- metrics: LPIPS alex ---
    WeightEntry("lpips_alex", "alexnet-owt + lpips lin weights",
                "https://github.com/richzhang/PerceptualSimilarity "
                "(lpips/weights/v0.1/alex.pth + torchvision alexnet)",
                "lpips_rules"),
    # --- metrics: MANIQA + MUSIQ (the reference's last two NR metrics) ---
    WeightEntry("maniqa", "ckpt_koniq10k.pt",
                "https://github.com/IIGROUP/MANIQA/releases",
                "maniqa_rules",
                notes="pyiqa's maniqa default (KonIQ-10k); see iqa/maniqa.py"
                      " port notes — validate-weights arbitrates"),
    WeightEntry("musiq", "musiq_koniq_ckpt.pth",
                "https://github.com/chaofengc/IQA-PyTorch/releases "
                "(pyiqa musiq koniq weights, converted from the TF "
                "google-research/musiq release)", "musiq_rules",
                notes="see iqa/musiq.py port caveats (patch encoder)"),
)


def get_entry(model: str) -> WeightEntry:
    for e in MANIFEST:
        if e.model == model:
            return e
    raise KeyError(f"no manifest entry for {model!r}; known: "
                   f"{[e.model for e in MANIFEST]}")


def build_template(model: str) -> torch.nn.Module:
    """The port's module for manifest name ``model``, built on the meta
    device (names and shapes only): a registered model's configuration, or
    the auxiliary network's published geometry (CLIP RN50x4, the
    Combiner, LPIPS-Alex, MANIQA, MUSIQ)."""
    from ..models.registry import MODEL_REGISTRY

    with torch.device("meta"):
        if model in MODEL_REGISTRY:
            spec = MODEL_REGISTRY[model]
            return spec.build(**spec.config)
        if model == "clip_rn50x4":
            from ..retrieval.clip import CLIPModel
            return CLIPModel()
        if model == "combiner":
            from ..retrieval.combiner import Combiner
            return Combiner()
        if model == "lpips_alex":
            from ..iqa.lpips import LPIPS
            return LPIPS()
        if model == "maniqa":
            from ..iqa.maniqa import MANIQA
            return MANIQA()
        if model == "musiq":
            from ..iqa.musiq import MUSIQ
            return MUSIQ()
    raise KeyError(f"no port module for {model!r}")


def convert_checkpoint(model: str, ckpt_path: str | Path,
                       out_dir: str | Path,
                       entry: Optional[WeightEntry] = None,
                       template: Optional[torch.nn.Module] = None) -> Path:
    """Convert a downloaded reference checkpoint to the port's weight file
    ``<out_dir>/<model>.npz`` and return its path.

    ``entry`` defaults to the manifest's; ``template``, the module the
    state must load into, to :func:`build_template` of ``entry.model``.
    The state is read with the entry's wrapper key, stripped of the keys
    the JAX rule sets drop on purpose (:mod:`convert.torch_import`;
    DiffBIR's through ``diffbir_checkpoint_state``, MAXIM's Flax ``.npz``
    through :mod:`convert.maxim_rules`), and must load into the template
    with ``strict=True``: every parameter present, none extra, every shape
    equal."""
    from . import torch_import as ti

    entry = entry or get_entry(model)
    if template is None:
        template = build_template(entry.model)
    if entry.rules is None:  # MAXIM: the official Flax .npz
        from ..models.registry import MODEL_REGISTRY
        from .maxim_rules import convert_maxim, name_map_config
        state = convert_maxim(ckpt_path, **name_map_config(
            MODEL_REGISTRY[entry.model].config))
    else:
        raw = ti.load_torch_checkpoint(ckpt_path, param_key=entry.param_key)
        if entry.rules == "diffbir_rules":
            from .from_jax import diffbir_checkpoint_state
            state = diffbir_checkpoint_state(raw)
        else:
            state = ti.reference_state(raw, entry.rules,
                                       keep=template.state_dict().keys())
    state = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
    template.load_state_dict(state, strict=True, assign=True)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{model}.npz"
    np.savez(out, **{k: v.numpy() for k, v in state.items()})
    return out
