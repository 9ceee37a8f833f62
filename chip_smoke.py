#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (image_restoration_agent_tpu_torch) on one
NVIDIA card and check it.

    python3 chip_smoke.py            # the whole smoke (one card)
    python3 chip_smoke.py --quick    # build + kernel checks at a small shape

Phases, each printing one JSON line:

1. device: card name and count, ``nvidia-smi`` name and power limit;
2. build: every CUDA source built by nvcc in parallel, with the
   ``-Xptxas -v`` register and spill figures, one line per kernel;
3. kernels: each kernel wrapper against its plain PyTorch version on the
   same inputs at the serving path's shapes (a 552x1920 band of SwinIR-M;
   K2 there in table mode as the band serves it, and at window 7, N 49,
   on a 546x1918 canvas of the same width),
   float32 exact (max-abs error <= 1e-4 * max|ref|) and bfloat16 fast
   (RMS error against plain bf16 no larger than plain bf16's RMS error
   against plain f32, the bf16-rounding control, and max-abs error no
   larger than the control's plus one bf16 ulp at the output's largest
   magnitude), timed with CUDA events, beside one library call where
   PyTorch has one (``F.conv2d``, ``scaled_dot_product_attention``, and
   ``F.linear`` beside K1 in its plain-GEMM mode at the band's qkv shape);
   restormer_kernels: the same for K4 ``gdfn_block`` and K5 ``mdta_front``
   (with its plain epilogue: the MDTA block) at the 1280x720 Restormer
   request's block shapes (768x1280 C 48, 384x640 C 96, 192x320 C 192,
   96x160 C 384, 768x1280 C 96; at 384x640 also without LN, BiasFree and
   with biases), and K3 at the Restormer convs' shapes; hat_kernels: the
   same for K2 at N 256 in table mode (no mask, bank, full mask; SDPA
   beside it),
   ``swin_attn_block`` (dc 0, -8), K6 ``roll2d`` (+-8; ``torch.roll``
   beside it) and K3 at the CAB's shapes on one HAT tile batch
   (5x256x256, C 180), and ``wmsa_block`` with the full mask at N 64 on the
   1088x1928 denoise canvas and at N 256 on the HAT batch;
4. golden: SwinIR-M x4 on the real-geometry synthetic golden in float32,
   PSNR against the independent torch reference output >= recorded - 0.1;
5. main_path: ``Engine(device="cuda")`` serving 1920x1080 x4 in band mode
   in bf16 (one warm-up request, three timed), with the launch counts of
   every kernel wrapper over the timed requests;
6. fast_vs_exact: the bf16 fast band path against the f32 exact whole-image
   path on a 480x270 probe, PSNR >= the plain bf16-vs-f32 control (on its
   240x136 corner, where the card's f32 is also held against the CPU's)
   - 2 dB;
7. restormer_golden: restormer_synth (320x320) in float32, PSNR >=
   recorded - 0.1;
8. restormer_path: ``Engine(device="cuda")`` serving 1280x720 with
   Restormer in bf16 (whole image, 768x1280 canvas; one warm-up request,
   three timed): 8 K3, 44 K4 and 44 K5 launches per request, and a
   ``torch.profiler`` split of one more;
9. restormer_fast_vs_exact: bf16 through the kernels against f32 exact on
   a 128x1024 probe (every level on the fused route), PSNR >= the plain
   bf16-vs-f32 control - 2 dB;
10. hat_exact: f32 ``hat_sr_x4`` (random weights from its seed) on the
    card against the CPU plain f32 path on a 112x112 input (one 128x128
    canvas), PSNR >= 60 dB;
11. hat_path: ``Engine(device="cuda")`` serving 1920x1080 x4 with HAT in
    bf16, tile mode (the 1104x1936 canvas, 45 tiles of 256, 9 batches of
    5; one warm-up request, three timed): per forward 36
    ``swin_attn_block``, 18 ``roll2d``, 36 ``mlp_block`` and 85 K3
    launches, and a ``torch.profiler`` split of one more request;
12. hat_fast_vs_exact: bf16 against f32 exact on the card on a 480x270
    probe (6 tiles), PSNR >= the plain bf16-vs-f32 control (the CPU path,
    on the probe canvas's top-left 64x64) - 2 dB;
13. swinir_denoise_path: ``swinir_denoise_15`` serving 1920x1080 whole
    image in bf16 (the 1088x1928 canvas, every block on the partition
    route): 36 ``wmsa_block``, 36 ``mlp_block`` and 9 K3 launches per
    request, and f32 on the card against the CPU plain f32 path on a
    72x400 canvas of the same route, PSNR >= 60 dB;
14. dehazeformer_kernels: ``wmsa`` (K2 with the logit scale) against
    ``wmsa_plain`` at the six window batches of the DehazeFormer-b 1080p
    request (level 0 C 24, 2 heads: 32400 and 32776 windows; level 1 C 48,
    4 heads: 8160 and 8228; level 2 C 96, 6 heads: 2040 and 2135) and one
    small case with a full (nW, N, N) mask, in f32 and bf16, SDPA beside it;
15. dehazeformer_reflect_pad: the model's reflect pad (a gather) against
    ``F.pad(mode="reflect")`` at the request's two padded shapes, equal
    values, both timed;
16. dehazeformer_path: ``Engine(device="cuda")`` serving 1920x1080 with
    ``dehazeformer_b`` in bf16 (whole image, one 1080x1920 canvas; one
    warm-up request, three timed; random weights from its seed with the
    reference's initialisation): 24 ``wmsa`` launches per request and no
    other kernel, and a ``torch.profiler`` split of one more;
17. dehazeformer_exact: f32 on the card against the CPU plain f32 path on
    a whole 270x480 image, PSNR >= 60 dB, with the output's largest
    magnitude;
18. dehazeformer_bf16_vs_f32: bf16 against f32 on the card on the same
    image, PSNR >= the plain bf16-vs-f32 control (the CPU path) - 2 dB;
19. lab_kernels (with the kernel checks, also under ``--quick`` at small
    shapes): K7 ``conv3x3_pair`` at the x4 head's second stage of one band
    (1104x3840, 64 -> 256 -> 12) and its ring strip (24x3840; also with
    LeakyReLU), K8 ``swin_pair_block`` at the 552x1920 band (``dc1`` 0
    and +4) and ``lab_strip`` at kernel_lab's (4, 256, 256, 180), each
    against its plain version under the f32 and bf16 rules, beside the
    sequence it replaces (``two_k3_ms``, ``two_swin_block_ms``,
    ``swin_attn_block_ms``);
20. lab_r5: the 12-block RSTB frame chain at the band in bf16, 6
    ``swin_pair_block`` against 12 ``swin_block`` (ms per block); the pair
    chain's difference from the sequential chain held to the rounding
    control (the plain bf16 chain against the plain f32 chain: RMS no
    larger, largest element no larger than the control's plus one ulp);
21. head_pair: the head's tail as two K3 launches and as one
    ``conv3x3_pair`` at both shapes (times);
22. lab_strip: every ``lab_strip`` mode at kernel_lab's shape, 30 chained
    calls each (times);
23. agent_kernels (with the kernel checks, also under ``--quick`` at
    16x128): K3, K4 and K5 against their plain versions at every call
    form the slice's served paths give them, traced by running each model
    on the meta device at the canvas the engine gives it
    (``agent_kernel_shapes``): NAFNet and FBCNN at 256 px (nafnet_path,
    fbcnn_path), and Restormer, NAFNet and FBCNN at the agent input's
    canvas (agent_path; Restormer's fused blocks take K4 and K5 there);
24. nafnet_golden and fbcnn_golden: the synthetic goldens' weights written
    as ``.npz`` (``materialize_synthetic_weights``) and served in f32 by
    ``Engine(weight_dir=..., device="cuda", allow_random_init=False)`` on
    each golden's input: PSNR of the uint8 result >= recorded - 0.1 dB, K3
    launches counted and no other kernel;
25. nafnet_path (BASELINE #1) and fbcnn_path: ``nafnet`` and
    ``fbcnn_blind`` serving a 256x256 request in bf16 (one warm-up, 20
    and 10 timed, the traced launches per request; best and median
    seconds, MP/s over input pixels, a ``torch.profiler`` split of one
    more), bf16 against f32 on the card beside the plain control - 2 dB;
    every kernel call form of one more request must be one agent_kernels
    checked;
26. classifier: the v4 degradation classifier in f32 on the card against
    the port's CPU path on the agent's input and 4 seeded images (logits
    within 1e-4 x max|ref|, equal argmaxes), ms per ``evaluate`` and the
    smallest top-2 logit margin;
27. agent_golden: the recipe of tests/test_agent_goldens.py on the card in
    f32 (nafnet_synth + fbcnn_synth weights, the nafnet golden input
    edge-padded by 64 plus seeded noise, rng_seed 0, no rollback): the
    trace equals tests/data/agent_golden_trace.json;
28. agent_path (BASELINE #5 on full-width models): the same input and
    agent in bf16 with Restormer, NAFNet and FBCNN toolboxes
    (``AGENT_TOOLBOXES``): one warm-up run, 5 timed (p50, min, max), the
    K3, K4 and K5 launches over them (none may be 0), and one more run
    split into classifier, PNG I/O and engine host seconds under
    ``torch.profiler``; whether ``cv2`` (the brightening tools) imports.
    Every kernel call form of the warm-up run must be one agent_kernels
    checked;
29. zoo_kernels (with the kernel checks, also under ``--quick`` at small
    shapes): K3, K4, K5 and the Swin partition route's ``wmsa_block`` and
    ``mlp_block`` against their plain versions at every call form of the
    slice-11 paths, traced on the meta device at the input shapes the
    engine gives each model (``served_canvas``): X-Restormer's 256 px tile
    batches of 8 (K4 and K5 at B 8), MPRNet's quadrant (4B) and half (2B)
    batches, MAXIM, DRBNet and IFAN, and every model of the default
    toolboxes on the agent golden input's plan at its canvas (SwinIR-
    denoise on the partition route);
30. one request phase per new model (``xrestormer_path``, ``mprnet_path``,
    ``maxim_s2_path``, ``maxim_s3_path``, ``drbnet_path``, ``ifan_path``):
    ``Engine(device="cuda")`` in bf16, random weights from the model's
    seed (``zoo_state``: torch's own initialisation), one warm-up request
    and three timed (best, median, MP/s) at 1280x720 (X-Restormer through
    its 256 px tiles; the others whole) or DPDD's 1680x1120 (DRBNet,
    IFAN), each kernel's launches against the traced count per request, a
    ``torch.profiler`` split of one more, every call form of one more
    checked by zoo_kernels; on a small probe f32 on the card against the
    CPU path (>= 60 dB) and bf16 against f32 (>= the CPU control - 2 dB);
31. default_agent_path: ``IRAgent`` on the agent golden input with the
    unmodified ``build_default_executor(engine)`` in bf16 (Restormer on
    its golden's weights, the other tools random and nearly the identity):
    the plan's 14 tool calls with no KeyError, the per-tool invocations,
    one warm-up run whose every kernel call form zoo_kernels checked, then
    three timed (p50, min, max) and one split as agent_path's;
32. ridcp_kernels (with the kernel checks, also under ``--quick`` at small
    shapes): K3 and ``swin_block`` (K1, K2, K1 and ``mlp_block``'s two K1;
    the three strip-route forms of RIDCP's RSTBs at 192x320, C 256, hidden
    1024: dc 0, -4 with the bank, +4) at every call form of the 1280x720
    ``ridcp`` request, traced on the meta device at the engine's 768x1280
    canvas, and K1's fc1 (256 -> 1024, LayerNorm-in, GELU) and fc2 (1024
    -> 256 in K chunks, residual, scatter) at its MLP, ``F.linear``
    beside both;
33. ridcp_path: ``ridcp`` (random weights, ``zoo_state``) serving 1280x720
    whole in bf16 (one warm-up, three timed; best, median, MP/s), each
    kernel's launches against the traced count (38 K3, 24 ``swin_block``,
    96 K1, 24 K2 and 24 ``mlp_block`` per request), a ``torch.profiler``
    split, every call form checked by ridcp_kernels; on a 256x256 probe f32
    on the card against the CPU path (>= 60 dB), bf16 against f32 (>= the
    CPU control - 2 dB) and the share of VQ codes whose card and CPU f32
    argmins agree; every model of the dehazing box registered;
34. serve_path: the HTTP API (``api/server.py`` ``make_server``) on a
    loopback port over default_agent_path's engine and the unmodified
    ``build_default_executor``: /health (device ``cuda``, the card's name,
    the native codec), three /process requests on the agent golden input
    (JSON, multipart, JSON), each with its /download; the same plan and
    subtask results, byte-equal downloads, no ``tool_errors`` in any
    request's graph state, every call form checked by zoo_kernels, p50
    seconds and launches; then /evaluate_degradation and /compare_quality
    on ``make_eval_server`` with the classifier on the card;
35. cli_path: ``python -m image_restoration_agent_tpu_torch.cli restore
    <png> --model ridcp`` and ``... test-tools`` in subprocesses with no
    ``--device`` (the card): the restored image's shape, every tool ok.
36. diffbir_kernels (with the kernel checks, also under ``--quick`` at
    small shapes): K3 and ``swin_block`` against their plain versions at
    every call form of the 256 px ``diffbir`` request, traced on the meta
    device at the engine's 256 canvas with bf16 weights, each form in the
    dtype the request runs it in (stage 1 and the condition encoder bf16;
    the ControlNet, UNet and VAE decoder float32, which is what the JAX
    package's promotions give under bf16 weights);
37. diffbir_path (bench.py's diffbir_sr): ``diffbir`` (random weights,
    torch's own init) serving 256x256 in bf16 through
    ``Engine(device="cuda")``, whole image, 50 steps: a warm-up request
    whose call forms diffbir_kernels checked, two timed (best, median, the
    launches per request against the trace, peak device memory), a
    ``torch.profiler`` split of one more (busy share, K3's f32 share);
    every model of the super-resolution box registered;
38. diffbir_exact: full geometry on a 64x64 canvas, 1 step,
    f32 on the card against the port's CPU path with the same injected
    draws, PSNR >= 60 dB;
39. diffbir_bf16_vs_f32: bf16 against f32 on the card on that probe, PSNR
    >= the CPU path's bf16-vs-f32 control - 2 dB;
40. sr_process: ``/process`` through ``make_server`` on the unmodified
    default executor with a 192 px input: the plan includes
    super-resolution, ``diffbir`` is called, no ``tool_errors``;
41. agent_fast and agent_full (BASELINE #5 as bench.py:444-488 defines
    it): IRAgent on ``build_default_executor(fast=True)`` with 192 px
    inputs and on the unmodified default executor (random-init full-size
    models, f32) with 512 px inputs, 2 warm-ups, p50 over 5, each run's
    plan.
42. retrieval_exact: full-width CLIP RN50x4 (288 px image tower, the
    77-token text tower) fused with the Combiner (``CLIPRetrievalEmbedder``,
    its tokenizer on a synthetic merges file) and the stand-in, random
    weights from their seeds, f32: the card's fused embedding against the
    port's CPU path on the same weights, cosine >= 1 - 1e-6 and max-abs <=
    1e-4 x max|ref|, on a 512x384 and a 1080p input;
43. retrieval_path: ``embed_array`` times of both embedders on those
    inputs (best of 3), ``NumpyVectorStore.query`` over 10 000 random unit
    vectors, ``insert_solved_runs`` over 10 fabricated work dirs;
44. retrieval_agent (the survey's fast path): on the agent golden input
    with ``AGENT_TOOLBOXES`` in bf16, ``local`` IRAgent runs, the first
    solved run inserted in a store by ``insert_solved_runs``, IRAgent in
    ``clip_retrieval`` mode on it (plan and tools the stored ones; its
    launches counted, every call form checked by agent_kernels) and the
    graph app on it (retrieval branch) and on a store of another image
    (depictqa branch); p50 of 3 of each beside ``local`` mode's;
45. iqa_exact: LPIPS-Alex (256 px pair), MANIQA (two 224 crops), MUSIQ
    (384 px) and CLIP-IQA (RN50, native 256 px) at full width on random
    weights, f32, the card against the CPU path, relative error <= 1e-4;
46. iqa_path: the six-metric ``Scorer`` on a 1920x1080 pair with the
    learned models passed in: ms per metric, peak device memory, a
    ``torch.profiler`` top-10 of the slowest metric;
47. degrade_exact: the 16 degradation combos on one suite image each,
    ``synthesize_combo`` on the card against the CPU from the same seed:
    equal, except ``lowres``'s (<= 1 level on <= 0.1% of the pixels);
48. eval_suite_fast: ``cli eval-suite --combos 16 --device cuda`` in a
    fresh process (the tiny executor), against the same suite on the CPU
    (plans, executed subtasks, tool calls equal; PSNR within 0.05 dB, SSIM
    within 1e-3), and its results scored on the card against the CPU
    (1e-6 relative);
49. eval_suite_full: ``run_suite`` on the default toolboxes as shipped
    (f32, random init) on three combos: per case the plan, tools,
    seconds (DiffBIR's apart) and launches; every kernel call form
    recorded and predicted by the meta-device trace at the engine's
    canvases;
50. exploration_path: ``exhaust_sequences`` on [brightening, denoising]
    over the default executor at 96 px (45 tool calls, the tree's nodes
    and leaves as ``expected_tree_counts`` says), fail rates from the v4
    classifier on the card, ``distill_experience`` with MockLLM;
51. eval_suite_kernels: every call form of phases 49-50, its kernels
    against their plain versions in f32;
52. ablation_grid: ``cli ablation-grid --combos 2 --device cuda``: six
    variants, seven pairs, the grid's JSON and markdown;
53. validate_synthetic: ``cli validate-weights --synthetic --device
    cuda``: the four committed goldens through the port's converter and
    tiled path at >= recorded - 0.1 dB; xrestormer ``missing``;
54. convert_maxim: an official-named MAXIM-S3 ``.npz`` through ``cli
    convert-weights``, the written state equal to the drawn one, served
    from the written file at 1280x720 in f32, the card against the CPU
    on a 256x128 probe (>= 60 dB);
55. engine_profile: ``Engine.profile`` around one NAFNet 256 px request:
    the Chrome trace names K3's kernel;
56. train_kernels (with the kernel checks, also under ``--quick`` at
    2x16x128): K3, K4 and K5 at Restormer's training forms in f32 at
    8x128x128 (K3 at patch_embed, down1_2, up2_1 and output, and its
    ``res``, ``ln_pre`` and ``shuffle`` epilogues; K4 and the MDTA block
    at C 48 and C 96) through their autograd functions: the forward
    against the plain version (max-abs <= 1e-4 x max|ref|), every input's
    and parameter's gradient against the plain version's own autograd on
    the card (<= 1e-5 x max|grad|), forward and backward ms;
57. train_exact: 3 ``Trainer`` steps of full-width ``restormer`` (f32,
    batch 1, crop 128) on the card and on the CPU from the same init and
    batches, every loss within 1e-4 relative;
58. train_path: ``Trainer`` on ``restormer`` at the JAX defaults (batch 8,
    crop 128, f32), 20 steps: median s per step over steps 5-20, peak
    memory, K3, K4 and K5 launches per step, the loss falling from step
    1 to 20, one more step profiled (top device rows) and one split into
    forward and backward by CUDA events;
59. classifier_train: ``synthesize_multi`` and ``build_dataset`` card vs
    CPU, 50 steps of ``train_classifier_v3_dataset`` on the v4 recipe with
    and without ``device_data``, its ``snapshot_fn`` calls;
60. retrieval_train: 20 steps of ``train_retrieval_model``, the loss
    falling;
61. parallel_single_rank: an ``nccl`` world of one rank: the sharded step
    equals the Trainer's, ``tiled_apply_sharded`` and
    ``tiled_apply_halo`` equal ``tiled_apply`` bit for bit on a 256 px
    NAFNet input, and ``dryrun_multichip(1)``;
62. swin_train_kernels (with the kernel checks, also under ``--quick`` at
    2x16x16): K1, K2, K6 and the Swin block at the Swin families' training
    forms in f32 (8 x 32 x 32 tokens: SwinIR-M's qkv, proj, fc1 and fc2,
    its K2 with bank and table at N 64 and its whole shifted block;
    HAT's K2 at N 256 and K6 by +-8; DehazeFormer-b's ``wmsa`` at level 0;
    RIDCP's fc2 at K 1024) through their autograd functions, checked as
    in phase 56, with forward, backward, plain and bound ms;
63. swin_train_path: ``Trainer`` on ``swinir_sr_x4`` (SwinIR-M x4) at the
    JAX defaults (batch 8, HQ crop 128, LQ 32 by ``lowres``, f32), 20
    steps: median s per step over steps 5-20, peak memory, launches per
    step (``swin_block``, ``token_linear``, ``window_attention`` and
    ``conv3x3`` in every step), the loss falling, one step profiled and
    one split into forward and backward;
64. swin_train_exact: 3 steps of it at batch 2 on the card and on the
    CPU from the same init and batches, every loss within 1e-4 relative;
65. family_train: 2 ``Trainer`` steps of each newly trainable family at
    full width (SwinIR denoising, HAT, DehazeFormer-b, RIDCP, X-Restormer,
    MPRNet, MAXIM-S2/S3, DRBNet, IFAN; batch 2, crop 128): finite losses,
    every parameter with a finite gradient, each family's kernels
    launched.
Every phase but the training ones (56-65) runs under ``torch.no_grad()``,
as a served forward does.
Phases 20-22 are the lab path: each counts its kernel's launches over one
call (6 ``swin_pair_block`` per chain, 1 ``conv3x3_pair`` per tail, 1
``lab_strip`` per call), with every count set to 0 just before.

Then the ``kernels`` line (each kernel's launches counted on the path
that runs it, and every path's launches by kernel), the ``nvidia-smi``
line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that last line; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12
SRC = "image_restoration_agent_tpu_torch/csrc/"
TPU = "image_restoration_agent_tpu/ops/"
REPLACES = {
    "swin_block": TPU + "pallas_attention.py:1015",
    "token_linear": TPU + "pallas_attention.py:1015",
    "window_attention": TPU + "pallas_attention.py:1015",
    "swin_attn_block": TPU + "pallas_attention.py:1015",
    "mlp_block": TPU + "pallas_attention.py:1457",
    "wmsa_block": TPU + "pallas_attention.py:145",
    "roll2d": TPU + "pallas_attention.py:1571",
    "conv3x3": TPU + "conv3x3.py:201",
    "gdfn_block": TPU + "restormer_fused.py:260",
    "mdta_front": TPU + "restormer_fused.py:398",
    "wmsa": TPU + "pallas_attention.py:1496",
    "conv3x3_pair": TPU + "conv3x3.py:500",
    "swin_pair_block": TPU + "pallas_attention.py:1868",
    "lab_strip": "scripts/kernel_lab.py:229",
}
SOURCE = {"swin_block": SRC + "swin_block.cu", "token_linear":
          SRC + "swin_block.cu", "window_attention": SRC + "swin_block.cu",
          "swin_attn_block": SRC + "swin_block.cu",
          "wmsa_block": SRC + "swin_block.cu", "roll2d": SRC + "roll2d.cu",
          "mlp_block": SRC + "swin_block.cu", "conv3x3": SRC + "conv3x3.cu",
          "gdfn_block": SRC + "restormer_fused.cu",
          "mdta_front": SRC + "restormer_fused.cu",
          "wmsa": SRC + "swin_block.cu",
          "conv3x3_pair": SRC + "conv3x3_pair.cu",
          "swin_pair_block": SRC + "swin_pair.cu",
          "lab_strip": SRC + "swin_block.cu"}
# the lab kernels' rows time the launch sequence each one replaces
REPLACED_MS = ("two_k3_ms", "two_swin_block_ms", "swin_attn_block_ms")
# one batch of the HAT 2K request's tiles (5 of 45, 256x256, C 180, 6
# heads, window 16) and the whole-image SwinIR-denoise canvas (1088x1928)
HAT_BATCH = (5, 256, 256, 180)
DENOISE_CANVAS = (1, 1088, 1928, 180)
# the DehazeFormer-b 1080p request's window attention calls: (level, C,
# heads, windows unshifted, windows shifted) on the 1080x1920 canvas
DEHAZE_LEVELS = ((0, 24, 2, 32400, 32776), (1, 48, 4, 8160, 8228),
                 (2, 96, 6, 2040, 2135))
# the 1280x720 Restormer request's block shapes (canvas 768x1280): the four
# U-Net levels and the C 96 full-resolution decoder / refinement stage
RESTORMER_SHAPES = (("level1", (1, 768, 1280, 48), 1),
                    ("level2", (1, 384, 640, 96), 2),
                    ("level3", (1, 192, 320, 192), 4),
                    ("level4", (1, 96, 160, 384), 8),
                    ("decoder1", (1, 768, 1280, 96), 1))
# its 3x3 convs that are not at a SwinIR shape: (name, cin, cout, H, W)
RESTORMER_CONVS = (("patch_embed", 3, 48, 768, 1280),
                   ("down1_2", 48, 24, 768, 1280),
                   ("up2_1", 96, 192, 384, 640),
                   ("up4_3", 384, 768, 96, 160),
                   ("output", 96, 3, 768, 1280))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave no output"


def _kernel_name(mangled: str) -> str:
    """The kernel's own name in an Itanium-mangled symbol (the
    length-prefixed identifier ending in ``kernel``), with its integer
    template arguments: ``window_attention_mma_kernel<256,2>``."""
    for i in range(len(mangled)):
        for j in range(i + 1, min(i + 4, len(mangled))):
            if not mangled[i:j].isdigit():
                break
            name = mangled[j:j + int(mangled[i:j])]
            if name.endswith("kernel") and name[:1].isalpha():
                m = re.match(r"I((?:L[ij]\d+E)+)E",
                             mangled[j + len(name):])
                args = re.findall(r"L[ij](\d+)E", m.group(1)) if m else []
                return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_lines(log: str) -> list[str]:
    """One line per kernel from nvcc's ``-Xptxas -v`` log: the kernel (its
    template arguments in angle brackets), registers, and the spill and
    stack figures."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = _kernel_name(ln.split("'")[1])
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip() if ":" in ln else ln.strip()
        elif "registers" in ln and name is not None:
            regs = ln.split("Used", 1)[-1].strip()
            out.append(f"{name}: {regs}; {spill}")
            name, spill = None, ""
    return out


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def range_psnr(a, ref) -> float:
    """PSNR normalized by the reference's dynamic range."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    span = float(ref.max() - ref.min()) or 1.0
    mse = float(np.mean((a - ref) ** 2))
    return float(20 * np.log10(span) - 10 * np.log10(max(mse, 1e-20)))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def check_case(cs: dict, dtype) -> dict:
    """One kernel case against its plain version: the f32 rule or the bf16
    rule of the module docstring, then CUDA-event times of the kernel, the
    plain version and the library call, and the bound."""
    import torch

    dn = str(dtype).split(".")[-1]
    got = cs["kernel"]()
    torch.cuda.synchronize()
    want = cs["plain"]().float()
    d = (got.float() - want).abs()
    err = float(d.max())
    row = dict(name=cs["name"], variant=cs["variant"], dtype=dn,
               path=cs.get("path", "swinir"), route="cuda",
               source=SOURCE[cs["name"]], replaces=REPLACES[cs["name"]],
               max_abs_err=err, rms_err=float(d.square().mean().sqrt()))
    finite = bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        scale = float(want.abs().max())
        row["tolerance"] = 1e-4 * scale
        row["pass"] = err <= 1e-4 * scale and finite
    else:
        # Kernel and plain version round the same float32 values, but sum
        # in another order, so a value on a rounding boundary lands one
        # bf16 ulp apart. The error is therefore held in RMS to the control
        # (plain bf16 vs plain f32 on the unrounded inputs), and its largest
        # element to the control's largest plus one bf16 ulp at the
        # output's largest magnitude.
        dc_ = (want - cs["ref32"]().float()).abs()
        ulp = 2.0 ** (math.floor(math.log2(
            float(want.abs().max()) or 1.0)) - 7)
        row["control_max_abs"] = float(dc_.max())
        row["control_rms"] = float(dc_.square().mean().sqrt())
        row["tolerance"] = row["control_max_abs"] + ulp
        row["pass"] = (row["rms_err"] <= row["control_rms"]
                       and err <= row["tolerance"] and finite)
        del dc_
    del got, want, d
    for key, fn in cs.get("extra_ms", {}).items():
        row[key] = cuda_ms(fn, cs["reps"])
    row.update(cs.get("extra", {}))
    row["pass"] = row["pass"] and row.get("repeatable", True)
    row["ms"] = cuda_ms(cs["kernel"], cs["reps"])
    row["plain_ms"] = cuda_ms(cs["plain"], 2)
    row["library_ms"] = (cuda_ms(cs["library"], cs["reps"])
                         if cs["library"] is not None else None)
    row["bound_ms"], row["bound_by"] = bound(cs["flops"], cs["nbytes"], dn)
    emit({"phase": "kernel", **row})
    torch.cuda.empty_cache()
    return row


def kernel_checks(shape, seed: int = 0) -> list[dict]:
    import torch

    from image_restoration_agent_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, conv3x3_weights)
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        GATHER, _dense, mlp_block, mlp_block_plain, prepare_swin_params,
        swin_block, swin_block_plain, token_linear, token_linear_plain,
        window_attention, window_attention_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask)

    dev = torch.device("cuda")
    b, h, w, c = shape
    ws, heads, hid = 8, 6, 2 * c
    n = ws * ws
    t = b * h * w
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    x32 = randn(b, h, w, c)
    wts = dict(
        norm1_w=1 + randn(c, scale=0.1), norm1_b=randn(c, scale=0.1),
        qkv_w=randn(3 * c, c, scale=c ** -0.5), qkv_b=randn(3 * c,
                                                            scale=0.1),
        proj_w=randn(c, c, scale=c ** -0.5), proj_b=randn(c, scale=0.1),
        rpb_table=randn((2 * ws - 1) ** 2, heads, scale=0.5),
        norm2_w=1 + randn(c, scale=0.1), norm2_b=randn(c, scale=0.1),
        fc1_w=randn(hid, c, scale=c ** -0.5), fc1_b=randn(hid, scale=0.1),
        fc2_w=randn(c, hid, scale=hid ** -0.5), fc2_b=randn(c, scale=0.1))
    bank = torch.from_numpy(shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n)).to(dev)
    x1_32 = randn(t, c)
    conv_w = {cin_cout: randn(3, 3, cin_cout[0], cin_cout[1],
                              scale=(9 * cin_cout[0]) ** -0.5)
              for cin_cout in ((3, c), (c, c), (c, 64), (64, 256), (256, 12))}
    conv_b = {k: randn(k[1], scale=0.1) for k in conv_w}
    ln = (1 + randn(c, scale=0.1), randn(c, scale=0.1))
    img32 = randn(b, h, w, 3)
    res32 = randn(b, h, w, c)
    # the x4 head's border ring: a 12-row strip after the first upsample
    # stage (24 rows, twice the width, 64 channels) enters upsample_tail
    ring32 = randn(b, 24, 2 * w, 64)
    ring_mid32 = randn(b, 24, 2 * w, 256)
    rows = []
    # window 7: a (b, h7, w7_) canvas of about the band's tokens, the
    # block's weights at window 7 (its own bias table)
    h7, w7_ = (h // 7) * 7, (w // 7) * 7
    wts7 = dict(wts, rpb_table=randn(13 ** 2, heads, scale=0.5))
    x7_32 = randn(b * h7 * w7_, c)
    bank7 = torch.from_numpy(shift_attention_mask(14, 14, 7, 3).reshape(
        2, 2, 49, 49)).to(dev)
    p7, w7 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        p7[dtype] = prepare_swin_params(**wts7, num_heads=heads, ws=7,
                                        dtype=dtype)
        pp = p7[dtype]
        q7_32 = token_linear_plain(x7_32, p7[torch.float32].wqkv,
                                   p7[torch.float32].bqkv,
                                   ln=(pp.ln1_w, pp.ln1_b))
        q7 = token_linear_plain(x7_32.to(dtype), pp.wqkv, pp.bqkv,
                                ln=(pp.ln1_w, pp.ln1_b))
        kw7 = dict(num_heads=heads, nwy=h7 // 7, nwx=w7_ // 7,
                   fast=dtype == torch.bfloat16)
        mask7 = (pp.rpb[None] + bank7[
            (torch.arange(h7 // 7, device=dev) == h7 // 7 - 1).long()
            [:, None], (torch.arange(w7_ // 7, device=dev)
                        == w7_ // 7 - 1).long()[None]]
            .reshape(-1, 49, 49)[:, None]).repeat(b, 1, 1, 1).to(dtype)
        w7[dtype] = (q7, q7_32, pp.rpb, bank7, kw7, mask7)

    for dtype, fast in ((torch.float32, False), (torch.bfloat16, True)):
        es = 4 if dtype == torch.float32 else 2
        p = prepare_swin_params(**wts, num_heads=heads, ws=ws, dtype=dtype)
        p32 = prepare_swin_params(**wts, num_heads=heads, ws=ws,
                                  dtype=torch.float32)
        x = x32.to(dtype)
        geom = (b, h, w, ws, -4)

        cases = []
        # the main path's three reads: a shift-0 block first (dc 0), a
        # shifted block (dc -4, bank), a shift-0 block after it (dc +4)
        for dc, bk in ((0, None), (-4, bank), (4, None)):
            kw = dict(num_heads=heads, ws=ws, dc=dc, mask_bank=bk, fast=fast)
            flops = (2 * t * c * 3 * c + 2 * t * c * c + 4 * t * c * hid
                     + 4 * t * n * c)
            nbytes = 2 * t * c * es + (4 * c * c + 2 * c * hid) * es
            cases.append(dict(
                name="swin_block", variant=f"dc={dc}"
                + (",bank" if bk is not None else ""),
                kernel=lambda x=x, kw=kw: swin_block(x, p, **kw),
                plain=lambda x=x, kw=kw: swin_block_plain(x, p, **kw),
                ref32=lambda kw=kw: swin_block_plain(x32, p32, **kw),
                library=None, flops=flops, nbytes=nbytes, reps=3))
        xt = x.reshape(t, c)
        qkv = token_linear_plain(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b),
                                 geom=geom, a_map=GATHER)
        qkv32 = token_linear_plain(x32.reshape(t, c), p32.wqkv, p32.bqkv,
                                   ln=(p32.ln1_w, p32.ln1_b), geom=geom,
                                   a_map=GATHER)
        tl_kw = dict(ln=(p.ln1_w, p.ln1_b), geom=geom, a_map=GATHER)
        cases.append(dict(
            name="token_linear", variant="ln1+gather->qkv",
            kernel=lambda: token_linear(xt, p.wqkv, p.bqkv, **tl_kw),
            plain=lambda: token_linear_plain(xt, p.wqkv, p.bqkv, **tl_kw),
            ref32=lambda: token_linear_plain(
                x32.reshape(t, c), p32.wqkv, p32.bqkv,
                ln=(p32.ln1_w, p32.ln1_b), geom=geom, a_map=GATHER),
            library=None, flops=2 * t * c * 3 * c,
            nbytes=4 * t * c * es + 3 * c * c * es, reps=3))
        # row 1a's yardstick: K1 in its plain-GEMM mode (identity maps, no
        # LayerNorm, bias only) beside F.linear on the same operands
        wl = _dense(p.wqkv, c, 3 * c).to(dtype).t().contiguous()
        bl = p.bqkv.to(dtype)
        cases.append(dict(
            name="token_linear", variant="plain GEMM qkv",
            kernel=lambda: token_linear(xt, p.wqkv, p.bqkv),
            plain=lambda: token_linear_plain(xt, p.wqkv, p.bqkv),
            ref32=lambda: token_linear_plain(x32.reshape(t, c), p32.wqkv,
                                             p32.bqkv),
            library=lambda wl=wl, bl=bl: torch.nn.functional.linear(
                xt, wl, bl),
            flops=2 * t * c * 3 * c, nbytes=4 * t * c * es + 3 * c * c * es,
            reps=3))
        wa_kw = dict(num_heads=heads, nwy=h // ws, nwx=w // ws, fast=fast)
        # SDPA computes the same function in both modes: the fast form is
        # the same softmax with the max subtraction replaced by a clamp, and
        # q carries the scale (scale=1.0); its mask is rpb + the bank
        qh, kh, vh = (qkv.reshape(-1, n, 3, heads, c // heads)
                      .permute(2, 0, 3, 1, 4).contiguous())
        mask = (p.rpb[None] + bank[
            (torch.arange(h // ws, device=dev) == h // ws - 1).long()
            [:, None], (torch.arange(w // ws, device=dev)
                        == w // ws - 1).long()[None]]
            .reshape(-1, n, n)[:, None]).repeat(b, 1, 1, 1).to(dtype)
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0)
        cases.append(dict(
            name="window_attention", variant="N64 bank",
            kernel=lambda: window_attention(qkv, p.rpb, bank, **wa_kw,
                                            table=p.rpb_table),
            plain=lambda: window_attention_plain(qkv, p.rpb, bank, **wa_kw),
            ref32=lambda: window_attention_plain(qkv32, p32.rpb, bank,
                                                 **wa_kw),
            library=lib, flops=4 * t * n * c, nbytes=4 * t * c * es,
            reps=3))
        # window 7 (N 49: swinir_jpeg_40's geometry, keys padded to 64) on
        # a canvas of as many tokens, qkv from K1's plain version
        q7, q7_32, rpb7, bank7, kw7, mask7 = w7[dtype]
        qh7, kh7, vh7 = (q7.reshape(-1, 49, 3, heads, c // heads)
                         .permute(2, 0, 3, 1, 4).contiguous())
        cases.append(dict(
            name="window_attention", variant=f"N49 bank {h7}x{w7_}",
            kernel=lambda: window_attention(q7, rpb7, bank7, **kw7,
                                            table=p7[dtype].rpb_table),
            plain=lambda: window_attention_plain(q7, rpb7, bank7, **kw7),
            ref32=lambda: window_attention_plain(q7_32, rpb7, bank7, **kw7),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                qh7, kh7, vh7, attn_mask=mask7, scale=1.0),
            flops=4 * q7.shape[0] * 49 * c, nbytes=4 * q7.shape[0] * c * es,
            reps=3))
        mlp_kw = dict(fast=fast, out_dtype=dtype, scatter=(b, h, w, ws))
        mlp_kw32 = dict(mlp_kw, out_dtype=torch.float32)
        cases.append(dict(
            name="mlp_block", variant="x1 f32 in, scatter",
            kernel=lambda: mlp_block(x1_32, *p.mlp, **mlp_kw),
            plain=lambda: mlp_block_plain(x1_32, *p.mlp, **mlp_kw),
            ref32=lambda: mlp_block_plain(x1_32, *p32.mlp, **mlp_kw32),
            library=None, flops=4 * t * c * hid,
            nbytes=t * c * (4 + es) + 2 * c * hid * es, reps=3))
        res = res32.to(dtype)
        for cname, inp32, (cin, cout), kw in (
                ("conv_first", img32, (3, c), {}),
                ("rstb_conv roll=+4 res", x32, (c, c),
                 dict(roll=4, res=True)),
                ("conv_after_body ln_pre res", x32, (c, c),
                 dict(ln_pre=ln, res=True)),
                ("conv_before_upsample lrelu", x32, (c, 64),
                 dict(act="lrelu")),
                ("head ring upsample conv", ring32, (64, 256), {}),
                ("head ring conv_last (plane)", ring_mid32, (256, 12), {})):
            inp = inp32.to(dtype)
            px = inp.shape[0] * inp.shape[1] * inp.shape[2]
            wk, bk_ = conv_w[(cin, cout)], conv_b[(cin, cout)]
            # the kernel form, made once as the model keeps it
            kf = conv3x3_weights(wk, bk_, dtype)
            use_res = kw.pop("res", False)
            kd = dict(kw, res=res if use_res else None)
            k32 = dict(kw, res=res32 if use_res else None)
            library = None
            if not kw:  # plain conv + bias: one library call
                xin = inp.permute(0, 3, 1, 2)
                wl = wk.to(dtype).permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                library = lambda xin=xin, wl=wl, bk_=bk_: \
                    torch.nn.functional.conv2d(xin, wl, bk_.to(dtype),
                                               padding=1)
            cases.append(dict(
                name="conv3x3", variant=cname,
                kernel=lambda inp=inp, kf=kf, kd=kd: conv3x3(inp, kf, **kd),
                plain=lambda inp=inp, wk=wk, bk_=bk_, kd=kd: conv3x3_plain(
                    inp, wk, bk_, **kd),
                ref32=lambda inp32=inp32, wk=wk, bk_=bk_, k32=k32:
                    conv3x3_plain(inp32, wk, bk_, **k32),
                library=library, flops=2 * px * 9 * cin * cout,
                nbytes=px * (cin + cout * (2 if use_res else 1)) * es
                + 9 * cin * cout * es, reps=5))

        rows += [check_case(cs, dtype) for cs in cases]
    return rows


def conv_case(randn, dtype, path: str, variant: str, cin: int, cout: int,
              h: int, w: int, *, bias: bool, res: bool = False,
              act: str | None = None, roll: int = 0, reps: int = 5,
              b: int = 1, ln: bool = False) -> dict:
    """One K3 case on a (b, h, w, cin) input: the kernel against
    ``conv3x3_plain`` with the epilogues the caller's conv uses (a bias, a
    residual, an activation, a folded roll, an input LayerNorm),
    ``F.conv2d`` beside it where one library call computes the same
    function (no epilogue but the bias)."""
    import torch

    from image_restoration_agent_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, conv3x3_weights)

    es = 4 if dtype == torch.float32 else 2
    x32 = randn(b, h, w, cin)
    x = x32.to(dtype)
    wk = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    bv = randn(cout, scale=0.1) if bias else None
    r32 = randn(b, h, w, cout) if res else None
    r = r32.to(dtype) if res else None
    kf = conv3x3_weights(wk, bv, dtype)
    kw = dict(act=act, roll=roll, ln_pre=(1 + randn(cin, scale=0.1),
                                          randn(cin, scale=0.1))
              if ln else None)
    library = None
    if not (res or act or roll or ln):
        xin = x.permute(0, 3, 1, 2)
        wl = wk.to(dtype).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bl = bv.to(dtype) if bias else None
        library = lambda: torch.nn.functional.conv2d(xin, wl, bl, padding=1)
    px = b * h * w
    return dict(
        name="conv3x3", variant=variant, path=path,
        kernel=lambda: conv3x3(x, kf, res=r, **kw),
        plain=lambda: conv3x3_plain(x, wk, bv, res=r, **kw),
        ref32=lambda: conv3x3_plain(x32, wk, bv, res=r32, **kw),
        library=library, flops=2 * px * 9 * cin * cout,
        nbytes=px * (cin + cout * (2 if res else 1)) * es
        + 9 * cin * cout * es, reps=reps)


def _k5_plan(dtype, c: int, heads: int, ptxas: list[str]) -> dict:
    """K5's launch plan at a shape (tile, threads, shared bytes, and in bf16
    the gram tiles and slices) and its kernel's ptxas lines."""
    import torch

    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        _plan, mdta_plan)

    if dtype == torch.float32:
        th, tw, smem = _plan(1, dtype, c, heads)
        plan, kern = dict(tile=[th, tw], threads=256, smem=smem), \
            "mdta_front_kernel"
    else:
        p = mdta_plan(c, heads)
        plan, kern = dict(tile=[p.th, p.tw], threads=p.threads,
                          smem=p.smem, gram_tiles=p.tiles,
                          gram_tile_mma=[p.mw, p.nw8], slices=p.slices), \
            f"mdta_mma_kernel<{p.mw},{p.nw8},{p.threads}>"
    return {"plan": plan, "ptxas": [ln for ln in ptxas
                                    if ln.split(":")[0] == kern]}


def restormer_block_cases(shapes, dtype, randn, gen, path: str,
                          forms_at: int | None = None) -> list[dict]:
    """K4 (``gdfn_block``) and K5 (``mdta_front``, held as the whole MDTA
    block) cases at Restormer block shapes ``(name, (b, h, w, c), heads)``:
    the served blocks' form (WithBias LN, no biases), and at index
    ``forms_at`` the other forms the kernels take."""
    import torch

    from image_restoration_agent_tpu_torch.ops import kernels
    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        gdfn_block, gdfn_block_plain, gdfn_weights, mdta_block,
        mdta_block_plain, mdta_front, mdta_weights)

    ptxas = ptxas_lines(kernels.build_log("restormer_fused"))
    dev = torch.device("cuda")

    def weights(c, heads, ln_kind, bias):
        hid = int(2.66 * c)
        ln = {"none": None, "biasfree": (1 + randn(c, scale=0.1),),
              "withbias": (1 + randn(c, scale=0.1), randn(c, scale=0.1))}
        b = (lambda n: randn(n, scale=0.1)) if bias else (lambda n: None)
        g = (ln[ln_kind], randn(c, 2 * hid, scale=c ** -0.5), b(2 * hid),
             randn(9, 2 * hid, scale=1 / 3), b(2 * hid),
             randn(hid, c, scale=hid ** -0.5), b(c))
        m = (ln[ln_kind], randn(c, 3 * c, scale=c ** -0.5), b(3 * c),
             randn(9, 3 * c, scale=1 / 3), b(3 * c),
             randn(c, c, scale=c ** -0.5), b(c),
             0.5 + torch.rand(heads, generator=gen).to(dev))
        return hid, g, m

    es = 4 if dtype == torch.float32 else 2
    fast = dtype == torch.bfloat16
    cases = []
    for i, (lvl, (b, h, w, c), heads) in enumerate(shapes):
        p = b * h * w
        ch = c // heads
        x32 = randn(b, h, w, c)
        x = x32.to(dtype)
        kinds = [("withbias", False)]
        if i == forms_at:
            kinds += [("none", False), ("biasfree", True),
                      ("withbias", True)]
        for ln_kind, bias in kinds:
            hid, g, m = weights(c, heads, ln_kind, bias)
            size = f"{h}x{w}" if b == 1 else f"{b}x{h}x{w}"
            var = f"{lvl} {size} C{c} ln={ln_kind}" + (
                " bias" if bias else "")
            gk = gdfn_weights(*g, dtype)
            cases.append(dict(
                name="gdfn_block", variant=var, path=path,
                kernel=lambda x=x, gk=gk: gdfn_block(x, gk, fast=fast),
                plain=lambda x=x, g=g: gdfn_block_plain(x, *g, fast=fast),
                ref32=lambda x32=x32, g=g: gdfn_block_plain(
                    x32, *g, fast=fast),
                library=None, reps=5,
                flops=p * (6 * c * hid + 36 * hid),
                nbytes=2 * p * c * es + 3 * c * hid * es))
            if ln_kind == "none":
                continue
            mk = mdta_weights(*m[:7], m[7], heads, dtype)
            g1 = mdta_front(x, mk)[1]
            g2 = mdta_front(x, mk)[1]
            cases.append(dict(
                name="mdta_front", variant=f"{var} heads={heads} (block)",
                path=path,
                kernel=lambda x=x, mk=mk: mdta_block(x, mk),
                plain=lambda x=x, m=m, hd=heads: mdta_block_plain(x, *m, hd),
                ref32=lambda x32=x32, m=m, hd=heads: mdta_block_plain(
                    x32, *m, hd),
                extra_ms={"front_ms": lambda x=x, mk=mk: mdta_front(x, mk)},
                extra={"repeatable": bool(torch.equal(g1, g2)),
                       **_k5_plan(dtype, c, heads, ptxas)},
                library=None, reps=5,
                flops=p * (8 * c * c + 54 * c + 2 * c * ch),
                nbytes=2 * p * c * es + 4 * c * c * es))
            del g1, g2
    return cases


def restormer_kernel_checks(quick: bool, seed: int = 3) -> list[dict]:
    """K4 and K5 (and K3 at the Restormer convs' shapes) against their plain
    versions at the 720p request's shapes (a 16x128 canvas with --quick).
    The K5 rows hold the whole MDTA block (K5 and the plain epilogue, the
    TPU kernel's function) to ``mdta_block_plain``; ``front_ms`` is K5
    alone, and ``repeatable`` says two launches gave the same bits;
    ``plan`` is K5's launch plan at the shape (tile, threads, shared bytes,
    and in bf16 the gram tiles and slices) and ``ptxas`` its kernel's
    registers and spills from the build log."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    shapes = [(n, (1, 16, 128, s[3]), hd) for n, s, hd in RESTORMER_SHAPES] \
        if quick else list(RESTORMER_SHAPES)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        # the main path's blocks, and at level 2 the other forms
        cases = restormer_block_cases(shapes, dtype, randn, gen, "restormer",
                                      forms_at=1)
        for cname, cin, cout, h, w in RESTORMER_CONVS:
            if quick:
                h, w = 16, 128
            cases.append(conv_case(randn, dtype, "restormer",
                                   f"restormer {cname} {h}x{w}", cin, cout,
                                   h, w, bias=False))
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


def hat_kernel_checks(quick: bool, seed: int = 11) -> list[dict]:
    """The slice-3 kernels against their plain versions: K2 at N 256 (no
    mask, bank, full mask), ``swin_attn_block`` (dc 0, -8), K6 ``roll2d``
    (+-8) and K3 at the CAB's shapes on one HAT tile batch (5x256x256, C
    180, window 16), ``wmsa_block`` with the full mask at N 64 on the
    1088x1928 denoise canvas and at N 256 on the HAT batch. ``--quick``
    takes a 32x64 batch of one and a 24x40 canvas."""
    import torch

    from image_restoration_agent_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, conv3x3_weights)
    from image_restoration_agent_tpu_torch.ops.roll2d import (roll2d,
                                                              roll2d_plain)
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        GATHER, prepare_swin_params, swin_attn_block, swin_attn_block_plain,
        token_linear_plain, window_attention, window_attention_plain,
        wmsa_block, wmsa_block_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask, window_partition)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    def weights(c, heads, ws):
        hid = 2 * c
        return dict(
            norm1_w=1 + randn(c, scale=0.1), norm1_b=randn(c, scale=0.1),
            qkv_w=randn(3 * c, c, scale=c ** -0.5),
            qkv_b=randn(3 * c, scale=0.1),
            proj_w=randn(c, c, scale=c ** -0.5), proj_b=randn(c, scale=0.1),
            rpb_table=randn((2 * ws - 1) ** 2, heads, scale=0.5),
            norm2_w=1 + randn(c, scale=0.1), norm2_b=randn(c, scale=0.1),
            fc1_w=randn(hid, c, scale=c ** -0.5),
            fc1_b=randn(hid, scale=0.1),
            fc2_w=randn(c, hid, scale=hid ** -0.5),
            fc2_b=randn(c, scale=0.1))

    def to_mask(m):
        return torch.from_numpy(m).to(dev)

    hb, hh, hw_, c = (1, 32, 64, 180) if quick else HAT_BATCH
    db, dh, dw, _ = (1, 24, 40, 180) if quick else DENOISE_CANVAS
    heads = 6
    wts16, wts8 = weights(c, heads, 16), weights(c, heads, 8)
    x16_32 = randn(hb, hh, hw_, c)
    xd_32 = randn(db, dh, dw, c)
    bank16 = to_mask(shift_attention_mask(32, 32, 16, 8).reshape(
        2, 2, 256, 256))
    mask16 = to_mask(shift_attention_mask(hh, hw_, 16, 8))
    mask8 = to_mask(shift_attention_mask(dh, dw, 8, 4))
    cab = [(c, c // 3), (c // 3, c)]
    cab_w = {k: randn(3, 3, *k, scale=(9 * k[0]) ** -0.5) for k in cab}
    cab_b = {k: randn(k[1], scale=0.1) for k in cab}
    cab_in = {c: x16_32, c // 3: randn(hb, hh, hw_, c // 3)}
    rows = []
    for dtype, fast in ((torch.float32, False), (torch.bfloat16, True)):
        es = 4 if dtype == torch.float32 else 2
        p = prepare_swin_params(**wts16, num_heads=heads, ws=16, dtype=dtype)
        p32 = prepare_swin_params(**wts16, num_heads=heads, ws=16,
                                  dtype=torch.float32)
        x = x16_32.to(dtype)
        t, n = hb * hh * hw_, 256
        cases = []
        # K2 on the qkv of the unshifted block's gather
        geom = (hb, hh, hw_, 16, 0)
        qkv = token_linear_plain(x.reshape(t, c), p.wqkv, p.bqkv,
                                 ln=(p.ln1_w, p.ln1_b), geom=geom,
                                 a_map=GATHER)
        qkv32 = token_linear_plain(x16_32.reshape(t, c), p32.wqkv, p32.bqkv,
                                   ln=(p32.ln1_w, p32.ln1_b), geom=geom,
                                   a_map=GATHER)
        qh, kh, vh = (qkv.reshape(-1, n, 3, heads, c // heads)
                      .permute(2, 0, 3, 1, 4).contiguous())
        nwy, nwx = hh // 16, hw_ // 16
        per_win = {
            "none": None,
            "bank": bank16[
                (torch.arange(nwy, device=dev) == nwy - 1).long()[:, None],
                (torch.arange(nwx, device=dev) == nwx - 1).long()[None]]
            .reshape(-1, n, n),
            "full mask": mask16}
        for form, pw in per_win.items():
            kw = dict(num_heads=heads, nwy=nwy, nwx=nwx, fast=fast,
                      mask=mask16 if form == "full mask" else None)
            bk = bank16 if form == "bank" else None
            am = p.rpb[None] if pw is None else (
                p.rpb[None] + pw[:, None]).repeat(hb, 1, 1, 1)
            am = am.to(dtype)
            mbytes = 0 if pw is None else (
                bk.numel() if bk is not None else pw.numel()) * 4
            cases.append(dict(
                name="window_attention", variant=f"N256 {form}", path="hat",
                kernel=lambda kw=kw, bk=bk: window_attention(
                    qkv, p.rpb, bk, **kw, table=p.rpb_table),
                plain=lambda kw=kw, bk=bk: window_attention_plain(
                    qkv, p.rpb, bk, **kw),
                ref32=lambda kw=kw, bk=bk: window_attention_plain(
                    qkv32, p32.rpb, bk, **kw),
                library=lambda am=am: torch.nn.functional
                .scaled_dot_product_attention(qh, kh, vh, attn_mask=am,
                                              scale=1.0),
                flops=4 * t * n * c,
                nbytes=4 * t * c * es + p.rpb.numel() * 4 + mbytes, reps=5))
        blk_flops = 2 * t * c * 3 * c + 2 * t * c * c + 4 * t * n * c
        blk_bytes = 2 * t * c * es + 4 * c * c * es + p.rpb.numel() * 4
        for dc, bk in ((0, None), (-8, bank16)):
            kw = dict(num_heads=heads, ws=16, dc=dc, mask_bank=bk,
                      fast=fast)
            cases.append(dict(
                name="swin_attn_block", variant=f"N256 dc={dc}"
                + (",bank" if bk is not None else ""), path="hat",
                kernel=lambda kw=kw: swin_attn_block(x, p, **kw),
                plain=lambda kw=kw: swin_attn_block_plain(x, p, **kw),
                ref32=lambda kw=kw: swin_attn_block_plain(x16_32, p32, **kw),
                library=None, flops=blk_flops,
                nbytes=blk_bytes + (0 if bk is None else bk.numel() * 4),
                reps=3))
        for shift in (8, -8):
            cases.append(dict(
                name="roll2d", variant=f"shift={shift:+d}", path="hat",
                kernel=lambda sh=shift: roll2d(x, sh, 16),
                plain=lambda sh=shift: roll2d_plain(x, sh, 16),
                ref32=lambda sh=shift: roll2d_plain(x16_32, sh, 16),
                library=lambda sh=shift: torch.roll(x, (sh, sh), (1, 2)),
                flops=0, nbytes=2 * t * c * es, reps=10))
        # wmsa_block: N 256 on the HAT batch, N 64 on the denoise canvas
        xw16 = window_partition(x, 16).reshape(-1, n, c)
        xw16_32 = window_partition(x16_32, 16).reshape(-1, n, c)
        p8 = prepare_swin_params(**wts8, num_heads=heads, ws=8, dtype=dtype)
        p8_32 = prepare_swin_params(**wts8, num_heads=heads, ws=8,
                                    dtype=torch.float32)
        xw8 = window_partition(xd_32.to(dtype), 8).reshape(-1, 64, c)
        xw8_32 = window_partition(xd_32, 8).reshape(-1, 64, c)
        for var, pp, pp32, xw, xw32, mk in (
                (f"N64 {dh}x{dw} full mask", p8, p8_32, xw8, xw8_32, mask8),
                ("N256 full mask", p, p32, xw16, xw16_32, mask16)):
            tt, nn_ = xw.shape[0] * xw.shape[1], xw.shape[1]
            cases.append(dict(
                name="wmsa_block", variant=var, path="denoise",
                kernel=lambda pp=pp, xw=xw, mk=mk: wmsa_block(
                    xw, pp, num_heads=heads, mask=mk),
                plain=lambda pp=pp, xw=xw, mk=mk: wmsa_block_plain(
                    xw, pp, num_heads=heads, mask=mk),
                ref32=lambda pp32=pp32, xw32=xw32, mk=mk: wmsa_block_plain(
                    xw32, pp32, num_heads=heads, mask=mk),
                library=None,
                flops=2 * tt * c * 3 * c + 2 * tt * c * c + 4 * tt * nn_ * c,
                nbytes=2 * tt * c * es + 4 * c * c * es + pp.rpb.numel() * 4
                + mk.numel() * 4, reps=3))
        for cin, cout in cab:
            inp32 = cab_in[cin]
            inp = inp32.to(dtype)
            wk, bk_ = cab_w[(cin, cout)], cab_b[(cin, cout)]
            kf = conv3x3_weights(wk, bk_, dtype)
            xin = inp.permute(0, 3, 1, 2)
            wl = wk.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            px = t
            cases.append(dict(
                name="conv3x3", variant=f"hat CAB {cin}->{cout} {hh}x{hw_}",
                path="hat",
                kernel=lambda inp=inp, kf=kf: conv3x3(inp, kf),
                plain=lambda inp=inp, wk=wk, bk_=bk_: conv3x3_plain(inp, wk,
                                                                    bk_),
                ref32=lambda inp32=inp32, wk=wk, bk_=bk_: conv3x3_plain(
                    inp32, wk, bk_),
                library=lambda xin=xin, wl=wl, bk_=bk_: torch.nn.functional
                .conv2d(xin, wl, bk_.to(dtype), padding=1),
                flops=2 * px * 9 * cin * cout,
                nbytes=px * (cin + cout) * es + 9 * cin * cout * es,
                reps=5))
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


# ---------------------------------------------------------------------------
# phases 4-6


def golden_check() -> dict:
    import torch

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.offline import (GOLDEN_ROOT,
                                                           load_golden,
                                                           psnr)

    g = load_golden(GOLDEN_ROOT / "swinir_sr_x4_synth")
    model = build_model("swinir_sr_x4", device="cuda")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["state"].items()}, strict=True)
    t0 = time.perf_counter()
    out = tiled_apply(model, torch.from_numpy(g["input"]).cuda(), tile=None,
                      scale=4, pad_multiple=8, pad_mode="extra",
                      pad_kind="symmetric")
    out = out.cpu().numpy()
    secs = time.perf_counter() - t0
    db = psnr(np.clip(out, 0, 1), g["expected"])
    want = g["spec"]["psnr_db"] - 0.1
    return {"phase": "golden", "model": "swinir_sr_x4", "dtype": "float32",
            "input": list(g["input"].shape), "psnr_db": db, "want_db": want,
            "seconds": secs, "pass": bool(db >= want)}


def main_path(state, card: str, requests: int = 3) -> dict:
    img = np.random.default_rng(0).random((1080, 1920, 3), dtype=np.float32)
    _, warm, warm_s, secs, results, counts, profile, _ = serve(
        "swinir_sr_x4", state, img, requests)
    # per band: 36 blocks of 4 K1 + 1 K2; 9 body convs, and 4 K3 in the
    # head's border ring (upsample_tail's two convs on the top and bottom
    # strips, 24x3840; the 24-wide side strips take the library conv, as
    # the TPU path took XLA there)
    per_req = {"swin_block": 72, "mlp_block": 72, "token_linear": 288,
               "window_attention": 72, "conv3x3": 18 + 8}
    ok = all(r.image.shape == (4320, 7680, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and all(counts[k] == v * requests for k, v in per_req.items())
    best = min(secs)
    return {"phase": "main_path", "model": "swinir_sr_x4", "dtype":
            "bfloat16", "input": [1080, 1920, 3], "bands": "2 x 552x1920",
            "output": list(results[-1].image.shape),
            "warmup_seconds": warm_s, "seconds": secs,
            "mp_per_s": 1920 * 1080 / 1e6 / best,
            "launches": counts, "expected_per_request": per_req,
            "profile": profile, "card": card, "pass": bool(ok)}


def profile_request(eng, img, model: str, top: int = 12,
                    results: list | None = None,
                    cpu_ops: bool = True) -> dict:
    """One more request under torch.profiler: device time by kernel, the
    library ops that launched the most of it, and the device's busy share
    of the request's wall time. Only the device's own rows (kernels,
    copies) are summed: an op's self device time repeats its kernels'.
    ``results``, where given, gets the request's result. ``cpu_ops=False``
    records the device's activity alone (no op rows): a request of 180 000
    launches then takes about half the profiler's processing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu_ops
                                      else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = eng.restore_array(img, model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if results is not None:
        results.append(res)
    return profile_summary(prof, wall, top)


def profile_summary(prof, wall: float, top: int) -> dict:
    """A finished torch.profiler run over ``wall`` seconds: the device's
    busy ms and share and its ``top`` kernels, summed by name from the
    trace's raw device events (kernels, copies); the library ops that
    launched the most only where CPU activity was recorded, since their
    rows need the profiler's own processing (tens of seconds over a
    DiffBIR request's events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def self_dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    dev: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            n, us = dev.get(e.name(), (0, 0.0))
            dev[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    ranked = sorted(dev.items(), key=lambda kv: kv[1][1], reverse=True)
    busy = sum(us for _, us in dev.values()) / 1e3
    ops = []
    if top and ProfilerActivity.CPU in prof.activities:
        evs = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU),
                     key=self_dev_us, reverse=True)
        ops = [{"name": e.key[:80], "calls": e.count,
                "device_ms": self_dev_us(e) / 1e3}
               for e in evs[:top] if self_dev_us(e) > 0]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "device_kernels": len(dev),
            "top": [{"name": k[:80], "calls": n, "device_ms": us / 1e3}
                    for k, (n, us) in ranked[:top] if us > 0],
            "top_ops": ops}


def fast_vs_exact(state) -> dict:
    """SwinIR-M x4 in bf16 through the band (fast) against f32 whole-image
    (exact) on the card on a 270x480 probe; the control, the plain versions
    (the CPU path) in bf16 against f32, on its top-left 136x240 (a quarter
    of the CPU work), where the card's exact run is also held against the
    CPU's f32."""
    import torch

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        pad_width_for_strips)

    h, w = 270, 480
    img = torch.from_numpy(np.random.default_rng(7).random(
        (h, w, 3), dtype=np.float32))
    whole = dict(tile=None, scale=4, pad_multiple=8, pad_mode="extra",
                 pad_kind="symmetric")
    sd = {k: torch.from_numpy(v) for k, v in state.items()}

    def band(h, w):
        ph, pw = -(-h // 8) * 8, pad_width_for_strips(w)
        bh = -(-(ph + 16) // 2 // 8) * 8
        return dict(tile=(bh, pw), overlap=16, scale=4, batch=1,
                    pad_to=(ph, pw))

    def run(device, dtype, im, kw):
        m = build_model("swinir_sr_x4", device=device, dtype=dtype)
        m.load_state_dict(sd, strict=True)
        out = tiled_apply(lambda b: m(b.to(dtype)).float(),
                          im.to(device), **kw)
        return out.cpu().numpy()

    fast = run("cuda", torch.bfloat16, img, band(h, w))
    exact = run("cuda", torch.float32, img, whole)
    sub = img[:136, :240]
    exact_sub = run("cuda", torch.float32, sub, whole)
    torch.set_num_threads(8)
    ctrl16 = run("cpu", torch.bfloat16, sub, band(136, 240))
    ctrl32 = run("cpu", torch.float32, sub, whole)
    db = range_psnr(fast, exact)
    ctrl = range_psnr(ctrl16, ctrl32)
    return {"phase": "fast_vs_exact", "probe": [h, w],
            "control_probe": [136, 240], "psnr_db": db,
            "control_db": ctrl, "floor_db": ctrl - 2.0,
            "exact_plain_vs_card_db": range_psnr(ctrl32, exact_sub),
            "pass": bool(db >= ctrl - 2.0)}


def restormer_golden() -> dict:
    """restormer_synth (320x320, real geometry) in float32 on the card:
    levels 1-2 take K5 + K4, levels 3-4 the unfused route."""
    import torch

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.offline import (GOLDEN_ROOT,
                                                           load_golden,
                                                           psnr)
    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        gdfn_block)

    g = load_golden(GOLDEN_ROOT / "restormer_synth")
    model = build_model("restormer", device="cuda")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["state"].items()}, strict=True)
    n0 = gdfn_block.launches
    t0 = time.perf_counter()
    with torch.no_grad():  # a served forward (Restormer's records a graph)
        out = tiled_apply(model, torch.from_numpy(g["input"]).cuda(),
                          tile=None, pad_multiple=8,
                          pad_kind="reflect").cpu().numpy()
    secs = time.perf_counter() - t0
    db = psnr(np.clip(out, 0, 1), g["expected"])
    want = g["spec"]["psnr_db"] - 0.1
    return {"phase": "restormer_golden", "model": "restormer",
            "dtype": "float32", "input": list(g["input"].shape),
            "fused_blocks": gdfn_block.launches - n0, "psnr_db": db,
            "want_db": want, "seconds": secs, "pass": bool(db >= want)}


def restormer_path(state, card: str, requests: int = 3) -> dict:
    """Engine(device="cuda") serving 1280x720 with Restormer in bf16: the
    whole-image route on a 768x1280 canvas."""
    img = np.random.default_rng(1).random((720, 1280, 3), dtype=np.float32)
    _, warm, warm_s, secs, results, counts, profile, _ = serve(
        "restormer", state, img, requests, shape_bucket=128)
    per_req = {"conv3x3": 8, "gdfn_block": 44, "mdta_front": 44}
    others = {k: v for k, v in counts.items() if k not in per_req}
    ok = all(r.image.shape == (720, 1280, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and all(counts[k] == v * requests for k, v in per_req.items())
    ok = ok and not any(others.values())
    best = min(secs)
    return {"phase": "restormer_path", "model": "restormer", "dtype":
            "bfloat16", "input": [720, 1280, 3], "canvas": [768, 1280],
            "output": list(results[-1].image.shape),
            "warmup_seconds": warm_s, "seconds": secs,
            "mp_per_s": 1280 * 720 / 1e6 / best,
            "launches": {k: counts[k] for k in per_req},
            "other_launches": others,
            "expected_per_request": per_req, "profile": profile,
            "card": card, "pass": bool(ok)}


def restormer_fast_vs_exact(state) -> dict:
    """bf16 through the kernels against f32 exact on the card, on a probe
    whose every level takes the fused route (level 4 is 16x128)."""
    import torch

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model

    h, w = 128, 1024
    img = torch.from_numpy(np.random.default_rng(9).random(
        (h, w, 3), dtype=np.float32))
    sd = {k: torch.from_numpy(v) for k, v in state.items()}

    @torch.no_grad()  # served forwards (Restormer's records a graph)
    def run(device, dtype):
        m = build_model("restormer", device=device, dtype=dtype)
        m.load_state_dict(sd, strict=True)
        out = tiled_apply(lambda b: m(b.to(dtype)).float(), img.to(device),
                          tile=None, pad_multiple=64, pad_kind="reflect")
        return out.cpu().numpy()

    fast = run("cuda", torch.bfloat16)
    exact = run("cuda", torch.float32)
    # the control: the plain versions (the CPU path) in bf16 vs f32
    torch.set_num_threads(8)
    ctrl16 = run("cpu", torch.bfloat16)
    ctrl32 = run("cpu", torch.float32)
    db = range_psnr(fast, exact)
    ctrl = range_psnr(ctrl16, ctrl32)
    return {"phase": "restormer_fast_vs_exact", "probe": [h, w],
            "psnr_db": db, "control_db": ctrl, "floor_db": ctrl - 2.0,
            "exact_plain_vs_card_db": range_psnr(ctrl32, exact),
            "pass": bool(db >= ctrl - 2.0)}


# ---------------------------------------------------------------------------
# slice 3: HAT x4 tile serving and SwinIR's partition route


def model_state(name: str, seed: int = 0) -> dict:
    """Random weights of a registered model from ``build_model``'s seed, as
    the reference-named numpy state dict the engine loads; DehazeFormer
    takes its reference's own initialisation on top."""
    from image_restoration_agent_tpu_torch.models import build_model
    m = build_model(name, device="cpu", seed=seed)
    if name.startswith("dehazeformer"):
        dehazeformer_reference_init(m, seed)
    return {k: v.numpy() for k, v in m.state_dict().items()}


def dehazeformer_reference_init(m, seed: int) -> None:
    """The initialisation of the reference's ``dehazeformer.py``, with
    which the activations of the random network stay near 1: RLN weight 1,
    bias 0, ``meta1`` weight N(0, 0.02) and bias 1, ``meta2`` weight N(0,
    0.02) and bias 0; the attention's and MLP's convs Glorot-normal times
    ``(8 * sum(depths))**-0.25`` (QK without the gain), biases 0. The other
    convs keep ``build_model``'s fan-in weights."""
    import torch

    from image_restoration_agent_tpu_torch.models import dehazeformer as df

    gen = torch.Generator().manual_seed(seed + 1)
    depth = sum(len(getattr(m, f"layer{i}").blocks) for i in range(1, 6))
    gain = (8 * depth) ** -0.25

    def normal(p, std):
        p.copy_((torch.randn(p.shape, generator=gen) * std).clamp(-2, 2))

    def glorot(conv, g):
        w = conv.weight
        rf = w[0, 0].numel()
        normal(w, g * (2.0 / (w.shape[1] * rf + w.shape[0] * rf)) ** 0.5)
        conv.bias.zero_()

    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, df.RLN):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                normal(mod.meta1.weight, 0.02)
                mod.meta1.bias.fill_(1.0)
                normal(mod.meta2.weight, 0.02)
                mod.meta2.bias.zero_()
            elif isinstance(mod, df.Attention):
                for conv in (mod.V, mod.proj, mod.conv):
                    glorot(conv, gain)
                if mod.use_attn:
                    glorot(mod.QK, 1.0)
            elif isinstance(mod, df.Mlp):
                glorot(mod.mlp[0], gain)
                glorot(mod.mlp[2], gain)


def _other_wrappers() -> tuple:
    """The kernel wrappers outside ``ops/swin_block.py``."""
    from image_restoration_agent_tpu_torch.lab.kernel_lab import lab_strip
    from image_restoration_agent_tpu_torch.ops.conv3x3 import (conv3x3,
                                                               conv3x3_pair)
    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        gdfn_block, mdta_front)
    from image_restoration_agent_tpu_torch.ops.roll2d import roll2d
    return (roll2d, conv3x3, gdfn_block, mdta_front, conv3x3_pair, lab_strip)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        launch_counts as swin_counts)
    return {**swin_counts(),
            **{fn.__name__: fn.launches for fn in _other_wrappers()}}


def reset_launch_counts() -> None:
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        reset_launch_counts as reset_swin)
    reset_swin()
    for fn in _other_wrappers():
        fn.launches = 0


def serve(name: str, state: dict, img, requests: int,
          shape_bucket: int = 8, top: int = 12) -> tuple:
    """``Engine(device="cuda")`` in bf16 serving ``img`` with ``name``: one
    warm-up request, then ``requests`` timed ones with every launch count
    set to 0 just before them and read just after, then one profiled
    request."""
    import torch

    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(device="cuda", param_dtype=torch.bfloat16,
                 shape_bucket=shape_bucket)
    eng.set_weights(name, state)
    t0 = time.perf_counter()
    warm = eng.restore_array(img, name)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launch_counts()
    secs, results = [], []
    for _ in range(requests):
        t0 = time.perf_counter()
        results.append(eng.restore_array(img, name))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = launch_counts()
    profile = profile_request(eng, img, name, top)
    key = next(k for k in eng._pipelines if k[0] == name)
    return eng, warm, warm_s, secs, results, counts, profile, key


def hat_path(state, card: str, requests: int = 3) -> dict:
    """HAT x4 serving 1920x1080 in bf16, tile mode (tile 256, overlap 32,
    'extra' pad to 16): the engine's shape bucket takes 1080 to 1088 and
    the pad to 1104x1936, 45 tiles in 9 batches of 5."""
    from image_restoration_agent_tpu_torch.core.pad import _pad_amount
    from image_restoration_agent_tpu_torch.core.tiling import plan_tiles

    img = np.random.default_rng(2).random((1080, 1920, 3), dtype=np.float32)
    _, warm, warm_s, secs, results, counts, profile, key = serve(
        "hat_sr_x4", state, img, requests)
    hb, wb, batch = key[1], key[2], key[5]
    canvas = [hb + _pad_amount(hb, 16, "extra"),
              wb + _pad_amount(wb, 16, "extra")]
    n_tiles = plan_tiles(*canvas, 256, 32).num_tiles
    fwd = -(-n_tiles // batch)
    # per forward: 36 HABs (each one swin_attn_block = 2 K1 + 1 K2, one
    # mlp_block = 2 K1, two CAB K3), 18 shifted (roll2d); K3: conv_first,
    # 72 CAB, 6 RHAG convs, conv_after_body, conv_before_upsample and 4 in
    # the head's top and bottom ring strips
    per_fwd = {"swin_attn_block": 36, "roll2d": 18, "mlp_block": 36,
               "window_attention": 36, "token_linear": 144,
               "conv3x3": 85, "wmsa_block": 0, "swin_block": 0}
    per_req = {k: v * fwd for k, v in per_fwd.items()}
    ok = all(r.image.shape == (4320, 7680, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and all(counts[k] == v * requests for k, v in per_req.items())
    best = min(secs)
    return {"phase": "hat_path", "model": "hat_sr_x4", "dtype": "bfloat16",
            "input": [1080, 1920, 3], "canvas": canvas, "tiles": n_tiles,
            "batch": batch, "forwards": fwd,
            "output": list(results[-1].image.shape),
            "warmup_seconds": warm_s, "seconds": secs,
            "mp_per_s": 1920 * 1080 / 1e6 / best, "launches": counts,
            "expected_per_request": per_req, "profile": profile,
            "card": card, "pass": bool(ok)}


def hat_exact(state) -> dict:
    """f32 hat_sr_x4 on the card against the port's CPU plain f32 path on a
    112x112 input (one 128x128 canvas)."""
    import torch

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import (build_model,
                                                          get_spec)

    spec = get_spec("hat_sr_x4")
    img = torch.from_numpy(np.random.default_rng(5).random(
        (112, 112, 3), dtype=np.float32))
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    kw = dict(tile=spec.tile, overlap=spec.tile_overlap, scale=4,
              pad_multiple=spec.pad_multiple, pad_mode=spec.pad_mode,
              pad_kind=spec.pad_kind)

    def run(device):
        m = build_model("hat_sr_x4", device=device)
        m.load_state_dict(sd, strict=True)
        return tiled_apply(m, img.to(device), **kw).cpu().numpy()

    t0 = time.perf_counter()
    card = run("cuda")
    secs = time.perf_counter() - t0
    torch.set_num_threads(8)
    cpu = run("cpu")
    db = range_psnr(card, cpu)
    return {"phase": "hat_exact", "model": "hat_sr_x4", "dtype": "float32",
            "input": [112, 112, 3], "canvas": [128, 128],
            "output": list(card.shape), "psnr_db": db, "floor_db": 60.0,
            "max_abs_err": float(np.abs(card - cpu).max()),
            "seconds": secs, "pass": bool(db >= 60.0
                                          and np.isfinite(card).all())}


def hat_fast_vs_exact(state) -> dict:
    """bf16 fast against f32 exact on the card on a 480x270 probe (a
    272x496 canvas, 6 tiles, one batch). The control (plain bf16 against
    plain f32, the CPU path) is taken on the probe canvas's top-left
    64x64 (4 x 4 windows, shifted ones included) as one forward, where the
    card's fast-vs-exact PSNR is also reported: the whole probe takes
    minutes on the CPU, a 256 tile two, a 128 crop 10 s."""
    import torch

    from image_restoration_agent_tpu_torch.core.pad import pad_to_multiple
    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model

    h, w = 270, 480
    img = torch.from_numpy(np.random.default_rng(8).random(
        (h, w, 3), dtype=np.float32))
    kw = dict(tile=256, overlap=32, scale=4, batch=6, pad_multiple=16,
              pad_mode="extra", pad_kind="symmetric")
    crop = pad_to_multiple(img, 16, "extra", "symmetric")[0][:64, :64]
    sd = {k: torch.from_numpy(v) for k, v in state.items()}

    def model(device, dtype):
        m = build_model("hat_sr_x4", device=device, dtype=dtype)
        m.load_state_dict(sd, strict=True)
        return lambda b: m(b.to(dtype)).float()

    def probe(device, dtype):
        return tiled_apply(model(device, dtype), img.to(device),
                           **kw).cpu().numpy()

    def on_crop(device, dtype):
        return model(device, dtype)(crop[None].to(device))[0].cpu().numpy()

    fast, exact = probe("cuda", torch.bfloat16), probe("cuda", torch.float32)
    fast_c = on_crop("cuda", torch.bfloat16)
    exact_c = on_crop("cuda", torch.float32)
    torch.set_num_threads(8)
    t0 = time.perf_counter()
    ctrl16 = on_crop("cpu", torch.bfloat16)
    ctrl32 = on_crop("cpu", torch.float32)
    ctrl_s = time.perf_counter() - t0
    db = range_psnr(fast, exact)
    ctrl = range_psnr(ctrl16, ctrl32)
    return {"phase": "hat_fast_vs_exact", "probe": [h, w], "tiles": 6,
            "psnr_db": db, "crop_psnr_db": range_psnr(fast_c, exact_c),
            "control_db": ctrl, "floor_db": ctrl - 2.0,
            "exact_plain_vs_card_crop_db": range_psnr(ctrl32, exact_c),
            "control_seconds": ctrl_s, "pass": bool(db >= ctrl - 2.0)}


def swinir_denoise_path(state, card: str, requests: int = 3) -> dict:
    """swinir_denoise_15 serving 1920x1080 whole-image in bf16: the
    1088x1928 canvas has no strip chunk width, so all 36 blocks take the
    partition route (wmsa_block + mlp_block). Also f32 on the card against
    the CPU plain f32 path at 64x392 (a 72x400 canvas, the same route)."""
    import torch

    from image_restoration_agent_tpu_torch.core.pad import _pad_amount
    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.models.swinir import strip_route

    img = np.random.default_rng(3).random((1080, 1920, 3), dtype=np.float32)
    eng, warm, warm_s, secs, results, counts, profile, key = serve(
        "swinir_denoise_15", state, img, requests)
    canvas = [key[1] + _pad_amount(key[1], 8, "extra"),
              key[2] + _pad_amount(key[2], 8, "extra")]
    del eng
    per_req = {"wmsa_block": 36, "mlp_block": 36, "window_attention": 36,
               "token_linear": 144, "conv3x3": 9, "swin_block": 0,
               "swin_attn_block": 0, "roll2d": 0}
    ok = all(r.image.shape == (1080, 1920, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and all(counts[k] == v * requests for k, v in per_req.items())
    ok = ok and not strip_route(1, *canvas, 8)

    small = torch.from_numpy(np.random.default_rng(4).random(
        (64, 392, 3), dtype=np.float32))
    sd = {k: torch.from_numpy(v) for k, v in state.items()}
    kw = dict(tile=None, pad_multiple=8, pad_mode="extra",
              pad_kind="symmetric")

    def run(device):
        m = build_model("swinir_denoise_15", device=device)
        m.load_state_dict(sd, strict=True)
        return tiled_apply(m, small.to(device), **kw).cpu().numpy()

    card32 = run("cuda")
    torch.set_num_threads(8)
    db = range_psnr(card32, run("cpu"))
    ok = ok and db >= 60.0 and not strip_route(1, 72, 400, 8)
    best = min(secs)
    return {"phase": "swinir_denoise_path", "model": "swinir_denoise_15",
            "dtype": "bfloat16", "input": [1080, 1920, 3], "canvas": canvas,
            "route": "partition", "output": list(results[-1].image.shape),
            "warmup_seconds": warm_s, "seconds": secs,
            "mp_per_s": 1920 * 1080 / 1e6 / best, "launches": counts,
            "expected_per_request": per_req, "profile": profile,
            "f32_card_vs_cpu_72x400_db": db, "f32_floor_db": 60.0,
            "card": card, "pass": bool(ok)}


# ---------------------------------------------------------------------------
# slice 4: DehazeFormer-b 1080p whole-image serving


def dehazeformer_kernel_checks(quick: bool, seed: int = 13) -> list[dict]:
    """``wmsa`` against ``wmsa_plain`` at the request's six window batches
    (64 and 65 windows with --quick) and a small full-mask case. SDPA
    beside it takes the same q, k, v made head-major once before timing
    (the layout copies are not in its time), ``attn_mask`` the bias (plus
    the mask) in the working type, ``scale`` head_dim**-0.5."""
    import torch

    from image_restoration_agent_tpu_torch.ops.swin_block import (
        wmsa, wmsa_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    n = 64
    cases32 = []
    for lvl, c, heads, nw0, nw1 in DEHAZE_LEVELS:
        rpb = randn(heads, n, n, scale=0.5)
        for shifted, nwb in ((False, nw0), (True, nw1)):
            nwb = 64 + shifted if quick else nwb
            cases32.append((f"L{lvl} C{c} heads {heads} nWB {nwb}"
                            + (" shifted" if shifted else ""),
                            randn(nwb, n, 3 * c), rpb, heads, None))
    # the TPU contract's full mask: the windows of two 24x40 canvases
    mask = torch.from_numpy(shift_attention_mask(24, 40, 8, 4)).to(dev)
    cases32.append(("C24 heads 2 nWB 30 full mask", randn(30, n, 72),
                    randn(2, n, n, scale=0.5), 2, mask))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = 4 if dtype == torch.float32 else 2
        cases = []
        for var, q32, rpb, heads, mk in cases32:
            nwb, _, c3 = q32.shape
            c, hd = c3 // 3, c3 // 3 // heads
            qkv = q32.to(dtype)
            qh, kh, vh = (qkv.reshape(nwb, n, 3, heads, hd)
                          .permute(2, 0, 3, 1, 4).contiguous())
            am = rpb[None] if mk is None else (
                rpb[None] + mk[:, None]).repeat(nwb // mk.shape[0], 1, 1, 1)
            am = am.to(dtype)
            cases.append(dict(
                name="wmsa", variant=var, path="dehaze",
                kernel=lambda qkv=qkv, rpb=rpb, mk=mk, h=heads: wmsa(
                    qkv, rpb, mk, num_heads=h),
                plain=lambda qkv=qkv, rpb=rpb, mk=mk, h=heads: wmsa_plain(
                    qkv, rpb, mk, num_heads=h),
                ref32=lambda q32=q32, rpb=rpb, mk=mk, h=heads: wmsa_plain(
                    q32, rpb, mk, num_heads=h),
                library=lambda qh=qh, kh=kh, vh=vh, am=am, hd=hd: torch.nn
                .functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=am, scale=hd ** -0.5),
                extra={"library_call": "scaled_dot_product_attention on "
                       "head-major q, k, v made before timing (layout "
                       "copies not timed)"},
                flops=4 * nwb * n * n * c,
                nbytes=nwb * n * 4 * c * es + rpb.numel() * 4
                + (0 if mk is None else mk.numel() * 4), reps=10))
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


def dehazeformer_reflect_pad(quick: bool) -> dict:
    """The port's reflect pad (one gather, ``models/dehazeformer.py``)
    against ``F.pad(mode="reflect")`` on the request's two padded shapes:
    the 5x5 depthwise conv's pad of 2 on the level-0 activation (64 of the
    request's 88 pads) and a shifted level-0 block's pad of 4 on its qkv;
    bf16, CUDA events. ``F.pad`` takes the NCHW view and returns NCHW, the
    layout ``F.conv2d`` is then given; the gather keeps channels-last.
    Both must give the same values."""
    import torch
    import torch.nn.functional as F

    from image_restoration_agent_tpu_torch.models.dehazeformer import (
        reflect_pad)

    h, w = (64, 128) if quick else (1080, 1920)
    gen = torch.Generator(device="cpu").manual_seed(17)
    out = {"phase": "dehazeformer_reflect_pad", "dtype": "bfloat16",
           "cases": []}
    ok = True
    for c, p in ((24, 2), (72, 4)):
        x = torch.randn(1, h, w, c, generator=gen).to("cuda", torch.bfloat16)
        same = torch.equal(
            reflect_pad(x, p, p, p, p),
            F.pad(x.permute(0, 3, 1, 2), (p,) * 4,
                  mode="reflect").permute(0, 2, 3, 1))
        ok = ok and same
        out["cases"].append({
            "shape": [1, h, w, c], "pad": p, "equal": same,
            "gather_ms": cuda_ms(lambda: reflect_pad(x, p, p, p, p), 10),
            "f_pad_ms": cuda_ms(lambda: F.pad(x.permute(0, 3, 1, 2),
                                              (p,) * 4, mode="reflect"), 10),
            "bound_ms": bound(0, 2 * (h + 2 * p) * (w + 2 * p) * c * 2,
                              "bfloat16")[0]})
    out["pass"] = bool(ok)
    return out


def dehazeformer_path(state, card: str, requests: int = 3) -> dict:
    """dehazeformer_b serving 1920x1080 in bf16, whole image (tile None):
    ``Engine(shape_bucket=8)`` keeps one 1080x1920 canvas (a multiple of
    the reflect pad's 4); each of the 24 attention blocks (4 + 8 + 12)
    launches K2 once through ``wmsa``; every other op is a library call."""
    img = np.random.default_rng(6).random((1080, 1920, 3), dtype=np.float32)
    _, warm, warm_s, secs, results, counts, profile, key = serve(
        "dehazeformer_b", state, img, requests, top=30)
    per_req = {"wmsa": 24, "window_attention": 24}
    others = {k: v for k, v in counts.items() if k not in per_req}
    ok = all(r.image.shape == (1080, 1920, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and all(counts[k] == v * requests for k, v in per_req.items())
    ok = ok and not any(others.values()) and key[1:3] == (1080, 1920)
    best = min(secs)
    return {"phase": "dehazeformer_path", "model": "dehazeformer_b",
            "dtype": "bfloat16", "input": [1080, 1920, 3],
            "canvas": list(key[1:3]), "output": list(results[-1].image.shape),
            "warmup_seconds": warm_s, "seconds": secs,
            "mp_per_s": 1920 * 1080 / 1e6 / best,
            "launches": {k: counts[k] for k in per_req},
            "launches_per_request": {k: counts[k] / requests
                                     for k in per_req},
            "other_launches": others, "expected_per_request": per_req,
            "profile": profile, "card": card, "pass": bool(ok)}


_DEHAZE_PROBE: dict = {}


def _dehaze_probe(state, device: str, dtype_name: str) -> np.ndarray:
    """dehazeformer_b on a whole 270x480 image (a 272x480 canvas) on
    ``device`` in ``dtype_name``; each setting runs once and is kept."""
    key = (device, dtype_name)
    if key not in _DEHAZE_PROBE:
        import torch

        from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
        from image_restoration_agent_tpu_torch.models import build_model

        dtype = getattr(torch, dtype_name)
        img = torch.from_numpy(np.random.default_rng(10).random(
            (270, 480, 3), dtype=np.float32))
        m = build_model("dehazeformer_b", device=device, dtype=dtype)
        m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                          strict=True)
        with torch.no_grad():
            out = tiled_apply(lambda b: m(b.to(dtype)).float(),
                              img.to(device), tile=None, pad_multiple=4,
                              pad_kind="reflect")
        _DEHAZE_PROBE[key] = out.cpu().numpy()
    return _DEHAZE_PROBE[key]


def dehazeformer_exact(state) -> dict:
    """f32 on the card against the port's CPU plain f32 path, whole
    270x480 image."""
    import torch

    card = _dehaze_probe(state, "cuda", "float32")
    torch.set_num_threads(8)
    cpu = _dehaze_probe(state, "cpu", "float32")
    db = range_psnr(card, cpu)
    return {"phase": "dehazeformer_exact", "model": "dehazeformer_b",
            "dtype": "float32", "input": [270, 480, 3],
            "output": list(card.shape), "psnr_db": db, "floor_db": 60.0,
            "max_abs_err": float(np.abs(card - cpu).max()),
            "output_max_abs": float(np.abs(cpu).max()),
            "pass": bool(db >= 60.0 and np.isfinite(card).all())}


def dehazeformer_bf16_vs_f32(state) -> dict:
    """bf16 against f32 on the card on the 270x480 image, beside the
    control: the plain versions (the CPU path) in bf16 against f32."""
    import torch

    fast = _dehaze_probe(state, "cuda", "bfloat16")
    exact = _dehaze_probe(state, "cuda", "float32")
    torch.set_num_threads(8)
    ctrl16 = _dehaze_probe(state, "cpu", "bfloat16")
    ctrl32 = _dehaze_probe(state, "cpu", "float32")
    db = range_psnr(fast, exact)
    ctrl = range_psnr(ctrl16, ctrl32)
    return {"phase": "dehazeformer_bf16_vs_f32", "probe": [270, 480],
            "psnr_db": db, "control_db": ctrl, "floor_db": ctrl - 2.0,
            "bf16_card_vs_cpu_db": range_psnr(fast, ctrl16),
            "output_max_abs": float(np.abs(exact).max()),
            "pass": bool(db >= ctrl - 2.0 and np.isfinite(fast).all())}


# ---------------------------------------------------------------------------
# slice 5: the lab path (K7 conv3x3_pair, K8 swin_pair_block, lab_strip)

# the x4 head's second stage at one band, and its ring strip
HEAD_SHAPES = ((1, 1104, 3840, 64), (1, 24, 3840, 64))
LAB_STRIP_SHAPE = (4, 256, 256, 180)


def lab_kernel_checks(quick: bool, seed: int = 19) -> list[dict]:
    """K7 ``conv3x3_pair`` (the head's two shapes with no activation, the
    ring strip with LeakyReLU), K8 ``swin_pair_block`` (the band, ``dc1``
    0 and +4) and ``lab_strip`` (kernel_lab's shape, ``stacked``) against
    their plain versions, each beside the sequence it replaces:
    ``two_k3_ms``, ``two_swin_block_ms``, ``swin_attn_block_ms``. No single
    PyTorch call computes these functions (no library column). ``--quick``
    takes 16-row heads, a 64x128 band and a 1x64x128 strip."""
    import torch

    from image_restoration_agent_tpu_torch.lab.kernel_lab import (
        lab_strip, lab_strip_plain)
    from image_restoration_agent_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_pair, conv3x3_pair_plain, conv3x3_pair_weights,
        conv3x3_weights)
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        kernel_params, prepare_swin_params, swin_attn_block, swin_block,
        swin_pair_block, swin_pair_block_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    heads_shapes = [(1, 16, 256, 64), (1, 24, 256, 64)] if quick \
        else list(HEAD_SHAPES)
    band = (1, 64, 128, 180) if quick else (1, 552, 1920, 180)
    strip = (1, 64, 128, 180) if quick else LAB_STRIP_SHAPE
    cin, cmid, cout = 64, 256, 12
    w1 = randn(3, 3, cin, cmid, scale=(9 * cin) ** -0.5)
    b1 = randn(cmid, scale=0.1)
    w2 = randn(3, 3, cmid, cout, scale=(9 * cmid) ** -0.5)
    b2 = randn(cout, scale=0.1)
    head_in = {s: randn(*s) for s in heads_shapes}
    ws, heads, c = 8, 6, 180
    n, hid = ws * ws, 2 * c

    def block_wts():
        return dict(
            norm1_w=1 + randn(c, scale=0.1), norm1_b=randn(c, scale=0.1),
            qkv_w=randn(3 * c, c, scale=c ** -0.5),
            qkv_b=randn(3 * c, scale=0.1),
            proj_w=randn(c, c, scale=c ** -0.5), proj_b=randn(c, scale=0.1),
            rpb_table=randn((2 * ws - 1) ** 2, heads, scale=0.5),
            norm2_w=1 + randn(c, scale=0.1), norm2_b=randn(c, scale=0.1),
            fc1_w=randn(hid, c, scale=c ** -0.5),
            fc1_b=randn(hid, scale=0.1),
            fc2_w=randn(c, hid, scale=hid ** -0.5),
            fc2_b=randn(c, scale=0.1))

    wa, wb = block_wts(), block_wts()
    bank = torch.from_numpy(shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n)).to(dev)
    xband32 = randn(*band)
    # lab_strip: the JAX lab's weight layout, q unscaled, fan-in scaled
    lab_w = (1 + randn(c, scale=0.1), randn(c, scale=0.1),
             randn(c, 3 * c, scale=c ** -0.5), randn(3 * c, scale=0.1),
             randn(c, c, scale=c ** -0.5), randn(c, scale=0.1),
             randn(heads, n, n, scale=0.5))
    xstrip32 = randn(*strip)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = 4 if dtype == torch.float32 else 2
        reps = 2 if dtype == torch.float32 else 5
        cases = []
        kp = conv3x3_pair_weights(w1, b1, w2, b2, dtype)
        k1 = conv3x3_weights(w1, b1, dtype)
        k2 = conv3x3_weights(w2, b2, dtype)
        head_cases = [(s, None) for s in heads_shapes] + [
            (heads_shapes[1], "lrelu")]
        for shape, act in head_cases:
            x32 = head_in[shape]
            x = x32.to(dtype)
            px = shape[0] * shape[1] * shape[2]
            cases.append(dict(
                name="conv3x3_pair", path="lab",
                variant=f"{shape[1]}x{shape[2]} {cin}->{cmid}->{cout}"
                + (" lrelu" if act else ""),
                kernel=lambda x=x, a=act: conv3x3_pair(x, kp, act_mid=a),
                plain=lambda x=x, a=act: conv3x3_pair_plain(
                    x, w1, b1, w2, b2, act_mid=a),
                ref32=lambda x32=x32, a=act: conv3x3_pair_plain(
                    x32, w1, b1, w2, b2, act_mid=a),
                extra_ms={"two_k3_ms": lambda x=x, a=act: conv3x3(
                    conv3x3(x, k1, act=a), k2)},
                library=None, reps=reps,
                flops=2 * px * 9 * (cin * cmid + cmid * cout),
                nbytes=px * (cin + cout) * es
                + 9 * (cin * cmid + cmid * cout) * es))
        pa = prepare_swin_params(**wa, num_heads=heads, ws=ws, dtype=dtype)
        pb = prepare_swin_params(**wb, num_heads=heads, ws=ws, dtype=dtype)
        pa32 = prepare_swin_params(**wa, num_heads=heads, ws=ws,
                                   dtype=torch.float32)
        pb32 = prepare_swin_params(**wb, num_heads=heads, ws=ws,
                                   dtype=torch.float32)
        x = xband32.to(dtype)
        t = band[0] * band[1] * band[2]
        blk_flops = (2 * t * c * 3 * c + 2 * t * c * c + 4 * t * c * hid
                     + 4 * t * n * c)
        wbytes = (4 * c * c + 2 * c * hid) * es + heads * n * n * 4
        for dc1 in (0, ws // 2):
            kw = dict(num_heads=heads, ws=ws, dc1=dc1)
            cases.append(dict(
                name="swin_pair_block", path="lab",
                variant=f"{band[1]}x{band[2]} dc1={dc1:+d}",
                kernel=lambda kw=kw: swin_pair_block(x, pa, pb, bank, **kw),
                plain=lambda kw=kw: swin_pair_block_plain(x, pa, pb, bank,
                                                          **kw),
                ref32=lambda kw=kw: swin_pair_block_plain(
                    xband32, pa32, pb32, bank, **kw),
                extra_ms={"two_swin_block_ms": lambda d=dc1: swin_block(
                    swin_block(x, pa, num_heads=heads, ws=ws, dc=d,
                               fast=True), pb, num_heads=heads, ws=ws,
                    dc=-ws // 2, mask_bank=bank, fast=True)},
                library=None, reps=reps, flops=2 * blk_flops,
                nbytes=2 * t * c * es + 2 * wbytes + bank.numel() * 4))
        # swin_attn_block beside lab_strip: the same weights in kernel form
        # (the scale folded into q), MLP weights unused
        ps = kernel_params(*lab_w, torch.ones(c, device=dev),
                           torch.zeros(c, device=dev),
                           torch.zeros(c, 1, device=dev),
                           torch.zeros(1, device=dev),
                           torch.zeros(1, c, device=dev),
                           torch.zeros(c, device=dev), num_heads=heads,
                           dtype=dtype)
        xs = xstrip32.to(dtype)
        ts = strip[0] * strip[1] * strip[2]
        lw = tuple(lab_w)
        cases.append(dict(
            name="lab_strip", path="lab",
            variant=f"{strip[0]}x{strip[1]}x{strip[2]} stacked",
            kernel=lambda: lab_strip(xs, *lw),
            plain=lambda: lab_strip_plain(xs, *lw),
            ref32=lambda: lab_strip_plain(xstrip32, *lw),
            extra_ms={"swin_attn_block_ms": lambda: swin_attn_block(
                xs, ps, num_heads=heads, ws=ws, dc=0, fast=False)},
            library=None, reps=5,
            flops=2 * ts * c * 3 * c + 4 * ts * n * c + 2 * ts * c * c,
            nbytes=2 * ts * c * es + 4 * c * c * es + heads * n * n * 4))
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


def _lab_launches(fn, expect: dict) -> tuple[dict, bool]:
    """Every launch count set to 0, ``fn`` run once, the counts read: the
    wrappers that ``expect`` names must show their counts."""
    import torch
    reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    return counts, all(counts[k] == v for k, v in expect.items())


def lab_r5_phase(quick: bool) -> dict:
    """The 12-block RSTB frame chain at the band in bf16 (4 blocks on a
    64x128 band with --quick): the pair chain (6 ``swin_pair_block``)
    against the sequential chain (12 ``swin_block``), held to the rounding
    control (the plain bf16 chain against the plain f32 chain): RMS no
    larger, the largest element no larger than the control's plus one bf16
    ulp."""
    import torch

    from image_restoration_agent_tpu_torch.lab import lab_r5, time_ms
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        swin_block_plain)

    dev = torch.device("cuda")
    shape = (1, 64, 128, 180) if quick else lab_r5.BAND
    nblk = 4 if quick else lab_r5.NBLK
    x = lab_r5.band_input(shape, torch.bfloat16, dev)
    blks = lab_r5.make_blocks(nblk, torch.bfloat16, dev)
    bank = lab_r5.mask_bank(lab_r5.WS, dev)
    with torch.no_grad():
        counts, ok = _lab_launches(
            lambda: lab_r5.chain_pair(x, blks, bank),
            {"swin_pair_block": nblk // 2, "swin_block": 0})
        pair = lab_r5.chain_pair(x, blks, bank).float()
        seq = lab_r5.chain_seq(x, blks, bank).float()
        ctrl16 = lab_r5.chain_seq(x, blks, bank,
                                  block=swin_block_plain).float()
        blks32 = lab_r5.make_blocks(nblk, torch.float32, dev)
        ctrl32 = lab_r5.chain_seq(x.float(), blks32, bank,
                                  block=swin_block_plain)
        seq_ms = time_ms(lambda: lab_r5.chain_seq(x, blks, bank), 3, dev)
        pair_ms = time_ms(lambda: lab_r5.chain_pair(x, blks, bank), 3, dev)
    d, dc_ = pair - seq, ctrl16 - ctrl32
    ulp = 2.0 ** (math.floor(math.log2(float(seq.abs().max()) or 1.0)) - 7)
    rms, crms = float(d.square().mean().sqrt()), float(
        dc_.square().mean().sqrt())
    mx, cmx = float(d.abs().max()), float(dc_.abs().max())
    ok = ok and bool(torch.isfinite(pair).all()) and rms <= crms \
        and mx <= cmx + ulp
    return {"phase": "lab_r5", "shape": list(shape), "blocks": nblk,
            "dtype": "bfloat16", "seq_frames_ms_per_block": seq_ms / nblk,
            "pair_ms_per_block": pair_ms / nblk, "rms_diff": rms,
            "max_abs_diff": mx, "control_rms": crms,
            "control_max_abs": cmx, "tolerance": cmx + ulp,
            "launches": {k: counts[k] for k in ("swin_pair_block",
                                                "swin_block")},
            "pass": ok}


def head_pair_phase(quick: bool) -> dict:
    """The head's tail as two K3 launches and as one ``conv3x3_pair``, at
    the band's second stage and its ring strip (times)."""
    import torch

    from image_restoration_agent_tpu_torch.lab import head_pair
    from image_restoration_agent_tpu_torch.ops.conv3x3 import conv3x3_pair

    dev = torch.device("cuda")
    shapes = ((1, 16, 256, 64), (1, 24, 256, 64)) if quick \
        else head_pair.SHAPES
    _, kp = head_pair.forms(*head_pair.head_weights(dev), torch.bfloat16)
    x = torch.randn(*shapes[1], device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        counts, ok = _lab_launches(lambda: conv3x3_pair(x, kp),
                                   {"conv3x3_pair": 1, "conv3x3": 0})
    rows = head_pair.run("cuda", shapes)
    return {"phase": "head_pair", "rows": rows,
            "launches": {k: counts[k] for k in ("conv3x3_pair", "conv3x3")},
            "pass": ok}


def lab_strip_phase(quick: bool) -> dict:
    """``lab_strip`` in every mode at kernel_lab's shape in bf16, each
    timed over 30 chained calls (3 with --quick on 1x64x128)."""
    import torch

    from image_restoration_agent_tpu_torch.lab import kernel_lab

    dev = torch.device("cuda")
    shape = (1, 64, 128, 180) if quick else kernel_lab.SHAPE
    x = torch.randn(*shape, device=dev, dtype=torch.bfloat16)
    wts = kernel_lab.lab_weights(dev)
    with torch.no_grad():
        counts, ok = _lab_launches(
            lambda: kernel_lab.lab_strip(x, *wts),
            {"lab_strip": 1, "token_linear": 2, "window_attention": 1})
    r = kernel_lab.run("cuda", shape, iters=3 if quick else 30)
    ok = ok and all(r[f"{m}_max_abs_diff"] == 0.0
                    for m in kernel_lab.MODES[1:])
    return {"phase": "lab_strip", **r,
            "launches": {k: counts[k] for k in ("lab_strip", "token_linear",
                                                "window_attention")},
            "pass": ok}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# slice 10: the agent chain (NAFNet, FBCNN, the v4 classifier, IRAgent)

# the toolboxes of tests/test_agent_goldens.py, and agent_path's full-width
# ones
GOLDEN_TOOLBOXES = {
    "denoising": [("nafnet", "nafnet")],
    "motion deblurring": [("nafnet", "nafnet")],
    "defocus deblurring": [("nafnet", "nafnet")],
    "deraining": [("nafnet", "nafnet")],
    "dehazing": [("nafnet", "nafnet")],
    "super-resolution": [],
    "jpeg compression artifact removal": [("fbcnn_blind", "fbcnn_blind")],
}
AGENT_TOOLBOXES = {
    "motion deblurring": [("restormer", "restormer")],
    "deraining": [("restormer", "restormer"), ("nafnet", "nafnet")],
    "denoising": [("nafnet", "nafnet"), ("restormer", "restormer")],
    "dehazing": [("nafnet", "nafnet")],
    "defocus deblurring": [("restormer", "restormer")],
    "jpeg compression artifact removal": [("fbcnn_blind", "fbcnn_blind")],
    "super-resolution": [],
}
TRACE = (Path(__file__).resolve().parent / "tests" / "data"
         / "agent_golden_trace.json")


@contextlib.contextmanager
def kernel_calls(model, dtypes: dict | None = None):
    """Record the kernel calls ``model``'s forward makes inside the block:
    ``(forms, counts)``, ``forms`` mapping each call form (the input's
    shape and what else decides the kernel's work) to the first module
    that made it, ``counts`` the calls of each kernel wrapper the modules
    call; ``dtypes``, where given, maps each form to {module: input
    dtype} over the modules that made it. K3 from every ``Conv``; K4 and
    K5 from a Restormer or X-Restormer block where it takes the fused
    route (X-Restormer's runs K4 twice);
    from a Swin block on the partition route one ``wmsa_block`` and one
    ``mlp_block``; on the strip route one ``swin_block`` (four K1, one K2
    and ``mlp_block`` inside), its form keyed by the folded roll ``dc`` its
    input frame gives and whether it reads the shift-mask bank; from a HAT
    block on the strip route ``swin_attn_block``, ``roll2d`` where it
    shifts and ``mlp_block``; from DehazeFormer's window attention one
    ``wmsa``."""
    from image_restoration_agent_tpu_torch.models.common import Conv
    from image_restoration_agent_tpu_torch.models.dehazeformer import (
        WindowAttention)
    from image_restoration_agent_tpu_torch.models.hat import HAB
    from image_restoration_agent_tpu_torch.models.restormer import (
        TransformerBlock)
    from image_restoration_agent_tpu_torch.models.swinir import SwinBlock
    from image_restoration_agent_tpu_torch.models.xrestormer import (
        XTransformerBlock)

    forms: dict = {}
    counts = {"conv3x3": 0, "gdfn_block": 0, "mdta_front": 0,
              "wmsa_block": 0, "mlp_block": 0, "swin_block": 0,
              "token_linear": 0, "window_attention": 0,
              "swin_attn_block": 0, "roll2d": 0, "wmsa": 0}

    def seen(key, name, x):
        forms.setdefault(key, name)
        if dtypes is not None:
            dtypes.setdefault(key, {})[name] = x.dtype

    def conv(name, mod, args, kw):
        arg = lambda i, k, d: args[i] if len(args) > i else kw.get(k, d)
        cout, cin = mod.weight.shape[:2]
        seen(("conv3x3", tuple(args[0].shape), cin, cout,
              mod.bias is not None, arg(1, "res", None) is not None, mod.act,
              arg(2, "roll", 0), arg(3, "ln_pre", None) is not None), name,
             args[0])
        counts["conv3x3"] += 1

    def block(name, mod, args, kw):
        x = args[0]
        if mod.fused(x):
            xblock = isinstance(mod, XTransformerBlock)
            attn, ffn = ((mod.channel_attn, mod.channel_ffn) if xblock
                         else (mod.attn, mod.ffn))
            forms.setdefault(("block", tuple(x.shape), attn.num_heads,
                              ffn.hidden), name)
            counts["gdfn_block"] += 2 if xblock else 1
            counts["mdta_front"] += 1

    def swin(name, mod, args, kw):
        x = args[0]
        ws = mod.window_size
        shift = 0 if min(x.shape[1:3]) <= ws else mod.shift_size
        hid = mod.mlp.fc1.out_features
        if isinstance(mod, HAB) and mod.strip(x):
            seen(("hat_strip", tuple(x.shape), mod.num_heads, ws, -shift,
                  shift > 0, hid), name, x)
            for k, v in (("swin_attn_block", 1), ("token_linear", 4),
                         ("window_attention", 1), ("mlp_block", 1),
                         ("roll2d", int(shift > 0))):
                counts[k] += v
            return
        if mod.strip(x):
            in_frame = args[1] if len(args) > 1 else kw.get("in_frame", 0)
            seen(("swin_strip", tuple(x.shape), mod.num_heads, ws,
                  -shift - in_frame, shift > 0, hid), name, x)
            for k, v in (("swin_block", 1), ("token_linear", 4),
                         ("window_attention", 1), ("mlp_block", 1)):
                counts[k] += v
            return
        seen(("swin_partition", tuple(x.shape), mod.num_heads, ws, shift,
              hid), name, x)
        counts["wmsa_block"] += 1
        counts["mlp_block"] += 1

    def window(name, mod, args, kw):
        seen(("wmsa", tuple(args[0].shape), mod.num_heads), name, args[0])
        counts["wmsa"] += 1

    hooks = [mod.register_forward_pre_hook(
        (lambda m, a, kw, n=name, f=fn: f(n, m, a, kw)), with_kwargs=True)
        for name, mod in model.named_modules()
        for cls, fn in ((Conv, conv), (TransformerBlock, block),
                        (XTransformerBlock, block), (SwinBlock, swin),
                        (WindowAttention, window))
        if isinstance(mod, cls)]
    try:
        yield forms, counts
    finally:
        for h in hooks:
            h.remove()


def traced_calls(name: str, inputs, dtype=None, dtypes: dict | None = None,
                 **overrides) -> tuple:
    """``kernel_calls`` of model ``name`` (its registered configuration,
    with ``overrides``) over its forwards on ``inputs``, a list of (b, h,
    w) input shapes, run on the meta device (the weights and input in
    ``dtype``, float32 by default): shapes only. The counts are summed over
    the forwards; ``dtypes`` gathers each form's modules and their input
    dtypes (``kernel_calls``)."""
    import torch

    from image_restoration_agent_tpu_torch.models import get_spec

    spec = get_spec(name)
    dtype = dtype or torch.float32
    with torch.device("meta"):
        model = spec.build(**{**spec.config, **overrides}).eval().to(dtype)
    with kernel_calls(model, dtypes) as (forms, counts), torch.no_grad():
        for b, h, w in inputs:
            model(torch.empty(b, h, w, 3, device="meta", dtype=dtype))
    return forms, counts


@functools.lru_cache(maxsize=None)
def served_canvas(name: str, h: int, w: int, bucket: int = 128) -> tuple:
    """The input shapes ``(b, h, w)``, one per forward, that
    ``Engine(shape_bucket=bucket)`` gives model ``name`` for an h x w
    request: the engine's own route (shape bucket, whole image or tile
    grid and tile batch, the model's pad), run on the CPU with a stand-in
    model that records its input and returns zeros."""
    import torch

    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.models import get_spec

    seen = []
    scale = get_spec(name).scale

    class Probe(torch.nn.Module):
        def forward(self, x, packed_output=False):
            b, hh, ww, c = x.shape
            seen.append((b, hh, ww))
            if packed_output:  # band mode: packed RGB rows
                return x.new_zeros(b, hh * scale, ww * scale * c)
            return x.new_zeros(b, hh * scale, ww * scale, c)

    eng = Engine(device="cpu", shape_bucket=bucket, hbm_budget_bytes=1 << 30)
    eng.store.get = lambda model_name: Probe()
    eng.restore_array(np.zeros((h, w, 3), np.float32), name)
    return tuple(seen)


def agent_models() -> list[str]:
    return sorted({m for box in AGENT_TOOLBOXES.values() for _, m in box})


def agent_input_hw() -> tuple:
    """The agent input's size: the nafnet golden's, edge-padded by 64."""
    from image_restoration_agent_tpu_torch.core.io import load_image
    from image_restoration_agent_tpu_torch.offline import GOLDEN_ROOT

    h, w = load_image(GOLDEN_ROOT / "nafnet_synth" / "input.png").shape[:2]
    return h + 64, w + 64


def models_forms(models, h: int, w: int) -> dict:
    """The union of the call forms of ``models`` served an h x w request,
    each named by its first model and module."""
    forms = {}
    for model in models:
        f, _ = traced_calls(model, served_canvas(model, h, w))
        for key, name in f.items():
            forms.setdefault(key, f"{model} {name}")
    return forms


@functools.lru_cache(maxsize=None)
def agent_kernel_shapes() -> dict:
    """path -> (call forms, launches per request or run): the kernel calls
    of the slice's served paths, traced on the meta device at the canvas
    each model is served on: ``nafnet`` and ``fbcnn`` a 256 px request,
    ``agent`` every toolbox model of ``AGENT_TOOLBOXES`` at the agent
    input's canvas (the launches there depend on the plan, so they are not
    a per-run count)."""
    out = {}
    for path, model in (("nafnet", "nafnet"), ("fbcnn", "fbcnn_blind")):
        out[path] = traced_calls(model, served_canvas(model, 256, 256))
    out["agent"] = (models_forms(agent_models(), *agent_input_hw()), None)
    return out


def unchecked_forms(path: str, seen: dict, shapes=None) -> list[str]:
    """The call forms ``seen`` on a path's real run that were not checked
    (it must be none): ``shapes`` (``agent_kernel_shapes()`` by default)
    maps the path to its checked forms."""
    checked = (shapes or agent_kernel_shapes())[path][0]
    return [f"{name}: {key}" for key, name in seen.items()
            if key not in checked]


def swin_weights(randn, c: int, heads: int, ws: int, hid: int) -> dict:
    """One Swin block's reference-layout weights, random from ``randn``."""
    return dict(
        norm1_w=1 + randn(c, scale=0.1), norm1_b=randn(c, scale=0.1),
        qkv_w=randn(3 * c, c, scale=c ** -0.5), qkv_b=randn(3 * c, scale=0.1),
        proj_w=randn(c, c, scale=c ** -0.5), proj_b=randn(c, scale=0.1),
        rpb_table=randn((2 * ws - 1) ** 2, heads, scale=0.5),
        norm2_w=1 + randn(c, scale=0.1), norm2_b=randn(c, scale=0.1),
        fc1_w=randn(hid, c, scale=c ** -0.5), fc1_b=randn(hid, scale=0.1),
        fc2_w=randn(c, hid, scale=hid ** -0.5), fc2_b=randn(c, scale=0.1))


def swin_strip_cases(key, name: str, path: str, dtype, randn,
                     quick: bool) -> list[dict]:
    """``swin_block`` (K1, K2, K1 and ``mlp_block``'s two K1; fast
    numerics in bf16, exact in f32) at one strip-route Swin block's form:
    its canvas, heads, window, folded roll and bank."""
    import torch

    from image_restoration_agent_tpu_torch.ops.swin_block import (
        prepare_swin_params, swin_block, swin_block_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask)

    _, shape, heads, ws, dc, banked, hid = key
    b, h, w, c = (1, 2 * ws, 4 * ws, shape[3]) if quick else shape
    wts = swin_weights(randn, c, heads, ws, hid)
    p = prepare_swin_params(**wts, num_heads=heads, ws=ws, dtype=dtype)
    p32 = prepare_swin_params(**wts, num_heads=heads, ws=ws,
                              dtype=torch.float32)
    n, t = ws * ws, b * h * w
    x32 = randn(b, h, w, c)
    bank = torch.from_numpy(shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n)).to(x32.device) \
        if banked else None
    x = x32.to(dtype)
    kw = dict(num_heads=heads, ws=ws, dc=dc, mask_bank=bank,
              fast=dtype == torch.bfloat16)
    es = 4 if dtype == torch.float32 else 2
    return [dict(
        name="swin_block", path=path,
        variant=f"{path} {name} {h}x{w} C{c} hid{hid} dc={dc}"
        + (",bank" if banked else ""),
        kernel=lambda: swin_block(x, p, **kw),
        plain=lambda: swin_block_plain(x, p, **kw),
        ref32=lambda: swin_block_plain(x32, p32, **kw), library=None,
        flops=(2 * t * c * 3 * c + 2 * t * c * c + 4 * t * c * hid
               + 4 * t * n * c),
        nbytes=2 * t * c * es + (4 * c * c + 2 * c * hid) * es, reps=3)]


def swin_partition_cases(key, name: str, path: str, dtype, randn,
                         quick: bool) -> list[dict]:
    """``wmsa_block`` (with the full shift mask where the block shifts)
    and ``mlp_block`` (erf GELU, tokens in and out in the block's dtype) at
    one partition-route Swin block's form: what ``SwinBlock.forward``
    launches there."""
    import torch

    from image_restoration_agent_tpu_torch.ops.swin_block import (
        mlp_block, mlp_block_plain, prepare_swin_params, wmsa_block,
        wmsa_block_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask, window_partition)

    _, shape, heads, ws, shift, hid = key
    b, h, w, c = (1, 2 * ws, 4 * ws, shape[3]) if quick else shape
    wts = swin_weights(randn, c, heads, ws, hid)
    p = prepare_swin_params(**wts, num_heads=heads, ws=ws, dtype=dtype)
    p32 = prepare_swin_params(**wts, num_heads=heads, ws=ws,
                              dtype=torch.float32)
    m = shift_attention_mask(h, w, ws, shift)
    mk = None if m is None else torch.from_numpy(m).to("cuda")
    x32 = randn(b, h, w, c)
    xw32 = window_partition(x32, ws).reshape(-1, ws * ws, c)
    xw = xw32.to(dtype)
    t, n = xw.shape[0] * xw.shape[1], ws * ws
    es = 4 if dtype == torch.float32 else 2
    var = f"{path} {name} {h}x{w} C{c} shift={shift}"
    mbytes = 0 if mk is None else mk.numel() * 4
    tok32 = randn(t, c)
    tok = tok32.to(dtype)
    return [dict(
        name="wmsa_block", variant=var, path=path,
        kernel=lambda: wmsa_block(xw, p, num_heads=heads, mask=mk),
        plain=lambda: wmsa_block_plain(xw, p, num_heads=heads, mask=mk),
        ref32=lambda: wmsa_block_plain(xw32, p32, num_heads=heads, mask=mk),
        library=None, reps=3,
        flops=2 * t * c * 3 * c + 2 * t * c * c + 4 * t * n * c,
        nbytes=2 * t * c * es + 4 * c * c * es + p.rpb.numel() * 4
        + mbytes), dict(
        name="mlp_block", variant=var, path=path,
        kernel=lambda: mlp_block(tok, *p.mlp, out_dtype=dtype),
        plain=lambda: mlp_block_plain(tok, *p.mlp, out_dtype=dtype),
        ref32=lambda: mlp_block_plain(tok32, *p32.mlp,
                                      out_dtype=torch.float32),
        library=None, reps=3, flops=4 * t * c * hid,
        nbytes=2 * t * c * es + 2 * c * hid * es)]


def form_cases(path: str, forms: dict, dtype, randn, gen, quick: bool,
               reps: int = 10) -> list[dict]:
    """The check cases of one path's call forms (at 16x128, or a two by
    four window canvas, with --quick): K3 through ``conv_case``, K4 and K5
    through ``restormer_block_cases`` at the block's batch, the Swin
    partition route through ``swin_partition_cases``, the strip route
    through ``swin_strip_cases``, HAT's strip route through
    ``hat_strip_cases``, DehazeFormer's window attention through
    ``wmsa_cases``."""
    cases, blocks = [], []
    for key, name in forms.items():
        if key[0] in ("hat_strip", "wmsa"):
            fn = hat_strip_cases if key[0] == "hat_strip" else wmsa_cases
            cases += fn(key, name, path, dtype, randn, quick)
            continue
        if key[0] in ("swin_partition", "swin_strip"):
            fn = swin_partition_cases if key[0] == "swin_partition" \
                else swin_strip_cases
            cases += fn(key, name, path, dtype, randn, quick)
            continue
        shape = (1, 16, 128, key[1][3]) if quick else key[1]
        if key[0] == "block":
            _, _, heads, hidden = key
            if hidden != int(2.66 * shape[3]):
                raise ValueError(f"{name}: hidden {hidden}")
            blocks.append((f"{path} {name}", shape, heads))
            continue
        _, _, cin, cout, bias, res, act, roll, ln = key
        b, h, w = shape[:3]
        size = f"{h}x{w}" if b == 1 else f"{b}x{h}x{w}"
        cases.append(conv_case(
            randn, dtype, path, f"{path} {name} {size} {cin}->{cout}"
            + (" res" if res else "") + (" ln_pre" if ln else ""), cin,
            cout, h, w, bias=bias, res=res, act=act, roll=roll, ln=ln,
            reps=reps, b=b))
    return cases + restormer_block_cases(blocks, dtype, randn, gen, path)


def agent_kernel_checks(quick: bool, seed: int = 23) -> list[dict]:
    """K3, K4 and K5 against their plain versions at every call form of
    ``agent_kernel_shapes`` (at 16x128 with --quick), f32 and bf16; K3's
    rows with ``F.conv2d`` beside them where the conv has no epilogue but
    its bias."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = []
        for path, (forms, _) in agent_kernel_shapes().items():
            cases += form_cases(path, forms, dtype, randn, gen, quick)
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


def agent_input(root) -> tuple:
    """The agent golden test's input (tests/test_agent_goldens.py): the
    nafnet golden fixture edge-padded by 64, plus N(0, 25/255) noise from
    ``default_rng(42)``; (float image, its PNG path under ``root``)."""
    from image_restoration_agent_tpu_torch.core.io import (load_image,
                                                           save_image,
                                                           to_float)
    from image_restoration_agent_tpu_torch.offline import GOLDEN_ROOT

    clean = to_float(load_image(GOLDEN_ROOT / "nafnet_synth" / "input.png"))
    clean = np.pad(clean, ((0, 64), (0, 64), (0, 0)), mode="edge")
    rng = np.random.default_rng(42)
    noisy = np.clip(clean + rng.normal(0.0, 25.0 / 255.0, clean.shape),
                    0.0, 1.0).astype(np.float32)
    path = root / "case" / "noisy.png"
    save_image(noisy, path)
    return to_float(load_image(path)), path


def synth_golden(wdir, golden: str, model: str) -> dict:
    """``golden``'s weights (materialized as ``<model>.npz``) served in f32
    by ``Engine(weight_dir=..., device="cuda", allow_random_init=False)``
    on the golden's input: PSNR of the uint8 result against the
    independent torch reference >= recorded - 0.1 dB; K3 launches counted
    over the request (and no other kernel)."""
    import torch

    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.offline import (GOLDEN_ROOT,
                                                           load_golden,
                                                           psnr)

    g = load_golden(GOLDEN_ROOT / golden)
    eng = Engine(weight_dir=wdir, device="cuda", allow_random_init=False)
    eng.store.get(model)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.restore_array(g["input"], model)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    others = {k: v for k, v in counts.items() if k != "conv3x3" and v}
    db = psnr(res.image.astype(np.float32) / 255.0, g["expected"])
    want = g["spec"]["psnr_db"] - 0.1
    return {"phase": f"{golden.split('_')[0]}_golden", "model": model,
            "dtype": "float32", "input": list(g["input"].shape),
            "output": list(res.image.shape), "psnr_db": db, "want_db": want,
            "random_init": res.random_init, "seconds": secs,
            "launches": {"conv3x3": counts["conv3x3"]},
            "other_launches": others,
            "pass": bool(db >= want and counts["conv3x3"] > 0
                         and not others and not res.random_init
                         and res.nonfinite == 0)}


def _probe(name: str, state, img, device: str,
           dtype_name: str) -> np.ndarray:
    import torch

    from image_restoration_agent_tpu_torch.models import build_model

    dtype = getattr(torch, dtype_name)
    m = build_model(name, device=device, dtype=dtype)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                      strict=True)
    with torch.no_grad():
        out = m(torch.from_numpy(img)[None].to(device, dtype)).float()
    return out[0].cpu().numpy()


def served_path(phase: str, path: str, name: str, state, card: str,
                requests: int) -> dict:
    """``name`` serving one 256x256 request in bf16 through
    ``Engine(device="cuda")``: one warm-up request, ``requests`` timed ones
    (the traced launches each), a ``torch.profiler`` split of one more, and
    one more with its kernel call forms recorded, all of which
    agent_kernels must have checked; bf16 against f32 on the card on the
    same image, beside the plain bf16-vs-f32 control (the CPU path)."""
    import torch

    img = np.random.default_rng(0).random((256, 256, 3), dtype=np.float32)
    eng, warm, warm_s, secs, results, counts, profile, _ = serve(
        name, state, img, requests, shape_bucket=128)
    per_req = {k: v for k, v in agent_kernel_shapes()[path][1].items() if v}
    with kernel_calls(eng.store.get(name)) as (seen, _):
        eng.restore_array(img, name)
    unchecked = unchecked_forms(path, seen)
    launches = {k: counts[k] for k in per_req}
    others = {k: v for k, v in counts.items() if k not in per_req and v}
    ok = all(r.image.shape == (256, 256, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and launches == {k: v * requests for k, v in per_req.items()} \
        and not others and not unchecked
    fast = _probe(name, state, img, "cuda", "bfloat16")
    exact = _probe(name, state, img, "cuda", "float32")
    torch.set_num_threads(8)
    ctrl16 = _probe(name, state, img, "cpu", "bfloat16")
    ctrl32 = _probe(name, state, img, "cpu", "float32")
    db = range_psnr(fast, exact)
    ctrl = range_psnr(ctrl16, ctrl32)
    best = min(secs)
    return {"phase": phase, "model": name, "dtype": "bfloat16",
            "input": [256, 256, 3], "warmup_seconds": warm_s,
            "seconds_best": best, "seconds_median": float(np.median(secs)),
            "seconds": secs, "mp_per_s": 256 * 256 / 1e6 / best,
            "launches": launches, "expected_per_request": per_req,
            "other_launches": others, "call_forms": len(seen),
            "unchecked_forms": unchecked,
            "bf16_vs_f32_db": db, "control_db": ctrl,
            "floor_db": ctrl - 2.0,
            "exact_plain_vs_card_db": range_psnr(ctrl32, exact),
            "profile": profile, "card": card,
            "pass": bool(ok and db >= ctrl - 2.0)}


def nafnet_path(state, card: str, requests: int = 20) -> dict:
    """BASELINE #1: ``nafnet`` (nafnet_synth weights), a 256x256 request
    in bf16 (``served_path``)."""
    return served_path("nafnet_path", "nafnet", "nafnet", state, card,
                       requests)


def fbcnn_path(state, card: str, requests: int = 10) -> dict:
    """``fbcnn_blind`` (fbcnn_synth weights), a 256x256 request in bf16
    (``served_path``): FBCNN's bf16 serving path, which the agent's pinned
    plan does not reach."""
    return served_path("fbcnn_path", "fbcnn", "fbcnn_blind", state, card,
                       requests)


def classifier_check(agent_img) -> dict:
    """The v4 classifier in f32 on the card against the port's CPU path,
    on the agent's input and 4 seeded images: logits within 1e-4 x
    max|ref|, every argmax equal; ms per ``evaluate`` (cache cleared) and
    the smallest top-2 logit margin seen."""
    import torch

    from image_restoration_agent_tpu_torch.iqa.classifier import (
        SeverityEvaluator)

    card = SeverityEvaluator.default(device="cuda")
    torch.set_num_threads(8)
    cpu = SeverityEvaluator.default(device="cpu")
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:240, 0:320] / 320.0
    imgs = [agent_img, rng.random((300, 400, 3), dtype=np.float32),
            np.clip(np.stack([yy, xx, yy * xx], -1)
                    + 0.03 * rng.standard_normal((240, 320, 3)), 0, 1),
            np.kron(rng.random((32, 32, 3)), np.ones((8, 8, 1))),
            0.2 * rng.random((512, 512, 3), dtype=np.float32)]
    rows, ok, margin = [], True, float("inf")
    for img in imgs:
        img = np.ascontiguousarray(img, np.float32)
        a, b = card.logits(img), cpu.logits(img)
        err = float(np.abs(a - b).max())
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        top2 = np.sort(b, axis=-1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()))
        ok = ok and same and err <= 1e-4 * float(np.abs(b).max())
        rows.append({"shape": list(img.shape), "max_abs_err": err,
                     "ref_max_abs": float(np.abs(b).max()),
                     "same_argmax": same,
                     "severities": [s for _, s in card.evaluate(img)]})

    def evaluate():
        card._logit_cache.clear()
        card.evaluate(agent_img)

    evaluate()
    t0 = time.perf_counter()
    for _ in range(20):
        evaluate()
    ms = (time.perf_counter() - t0) / 20 * 1e3
    return {"phase": "classifier", "weights": "degradation_classifier_v4",
            "dtype": "float32", "images": rows, "evaluate_ms": ms,
            "min_top2_margin": margin, "pass": bool(ok)}


def _trace(summary: dict) -> dict:
    return {"plan_initial": summary["plan"]["initial"],
            "execution_subtasks": summary["execution_path"]["subtasks"],
            "execution_tools": summary["execution_path"]["tools"],
            "n_invocations": summary["n_invocations"]}


def _run_agent(eng, toolboxes, inp, out, ex=None) -> tuple[float, dict]:
    """One IRAgent run (bf16 or f32 as ``eng`` serves, rng_seed 0, no
    rollback) on ``build_default_executor(engine=eng, toolboxes=...)``, or
    on the executor ``ex``; (seconds, summary)."""
    import torch

    from image_restoration_agent_tpu_torch.agent import (
        IRAgent, build_default_executor)

    ex = ex or build_default_executor(engine=eng, toolboxes=toolboxes)
    t0 = time.perf_counter()
    agent = IRAgent(inp, out, executor=ex, rng_seed=0, with_rollback=False,
                    silent=True, device="cuda")
    result = agent.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if result is None or not result.exists():
        raise RuntimeError("the agent wrote no result")
    return secs, json.loads(agent.summary_path.read_text())


def agent_golden(wdir, inp, root) -> dict:
    """The recipe of tests/test_agent_goldens.py on the card in f32: its
    trace equals tests/data/agent_golden_trace.json."""
    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(weight_dir=wdir, device="cuda", allow_random_init=False)
    reset_launch_counts()
    secs, summary = _run_agent(eng, GOLDEN_TOOLBOXES, inp, root / "golden")
    counts = launch_counts()
    with open(TRACE) as f:
        want = json.load(f)
    got = _trace(summary)
    return {"phase": "agent_golden", "dtype": "float32", "trace": got,
            "want": want, "seconds": secs,
            "launches": {k: v for k, v in counts.items() if v},
            "random_init_models": sorted(eng.random_init_models),
            "pass": bool(got == want and not eng.random_init_models
                         and counts["conv3x3"] > 0)}


def _wrap_seconds(owner, name: str, acc: dict, key: str):
    """Replace ``owner.name`` by a wrapper that adds its host seconds to
    ``acc[key]``; returns the original."""
    fn = getattr(owner, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] += time.perf_counter() - t0

    setattr(owner, name, timed)
    return fn


def agent_split(eng, toolboxes, inp, out) -> dict:
    """One more agent run under torch.profiler, with the host seconds in
    the classifier (resize + forward + copy back), in PNG decode/encode and
    in the engine's requests counted by wrappers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from image_restoration_agent_tpu_torch.agent import (evaluators,
                                                         executor, iragent)
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.iqa.classifier import (
        SeverityEvaluator)

    acc = {"classifier_s": 0.0, "png_io_s": 0.0, "engine_s": 0.0}
    wrapped = [(SeverityEvaluator, "logits", "classifier_s"),
               (Engine, "restore_array", "engine_s")] + [
        (mod, fn, "png_io_s") for mod, fns in (
            (executor, ("load_image", "save_image")),
            (evaluators, ("load_image",)), (iragent, ("load_image",)))
        for fn in fns]
    saved = [(o, n, _wrap_seconds(o, n, acc, k)) for o, n, k in wrapped]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            secs, _ = _run_agent(eng, toolboxes, inp, out)
    finally:
        for o, n, fn in saved:
            setattr(o, n, fn)

    def self_dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    evs = sorted(prof.key_averages(), key=self_dev_us, reverse=True)
    dev = [e for e in evs if e.device_type != DeviceType.CPU]
    busy = sum(self_dev_us(e) for e in dev) / 1e3
    return {"wall_s": secs, **acc,
            "classifier_share": acc["classifier_s"] / secs,
            "png_io_share": acc["png_io_s"] / secs,
            "engine_share": acc["engine_s"] / secs,
            "device_busy_ms": busy, "device_busy_share": busy / (secs * 1e3),
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": self_dev_us(e) / 1e3} for e in dev[:10]]}


def _cv2_version() -> str | None:
    """OpenCV's version where it imports (the brightening tools need it),
    else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def agent_path(wdir, inp, shape, root, card: str, runs: int = 5) -> dict:
    """BASELINE #5 on full-width models: the golden recipe's input and
    agent settings in bf16 with ``AGENT_TOOLBOXES`` (Restormer, NAFNet,
    FBCNN; synthetic weights): one warm-up run, ``runs`` timed ones with the
    launch counts set to 0 just before them and read just after, then one
    run split by ``agent_split``. The plan starts with motion deblurring,
    so Restormer runs: K4 and K5 must launch. The warm-up run records
    every kernel call form, all of which agent_kernels must have
    checked."""
    import torch

    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(weight_dir=wdir, device="cuda", param_dtype=torch.bfloat16,
                 allow_random_init=False)
    seen: dict = {}
    with contextlib.ExitStack() as stack:
        for model in agent_models():
            forms, _ = stack.enter_context(kernel_calls(eng.store.get(model)))
            seen[model] = forms
        warm_s, warm = _run_agent(eng, AGENT_TOOLBOXES, inp, root / "warm")
    seen = {key: f"{model} {name}" for model, forms in seen.items()
            for key, name in forms.items()}
    unchecked = unchecked_forms("agent", seen)
    reset_launch_counts()
    timed = [_run_agent(eng, AGENT_TOOLBOXES, inp, root / f"run{i}")
             for i in range(runs)]
    counts = launch_counts()
    secs = [t for t, _ in timed]
    traces = [_trace(s) for _, s in timed]
    split = agent_split(eng, AGENT_TOOLBOXES, inp, root / "split")
    per_kernel = {k: counts[k] for k in ("conv3x3", "gdfn_block",
                                         "mdta_front")}
    ok = (all(t == _trace(warm) for t in traces)
          and all(v > 0 for v in per_kernel.values())
          and not eng.random_init_models and not unchecked)
    return {"phase": "agent_path", "dtype": "bfloat16",
            "input": list(shape), "warmup_seconds": warm_s, "seconds": secs,
            "p50_s": float(np.median(secs)), "min_s": min(secs),
            "max_s": max(secs), "trace": traces[0],
            "launches": per_kernel,
            "other_launches": {k: v for k, v in counts.items()
                               if k not in per_kernel and v},
            "call_forms": len(seen), "unchecked_forms": unchecked,
            "split": split,
            "cv2": _cv2_version(),
            "card": card, "pass": bool(ok)}


def agent_phases(phase, card: str) -> dict:
    """Slice 10's phases in order, on the synthetic goldens' weights
    written to a temporary directory; returns the served paths' results
    (``nafnet``, ``fbcnn``, ``agent``) for their launch counts."""
    import tempfile

    from image_restoration_agent_tpu_torch.offline import (
        GOLDEN_ROOT, load_golden, materialize_synthetic_weights)

    served = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        wdir = root / "weights"
        materialize_synthetic_weights(
            wdir, ["nafnet_synth", "fbcnn_synth", "restormer_synth"])
        phase("nafnet_golden", synth_golden, wdir, "nafnet_synth", "nafnet")
        phase("fbcnn_golden", synth_golden, wdir, "fbcnn_synth",
              "fbcnn_blind")
        served["nafnet"] = phase(
            "nafnet_path", nafnet_path,
            load_golden(GOLDEN_ROOT / "nafnet_synth")["state"], card)
        served["fbcnn"] = phase(
            "fbcnn_path", fbcnn_path,
            load_golden(GOLDEN_ROOT / "fbcnn_synth")["state"], card)
        img, inp = agent_input(root)
        phase("classifier", classifier_check, img)
        phase("agent_golden", agent_golden, wdir, inp, root)
        served["agent"] = phase("agent_path", agent_path, wdir, inp,
                                img.shape, root, card)
    return served


# ---------------------------------------------------------------------------
# slice 11: the zoo behind the default toolboxes (X-Restormer, MPRNet,
# MAXIM-S2/S3, DRBNet, IFAN) and the agent on the unmodified default
# executor

# each new model's request, (model, h, w): GoPro's 1280x720 deblurring
# frame (Restormer's request) and DPDD's 1680x1120 defocus frame
ZOO_REQUESTS = (("xrestormer", 720, 1280), ("mprnet", 720, 1280),
                ("maxim_s2", 720, 1280), ("maxim_s3", 720, 1280),
                ("drbnet", 1120, 1680), ("ifan", 1120, 1680))
# the agent golden input's plan, and the f32 / bf16 probe sizes (X-Restormer
# at 64x128, where its level-1 blocks take the fused route)
DEFAULT_PLAN = ["motion deblurring", "deraining", "denoising"]
ZOO_PROBES = {"xrestormer": (64, 128)}


# the conv that closes each default-agent model's global residual
LAST_CONV = {"xrestormer": "output", "mprnet": "tail",
             "maxim_s2": "stage1_output_conv_0",
             "maxim_s3": "stage2_output_conv_0",
             "swinir_denoise_15": "conv_last", "swinir_denoise_50": "conv_last"}


def torch_default_init(m, seed: int) -> None:
    """torch's own initialisation of the reference's layers, from
    ``seed``: conv, transposed-conv and linear weights and biases
    U(+-1/sqrt(fan_in)) (``Conv2d`` / ``Linear.reset_parameters``; fan_in
    from dim 1 as torch counts it), norm scales 1 and shifts 0, PReLU
    slopes 0.25, attention temperatures 1, X-Restormer's rel-pos tables
    N(0, dim_head**-0.5), Swin bias tables and DiffBIR's empty_context N(0,
    0.02). The registry's fan-in normal weights make MPRNet's and MAXIM's
    random outputs grow to 1e3-1e5 through their stages, too
    ill-conditioned to compare f32 rounding orders; with these they stay
    near the image's range."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def fill(p, kind, scale=1.0):
        r = (torch.rand(p.shape, generator=gen) * 2 - 1 if kind == "u"
             else torch.randn(p.shape, generator=gen))
        p.copy_(r * scale)

    with torch.no_grad():
        for mod in m.modules():
            for name, p in mod.named_parameters(recurse=False):
                w = mod._parameters.get("weight")
                if name in ("weight", "bias") and w is not None \
                        and w.ndim >= 2:
                    fill(p, "u", (w.shape[1] * w[0, 0].numel()) ** -0.5)
                elif name == "weight":
                    p.fill_(0.25 if type(mod).__name__ == "PReLU" else 1.0)
                elif name == "bias":
                    p.zero_()
                elif name == "temperature":
                    p.fill_(1.0)
                elif name in ("rel_height", "rel_width"):
                    fill(p, "n", p.shape[1] ** -0.5)
                elif name == "relative_position_bias_table":
                    fill(p, "n", 0.02)
                elif name == "empty_context":
                    fill(p, "n", 0.02)
                else:
                    raise ValueError(f"no initialisation for {name}")


def zoo_state(name: str, seed: int = 0, residual: float = 1.0) -> dict:
    """Random weights of ``name`` from ``seed`` with
    :func:`torch_default_init`, as the numpy state dict the engine loads;
    ``residual`` scales the conv that closes the global residual
    (``LAST_CONV``), 1e-3 making the untrained model nearly the identity."""
    import torch

    from image_restoration_agent_tpu_torch.models import build_model
    m = build_model(name, device="cpu", seed=seed)
    torch_default_init(m, seed)
    if residual != 1.0:
        with torch.no_grad():
            for p in getattr(m, LAST_CONV[name]).parameters():
                p.mul_(residual)
    return {k: v.numpy() for k, v in m.state_dict().items()}


def default_agent_models() -> list[str]:
    """The models of the unmodified DEFAULT_TOOLBOXES' boxes on the agent
    golden input's plan."""
    from image_restoration_agent_tpu_torch.agent.executor import (
        DEFAULT_TOOLBOXES)
    return sorted({m for box in DEFAULT_PLAN
                   for _, m in DEFAULT_TOOLBOXES[box]})


@functools.lru_cache(maxsize=None)
def zoo_kernel_shapes() -> dict:
    """path -> (call forms, launches per request or None): each new
    model at its request (``ZOO_REQUESTS``; the launches summed over the
    request's forwards), and ``default_agent``: every model of the default
    toolboxes on the plan at the agent input's canvas (SwinIR-denoise's
    blocks on the partition route there)."""
    out = {name: traced_calls(name, served_canvas(name, h, w))
           for name, h, w in ZOO_REQUESTS}
    out["default_agent"] = (models_forms(default_agent_models(),
                                         *agent_input_hw()), None)
    return out


def zoo_kernel_checks(quick: bool, seed: int = 29) -> list[dict]:
    """K3, K4, K5 and the Swin partition route's ``wmsa_block`` and
    ``mlp_block`` against their plain versions at every call form of
    ``zoo_kernel_shapes`` (small shapes with --quick), f32 and bf16."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for path, (forms, _) in zoo_kernel_shapes().items():
            cases = form_cases(path, forms, dtype, randn, gen, quick, reps=3)
            rows += [check_case(cs, dtype) for cs in cases]
            del cases
    return rows


def zoo_path(name: str, h: int, w: int, card: str,
             requests: int = 3) -> dict:
    """``name`` (random weights from its seed) serving one h x w request
    in bf16 through ``Engine(device="cuda")``: one warm-up request,
    ``requests`` timed ones (each kernel's launches over them against the
    traced launches per request), a ``torch.profiler`` split of one more,
    and one more with its kernel call forms recorded, all of which
    zoo_kernels must have checked. On a small probe: f32 on the card
    against the port's CPU path (PSNR >= 60 dB), bf16 against f32 on the
    card (>= the CPU path's bf16-vs-f32 control - 2 dB)."""
    import torch

    state = zoo_state(name)
    img = np.random.default_rng(5).random((h, w, 3), dtype=np.float32)
    eng, warm, warm_s, secs, results, counts, profile, key = serve(
        name, state, img, requests, shape_bucket=128)
    shapes = zoo_kernel_shapes()
    per_req = {k: v for k, v in shapes[name][1].items() if v}
    with kernel_calls(eng.store.get(name)) as (seen, _):
        eng.restore_array(img, name)
    unchecked = unchecked_forms(name, seen, shapes)
    del eng
    launches = {k: counts[k] for k in per_req}
    others = {k: v for k, v in counts.items() if k not in per_req and v}
    ok = all(r.image.shape == (h, w, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and launches == {k: v * requests for k, v in per_req.items()} \
        and per_req.get("conv3x3", 0) > 0 and not others and not unchecked
    if name == "xrestormer":  # its level-1 and decoder blocks are fused
        ok = ok and per_req.get("gdfn_block", 0) > 0 \
            and per_req.get("mdta_front", 0) > 0
    probe = np.random.default_rng(6).random((*ZOO_PROBES.get(name, (64, 64)),
                                             3), dtype=np.float32)
    card32 = _probe(name, state, probe, "cuda", "float32")
    card16 = _probe(name, state, probe, "cuda", "bfloat16")
    torch.set_num_threads(8)
    cpu32 = _probe(name, state, probe, "cpu", "float32")
    cpu16 = _probe(name, state, probe, "cpu", "bfloat16")
    exact = range_psnr(card32, cpu32)
    db = range_psnr(card16, card32)
    ctrl = range_psnr(cpu16, cpu32)
    best = min(secs)
    return {"phase": f"{name}_path", "model": name, "dtype": "bfloat16",
            "input": [h, w, 3], "forwards": [list(s) for s in
                                             served_canvas(name, h, w)],
            "pipeline": list(key[1:6]), "warmup_seconds": warm_s,
            "seconds_best": best, "seconds_median": float(np.median(secs)),
            "seconds": secs, "mp_per_s": h * w / 1e6 / best,
            "launches": launches, "expected_per_request": per_req,
            "other_launches": others, "call_forms": len(seen),
            "unchecked_forms": unchecked, "profile": profile,
            "probe": list(probe.shape), "f32_card_vs_cpu_db": exact,
            "f32_floor_db": 60.0, "bf16_vs_f32_db": db, "control_db": ctrl,
            "floor_db": ctrl - 2.0,
            "output_max_abs": float(np.abs(cpu32).max()), "card": card,
            "pass": bool(ok and exact >= 60.0 and db >= ctrl - 2.0)}


def default_agent_path(wdir, inp, shape, root, card: str,
                       runs: int = 3) -> dict:
    """IRAgent on the agent golden input with ``build_default_executor(
    engine)`` exactly as shipped (DEFAULT_TOOLBOXES), in bf16, rng_seed 0,
    no rollback, the MockLLM and the v4 classifier; Restormer on its
    synthetic golden's weights, every other model random from its seed
    (``zoo_state``) with its global residual's closing conv scaled by
    1e-3, so that each untrained tool returns nearly its input: a tool
    whose output the reflection judges "very low" ends its box early, and
    the residual scale keeps every output as degraded as the input, so the
    plan [motion deblurring, deraining, denoising] tries every tool of its
    boxes (14 calls) with no KeyError. One warm-up run with every kernel
    call form recorded (all of them checked by zoo_kernels), then ``runs``
    timed ones (p50, min, max) with the launch counts over them, and one
    more split by ``agent_split``."""
    import torch

    from image_restoration_agent_tpu_torch.agent import (
        build_default_executor)
    from image_restoration_agent_tpu_torch.agent.executor import (
        DEFAULT_TOOLBOXES)
    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(weight_dir=wdir, device="cuda", param_dtype=torch.bfloat16,
                 allow_random_init=False)
    for model in default_agent_models():
        if model != "restormer":
            eng.set_weights(model, zoo_state(model, residual=1e-3))
    seen: dict = {}
    ex = build_default_executor(engine=eng)
    with contextlib.ExitStack() as stack:
        for model in default_agent_models():
            forms, _ = stack.enter_context(kernel_calls(eng.store.get(model)))
            seen[model] = forms
        warm_s, warm = _run_agent(eng, None, inp, root / "dwarm", ex)
    invocations = {f"{sub}/{t.tool_name}": t.invocations
                   for sub, tools in ex.toolbox_router.items()
                   for t in tools if t.invocations}
    seen = {key: f"{model} {name}" for model, forms in seen.items()
            for key, name in forms.items()}
    unchecked = unchecked_forms("default_agent", seen, zoo_kernel_shapes())
    reset_launch_counts()
    timed = [_run_agent(eng, None, inp, root / f"drun{i}")
             for i in range(runs)]
    counts = launch_counts()
    secs = [t for t, _ in timed]
    traces = [_trace(s) for _, s in timed]
    split = agent_split(eng, None, inp, root / "dsplit")
    want_calls = sum(len(DEFAULT_TOOLBOXES[b]) for b in DEFAULT_PLAN)
    kinds = {key[0] for key in seen}
    used = {"conv3x3"} | ({"gdfn_block", "mdta_front"} if "block" in kinds
                          else set()) | ({"wmsa_block", "mlp_block"}
                                         if "swin_partition" in kinds
                                         else set())
    per_kernel = {k: counts[k] for k in sorted(used)}
    ok = (_trace(warm)["plan_initial"] == DEFAULT_PLAN
          and warm["n_invocations"] == want_calls
          and sum(invocations.values()) == want_calls
          and all(t == _trace(warm) for t in traces)
          and all(v > 0 for v in per_kernel.values())
          and used >= {"conv3x3", "gdfn_block", "mdta_front", "wmsa_block",
                       "mlp_block"}
          and not eng.random_init_models and not unchecked)
    return {"phase": "default_agent_path", "dtype": "bfloat16",
            "input": list(shape), "toolboxes": "DEFAULT_TOOLBOXES",
            "warmup_seconds": warm_s, "seconds": secs,
            "p50_s": float(np.median(secs)), "min_s": min(secs),
            "max_s": max(secs), "trace": _trace(warm),
            "tool_calls": warm["n_invocations"], "want_calls": want_calls,
            "invocations": invocations, "launches": per_kernel,
            "other_launches": {k: v for k, v in counts.items()
                               if k not in per_kernel and v},
            "random_init_models": sorted(eng.random_init_models),
            "call_forms": len(seen), "unchecked_forms": unchecked,
            "split": split, "card": card, "pass": bool(ok)}


def zoo_phases(phase, card: str) -> dict:
    """Slice 11's served phases in order; returns each path's result
    (``<model>`` and ``default_agent``) for its launch counts."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.offline import (
        materialize_synthetic_weights)

    served = {}
    for name, h, w in ZOO_REQUESTS:
        served[name] = phase(f"{name}_path", zoo_path, name, h, w, card)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        wdir = root / "weights"
        materialize_synthetic_weights(wdir, ["restormer_synth"])
        img, inp = agent_input(root)
        served["default_agent"] = phase(
            "default_agent_path", default_agent_path, wdir, inp, img.shape,
            root, card)
    return served


# ---------------------------------------------------------------------------
# slice 12: RIDCP (the dehazing box), the HTTP API and the command line

# GoPro-sized 1280x720 hazy frame: the engine serves it whole (1280 <=
# max_size 1500) on the 768x1280 canvas; RIDCP's Swin blocks then run at
# 192x320, C 256 (fc2 at K 1024), the f32 and bf16 probes at 256x256
RIDCP_REQUEST = (720, 1280)
RIDCP_PROBE = (256, 256)


@functools.lru_cache(maxsize=None)
def ridcp_kernel_shapes() -> dict:
    """``ridcp``: (call forms, launches per request) of the 1280x720
    request, traced on the meta device at the engine's canvas."""
    return {"ridcp": traced_calls("ridcp", served_canvas(
        "ridcp", *RIDCP_REQUEST))}


def ridcp_linear_cases(dtype, randn, quick: bool) -> list[dict]:
    """K1 at RIDCP's MLP on the strip route (C 256, hidden 1024, the
    192x320 canvas's 61440 tokens): fc1 (LayerNorm-in, GELU, float32 rows
    in) and fc2 (K 1024 in chunks, the float32 residual, scattered to the
    canvas), each beside ``F.linear`` on the same operands."""
    import torch
    import torch.nn.functional as F

    from image_restoration_agent_tpu_torch.ops.swin_block import (
        SCATTER, kernel_matrix, token_linear, token_linear_plain)

    c, hid, ws = 256, 1024, 8
    h, w = (16, 32) if quick else (192, 320)
    t = h * w
    es = 4 if dtype == torch.float32 else 2
    gelu = "tanh" if dtype == torch.bfloat16 else "erf"
    w1, w2 = randn(c, hid, scale=c ** -0.5), randn(hid, c, scale=hid ** -0.5)
    b1, b2 = randn(hid, scale=0.1), randn(c, scale=0.1)
    ln = (1 + randn(c, scale=0.1), randn(c, scale=0.1))
    x1 = randn(t, c)  # the attention half's float32 output
    hdn32 = 0.5 * randn(t, hid)
    hdn = hdn32.to(dtype)
    k1, k2 = kernel_matrix(w1, dtype), kernel_matrix(w2, dtype)
    f1, f2 = kernel_matrix(w1, torch.float32), kernel_matrix(w2,
                                                             torch.float32)
    geom = (1, h, w, ws, 0)
    fc1 = dict(ln=ln, gelu=gelu)
    fc2 = dict(res=x1, geom=geom, o_map=SCATTER)
    x1d, w1t, w2t = x1.to(dtype), w1.t().to(dtype), w2.t().to(dtype)
    return [dict(
        name="token_linear", path="ridcp",
        variant=f"ridcp fc1 ln+gelu {c}->{hid} {h}x{w}",
        kernel=lambda: token_linear(x1, k1, b1, out_dtype=dtype, **fc1),
        plain=lambda: token_linear_plain(x1, k1, b1, out_dtype=dtype, **fc1),
        ref32=lambda: token_linear_plain(x1, f1, b1, out_dtype=torch.float32,
                                         **fc1),
        library=lambda: F.linear(x1d, w1t, b1.to(dtype)),
        flops=2 * t * c * hid, nbytes=t * c * 4 + c * hid * es
        + t * hid * es, reps=5), dict(
        name="token_linear", path="ridcp",
        variant=f"ridcp fc2 {hid}->{c} +res scatter {h}x{w}",
        kernel=lambda: token_linear(hdn, k2, b2, out_dtype=dtype, **fc2),
        plain=lambda: token_linear_plain(hdn, k2, b2, out_dtype=dtype,
                                         **fc2),
        ref32=lambda: token_linear_plain(hdn32, f2, b2,
                                         out_dtype=torch.float32, **fc2),
        library=lambda: F.linear(hdn, w2t, b2.to(dtype)),
        flops=2 * t * hid * c, nbytes=t * hid * es + hid * c * es
        + t * c * (4 + es), reps=5)]


def ridcp_kernel_checks(quick: bool, seed: int = 31) -> list[dict]:
    """K1 (``swin_block`` at the three strip-route forms, and K1's fc1 and
    fc2 at RIDCP's MLP) and K3 against their plain versions at every call
    form of ``ridcp_kernel_shapes`` (small shapes with --quick), f32 and
    bf16."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        forms, _ = ridcp_kernel_shapes()["ridcp"]
        cases = form_cases("ridcp", forms, dtype, randn, gen, quick, reps=3)
        cases += ridcp_linear_cases(dtype, randn, quick)
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


def _ridcp_probe(state, img, device: str, dtype_name: str) -> tuple:
    """``ridcp`` on ``img`` alone: (output, the VectorQuantizer's code
    indices)."""
    import torch

    from image_restoration_agent_tpu_torch.models import build_model

    m = build_model("ridcp", device=device, dtype=getattr(torch, dtype_name))
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                      strict=True)
    codes = []
    hook = m.quantize_group[0].register_forward_hook(
        lambda mod, a, out: codes.append(out[1].cpu()))
    with torch.no_grad():
        out = m(torch.from_numpy(img)[None].to(device, m.residual_conv
                                               .weight.dtype)).float()
    hook.remove()
    return out[0].cpu().numpy(), codes[0].numpy()


def ridcp_path(card: str, requests: int = 3) -> dict:
    """``ridcp`` (random weights from its seed, ``zoo_state``) serving one
    1280x720 request in bf16 through ``Engine(device="cuda")``: one
    warm-up, ``requests`` timed (best, median, MP/s), each kernel's launches
    against the traced count per request, a ``torch.profiler`` split of one
    more, one more with its call forms recorded (all checked by
    ridcp_kernels). On a 256x256 probe: f32 on the card against the CPU
    path (>= 60 dB), bf16 against f32 on the card (>= the CPU control - 2
    dB), and the share of VQ codes on which the card's f32 argmin agrees
    with the CPU's. Every model of the dehazing box is registered."""
    import torch

    from image_restoration_agent_tpu_torch.agent.executor import (
        DEFAULT_TOOLBOXES)
    from image_restoration_agent_tpu_torch.models import MODEL_REGISTRY

    h, w = RIDCP_REQUEST
    state = zoo_state("ridcp")
    img = np.random.default_rng(7).random((h, w, 3), dtype=np.float32)
    eng, warm, warm_s, secs, results, counts, profile, key = serve(
        "ridcp", state, img, requests, shape_bucket=128)
    shapes = ridcp_kernel_shapes()
    per_req = {k: v for k, v in shapes["ridcp"][1].items() if v}
    with kernel_calls(eng.store.get("ridcp")) as (seen, _):
        eng.restore_array(img, "ridcp")
    unchecked = unchecked_forms("ridcp", seen, shapes)
    del eng
    launches = {k: counts[k] for k in per_req}
    others = {k: v for k, v in counts.items() if k not in per_req and v}
    ok = all(r.image.shape == (h, w, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and launches == {k: v * requests for k, v in per_req.items()} \
        and all(per_req.get(k, 0) > 0 for k in ("conv3x3", "swin_block",
                                                "token_linear")) \
        and not others and not unchecked
    dehaze = [m for _, m in DEFAULT_TOOLBOXES["dehazing"]]
    missing = [m for m in dehaze if m not in MODEL_REGISTRY]
    probe = np.random.default_rng(8).random((*RIDCP_PROBE, 3),
                                            dtype=np.float32)
    card32, codes_card = _ridcp_probe(state, probe, "cuda", "float32")
    card16, _ = _ridcp_probe(state, probe, "cuda", "bfloat16")
    torch.set_num_threads(8)
    cpu32, codes_cpu = _ridcp_probe(state, probe, "cpu", "float32")
    cpu16, _ = _ridcp_probe(state, probe, "cpu", "bfloat16")
    exact = range_psnr(card32, cpu32)
    db = range_psnr(card16, card32)
    ctrl = range_psnr(cpu16, cpu32)
    agree = float((codes_card == codes_cpu).mean())
    best = min(secs)
    return {"phase": "ridcp_path", "model": "ridcp", "dtype": "bfloat16",
            "input": [h, w, 3], "forwards": [list(f) for f in
                                             served_canvas("ridcp", h, w)],
            "pipeline": list(key[1:6]), "warmup_seconds": warm_s,
            "seconds_best": best, "seconds_median": float(np.median(secs)),
            "seconds": secs, "mp_per_s": h * w / 1e6 / best,
            "launches": launches, "expected_per_request": per_req,
            "other_launches": others, "call_forms": len(seen),
            "unchecked_forms": unchecked, "profile": profile,
            "dehazing_box": dehaze, "unregistered": missing,
            "probe": list(probe.shape), "f32_card_vs_cpu_db": exact,
            "f32_floor_db": 60.0, "bf16_vs_f32_db": db, "control_db": ctrl,
            "floor_db": ctrl - 2.0, "vq_codes": int(codes_cpu.size),
            "vq_argmin_agreement": agree,
            "output_max_abs": float(np.abs(cpu32).max()), "card": card,
            "pass": bool(ok and not missing and exact >= 60.0
                         and db >= ctrl - 2.0)}


class _RecordingGraph:
    """The compiled agent graph, keeping each request's final state: the
    graph app turns a tool's exception into a ``tool_errors`` entry and
    goes on, so only the state shows that a tool failed."""

    def __init__(self, graph):
        self.graph, self.states = graph, []

    def invoke(self, state):
        out = self.graph.invoke(state)
        self.states.append(out)
        return out


def _http(url: str, body: bytes | None = None, ctype: str = "") -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=(
        {"Content-Type": ctype} if ctype else {}))
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serve_path(card: str) -> dict:
    """The port's HTTP API on the card: ``make_server`` on a loopback port
    in a thread, over an engine set up as default_agent_path's (Restormer
    on its golden's weights, the other tools random and nearly the
    identity) and the unmodified ``build_default_executor(engine)``; one
    /health (device ``cuda`` and the card's name), then three /process
    requests on the agent golden input (a JSON image_path in the work
    root, a multipart upload, JSON again), each followed by its
    /download. Fails on a status other than 200, plans or subtask results
    that differ between the requests, downloaded bytes that differ from
    ``final_output/<task_id>.png``, any ``tool_errors`` in a request's
    graph state, a plan box outside default_agent_path's (whose call forms
    zoo_kernels checked) or an unchecked call form. Then two requests to
    ``make_eval_server`` with the classifier on the card."""
    import tempfile
    import threading

    import torch

    from image_restoration_agent_tpu_torch.agent import (
        build_default_executor, create_image_analysis_graph)
    from image_restoration_agent_tpu_torch.api import (AgentAPIServer,
                                                       make_server)
    from image_restoration_agent_tpu_torch.api.eval_service import (
        make_eval_server)
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.offline import (
        materialize_synthetic_weights)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        wdir = root / "weights"
        materialize_synthetic_weights(wdir, ["restormer_synth"])
        eng = Engine(weight_dir=wdir, device="cuda",
                     param_dtype=torch.bfloat16, allow_random_init=False)
        for model in default_agent_models():
            if model != "restormer":
                eng.set_weights(model, zoo_state(model, residual=1e-3))
        ex = build_default_executor(engine=eng)
        graph = _RecordingGraph(create_image_analysis_graph(
            executor=ex, device="cuda"))
        app = AgentAPIServer(root / "work", graph=graph,
                             engine_status=eng.status)
        srv = make_server(host="127.0.0.1", port=0, app=app)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        img, src = agent_input(root)
        inp = app.work_root / "uploads" / "noisy.png"
        inp.write_bytes(src.read_bytes())
        boundary = "----chipsmoke12"
        upload = (f"--{boundary}\r\nContent-Disposition: form-data; "
                  f'name="file"; filename="noisy.png"\r\n'
                  "Content-Type: image/png\r\n\r\n").encode() \
            + inp.read_bytes() + f"\r\n--{boundary}--\r\n".encode()
        requests = [
            ("json", json.dumps({"image_path": str(inp)}).encode(),
             "application/json"),
            ("multipart", upload, f"multipart/form-data; boundary={boundary}"),
            ("json", json.dumps({"image_path": str(inp)}).encode(),
             "application/json")]
        seen: dict = {}
        codes, outs, secs, downloads = [], [], [], []
        try:
            code, body = _http(f"{base}/health")
            health = json.loads(body)
            codes.append(code)
            with contextlib.ExitStack() as stack:
                for model in default_agent_models():
                    forms, _ = stack.enter_context(
                        kernel_calls(eng.store.get(model)))
                    seen[model] = forms
                reset_launch_counts()
                for kind, body, ctype in requests:
                    t0 = time.perf_counter()
                    code, raw = _http(f"{base}/process", body, ctype)
                    secs.append(time.perf_counter() - t0)
                    codes.append(code)
                    out = json.loads(raw)
                    outs.append(out)
                    code, png = _http(f"{base}/download/{out.get('task_id')}")
                    codes.append(code)
                    final = app.work_root / "final_output" / \
                        f"{out.get('task_id')}.png"
                    downloads.append(final.exists()
                                     and png == final.read_bytes())
                counts = launch_counts()
            ev = make_eval_server(host="127.0.0.1", port=0, device="cuda")
            threading.Thread(target=ev.serve_forever, daemon=True).start()
            ebase = f"http://127.0.0.1:{ev.server_address[1]}"
            t0 = time.perf_counter()
            sev = _http(f"{ebase}/evaluate_degradation", json.dumps(
                {"img_path": str(inp), "degradation": "noise"}).encode(),
                "application/json")
            cmp_ = _http(f"{ebase}/compare_quality", json.dumps(
                {"img_path_A": str(inp),
                 "img_path_B": outs[-1].get("output_path", "")}).encode(),
                "application/json")
            eval_s = time.perf_counter() - t0
            ev.shutdown()
            ev.server_close()
        finally:
            srv.shutdown()
            srv.server_close()
        errors = [e for st in graph.states for e in st.get("tool_errors",
                                                            [])]
        seen = {key: f"{model} {name}" for model, forms in seen.items()
                for key, name in forms.items()}
        unchecked = unchecked_forms("default_agent", seen,
                                    zoo_kernel_shapes())
        plans = [o.get("initial_plan") for o in outs]
        results = [o.get("subtask_success") for o in outs]
        boxes = {s for p in plans for s, _ in (p or [])}
        used = ("conv3x3", "gdfn_block", "mdta_front", "wmsa_block",
                "mlp_block")
        launches = {k: counts[k] for k in used}
        answers = [json.loads(sev[1]).get("answer"),
                   json.loads(cmp_[1]).get("answer")]
        invocations = {f"{sub}/{t.tool_name}": t.invocations
                       for sub, tools in ex.toolbox_router.items()
                       for t in tools if t.invocations}
        ok = (all(c == 200 for c in codes) and all(downloads)
              and all(p == plans[0] for p in plans) and plans[0]
              and all(r == results[0] for r in results)
              and not errors and boxes <= set(DEFAULT_PLAN)
              and not unchecked and all(v > 0 for v in launches.values())
              and health.get("device") == "cuda"
              and health.get("device_name") == torch.cuda.get_device_name(0)
              and sev[0] == 200 and cmp_[0] == 200
              and answers[0] in ("very low", "low", "medium", "high",
                                 "very high")
              and answers[1] in ("Image A", "Image B", "similar"))
        return {"phase": "serve_path", "dtype": "bfloat16",
                "input": list(img.shape), "requests": [k for k, _, _ in
                                                       requests],
                "health": health, "statuses": codes,
                "downloads_equal": downloads, "plan": plans[0],
                "subtask_success": results[0],
                "executed": [st.get("executed") for st in graph.states],
                "tool_calls": sum(invocations.values()),
                "invocations": invocations,
                "tool_errors": errors, "seconds": secs,
                "p50_s": float(np.median(secs)), "launches": launches,
                "other_launches": {k: v for k, v in counts.items()
                                   if k not in used and v},
                "call_forms": len(seen), "unchecked_forms": unchecked,
                "eval_service": {"answers": answers, "seconds": eval_s},
                "card": card, "pass": bool(ok)}


def cli_path() -> dict:
    """The command line on the card, in subprocesses with no ``--device``:
    ``restore <png> --model ridcp -o out.png`` (random weights, no weight
    dir; the output's shape is the input's) and ``test-tools`` (the tiny
    toolboxes; every tool's ``ok``)."""
    import tempfile

    from image_restoration_agent_tpu_torch.core.io import (load_image,
                                                           save_image)

    cmd = [sys.executable, "-m", "image_restoration_agent_tpu_torch.cli"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        src, dst = root / "hazy.png", root / "out.png"
        yy, xx = np.mgrid[0:360, 0:640] / 640.0
        save_image(np.stack([0.6 + 0.3 * yy, 0.6 + 0.2 * xx,
                             0.7 + 0.1 * np.sin(9 * xx * yy)], -1), src)
        runs = {}
        for name, args in (
                ("restore", ["restore", str(src), "--model", "ridcp", "-o",
                             str(dst)]),
                ("test_tools", ["test-tools", "--work-dir",
                                str(root / "tools")])):
            t0 = time.perf_counter()
            r = subprocess.run(cmd + args, capture_output=True, text=True,
                               timeout=600)
            runs[name] = (r, time.perf_counter() - t0)
        r, restore_s = runs["restore"]
        rec = json.loads(r.stdout.strip().splitlines()[-1]) \
            if r.returncode == 0 else {}
        shape = list(load_image(dst).shape) if dst.exists() else None
        t, tools_s = runs["test_tools"]
        report = json.loads(t.stdout) if t.returncode == 0 else {}
        bad = [k for k, v in report.items() if not v["ok"]]
        ok = (r.returncode == 0 and rec.get("shape") == [360, 640]
              and shape == [360, 640, 3] and t.returncode == 0
              and len(report) >= 8 and not bad)
        return {"phase": "cli_path",
                "restore": {"rc": r.returncode, "record": rec,
                            "output_shape": shape, "seconds": restore_s,
                            "stderr_tail": r.stderr[-600:]},
                "test_tools": {"rc": t.returncode, "tools": len(report),
                               "not_ok": bad, "seconds": tools_s,
                               "stderr_tail": t.stderr[-600:]},
                "pass": bool(ok)}


def slice12_phases(phase, card: str) -> dict:
    """Slice 12's phases in order; returns each served path's result
    (``ridcp``, ``serve``) for its launch counts."""
    import torch

    served = {"ridcp": phase("ridcp_path", ridcp_path, card)}
    torch.cuda.empty_cache()
    served["serve"] = phase("serve_path", serve_path, card)
    torch.cuda.empty_cache()
    phase("cli_path", cli_path)
    return served


# ---------------------------------------------------------------------------
# slice 13: DiffBIR (the super-resolution box), BASELINE #5

# bench.py's diffbir_sr preset: a 256 px request, whole image on the
# engine's 256 canvas; stage 1 at 1024 px (its Swin blocks on the 128x128
# pixel-unshuffled canvas), the 128x128 latent, 50 sampler steps. The f32
# and bf16 probes: the model called on a 64x64 canvas (the smallest its
# stages take: stage 1's 32x32 unshuffled canvas, a 32x32 latent; the
# engine pads any input to 128, a CPU half four times as long), one
# sampler step (each stage runs once; more steps repeat the same
# launches).
DIFFBIR_REQUEST = (256, 256)
DIFFBIR_PROBE = (64, 64)
DIFFBIR_PROBE_STEPS = 1
# /process on a small image: the graph app puts super-resolution first
SR_PROCESS_SIZE = 192
# BASELINE #5 (bench.py:444-488): warm-up runs, timed runs (p50)
AGENT_WARMUP, AGENT_RUNS = 2, 5
# the top-level modules of DiffBIRPipeline, each a stage of the request
DIFFBIR_STAGES = ("preprocess_model", "cond_encoder", "control_model",
                  "model.diffusion_model", "first_stage_model")


@functools.lru_cache(maxsize=1)
def diffbir_state(seed: int = 0) -> dict:
    """``diffbir``'s random weights from ``seed`` with torch's own init
    (``torch_default_init``, as ``zoo_state``; built on the meta device,
    so 1.36 B parameters get one random draw, not the registry's first):
    the zero convs and the UNet's out conv get U(+-1/sqrt(fan_in)) like
    every conv, so a wrong tap order shows; ``empty_context`` N(0, 0.02).
    """
    import torch

    from image_restoration_agent_tpu_torch.models import get_spec

    spec = get_spec("diffbir")
    with torch.device("meta"):
        m = spec.build(**spec.config)
    m = m.to_empty(device="cpu")
    torch_default_init(m, seed)
    return {k: v.numpy() for k, v in m.state_dict().items()}


def diffbir_engine():
    """The bf16 ``Engine(device="cuda")`` that diffbir_path and sr_process
    share, ``diffbir`` set to ``diffbir_state``."""
    import torch

    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(device="cuda", param_dtype=torch.bfloat16)
    eng.set_weights("diffbir", diffbir_state())
    return eng


@functools.lru_cache(maxsize=None)
def diffbir_kernel_shapes() -> dict:
    """``diffbir``: (call forms, launches per request, each form's
    {module: input dtype}) of the 256 px request in bf16, traced on the
    meta device at the
    engine's canvas with bf16 weights and input, so each stage runs in the
    dtype the served request gives it (stage 1 and the condition encoder
    bf16, the ControlNet, UNet and decoder float32). Traced at 1 and 2
    sampler steps; every step makes the same calls, so the 50-step
    launches are the 1-step ones plus 49 times the difference."""
    import torch

    from image_restoration_agent_tpu_torch.models import get_spec

    canvas = served_canvas("diffbir", *DIFFBIR_REQUEST)
    dtypes: dict = {}
    f1, c1 = traced_calls("diffbir", canvas, dtype=torch.bfloat16,
                          dtypes=dtypes, num_steps=1)
    f2, c2 = traced_calls("diffbir", canvas, dtype=torch.bfloat16,
                          num_steps=2)
    if set(f1) != set(f2):
        raise RuntimeError("a sampler step made other call forms")
    steps = get_spec("diffbir").build().num_steps
    per_req = {k: c1[k] + (steps - 1) * (c2[k] - c1[k]) for k in c1}
    return {"diffbir": (f1, per_req, dtypes)}


def diffbir_stage_dtypes() -> dict:
    """stage -> the dtypes its kernel calls run in (from the trace)."""
    _, _, dtypes = diffbir_kernel_shapes()["diffbir"]
    out: dict = {}
    for mods in dtypes.values():
        for name, dt in mods.items():
            stage = next(s for s in DIFFBIR_STAGES if name.startswith(s))
            out.setdefault(stage, set()).add(str(dt).split(".")[-1])
    return {k: sorted(v) for k, v in out.items()}


def diffbir_kernel_checks(quick: bool, seed: int = 37) -> list[dict]:
    """K3 and ``swin_block`` (K1, K2, K1 and ``mlp_block``'s two K1)
    against their plain versions at every call form of the 256 px DiffBIR
    request (``diffbir_kernel_shapes``; small shapes with --quick), each in
    the dtype the bf16 request runs it in. Inputs drawn on the card."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    forms, _, dtypes = diffbir_kernel_shapes()["diffbir"]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        sub = {k: v for k, v in forms.items()
               if dtype in dtypes[k].values()}
        cases = form_cases("diffbir", sub, dtype, randn, gen, quick, reps=3)
        rows += [check_case(cs, dtype) for cs in cases]
        del cases
    return rows


def _diffbir_model(state: dict, device: str, dtype, **overrides):
    """``diffbir`` with ``state`` on ``device`` in ``dtype``, built on the
    meta device and given the weights (no random init first)."""
    import torch

    from image_restoration_agent_tpu_torch.models import get_spec

    spec = get_spec("diffbir")
    with torch.device("meta"):
        m = spec.build(**{**spec.config, **overrides})
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()},
                      strict=True, assign=True)
    return m.to(device=device, dtype=dtype).eval()


@functools.lru_cache(maxsize=1)
def diffbir_probes() -> dict:
    """``diffbir`` on the probe's 64x64 canvas, ``DIFFBIR_PROBE_STEPS``
    steps, the same injected draws everywhere: f32 and bf16 on the card and
    on the CPU (the plain path); {"card32", "card16", "cpu32", "cpu16"}
    as numpy, and the seconds of each."""
    import torch

    state = diffbir_state()
    h, w = DIFFBIR_PROBE
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.random((1, h, w, 3), dtype=np.float32))
    lat = (1, 4 * h // 8, 4 * w // 8, 4)
    noise = [torch.from_numpy(rng.standard_normal(lat).astype(np.float32))
             for _ in range(DIFFBIR_PROBE_STEPS + 1)]
    out, secs = {}, {}
    torch.set_num_threads(8)
    for dev, tag in (("cuda", "card"), ("cpu", "cpu")):
        for dtype, bits in ((torch.float32, "32"), (torch.bfloat16, "16")):
            m = _diffbir_model(state, dev, dtype,
                               num_steps=DIFFBIR_PROBE_STEPS)
            t0 = time.perf_counter()
            with torch.no_grad():
                y = m(x.to(dev, dtype), noise=[n.to(dev) for n in noise])
            out[tag + bits] = y[0].float().cpu().numpy()
            secs[tag + bits] = time.perf_counter() - t0
            del m, y
            if dev == "cuda":
                torch.cuda.empty_cache()
    out["seconds"] = secs
    out["canvas"] = [h, w]
    return out


def diffbir_exact() -> dict:
    """f32 on the card against the port's CPU path, full geometry, the
    probe's 64 canvas, one step, the same draws: PSNR >= 60 dB."""
    pr = diffbir_probes()
    db = range_psnr(pr["card32"], pr["cpu32"])
    return {"phase": "diffbir_exact", "canvas": pr["canvas"],
            "steps": DIFFBIR_PROBE_STEPS, "f32_card_vs_cpu_db": db,
            "floor_db": 60.0, "output_shape": list(pr["cpu32"].shape),
            "output_max_abs": float(np.abs(pr["cpu32"]).max()),
            "seconds": pr["seconds"], "pass": bool(db >= 60.0)}


def diffbir_bf16_vs_f32() -> dict:
    """bf16 against f32 on the card on the probe, PSNR >= the plain
    control (the CPU path's bf16 against its f32) - 2 dB."""
    pr = diffbir_probes()
    db = range_psnr(pr["card16"], pr["card32"])
    ctrl = range_psnr(pr["cpu16"], pr["cpu32"])
    return {"phase": "diffbir_bf16_vs_f32", "canvas": pr["canvas"],
            "bf16_vs_f32_db": db, "control_db": ctrl,
            "floor_db": ctrl - 2.0,
            "finite": bool(np.isfinite(pr["card16"]).all()),
            "pass": bool(db >= ctrl - 2.0 and np.isfinite(pr["card16"]).all())}


def _share(profile: dict, pattern: str) -> float:
    """The device ms of the profile's kernels whose name matches."""
    return sum(r["device_ms"] for r in profile["top"]
               if re.search(pattern, r["name"]))


def diffbir_path(eng, card: str) -> dict:
    """bench.py's diffbir_sr: ``eng`` (``diffbir_engine``: bf16, random
    weights) serving a 256x256 request with ``diffbir``, whole image, 50
    steps: one warm-up request with every kernel call form recorded (all
    checked by diffbir_kernels), then one timed under ``torch.profiler``
    with the device's activity alone (busy share, top kernels, K3's f32
    and bf16 shares; the profiler adds about 0.2% to its wall time; with
    the ops' rows too its processing took two minutes),
    with the launch counts over both against the traced count per request
    and the peak device memory. Every model of the super-resolution box is
    registered."""
    import torch

    from image_restoration_agent_tpu_torch.agent.executor import (
        DEFAULT_TOOLBOXES)
    from image_restoration_agent_tpu_torch.models import MODEL_REGISTRY

    h, w = DIFFBIR_REQUEST
    requests = 1
    img = np.random.default_rng(21).random((h, w, 3), dtype=np.float32)
    t0 = time.perf_counter()
    model = eng.store.get("diffbir")
    load_s = time.perf_counter() - t0
    weights_bytes = torch.cuda.memory_allocated()
    with kernel_calls(model) as (seen, _):
        t0 = time.perf_counter()
        warm = eng.restore_array(img, "diffbir")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    shapes = diffbir_kernel_shapes()
    unchecked = unchecked_forms("diffbir", seen, shapes)
    per_req = {k: v for k, v in shapes["diffbir"][1].items() if v}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    results: list = []
    t0 = time.perf_counter()
    profile = profile_request(eng, img, "diffbir", top=40, results=results,
                              cpu_ops=False)
    profile_s = time.perf_counter() - t0
    secs = [profile["wall_ms"] / 1e3]
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del model
    launches = {k: counts[k] for k in per_req}
    others = {k: v for k, v in counts.items() if k not in per_req and v}
    same = all(np.array_equal(r.image, warm.image) for r in results)
    ok = all(r.image.shape == (4 * h, 4 * w, 3) and r.nonfinite == 0
             for r in results + [warm])
    ok = ok and launches == {k: v * requests for k, v in per_req.items()} \
        and all(per_req.get(k, 0) > 0 for k in (
            "conv3x3", "swin_block", "token_linear", "window_attention")) \
        and not others and not unchecked and same
    sr_box = [m for _, m in DEFAULT_TOOLBOXES["super-resolution"]]
    missing = [m for m in sr_box if m not in MODEL_REGISTRY]
    busy = profile["device_busy_ms"]
    best = min(secs)
    return {"phase": "diffbir_path", "model": "diffbir", "dtype": "bfloat16",
            "input": [h, w, 3], "forwards": [list(f) for f in served_canvas(
                "diffbir", h, w)], "steps": 50,
            "stage_dtypes": diffbir_stage_dtypes(),
            "weights_load_seconds": load_s, "weights_bytes": weights_bytes,
            "warmup_seconds": warm_s, "profile_seconds": profile_s,
            "seconds_best": best,
            "seconds_median": float(np.median(secs)), "seconds": secs,
            "mp_per_s": h * w / 1e6 / best,
            "peak_memory_bytes": peak, "deterministic": same,
            "launches": launches, "expected_per_request": per_req,
            "other_launches": others, "call_forms": len(seen),
            "unchecked_forms": unchecked, "profile": profile,
            "k3_f32_share_of_busy": _share(profile, r"conv3x3_kernel") / busy,
            "k3_bf16_share_of_busy": _share(profile, r"conv3x3_mma") / busy,
            "super_resolution_box": sr_box, "unregistered": missing,
            "card": card, "pass": bool(ok and not missing)}


def sr_process(eng, card: str) -> dict:
    """``/process`` through ``make_server`` on the unmodified default
    executor with a 192 px bench-style input (``random * 0.6``, seed 0):
    the size rule puts super-resolution in the plan, whose box tries
    ``diffbir`` first. ``eng`` is diffbir_path's bf16 engine; the other
    models of the super-resolution and denoising boxes random from their
    seeds (``zoo_state``; the denoisers' global residual scaled by 1e-3),
    loaded by the request. The request answers 200, its graph state has no
    ``tool_errors``, super-resolution is executed and ``diffbir`` was
    called; the downloaded bytes are the result's."""
    import tempfile
    import threading

    from image_restoration_agent_tpu_torch.agent import (
        build_default_executor, create_image_analysis_graph)
    from image_restoration_agent_tpu_torch.agent.executor import (
        DEFAULT_TOOLBOXES)
    from image_restoration_agent_tpu_torch.api import (AgentAPIServer,
                                                       make_server)
    from image_restoration_agent_tpu_torch.core.io import save_image

    for box in ("super-resolution", "denoising"):
        for _, model in DEFAULT_TOOLBOXES[box]:
            if model != "diffbir" and model not in eng._states:
                eng.set_weights(model, zoo_state(
                    model, residual=1e-3 if model in LAST_CONV else 1.0))
    ex = build_default_executor(engine=eng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        graph = _RecordingGraph(create_image_analysis_graph(
            executor=ex, device="cuda"))
        app = AgentAPIServer(root / "work", graph=graph,
                             engine_status=eng.status)
        srv = make_server(host="127.0.0.1", port=0, app=app)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        rng = np.random.default_rng(0)
        img = rng.random((SR_PROCESS_SIZE, SR_PROCESS_SIZE, 3),
                         dtype=np.float32) * 0.6
        inp = app.work_root / "uploads" / "small.png"
        save_image(img, inp)
        reset_launch_counts()
        try:
            t0 = time.perf_counter()
            code, raw = _http(f"{base}/process", json.dumps(
                {"image_path": str(inp)}).encode(), "application/json")
            secs = time.perf_counter() - t0
            out = json.loads(raw)
            dl_code, png = _http(f"{base}/download/{out.get('task_id')}")
            final = app.work_root / "final_output" / \
                f"{out.get('task_id')}.png"
            download_ok = final.exists() and png == final.read_bytes()
        finally:
            srv.shutdown()
            srv.server_close()
        counts = launch_counts()
    state = graph.states[-1] if graph.states else {}
    errors = list(state.get("tool_errors", []))
    invocations = {f"{sub}/{t.tool_name}": t.invocations
                   for sub, tools in ex.toolbox_router.items()
                   for t in tools if t.invocations}
    plan = out.get("initial_plan") or []
    ok = (code == 200 and dl_code == 200 and download_ok and not errors
          and "super-resolution" in state.get("executed", [])
          and invocations.get("super-resolution/diffbir", 0) > 0
          and counts["conv3x3"] > 0 and counts["swin_block"] > 0)
    return {"phase": "sr_process", "dtype": "bfloat16",
            "input": [SR_PROCESS_SIZE, SR_PROCESS_SIZE, 3],
            "status": code, "download_status": dl_code,
            "download_equal": download_ok, "plan": plan,
            "executed": state.get("executed"),
            "subtask_success": out.get("subtask_success"),
            "tool_errors": errors, "invocations": invocations,
            "tool_calls": sum(invocations.values()), "seconds": secs,
            "launches": {k: v for k, v in counts.items() if v},
            "random_init_models": sorted(eng.random_init_models),
            "card": card, "pass": bool(ok)}


def agent_baseline(card: str, fast: bool) -> dict:
    """BASELINE #5 as bench.py's bench_agent_p50 defines it: IRAgent
    (defaults: rollback, reflection, MockLLM, the v4 classifier) on
    ``build_default_executor(fast=fast)`` exactly as shipped (its own
    ``Engine(device="cuda")``, float32, random init); a new seeded image
    each run (``default_rng(0).random((size, size, 3)) * 0.6``; 192 px
    fast, 512 px full), 2 warm-up runs then 5 timed (p50, min, max), the
    plan and tool calls of each run and the launches over the timed
    ones."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.agent import (
        IRAgent, build_default_executor)
    from image_restoration_agent_tpu_torch.core.io import save_image

    size = 192 if fast else 512
    rng = np.random.default_rng(0)
    ex = build_default_executor(fast=fast)
    secs, plans, calls = [], [], []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        for i in range(AGENT_WARMUP + AGENT_RUNS):
            img = rng.random((size, size, 3), dtype=np.float32) * 0.6
            inp = Path(td) / f"in_{i}.png"
            save_image(img, inp)
            if i == AGENT_WARMUP:
                reset_launch_counts()
            t0 = time.perf_counter()
            agent = IRAgent(inp, Path(td) / f"work_{i}", executor=ex,
                            silent=True)
            result = agent.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            summary = json.loads(agent.summary_path.read_text())
            plans.append(summary["plan"]["initial"])
            calls.append(summary["n_invocations"])
            if result is None or not result.exists():
                raise RuntimeError(f"agent run {i} wrote no result")
            if i >= AGENT_WARMUP:
                secs.append(dt)
        counts = launch_counts()
    p50 = sorted(secs)[len(secs) // 2]
    return {"phase": "agent_fast" if fast else "agent_full",
            "dtype": "float32", "input": [size, size, 3],
            "toolboxes": "build_default_executor(fast=True)" if fast
            else "DEFAULT_TOOLBOXES", "warmup_runs": AGENT_WARMUP,
            "p50_s": p50, "min_s": min(secs), "max_s": max(secs),
            "seconds": secs, "plans": plans, "tool_calls": calls,
            "launches": {k: v for k, v in counts.items() if v},
            "card": card, "pass": bool(all(calls) and counts["conv3x3"] > 0)}


def slice13_phases(phase, card: str) -> dict:
    """Slice 13's phases in order; returns the DiffBIR path's result for
    its launch counts."""
    import torch

    eng = diffbir_engine()
    served = {"diffbir": phase("diffbir_path", diffbir_path, eng, card)}
    phase("sr_process", sr_process, eng, card)
    del eng
    torch.cuda.empty_cache()
    phase("diffbir_exact", diffbir_exact)
    phase("diffbir_bf16_vs_f32", diffbir_bf16_vs_f32)
    diffbir_probes.cache_clear()
    diffbir_state.cache_clear()
    torch.cuda.empty_cache()
    phase("agent_fast", agent_baseline, card, True)
    torch.cuda.empty_cache()
    phase("agent_full", agent_baseline, card, False)
    torch.cuda.empty_cache()
    return served


# ---------------------------------------------------------------------------
# slice 14: the retrieval fast path and the quality scorers

# the published geometries, overridable (a CPU rehearsal sets tiny ones):
# CLIP RN50x4 at 288 with its 77-token text tower, the Combiner (640,
# 2560, 5120), the stand-in (its Combiner at the same widths), CLIP-IQA's
# ResNet-50, MANIQA (ViT-B/8 at 224, TABlocks, two Swin stages), MUSIQ (14
# layers, hidden 384), LPIPS-Alex
S14_CLIP = {}            # CLIPModel() defaults: RN50x4
S14_COMBINER = {}        # Combiner() defaults
S14_FEATURE = 640
S14_N_PX = 288
S14_RN50 = None          # None: iqa.clipiqa.RN50_CONFIG
S14_MANIQA = {}
S14_MUSIQ = {}
S14_SCORE_HW = (1080, 1920)
S14_STORE_SIZE = 10_000
S14_INSERT_RUNS = 10
S14_RUNS = 3
# the captions the synthetic merges file builds whole (the retrieval
# caption and CLIP-IQA's prompts)
S14_WORDS = ("similar", "degradation", "good", "bad", "photo")


def write_merges(path) -> Path:
    """A CLIP merges file with CLIP's vocabulary size (49408): its first
    merges build ``S14_WORDS`` letter by letter, the rest unique pairs of
    byte symbols. CLIP's own file is not in the repository; the tokenizer's
    work is the same."""
    import gzip
    import itertools

    from image_restoration_agent_tpu_torch.retrieval.tokenizer import (
        bytes_to_unicode)

    head = []
    for w in S14_WORDS:
        sym = list(w[:-1]) + [w[-1] + "</w>"]
        cur = sym[0]
        for s in sym[1:]:
            head.append(f"{cur} {s}")
            cur += s
    seen = set(head)
    alphabet = list(bytes_to_unicode().values())
    pad = [m for m in (f"{a} {b}" for a, b in itertools.product(
        alphabet, alphabet)) if m not in seen][:49152 - 256 - 2 - len(head)]
    path = Path(path)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"] + head + pad))
    return path


def random_init(model, seed: int):
    """Random weights from ``seed`` for the retrieval and quality models:
    matrices and kernels normal over the square root of their fan-in,
    1-D weights (norm scales) 1 + 0.05 N, other vectors 0.02 N, BatchNorm
    running means 0.1 N and variances U(0.5, 1.5); scalars kept. Returns
    ``model``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in list(model.named_parameters()) + [
                (n, b) for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))]:
            if p.dim() == 0:
                continue
            n = torch.randn(p.shape, generator=gen)
            if name.endswith("running_var"):
                v = 0.5 + torch.rand(p.shape, generator=gen)
            elif name.endswith("running_mean"):
                v = 0.1 * n
            elif p.dim() == 1 and name.endswith("weight"):
                v = 1.0 + 0.05 * n
            elif p.dim() == 1:
                v = 0.02 * n
            else:
                v = n / p[0].numel() ** 0.5
            p.copy_(v)
    return model


@functools.lru_cache(maxsize=1)
def retrieval_states(seed: int = 41) -> dict:
    """CPU state dicts of CLIP RN50x4 and the Combiner (``random_init``
    from ``seed``, ``seed + 1``)."""
    from image_restoration_agent_tpu_torch.retrieval.clip import CLIPModel
    from image_restoration_agent_tpu_torch.retrieval.combiner import (
        Combiner)

    return {"clip": random_init(CLIPModel(**S14_CLIP), seed).state_dict(),
            "combiner": random_init(Combiner(**S14_COMBINER),
                                    seed + 1).state_dict()}


def _built(cls, state: dict, **kw):
    """``cls(**kw)`` holding ``state``'s tensors, built on the meta device
    (no init of its own)."""
    import torch

    with torch.device("meta"):
        m = cls(**kw)
    m.load_state_dict(state, strict=True, assign=True)
    return m


def clip_embedder(device: str, bpe):
    """``CLIPRetrievalEmbedder`` on ``device`` over ``retrieval_states``."""
    from image_restoration_agent_tpu_torch.retrieval.clip import CLIPModel
    from image_restoration_agent_tpu_torch.retrieval.combiner import (
        Combiner)
    from image_restoration_agent_tpu_torch.retrieval.embedder import (
        CLIPRetrievalEmbedder)
    from image_restoration_agent_tpu_torch.retrieval.tokenizer import (
        SimpleTokenizer)

    st = retrieval_states()
    return CLIPRetrievalEmbedder(
        None, None, SimpleTokenizer(bpe), n_px=S14_N_PX,
        feature_dim=S14_FEATURE,
        clip_model=_built(CLIPModel, st["clip"], **S14_CLIP),
        combiner_model=_built(Combiner, st["combiner"], **S14_COMBINER),
        device=device)


def standin_embedder(device: str, seed: int = 43):
    from image_restoration_agent_tpu_torch.retrieval.embedder import (
        RetrievalEmbedder)
    return RetrievalEmbedder(seed=seed, feature_dim=S14_FEATURE,
                             device=device)


def _vec_check(card_v, cpu_v) -> dict:
    a = np.asarray(card_v, np.float64)
    b = np.asarray(cpu_v, np.float64)
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    return {"cosine": cos, "max_abs_err": err, "max_abs_ref": scale,
            "pass": bool(cos >= 1 - 1e-6 and err <= 1e-4 * scale)}


def s14_images() -> dict:
    """Seeded inputs: a 512x384 gradient with noise and a 1080p one."""
    rng = np.random.default_rng(47)
    out = {}
    for name, (h, w) in (("512x384", (384, 512)), ("1080p", (1080, 1920))):
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        base = np.stack([yy, xx, 0.5 + 0.4 * np.sin(9 * yy * xx)], -1)
        out[name] = np.clip(base + 0.05 * rng.standard_normal(base.shape),
                            0, 1).astype(np.float32)
    return out


def retrieval_exact(card: str, dev: str = "cuda") -> dict:
    """Full-width CLIP RN50x4 + Combiner (``CLIPRetrievalEmbedder``) and
    the stand-in, random weights from their seeds, f32: the fused
    embedding on ``dev`` against the port's CPU path on the same weights,
    cosine >= 1 - 1e-6 and max-abs <= 1e-4 x max|ref|, on two images; the
    caption's text feature alone likewise."""
    import tempfile

    import torch

    imgs = s14_images()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        bpe = write_merges(Path(td) / "bpe.txt.gz")
        on_dev, on_cpu = clip_embedder(dev, bpe), clip_embedder("cpu", bpe)
        rows = {f"clip {k}": _vec_check(on_dev.embed_array(v),
                                        on_cpu.embed_array(v))
                for k, v in imgs.items()}
        rows["clip caption text feature"] = _vec_check(
            on_dev._text_feat[0].cpu().numpy(), on_cpu._text_feat[0].numpy())
        del on_dev, on_cpu
        on_dev, on_cpu = standin_embedder(dev), standin_embedder("cpu")
        rows.update({f"standin {k}": _vec_check(on_dev.embed_array(v),
                                                on_cpu.embed_array(v))
                     for k, v in imgs.items()})
        del on_dev, on_cpu
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"phase": "retrieval_exact", "dtype": "float32",
            "clip": S14_CLIP or "RN50x4", "n_px": S14_N_PX, "checks": rows,
            "card": card, "pass": all(r["pass"] for r in rows.values())}


def _best_ms(fn, reps: int = 3, dev: str = "cuda") -> tuple[float, list]:
    """Best of ``reps`` host-clock runs of ``fn`` after one warm-up, each
    ending in ``torch.cuda.synchronize()``; (best ms, all ms)."""
    import torch

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return min(ms), ms


def profile_top(fn, dev: str = "cuda", top: int = 10) -> dict:
    """One call of ``fn`` under torch.profiler, ending in a synchronize:
    its wall ms, the device's busy ms and share (the device's own rows),
    and the ``top`` device rows by self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def self_dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    evs = sorted(prof.key_averages(), key=self_dev_us, reverse=True)
    rows = [e for e in evs if e.device_type != DeviceType.CPU]
    busy = sum(self_dev_us(e) for e in rows) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": self_dev_us(e) / 1e3}
                    for e in rows[:top]]}


def fabricate_runs(root, img, n: int) -> None:
    """``n`` agent work dirs as IRAgent leaves them (``logs/summary.json``
    with an execution path, ``img_tree/0-img/input.png``), each input
    ``img`` with its own seeded noise."""
    from image_restoration_agent_tpu_torch.core.io import save_image

    rng = np.random.default_rng(53)
    plans = ((["denoising"], ["nafnet"]),
             (["motion deblurring", "denoising"], ["restormer", "nafnet"]),
             (["jpeg compression artifact removal"], ["fbcnn_blind"]))
    for i in range(n):
        run = Path(root) / f"run_{i:03d}"
        (run / "logs").mkdir(parents=True)
        subtasks, tools = plans[i % len(plans)]
        (run / "logs" / "summary.json").write_text(json.dumps(
            {"execution_path": {"subtasks": subtasks, "tools": tools}}))
        noisy = np.clip(img + 0.02 * rng.standard_normal(img.shape), 0, 1)
        save_image(noisy.astype(np.float32),
                   run / "img_tree" / "0-img" / "input.png")


def retrieval_path(card: str, dev: str = "cuda") -> dict:
    """Times of the fast path's parts, f32: ``embed_array`` of the CLIP
    embedder (RN50x4 at 288, the caption feature made once) and of the
    stand-in (224) on the 512x384 and 1080p inputs, best of 3 after a
    warm-up, and a ``torch.profiler`` top-10 of the CLIP embedding;
    ``NumpyVectorStore.query`` (top-5) over 10 000 random unit
    vectors (a store file loaded); ``insert_solved_runs`` over 10
    fabricated work dirs of
    512x384 inputs (decode, embed, insert) with the CLIP embedder."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.retrieval import NumpyVectorStore
    from image_restoration_agent_tpu_torch.train.retrieval import (
        insert_solved_runs)

    imgs = s14_images()
    out = {"phase": "retrieval_path", "dtype": "float32", "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        t0 = time.perf_counter()
        clip = clip_embedder(dev, write_merges(root / "bpe.txt.gz"))
        out["clip_build_seconds"] = time.perf_counter() - t0
        standin = standin_embedder(dev)
        embed = {}
        for name, emb in (("clip_rn50x4_288", clip),
                          ("standin_224", standin)):
            for k, v in imgs.items():
                best, ms = _best_ms(lambda: emb.embed_array(v), dev=dev)
                embed[f"{name} {k}"] = {"best_ms": best, "ms": ms}
        out["embed"] = embed
        out["clip_embed_profile"] = profile_top(
            lambda: clip.embed_array(imgs["512x384"]), dev)
        # the store as a file of the package's format (names, seqs, unit
        # vectors), loaded: filling it through insert() is quadratic (a
        # list search and a concatenate per entry, as the JAX store's)
        rng = np.random.default_rng(59)
        vecs = rng.standard_normal((S14_STORE_SIZE, S14_FEATURE))
        vecs = (vecs / np.linalg.norm(vecs, axis=1, keepdims=True)).astype(
            np.float32)
        np.savez_compressed(root / "store.npz", embeddings=vecs,
                            meta=json.dumps({
                                "names": [f"r{i}" for i in range(len(vecs))],
                                "seqs": ["denoising_nafnet"] * len(vecs),
                                "dim": S14_FEATURE, "embedder": None}))
        t0 = time.perf_counter()
        store = NumpyVectorStore.load(root / "store.npz")
        out["store_load_seconds"] = time.perf_counter() - t0
        q = clip.embed_array(imgs["512x384"])
        best, ms = _best_ms(lambda: store.query(q, topk=5), dev="cpu")
        out["query"] = {"entries": len(store), "best_ms": best, "ms": ms,
                        "top1": store.query(q, topk=1)[0]}
        fabricate_runs(root / "runs", imgs["512x384"], S14_INSERT_RUNS)
        ins = NumpyVectorStore(dim=S14_FEATURE, embedder=clip)
        t0 = time.perf_counter()
        n = insert_solved_runs(root / "runs", ins, clip)
        dt = time.perf_counter() - t0
        out["insert_solved_runs"] = {"inserted": n, "seconds": dt,
                                     "ms_per_run": dt * 1e3 / max(n, 1)}
        ok = n == S14_INSERT_RUNS and len(ins) == n
        del clip, standin
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["pass"] = bool(ok)
    return out


def centre_combiner(emb, images) -> None:
    """Centre ``emb``'s (a ``CLIPRetrievalEmbedder``) fused output on
    ``images``: the dynamic scalar off (its bias -30) and the output
    layer's bias less the mean pre-normalisation output. With random
    weights every pair of images embeds at a cosine above 0.9, so without
    this no other image falls under the graph app's 0.9 threshold."""
    import torch

    from image_restoration_agent_tpu_torch.retrieval.clip import preprocess

    cb = emb.combiner
    outs = []
    with torch.no_grad():
        cb.dynamic_scalar[3].bias.fill_(-30.0)
        for img in images:
            x = preprocess(torch.from_numpy(img).to(emb.device),
                           n_px=emb.n_px, target_ratio=emb.target_ratio)
            f = emb.clip.encode_image(x[None])
            t = emb._text_feat
            both = torch.cat([torch.relu(cb.text_projection_layer(t)),
                              torch.relu(cb.image_projection_layer(f))], -1)
            s = cb.dynamic_scalar(both)
            outs.append(cb.output_layer(torch.relu(cb.combiner_layer(both)))
                        + s * t + (1 - s) * f)
        cb.output_layer.bias -= torch.cat(outs).mean(dim=0)


def retrieval_agent(card: str, dev: str = "cuda") -> dict:
    """The fast path end to end on the agent golden input, bf16 engine with
    ``AGENT_TOOLBOXES`` (synthetic weights), f32 CLIP embedder (random
    RN50x4 + Combiner): ``local`` IRAgent runs (a warm-up, 3 timed); the
    first solved run inserted with ``insert_solved_runs``; IRAgent in
    ``clip_retrieval`` mode on that store (a warm-up with every kernel call
    form recorded, all of which agent_kernels checked, then 3 timed with
    the launch counts set to 0 just before and read just after): its plan
    must be the stored subtasks and its tools the stored tools; the graph
    app on the same store (retrieval branch, similarity >= 0.9; 3 timed)
    and on a store whose only entry is another image (depictqa branch,
    with the embedder centred on the two images; 3 timed). p50 seconds of
    each beside local mode's."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.agent import (
        IRAgent, build_default_executor, run_agent)
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.offline import (
        materialize_synthetic_weights)
    from image_restoration_agent_tpu_torch.retrieval import (
        NumpyVectorStore, RetrievalRecord)
    from image_restoration_agent_tpu_torch.train.retrieval import (
        insert_solved_runs)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        root = Path(td)
        wdir = root / "weights"
        materialize_synthetic_weights(
            wdir, ["nafnet_synth", "fbcnn_synth", "restormer_synth"])
        eng = Engine(weight_dir=wdir, device=dev, allow_random_init=False,
                     param_dtype=torch.bfloat16)
        ex = build_default_executor(engine=eng, toolboxes=AGENT_TOOLBOXES)
        img, inp = agent_input(root)
        emb = clip_embedder(dev, write_merges(root / "bpe.txt.gz"))

        def agent(out, **kw):
            t0 = time.perf_counter()
            a = IRAgent(inp, out, executor=ex, rng_seed=0,
                        with_rollback=False, silent=True, device=dev, **kw)
            if a.run() is None:
                raise RuntimeError("the agent wrote no result")
            sync()
            return (time.perf_counter() - t0,
                    json.loads(a.summary_path.read_text()))

        local = [agent(root / f"local{i}") for i in range(1 + S14_RUNS)]
        store = NumpyVectorStore(dim=S14_FEATURE, embedder=emb)
        inserted = insert_solved_runs(root / "local0", store, emb)
        stored = local[0][1]["execution_path"]

        seen: dict = {}
        with contextlib.ExitStack() as stack:
            for model in agent_models():
                forms, _ = stack.enter_context(
                    kernel_calls(eng.store.get(model)))
                seen[model] = forms
            warm = agent(root / "rwarm", evaluate_degradation_by=
                         "clip_retrieval", retrieval_store=store)
        seen = {key: f"{model} {name}" for model, forms in seen.items()
                for key, name in forms.items()}
        unchecked = unchecked_forms("agent", seen) if dev == "cuda" else []
        reset_launch_counts()
        timed = [agent(root / f"r{i}", evaluate_degradation_by=
                       "clip_retrieval", retrieval_store=store)
                 for i in range(S14_RUNS)]
        counts = launch_counts()
        traces = [_trace(s) for _, s in [warm] + timed]
        plan_ok = all(
            [p[0] for p in t["plan_initial"]] == stored["subtasks"]
            and t["execution_tools"] == stored["tools"]
            and t["execution_subtasks"] == stored["subtasks"]
            for t in traces)

        def graph(st, out):
            t0 = time.perf_counter()
            state = run_agent(inp, out, executor=ex, retrieval_store=st,
                              device=dev)
            sync()
            return time.perf_counter() - t0, state

        g_ret = [graph(store, root / f"gr{i}") for i in range(1 + S14_RUNS)]
        other = np.ascontiguousarray(img[::-1, ::-1] * 0.5 + 0.25)
        sim_raw = float(emb.embed_array(img) @ emb.embed_array(other))
        centre_combiner(emb, [img, other])
        other_store = NumpyVectorStore(dim=S14_FEATURE, embedder=emb)
        other_store.insert(RetrievalRecord("other", "dehazing_nafnet",
                                           emb.embed_array(other)))
        g_dep = [graph(other_store, root / f"gd{i}")
                 for i in range(1 + S14_RUNS)]
        ret_ok = all(s["retrieval"]["similarity"] >= 0.9
                     and "evaluation" not in s
                     and [list(p) for p in s["initial_plan"]]
                     == [list(p) for p in zip(stored["subtasks"],
                                              stored["tools"])]
                     for _, s in g_ret)
        dep_ok = all(s["retrieval"]["similarity"] < 0.9
                     and "evaluation" in s
                     and all(t is None for _, t in s["initial_plan"])
                     for _, s in g_dep)
        random_init_models = sorted(eng.random_init_models)
        del eng, ex, emb
    if dev == "cuda":
        torch.cuda.empty_cache()
    launches = {k: v for k, v in counts.items() if v}
    secs = {"local": [t for t, _ in local[1:]],
            "clip_retrieval": [t for t, _ in timed],
            "graph_retrieval": [t for t, _ in g_ret[1:]],
            "graph_depictqa": [t for t, _ in g_dep[1:]]}
    return {"phase": "retrieval_agent", "dtype": "bfloat16 engine, float32 "
            "embedder", "input": list(img.shape), "inserted": inserted,
            "stored": stored, "trace": traces[0],
            "local_plan": local[0][1]["plan"]["initial"],
            "p50_s": {k: float(np.median(v)) for k, v in secs.items()},
            "seconds": secs,
            "graph_similarity": {
                "retrieval": g_ret[0][1]["retrieval"]["similarity"],
                "depictqa": g_dep[0][1]["retrieval"]["similarity"],
                "other_image_before_centring": sim_raw},
            "launches": launches, "call_forms": len(seen),
            "unchecked_forms": unchecked,
            "random_init_models": random_init_models, "card": card,
            "pass": bool(inserted == 1 and plan_ok and ret_ok and dep_ok
                         and launches and not unchecked
                         and not random_init_models)}


def maniqa_reference_init(m, seed: int):
    """The official MANIQA's initialisation from ``seed``: timm's ViT and
    the Swin stages' ``_init_weights`` (linear weights N(0, 0.02) cut at
    two sigma, biases 0, LayerNorms 1 and 0, bias tables and the position
    embedding N(0, 0.02), CLS N(0, 1e-6)), torch's own elsewhere (the
    TABlocks, the 1x1 convs, the heads, the patch embedding: U(+-1/sqrt(
    fan_in))). With ``random_init``'s fan-in weights the activations grow
    through the first Swin stage until the second TABlocks' softmax turns
    on the last bits of float32, and the card's and the CPU's scores
    differ by about 1e-3 though both compute the same function. Returns
    ``m``."""
    import torch
    from torch import nn

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod_name, mod in m.named_modules():
            timm = mod_name.startswith(("vit.", "swintransformer"))
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, nn.Linear) and timm:
                    if name == "weight":
                        nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                              generator=gen)
                    else:
                        p.zero_()
                elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                    fan_in = mod.weight[0].numel()
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                            * fan_in ** -0.5)
                elif isinstance(mod, nn.LayerNorm):
                    p.fill_(1.0 if name == "weight" else 0.0)
                elif name in ("relative_position_bias_table", "pos_embed"):
                    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                          generator=gen)
                elif name == "cls_token":
                    p.copy_(1e-6 * torch.randn(p.shape, generator=gen))
                else:
                    raise ValueError(f"no initialisation for {name}")
    return m


def iqa_models(seed: int = 61) -> dict:
    """The learned metrics at full width with random weights (CPU modules):
    LPIPS-Alex (``random_init``, heads made non-negative), MANIQA (its
    reference's initialisation, ``maniqa_reference_init``), MUSIQ and
    CLIP-IQA's CLIP ResNet-50 without the pool's positional embedding
    (``random_init``)."""
    import torch

    from image_restoration_agent_tpu_torch.iqa.clipiqa import RN50_CONFIG
    from image_restoration_agent_tpu_torch.iqa.lpips import LPIPS
    from image_restoration_agent_tpu_torch.iqa.maniqa import MANIQA
    from image_restoration_agent_tpu_torch.iqa.musiq import MUSIQ
    from image_restoration_agent_tpu_torch.retrieval.clip import CLIPModel

    lp = random_init(LPIPS(), seed)
    with torch.no_grad():
        for k in range(5):
            w = getattr(lp, f"lin{k}").model[1].weight
            w.abs_()
    return {"lpips": lp,
            "maniqa": maniqa_reference_init(MANIQA(**S14_MANIQA), seed + 1),
            "musiq": random_init(MUSIQ(**S14_MUSIQ), seed + 2),
            "clip_rn50": random_init(CLIPModel(**(S14_RN50 or RN50_CONFIG),
                                               attnpool_pos=False),
                                     seed + 3)}


def iqa_scorers(models: dict, dev: str) -> dict:
    """Each metric's scorer on ``dev`` over copies of ``models``' weights:
    callables of (img, ref) numpy arrays -> float."""
    import copy

    import torch

    from image_restoration_agent_tpu_torch.iqa.clipiqa import ClipIQA
    from image_restoration_agent_tpu_torch.iqa.maniqa import ManiqaScorer
    from image_restoration_agent_tpu_torch.iqa.musiq import MusiqScorer

    tf = np.random.default_rng(67).standard_normal(
        (2, models["clip_rn50"].text_projection.shape[1])).astype(np.float32)
    lp = copy.deepcopy(models["lpips"]).to(dev).eval()

    @torch.no_grad()
    def lpips(img, ref):
        a, b = (torch.from_numpy(x).to(dev)[None] for x in (img, ref))
        return float(lp(a, b)[0])

    return {"lpips": lpips,
            "maniqa": ManiqaScorer(None, copy.deepcopy(models["maniqa"]),
                                   device=dev),
            "musiq": MusiqScorer(None, copy.deepcopy(models["musiq"]),
                                 device=dev),
            "clipiqa": ClipIQA(None, clip_model=copy.deepcopy(
                models["clip_rn50"]), text_features=tf, device=dev)}


def iqa_exact(card: str, dev: str = "cuda") -> dict:
    """Each learned metric at full width on random weights, f32, the card
    against the port's CPU path on the same weights and input, relative
    error <= 1e-4 on the score: LPIPS-Alex on a 256 px pair, MANIQA on two
    224 crops, MUSIQ on a 384 px image (3 scales), CLIP-IQA (RN50) native
    at 256 px."""
    import torch

    models = iqa_models()
    rng = np.random.default_rng(71)

    def img(h, w):
        return rng.random((h, w, 3), dtype=np.float32)

    a256 = img(256, 256)
    b256 = np.clip(a256 + 0.05 * rng.standard_normal(a256.shape), 0,
                   1).astype(np.float32)
    cases = {"lpips": (a256, b256), "maniqa": (img(256, 320), None),
             "musiq": (img(384, 384), None), "clipiqa": (img(256, 256),
                                                         None)}
    rows = {}
    for side, dv in (("card", dev), ("cpu", "cpu")):
        sc = iqa_scorers(models, dv)
        sc["maniqa"].n_crops = 2
        for name, (x, y) in cases.items():
            fn = sc[name]
            rows.setdefault(name, {})[side] = fn(x, y) if name == "lpips" \
                else fn(x)
        del sc
        if dv == "cuda":
            torch.cuda.empty_cache()
    for r in rows.values():
        r["rel_err"] = abs(r["card"] - r["cpu"]) / max(abs(r["cpu"]), 1e-30)
        r["pass"] = bool(r["rel_err"] <= 1e-4 and r["cpu"] != 0.0
                         and math.isfinite(r["card"]))
    return {"phase": "iqa_exact", "dtype": "float32", "scores": rows,
            "inputs": {k: list(v[0].shape) for k, v in cases.items()},
            "card": card, "pass": all(r["pass"] for r in rows.values())}


def iqa_path(card: str, dev: str = "cuda") -> dict:
    """``Scorer(("psnr", "ssim", "lpips", "maniqa", "clipiqa", "musiq"))``
    with the learned models passed in (random weights, f32) scoring a
    1920x1080 pair: ms and peak device memory per metric (each alone,
    best of 3 after a warm-up; the models' weights resident throughout),
    the six together with their peak, and a ``torch.profiler`` top-10 of
    the slowest metric."""
    import torch

    from image_restoration_agent_tpu_torch.iqa.scorer import Scorer

    metrics = ("psnr", "ssim", "lpips", "maniqa", "clipiqa", "musiq")
    models = iqa_models()
    sc = iqa_scorers(models, dev)
    lp_state = models["lpips"].state_dict()
    kw = dict(lpips_state=lp_state, clipiqa=sc["clipiqa"],
              maniqa=sc["maniqa"], musiq=sc["musiq"], device=dev)
    h, w = S14_SCORE_HW
    rng = np.random.default_rng(73)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    ref = np.stack([yy, xx, 0.5 + 0.4 * np.sin(9 * yy * xx)], -1)
    img = np.clip(ref + 0.04 * rng.standard_normal(ref.shape), 0, 1)
    ref, img = ref.astype(np.float32), img.astype(np.float32)
    per = {}
    resident = torch.cuda.memory_allocated() if dev == "cuda" else None
    for m in metrics:
        one = Scorer((m,), **kw)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        best, ms = _best_ms(lambda: one.score_arrays(img, ref), dev=dev)
        per[m] = {"best_ms": best, "ms": ms,
                  "value": one.score_arrays(img, ref)[m],
                  "peak_memory_bytes": torch.cuda.max_memory_allocated()
                  if dev == "cuda" else None}
    full = Scorer(metrics, **kw)
    full.score_arrays(img, ref)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = full.score_arrays(img, ref)
    if dev == "cuda":
        torch.cuda.synchronize()
    all_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
    slowest = max(per, key=lambda m: per[m]["best_ms"])
    one = Scorer((slowest,), **kw)
    profile = profile_top(lambda: one.score_arrays(img, ref), dev)
    del sc, full, one, models
    if dev == "cuda":
        torch.cuda.empty_cache()
    ok = all(isinstance(scores[m], float) and math.isfinite(scores[m])
             for m in metrics)
    return {"phase": "iqa_path", "dtype": "float32", "input": [h, w, 3],
            "per_metric": per, "six_ms": all_ms, "scores": scores,
            "resident_weights_bytes": resident, "peak_memory_bytes": peak,
            "slowest": slowest,
            "profile": profile, "card": card,
            "pass": bool(ok and (profile["top"] or dev != "cuda"))}


def slice14_phases(phase, card: str) -> dict:
    """Slice 14's phases in order; returns the retrieval agent's result for
    its launch counts."""
    import torch

    phase("retrieval_exact", retrieval_exact, card)
    phase("retrieval_path", retrieval_path, card)
    served = {"retrieval": phase("retrieval_agent", retrieval_agent, card)}
    retrieval_states.cache_clear()
    torch.cuda.empty_cache()
    phase("iqa_exact", iqa_exact, card)
    torch.cuda.empty_cache()
    phase("iqa_path", iqa_path, card)
    torch.cuda.empty_cache()
    return served


# ---------------------------------------------------------------------------
# slice 15: the offline pipelines (degradation synthesis, the 16-combo
# suite, the ablation grid, exploration and distillation, the weight
# converters, validate-weights, Engine.profile)

# the full suite's combos: none with "low resolution"; the 96 px suite
# images put super-resolution on every plan all the same, so the combos'
# own boxes are mostly not planned (exploration_path's one-box trees
# serve the dehazing box and HAT)
S15_FULL_COMBOS = ("rain + haze", "dark + noise",
                   "defocus blur + jpeg compression artifact")
S15_EXPLORE = ["brightening", "denoising"]
# exploration_path's one-box trees after the pair: every tool of the
# dehazing box and of the super-resolution box but DiffBIR (which
# eval_suite_full serves), so RIDCP, DehazeFormer and HAT serve at 96 px
S15_EXPLORE_BOXES = ("dehazing", "super-resolution")
S15_MAXIM_REQUEST = (720, 1280)
S15_MAXIM_PROBE = (128, 256)
S15_NAFNET_PX = 256
# path -> {call form: "model module"}: the forms eval_suite_full and
# exploration_path recorded and predicted, which eval_suite_kernels checks
S15_FORMS: dict = {}


def _sync(dev: str) -> None:
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def recording_engine(dev: str = "cuda"):
    """``Engine(device=dev)`` (f32, the registry's random init: the engine
    ``build_default_executor`` makes) whose every model gets the
    ``kernel_calls`` hooks as it loads; yields (engine, {model: forms})."""
    from image_restoration_agent_tpu_torch.engine import Engine

    eng = Engine(device=dev)
    seen: dict = {}
    loader = eng.store._loader
    with contextlib.ExitStack() as stack:
        def hooked(name):
            model = loader(name)
            seen[name], _ = stack.enter_context(kernel_calls(model))
            return model

        eng.store._loader = hooked
        yield eng, seen


def record_forms(path: str, eng, seen: dict) -> tuple:
    """Put the call forms ``seen`` on ``path`` and their prediction (each
    (model, request size) in the engine's call log traced on the meta
    device at the canvas ``served_canvas`` gives it; DiffBIR at one
    sampler step, which makes every step's forms) in ``S15_FORMS``;
    returns (the engine's (model, h, w) requests, the forms seen, the
    forms predicted, the seen forms the prediction missed)."""
    served = sorted({(c["model"], c["h"], c["w"]) for c in eng.call_log})
    predicted: dict = {}
    for model, h, w in served:
        kw = {"num_steps": 1} if model == "diffbir" else {}
        forms, _ = traced_calls(model, served_canvas(model, h, w), **kw)
        for key, name in forms.items():
            predicted.setdefault(key, f"{model} {name}")
    seen = {key: f"{model} {name}" for model, forms in seen.items()
            for key, name in forms.items()}
    untraced = [f"{name}: {key}" for key, name in seen.items()
                if key not in predicted]
    earlier = {k for forms in S15_FORMS.values() for k in forms}
    S15_FORMS[path] = {k: v for k, v in {**predicted, **seen}.items()
                       if k not in earlier}
    return served, seen, predicted, untraced


def degrade_exact(card: str) -> dict:
    """The 16 combos, one ``synthetic_hq`` image each, through
    ``synthesize_combo`` on the card and on the CPU from the same seed:
    equal images, except ``lowres``'s, at most one level apart on at most
    0.1% of the pixels (the MATLAB-bicubic sums run in another order)."""
    import torch

    from image_restoration_agent_tpu_torch.data import synthesize_combo
    from image_restoration_agent_tpu_torch.offline.benchmark_suite import (
        ALL_COMBOS, synthetic_hq)

    hqs = synthetic_hq(len(ALL_COMBOS), seed=0)
    cases, secs, ok = [], {"cuda": 0.0, "cpu": 0.0}, True
    for i, (combo, hq) in enumerate(zip(ALL_COMBOS, hqs)):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[dev] = synthesize_combo(hq, combo,
                                        rng=np.random.default_rng(i),
                                        device=dev)
            torch.cuda.synchronize()
            secs[dev] += time.perf_counter() - t0
        same_shape = out["cuda"].shape == out["cpu"].shape
        d = (np.abs(out["cuda"].astype(np.int16)
                    - out["cpu"].astype(np.int16)) if same_shape
             else np.full(1, 255))
        frac = float((d > 0).mean())
        lowres = "low resolution" in combo
        good = same_shape and (
            (int(d.max()) <= 1 and frac <= 1e-3) if lowres
            else int(d.max()) == 0)
        ok = ok and good
        cases.append({"combo": combo, "shape": list(out["cuda"].shape),
                      "max_diff": int(d.max()), "diff_frac": frac,
                      "pass": bool(good)})
    return {"phase": "degrade_exact", "cases": cases,
            "cuda_seconds": secs["cuda"], "cpu_seconds": secs["cpu"],
            "cv2": _cv2_version(), "card": card, "pass": bool(ok)}


def _cli(args: list, timeout: int = 900) -> tuple:
    """``python -m image_restoration_agent_tpu_torch.cli <args>`` in a
    fresh process (it loads the kernels this process built): (completed
    process, seconds, its last stdout line as JSON or None)."""
    cmd = [sys.executable, "-m", "image_restoration_agent_tpu_torch.cli"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd + args, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    try:
        rec = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        rec = None
    return r, secs, rec


def _suite_results(work: Path) -> tuple:
    """(result dir, ground-truth dir) of a suite's work dir: each case's
    agent result and its ``hq.png`` copied under the case's name, the
    layout ``score`` pairs by file name."""
    import shutil

    res, gt = work / "_score" / "res", work / "_score" / "gt"
    res.mkdir(parents=True, exist_ok=True)
    gt.mkdir(parents=True, exist_ok=True)
    for case in sorted(work.glob("case_*")):
        result = next(case.glob("runs/*/result.png"))
        shutil.copy(result, res / f"{case.name}.png")
        shutil.copy(case / "hq.png", gt / f"{case.name}.png")
    return res, gt


def eval_suite_fast(card: str) -> dict:
    """``cli eval-suite --combos 16 --device cuda`` in a fresh process (the
    tiny fast executor, as the JAX CLI's default ``--fast``): 16 records,
    a plan each, ``report.json`` and ``report.md``. The same suite on the
    CPU in this process: equal plans, executed subtasks and tool calls,
    PSNR within 0.05 dB, SSIM within 1e-3. Then ``compute_scores`` of the
    card suite's results against its ``hq.png``s on the card and on the
    CPU, within 1e-6 relative."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.offline.benchmark_suite import (
        run_suite)
    from image_restoration_agent_tpu_torch.offline.eval_harness import (
        compute_scores)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        work = Path(td) / "suite"
        r, card_s, rec = _cli(["eval-suite", "--combos", "16", "--device",
                               "cuda", "--work-dir", str(work)])
        report = json.loads((work / "report.json").read_text()) \
            if (work / "report.json").exists() else {"records": []}
        recs = report["records"]
        torch.set_num_threads(8)
        t0 = time.perf_counter()
        cpu = run_suite(Path(td) / "cpu", fast=True, device="cpu")
        cpu_s = time.perf_counter() - t0
        diffs = []
        for a, b in zip(recs, cpu["records"]):
            diffs.append({
                "combo": a["combo"],
                "same_trace": all(a[k] == b[k] for k in
                                  ("plan", "executed", "n_invocations")),
                "psnr_diff": max(abs(a[k] - b[k]) for k in
                                 ("input_psnr", "output_psnr")),
                "ssim_diff": max(abs(a[k] - b[k]) for k in
                                 ("input_ssim", "output_ssim"))})
        split = _fast_case_split(work / "case_001" / "lq.png",
                                 Path(td) / "split")
        res, gt = _suite_results(work)
        t0 = time.perf_counter()
        s_card = compute_scores(res, gt, device="cuda")
        score_card_s = time.perf_counter() - t0
        s_cpu = compute_scores(res, gt, device="cpu")
        rel = max(abs(s_card["per_image"][n][m] - v) / max(abs(v), 1e-12)
                  for n, s in s_cpu["per_image"].items()
                  for m, v in s.items())
        ok = (r.returncode == 0 and rec is not None and rec["cases"] == 16
              and len(recs) == 16 and all(x["plan"] for x in recs)
              and (work / "report.md").exists()
              and len(diffs) == 16 and all(
                  d["same_trace"] and d["psnr_diff"] <= 0.05
                  and d["ssim_diff"] <= 1e-3 for d in diffs)
              and s_card["n"] == 16 and rel <= 1e-6)
        return {"phase": "eval_suite_fast", "cli": rec,
                "rc": r.returncode, "stderr_tail": r.stderr[-600:],
                "seconds": card_s, "cpu_seconds": cpu_s,
                "mean_input_psnr": report.get("mean_input_psnr"),
                "mean_output_psnr": report.get("mean_output_psnr"),
                "plans": [x["plan"] for x in recs],
                "tool_calls": [x["n_invocations"] for x in recs],
                "card_vs_cpu": diffs, "score_seconds": score_card_s,
                "score_rel_err": rel, "score_mean": s_card["mean"],
                "case_001_split": split, "card": card, "pass": bool(ok)}


def _fast_case_split(inp: Path, out: Path) -> dict:
    """The suite's first case once more in this process on the card (the
    tiny executor, warmed by one run) under torch.profiler: wall seconds
    and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_restoration_agent_tpu_torch.agent import (
        IRAgent, build_default_executor)

    ex = build_default_executor(fast=True, device="cuda")
    IRAgent(inp, out / "warm", executor=ex, device="cuda").run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        IRAgent(inp, out / "run", executor=ex, device="cuda").run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = profile_summary(prof, wall, 0)["device_busy_ms"]
    return {"wall_s": wall, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "host_share": 1.0 - busy / (wall * 1e3)}


def eval_suite_full(card: str, dev: str = "cuda") -> dict:
    """``run_suite`` on ``build_default_executor`` as shipped (the
    DEFAULT_TOOLBOXES over ``Engine(device="cuda")``: full width, f32,
    the registry's random init) on ``S15_FULL_COMBOS``, one 96 px image
    each. Per case: the plan, the tools called, its seconds (DiffBIR's
    apart; the host seconds in the classifier, PNG I/O and the engine's
    requests, as ``agent_split`` counts them), each kernel's launches
    (every count set to 0 just before the case's agent and read just
    after). The suite's first DiffBIR call runs under torch.profiler with
    the device's activity alone (``diffbir_profile``: busy share, top
    kernels); the profiler's processing after the call is taken out of
    the case's seconds. Every model's kernel call forms are
    recorded as it serves; the meta-device trace of each (model, request
    size) the engine served (``served_canvas``) must predict them all.
    eval_suite_kernels then checks every form."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_restoration_agent_tpu_torch.agent import (
        IRAgent, build_default_executor)
    from image_restoration_agent_tpu_torch.offline import benchmark_suite

    from image_restoration_agent_tpu_torch.agent import (evaluators,
                                                         executor, iragent)
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.iqa.classifier import (
        SeverityEvaluator)

    cases = []
    acc = {"classifier_s": 0.0, "png_io_s": 0.0, "engine_s": 0.0}
    dprof: dict = {"processing_s": 0.0}
    serve = Engine.restore_array

    def profiled(self, img, name, *a, **kw):
        if name != "diffbir" or "wall_ms" in dprof or dev != "cuda":
            return serve(self, img, name, *a, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = serve(self, img, name, *a, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dprof.update(profile_summary(prof, wall, 12),
                     input=list(np.shape(img)))
        dprof["processing_s"] = time.perf_counter() - t0 - wall
        return res
    wrapped = [(SeverityEvaluator, "logits", "classifier_s"),
               (Engine, "restore_array", "engine_s")] + [
        (mod, fn, "png_io_s") for mod, fns in (
            (executor, ("load_image", "save_image")),
            (evaluators, ("load_image",)), (iragent, ("load_image",)))
        for fn in fns]
    with recording_engine(dev) as (eng, seen), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        ex = build_default_executor(engine=eng)

        class CaseAgent(IRAgent):
            def run(self):
                before = {f"{t.subtask}/{t.tool_name}": (t.invocations,
                                                          t.total_seconds)
                          for ts in ex.toolbox_router.values() for t in ts}
                acc0 = dict(acc)
                proc0 = dprof["processing_s"]
                reset_launch_counts()
                t0 = time.perf_counter()
                out = super().run()
                _sync(dev)
                proc = dprof["processing_s"] - proc0
                secs = time.perf_counter() - t0 - proc
                counts = launch_counts()
                tools = {}
                for ts in ex.toolbox_router.values():
                    for t in ts:
                        k = f"{t.subtask}/{t.tool_name}"
                        n0, s0 = before[k]
                        if t.invocations > n0:
                            tools[k] = {"calls": t.invocations - n0,
                                        "seconds": t.total_seconds - s0 - (
                                            proc if k.endswith("/diffbir")
                                            else 0.0)}
                acc["engine_s"] -= proc
                summary = json.loads(self.summary_path.read_text())
                cases.append({
                    "plan": summary["plan"]["initial"],
                    "executed": summary["execution_path"]["subtasks"],
                    "tools": summary["execution_path"]["tools"],
                    "tool_calls": summary["n_invocations"],
                    "seconds": secs,
                    "diffbir_seconds": tools.get(
                        "super-resolution/diffbir", {}).get("seconds", 0.0),
                    "tool_seconds": tools,
                    "host_split": {k: acc[k] - acc0[k] for k in acc},
                    "launches": {k: v for k, v in counts.items() if v}})
                return out

        benchmark_suite.IRAgent = CaseAgent
        Engine.restore_array = profiled
        saved = [(o, n, _wrap_seconds(o, n, acc, k)) for o, n, k in wrapped]
        try:
            t0 = time.perf_counter()
            report = benchmark_suite.run_suite(
                Path(td), combos=list(S15_FULL_COMBOS), executor=ex,
                device=dev)
            suite_s = time.perf_counter() - t0
        finally:
            benchmark_suite.IRAgent = IRAgent
            for o, n, fn in saved:
                setattr(o, n, fn)
            Engine.restore_array = serve
        suite_s -= dprof["processing_s"]
        served, seen, predicted, untraced = record_forms("eval_suite", eng,
                                                         seen)
    totals: dict = {}
    for c, r in zip(cases, report["records"]):
        c.update(combo=r["combo"], input_psnr=r["input_psnr"],
                 output_psnr=r["output_psnr"])
        for k, v in c["launches"].items():
            totals[k] = totals.get(k, 0) + v
    if "wall_ms" in dprof:
        dprof["k3_ms"] = _share(dprof, "conv3x3")
    ok = (len(cases) == len(S15_FULL_COMBOS)
          and all(c["plan"] and c["tool_calls"] > 0 for c in cases)
          and totals.get("conv3x3", 0) > 0 and not untraced)
    return {"phase": "eval_suite_full", "dtype": "float32",
            "toolboxes": "DEFAULT_TOOLBOXES", "input": [96, 96, 3],
            "seconds": suite_s, "cases": cases, "diffbir_profile": dprof,
            "mean_input_psnr": report["mean_input_psnr"],
            "mean_output_psnr": report["mean_output_psnr"],
            "served": [list(x) for x in served],
            "call_forms": len(seen), "predicted_forms": len(predicted),
            "form_kinds": sorted({k[0] for k in seen}),
            "untraced_forms": untraced, "launches": totals, "card": card,
            "pass": bool(ok)}


def hat_strip_cases(key, name: str, path: str, dtype, randn,
                    quick: bool) -> list[dict]:
    """A strip-route HAT block's kernels at its form: ``swin_attn_block``
    (K1, K2, K1; with the mask bank where the block shifts), ``roll2d``
    back by the shift, and ``mlp_block``."""
    import torch

    from image_restoration_agent_tpu_torch.ops.roll2d import (roll2d,
                                                              roll2d_plain)
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        mlp_block, mlp_block_plain, prepare_swin_params, swin_attn_block,
        swin_attn_block_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        shift_attention_mask)

    _, shape, heads, ws, dc, banked, hid = key
    b, h, w, c = (1, 2 * ws, 4 * ws, shape[3]) if quick else shape
    wts = swin_weights(randn, c, heads, ws, hid)
    p = prepare_swin_params(**wts, num_heads=heads, ws=ws, dtype=dtype)
    p32 = prepare_swin_params(**wts, num_heads=heads, ws=ws,
                              dtype=torch.float32)
    n, t = ws * ws, b * h * w
    x32 = randn(b, h, w, c)
    bank = torch.from_numpy(shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n)).to(x32.device) \
        if banked else None
    x = x32.to(dtype)
    kw = dict(num_heads=heads, ws=ws, dc=dc, mask_bank=bank,
              fast=dtype == torch.bfloat16)
    es = 4 if dtype == torch.float32 else 2
    var = f"{path} {name} {b}x{h}x{w} C{c} dc={dc}" + (
        ",bank" if banked else "")
    tok32 = randn(t, c)
    tok = tok32.to(dtype)
    cases = [dict(
        name="swin_attn_block", path=path, variant=var,
        kernel=lambda: swin_attn_block(x, p, **kw),
        plain=lambda: swin_attn_block_plain(x, p, **kw),
        ref32=lambda: swin_attn_block_plain(x32, p32, **kw), library=None,
        flops=2 * t * c * 3 * c + 2 * t * c * c + 4 * t * n * c,
        nbytes=2 * t * c * es + 4 * c * c * es + p.rpb.numel() * 4, reps=3),
        dict(name="mlp_block", path=path, variant=var,
             kernel=lambda: mlp_block(tok, *p.mlp),
             plain=lambda: mlp_block_plain(tok, *p.mlp),
             ref32=lambda: mlp_block_plain(tok32, *p32.mlp), library=None,
             reps=3, flops=4 * t * c * hid,
             nbytes=2 * t * c * es + 2 * c * hid * es)]
    if banked:
        shift = -dc
        cases.append(dict(
            name="roll2d", path=path, variant=f"{var} shift={shift:+d}",
            kernel=lambda: roll2d(x, shift, ws),
            plain=lambda: roll2d_plain(x, shift, ws),
            ref32=lambda: roll2d_plain(x32, shift, ws),
            library=lambda: torch.roll(x, (shift, shift), (1, 2)),
            flops=0, nbytes=2 * t * c * es, reps=5))
    return cases


def wmsa_cases(key, name: str, path: str, dtype, randn,
               quick: bool) -> list[dict]:
    """DehazeFormer's ``wmsa`` (K2 with the logit scale) at one window
    attention's form, SDPA beside it on head-major q, k, v made before
    timing."""
    import torch

    from image_restoration_agent_tpu_torch.ops.swin_block import (
        wmsa, wmsa_plain)

    _, shape, heads = key
    nwb, n, c3 = (min(shape[0], 64), shape[1], shape[2]) if quick \
        else shape
    c, hd = c3 // 3, c3 // 3 // heads
    q32 = randn(nwb, n, c3)
    rpb = randn(heads, n, n, scale=0.5)
    qkv = q32.to(dtype)
    qh, kh, vh = (qkv.reshape(nwb, n, 3, heads, hd)
                  .permute(2, 0, 3, 1, 4).contiguous())
    am = rpb[None].to(dtype)
    es = 4 if dtype == torch.float32 else 2
    return [dict(
        name="wmsa", path=path, variant=f"{path} {name} nWB {nwb} N {n} "
        f"C {c} heads {heads}",
        kernel=lambda: wmsa(qkv, rpb, None, num_heads=heads),
        plain=lambda: wmsa_plain(qkv, rpb, None, num_heads=heads),
        ref32=lambda: wmsa_plain(q32, rpb, None, num_heads=heads),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=am, scale=hd ** -0.5),
        flops=4 * nwb * n * n * c,
        nbytes=nwb * n * 4 * c * es + rpb.numel() * 4, reps=5)]


def eval_suite_kernels(quick: bool, seed: int = 67) -> list[dict]:
    """Every call form eval_suite_full and exploration_path recorded or
    predicted (``S15_FORMS``), its kernels against their plain versions in
    float32, the dtype those paths run (small shapes with --quick, where
    the forms are the prediction of Restormer and SwinIR-denoise-15 on a
    96 px request)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    # drawn on the card (the CPU's generator, about 0.1 s per 1e7 values,
    # took much of a phase at the request shapes)
    dgen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=dgen, device=dev) * scale

    paths = dict(S15_FORMS)
    if not paths:  # --quick: no path ran
        forms = {}
        for model in ("restormer", "swinir_denoise_15"):
            f, _ = traced_calls(model, served_canvas(model, 96, 96))
            forms.update({k: f"{model} {v}" for k, v in f.items()})
        paths = {"eval_suite": forms}
    rows = []
    for path, forms in paths.items():
        cases = form_cases(path, forms, torch.float32, randn, gen, quick,
                           reps=3)
        rows += [check_case(cs, torch.float32) for cs in cases]
        del cases
    return rows


def ablation_grid(card: str) -> dict:
    """``cli ablation-grid --combos 2 --device cuda`` in a fresh process:
    the six variants and seven paired comparisons, ``ablation_grid.json``
    and ``.md`` written."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        work = Path(td) / "grid"
        r, secs, rec = _cli(["ablation-grid", "--combos", "2", "--device",
                             "cuda", "--work-dir", str(work)])
        grid = json.loads((work / "ablation_grid.json").read_text()) \
            if (work / "ablation_grid.json").exists() else {}
        md = (work / "ablation_grid.md").exists()
    ok = (r.returncode == 0 and rec is not None
          and len(rec["variants"]) == 6 and len(rec["pairs"]) == 7
          and grid == {"variants": rec["variants"], "pairs": rec["pairs"]}
          and md)
    return {"phase": "ablation_grid", "seconds": secs, "rc": r.returncode,
            "variants": rec and rec["variants"],
            "pairs": rec and rec["pairs"], "stderr_tail": r.stderr[-600:],
            "card": card, "pass": bool(ok)}


def exploration_path(card: str, dev: str = "cuda") -> dict:
    """``exhaust_sequences`` on [brightening, denoising] over
    ``build_default_executor(device="cuda")`` (3 and 6 tools) on a 96 px
    suite image: 3 + 6 + 18 + 18 = 45 tool calls, nodes and leaves as
    ``expected_tree_counts`` says; then ``explore_fail_rates`` with the v4
    classifier on the card and ``distill_experience`` with MockLLM. Then a
    one-box tree for each of ``S15_EXPLORE_BOXES`` on the same engine and
    image: one call for each tool of the default box (DiffBIR left out).
    The launch counts are set to 0 before the pair and read after the
    boxes; every kernel call form is among eval_suite_kernels' checked
    ones."""
    import tempfile

    from image_restoration_agent_tpu_torch.agent import (
        LocalEvaluator, build_default_executor)
    from image_restoration_agent_tpu_torch.agent.executor import (
        DEFAULT_TOOLBOXES)
    from image_restoration_agent_tpu_torch.agent.llm import MockLLM
    from image_restoration_agent_tpu_torch.core.io import save_image
    from image_restoration_agent_tpu_torch.offline import (
        distill_experience, exhaust_sequences, expected_tree_counts,
        explore_fail_rates)
    from image_restoration_agent_tpu_torch.offline.benchmark_suite import (
        synthetic_hq)

    with recording_engine(dev) as (eng, seen), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        ex = build_default_executor(engine=eng)
        counts_t = [len(ex.toolbox_router[s]) for s in S15_EXPLORE]
        want = expected_tree_counts(counts_t)
        src = Path(td) / "in.png"
        save_image(synthetic_hq(1, seed=5)[0].astype(np.float32) / 255, src)
        reset_launch_counts()
        t0 = time.perf_counter()
        leaves = exhaust_sequences(src, Path(td) / "tree", S15_EXPLORE, ex)
        _sync(dev)
        tree_s = time.perf_counter() - t0
        counts = launch_counts()
        nodes = len(list((Path(td) / "tree").rglob("0-img/output.png")))
        calls = sum(t.invocations for ts in ex.toolbox_router.values()
                    for t in ts)
        t0 = time.perf_counter()
        rates = explore_fail_rates(Path(td) / "tree",
                                   LocalEvaluator(device=dev),
                                   S15_EXPLORE)
        rates_s = time.perf_counter() - t0
        exp = distill_experience(rates, MockLLM(),
                                 Path(td) / "schedule_experience.json")
        ex1 = build_default_executor(engine=eng, toolboxes={
            b: [e for e in DEFAULT_TOOLBOXES[b] if e[0] != "diffbir"]
            for b in S15_EXPLORE_BOXES})
        boxes = {}
        for b in S15_EXPLORE_BOXES:
            t0 = time.perf_counter()
            got = exhaust_sequences(src, Path(td) / b.replace(" ", "_"), [b],
                                    ex1)
            _sync(dev)
            tools = ex1.toolbox_router[b]
            boxes[b] = {"tools": [t.tool_name for t in tools],
                        "leaves": len(got),
                        "tool_calls": sum(t.invocations for t in tools),
                        "seconds": time.perf_counter() - t0}
        all_counts = launch_counts()
        served, seen, predicted, untraced = record_forms("exploration", eng,
                                                         seen)
    ok = (len(leaves) == want["leaves"] and nodes == want["nodes"]
          and calls == want["nodes"] == 45 and len(rates) == 2
          and all(r["n"] == want["leaves"] // 2 for r in rates.values())
          and exp["raw"] and exp["distilled"] and not untraced
          and counts["conv3x3"] > 0
          and all(x["leaves"] == x["tool_calls"] == len(x["tools"]) > 0
                  for x in boxes.values()))
    return {"phase": "exploration_path", "subtasks": S15_EXPLORE,
            "tool_counts": counts_t, "expected": want, "leaves": len(leaves),
            "nodes": nodes, "tool_calls": calls, "tree_seconds": tree_s,
            "fail_rates": rates, "fail_rate_seconds": rates_s,
            "distilled_chars": len(exp["distilled"]), "boxes": boxes,
            "served": [list(x) for x in served],
            "pair_launches": {k: v for k, v in counts.items() if v},
            "launches": {k: v for k, v in all_counts.items() if v},
            "call_forms": len(seen), "predicted_forms": len(predicted),
            "untraced_forms": untraced, "card": card, "pass": bool(ok)}


def validate_synthetic_phase(card: str) -> dict:
    """``cli validate-weights --synthetic --device cuda`` in a fresh
    process: the four committed goldens rebuilt as ``.pth``, converted
    through the port's ``convert_checkpoint`` and served through the tiled
    path, each at or above its recorded PSNR - 0.1 dB; then ``validate``
    on a directory without ``dehaze_300k.pth``: xrestormer ``missing``."""
    import tempfile

    from image_restoration_agent_tpu_torch.offline.validate_weights import (
        validate)

    r, secs, rec = _cli(["validate-weights", "--synthetic", "--device",
                         "cuda"])
    records = (rec or {}).get("records", [])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        (Path(td) / "ckpts").mkdir()
        rep = validate(Path(td) / "ckpts", Path(td) / "w",
                       models=["xrestormer"], device="cuda")
    names = sorted(x["golden"] for x in records)
    ok = (r.returncode == 0 and names == ["fbcnn_synth", "nafnet_synth",
                                          "restormer_synth",
                                          "swinir_sr_x4_synth"]
          and all(x["status"] == "pass" and x["shape_ok"]
                  and x["golden_psnr_db"] >= x["want_db"] - 0.1
                  for x in records)
          and [x["status"] for x in rep["records"]] == ["missing"])
    return {"phase": "validate_synthetic", "seconds": secs,
            "rc": r.returncode, "records": records,
            "xrestormer": rep["records"], "stderr_tail": r.stderr[-600:],
            "card": card, "pass": bool(ok)}


def maxim_official(state: dict, cfg: dict) -> dict:
    """The official checkpoint's flat ``<module>/<param>`` leaves of a
    port MAXIM state dict: each name mapped back through the name map
    (the JAX package's module path, then the upstream one) and each
    tensor back to its Flax layout (Conv (kh, kw, I, O), Dense (I, O),
    ConvTranspose (kh, kw, I, O) with both taps flipped, LayerNorm
    ``scale``)."""
    from image_restoration_agent_tpu_torch.convert.maxim_rules import (
        maxim_name_map)

    back = {v: k for k, v in maxim_name_map(**cfg).items()}
    out = {}
    for key, t in state.items():
        w = t.numpy() if hasattr(t, "numpy") else np.asarray(t)
        mod, leaf = key.rsplit(".", 1)
        mod = mod.replace(".", "/")
        jmod = mod if mod in back else mod + "/Conv_0"
        transposed = re.fullmatch(r"y_up|stage\d+_dec\d+_up",
                                  mod.split("/")[-1])
        if leaf == "bias":
            name = "bias"
        elif w.ndim == 1:
            name = "scale"
        else:
            name = "kernel"
            if transposed:
                w = np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))
            elif w.ndim == 4:
                w = np.transpose(w, (2, 3, 1, 0))
            else:
                w = w.T
        out[f"{back[jmod]}/{name}"] = np.ascontiguousarray(w, np.float32)
    return out


def convert_maxim_phase(card: str) -> dict:
    """An official-named MAXIM-S3 ``.npz`` (``opt/target/`` leaves of
    torch's own init, ``zoo_state``, mapped back to the upstream names and
    Flax layouts) through ``cli convert-weights maxim_s3 --ckpt``: the
    written state equals the drawn one. ``Engine(weight_dir=...,
    allow_random_init=False)`` serves a 1280x720 request from it in f32;
    the card against the port's CPU path on the same weights on a 256x128
    probe, >= 60 dB."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.convert.maxim_rules import (
        name_map_config)
    from image_restoration_agent_tpu_torch.convert.torch_import import (
        read_state)
    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.models import get_spec

    state = zoo_state("maxim_s3")
    flat = maxim_official(state, name_map_config(get_spec("maxim_s3")
                                                 .config))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        npz = Path(td) / "maxim_s3_dehazing_sots-indoor.npz"
        np.savez(npz, **{f"opt/target/{k}": v for k, v in flat.items()},
                 **{"opt/state/step": np.zeros((), np.int64)})
        r, conv_s, rec = _cli(["convert-weights", "maxim_s3", "--ckpt",
                               str(npz), "--out", str(Path(td) / "w")])
        written = read_state(Path(td) / "w" / "maxim_s3.npz") \
            if r.returncode == 0 else {}
        same = written.keys() == state.keys() and all(
            np.array_equal(written[k], np.asarray(state[k]))
            for k in state)
        eng = Engine(weight_dir=Path(td) / "w", device="cuda",
                     allow_random_init=False)
        img = np.random.default_rng(8).random((*S15_MAXIM_REQUEST, 3),
                                              dtype=np.float32)
        warm = eng.restore_array(img, "maxim_s3")
        reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.restore_array(img, "maxim_s3")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        probe = np.random.default_rng(9).random((*S15_MAXIM_PROBE, 3),
                                                dtype=np.float32)
        card32 = _probe("maxim_s3", written, probe, "cuda", "float32")
        torch.set_num_threads(8)
        cpu32 = _probe("maxim_s3", written, probe, "cpu", "float32")
    db = range_psnr(card32, cpu32)
    ok = (r.returncode == 0 and rec is not None and same
          and res.image.shape == (*S15_MAXIM_REQUEST, 3)
          and res.nonfinite == 0 and not res.random_init
          and counts["conv3x3"] > 0 and db >= 60.0)
    return {"phase": "convert_maxim", "official_leaves": len(flat),
            "convert_seconds": conv_s, "cli": rec, "rc": r.returncode,
            "state_equal": bool(same), "dtype": "float32",
            "input": list(img.shape), "warmup_seconds": warm.seconds,
            "seconds": secs,
            "launches": {k: v for k, v in counts.items() if v},
            "probe": list(probe.shape), "f32_card_vs_cpu_db": db,
            "floor_db": 60.0, "stderr_tail": r.stderr[-600:], "card": card,
            "pass": bool(ok)}


def engine_profile(card: str) -> dict:
    """``with eng.profile(dir):`` around one NAFNet 256 px request (the
    nafnet_synth weights, f32): the Chrome trace is written under the
    directory and names K3's kernel."""
    import tempfile

    from image_restoration_agent_tpu_torch.engine import Engine
    from image_restoration_agent_tpu_torch.offline import (
        materialize_synthetic_weights)

    img = np.random.default_rng(10).random((S15_NAFNET_PX, S15_NAFNET_PX,
                                            3), dtype=np.float32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        materialize_synthetic_weights(Path(td) / "w", ["nafnet_synth"])
        eng = Engine(weight_dir=Path(td) / "w", device="cuda",
                     allow_random_init=False)
        eng.restore_array(img, "nafnet")
        reset_launch_counts()
        t0 = time.perf_counter()
        with eng.profile(Path(td) / "prof") as e:
            res = e.restore_array(img, "nafnet")
        secs = time.perf_counter() - t0
        counts = launch_counts()
        trace = eng.last_trace
        events = json.loads(trace.read_text())["traceEvents"] \
            if trace and trace.exists() else []
    kernels = sorted({ev["name"][:60] for ev in events
                      if ev.get("cat") == "kernel"})
    k3 = [k for k in kernels if "conv3x3" in k]
    ok = (trace is not None and trace.parent.name == "prof" and events
          and k3 and counts["conv3x3"] > 0 and res.nonfinite == 0)
    return {"phase": "engine_profile", "seconds": secs,
            "trace_events": len(events), "device_kernels": len(kernels),
            "k3_kernels": k3, "launches": {k: v for k, v in counts.items()
                                           if v},
            "card": card, "pass": bool(ok)}


def slice15_phases(phase, card: str) -> dict:
    """Slice 15's phases in order; returns (each path's result:
    ``eval_suite``, ``exploration``, ``maxim_convert``, ``engine_profile``,
    for its launch counts; eval_suite_kernels' rows)."""
    import torch

    phase("degrade_exact", degrade_exact, card)
    phase("eval_suite_fast", eval_suite_fast, card)
    torch.cuda.empty_cache()
    S15_FORMS.clear()
    served = {"eval_suite": phase("eval_suite_full", eval_suite_full, card)}
    torch.cuda.empty_cache()
    served["exploration"] = phase("exploration_path", exploration_path, card)
    torch.cuda.empty_cache()
    rows = phase("eval_suite_kernels", eval_suite_kernels, False) or []
    phase("ablation_grid", ablation_grid, card)
    phase("validate_synthetic", validate_synthetic_phase, card)
    served["maxim_convert"] = phase("convert_maxim", convert_maxim_phase,
                                    card)
    torch.cuda.empty_cache()
    served["engine_profile"] = phase("engine_profile", engine_profile, card)
    return served, rows


# ---------------------------------------------------------------------------
# slice 16: training and parallelism

S16_MODEL = "restormer"               # full width (dim 48), the trained family
S16_BATCH, S16_CROP = 8, 128          # the JAX TrainConfig's defaults
S16_STEPS = 20
S16_EXACT = (1, 128, 3)               # batch, crop, steps on card and CPU
S16_CLS = dict(n=64, batch=32, size=224, steps=50, lr=5e-4, smooth=0.1,
               p_multi=0.75)          # the v4 recipe (train_classifier_v4)
S16_RET = dict(batch=8, steps=20, lr=1e-4)
S16_TILE = (256, 64, 16)              # NAFNet input px, tile, overlap


def _s16_images(n: int = 4, size: int = 192, seed: int = 16) -> list:
    from image_restoration_agent_tpu_torch.train.classifier import (
        procedural_corpus)
    return procedural_corpus(n, size=size, seed=seed)


def _s16_noise(patch, drng):
    """The denoising pairs the training phases learn: Gaussian sigma 25."""
    noisy = patch.astype(np.float32) + drng.normal(0, 25, patch.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _grad_err(got, want) -> float:
    """max over tensors of max|g - g_ref| / max|g_ref| (a leaf the outputs
    do not reach has no gradient on either side; on one side only, inf)."""
    errs = []
    for a, b in zip(got, want):
        if a is None or b is None:
            errs.append(0.0 if a is None and b is None else float("inf"))
            continue
        scale = float(b.abs().max()) or 1.0
        errs.append(float((a - b).abs().max()) / scale)
    return max(errs)


def train_case(name: str, variant: str, make, flops: float, nbytes: float,
               library=None, reps: int = 5, path: str = "train") -> dict:
    """One kernel at a training form, f32: ``make()`` gives (leaves,
    kernel_fn, plain_fn[, kernel_grad_fn, plain_grad_fn]), each fn mapping
    the leaf tensors to outputs. The kernel's forward (through its
    autograd function, grad enabled) against the plain version (max-abs
    <= 1e-4 x max|ref|), and every leaf's gradient from the kernel's
    backward (the plain VJP, ``ops/autograd.py``) against the plain
    version's own autograd on the card (<= 1e-5 x each gradient's max|g|),
    random cotangents on the grad fns' outputs (the kernel's own: K5's v,
    gram and sums of squares where the forward is the MDTA block); forward
    kernel ms, backward ms, the plain version's forward and backward ms.
    ``path`` names the training path whose launches the row reports."""
    import torch

    leaves, kfn, pfn, *grad_fns = make()
    out_k = kfn(*leaves)
    out_p = pfn(*leaves)
    err = float((out_k - out_p).detach().abs().max())
    tol = 1e-4 * float(out_p.detach().abs().max())
    # the gradients of the kernel's own outputs (K5's three, where the
    # case's forward is the MDTA block around it)
    kg, pg = grad_fns or (kfn, pfn)
    outs_k, outs_p = kg(*leaves), pg(*leaves)
    if not isinstance(outs_k, tuple):
        outs_k, outs_p = (outs_k,), (outs_p,)
    cot = [torch.randn_like(o) for o in outs_p]
    gk = torch.autograd.grad(outs_k, leaves, cot, retain_graph=True,
                             allow_unused=True)
    gp = torch.autograd.grad(outs_p, leaves, cot, retain_graph=True,
                             allow_unused=True)
    gerr = _grad_err(gk, gp)
    finite = bool(torch.isfinite(out_k).all()) and all(
        bool(torch.isfinite(g).all()) for g in gk if g is not None)
    row = dict(name=name, variant=variant, dtype="float32", path=path,
               route="cuda", source=SOURCE[name], replaces=REPLACES[name],
               max_abs_err=err, tolerance=tol, grad_max_rel_err=gerr,
               grad_tolerance=1e-5, leaves=len(leaves),
               grad_of="front" if grad_fns else "output")
    row["pass"] = err <= tol and gerr <= 1e-5 and finite
    with torch.no_grad():
        row["ms"] = cuda_ms(lambda: kfn(*leaves), reps)
        row["plain_ms"] = cuda_ms(lambda: pfn(*leaves), 2)
        row["library_ms"] = (cuda_ms(library, reps) if library is not None
                             else None)
    row["backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        outs_k, leaves, cot, retain_graph=True, allow_unused=True), reps)
    row["plain_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        outs_p, leaves, cot, retain_graph=True, allow_unused=True), 2)
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "float32")
    emit({"phase": "kernel", **row})
    del out_k, out_p, outs_k, outs_p, gk, gp
    torch.cuda.empty_cache()
    return row


def _leaf(*shape, scale=1.0, shift=0.0, gen=None):
    import torch
    t = torch.randn(*shape, generator=gen) * scale + shift
    return t.cuda().requires_grad_(True)


def train_kernel_checks(quick: bool, seed: int = 71) -> list[dict]:
    """K3, K4 and K5 at Restormer's training forms (f32, 8 x 128 x 128 at
    crop 128; 2 x 16 x 128 with --quick): K3 at patch_embed 3->48,
    down1_2 48->24, up2_1 96->192 (64 x 64) and output 96->3, and its
    ``res``, ``ln_pre`` and ``shuffle`` (``Conv``) epilogues; K4 and K5
    (the MDTA block) at C 48 and C 96, heads 1 (encoder 1; decoder 1 and
    refinement). ``F.conv2d`` beside K3's plain forms."""
    import torch
    import torch.nn.functional as F

    from image_restoration_agent_tpu_torch.models.common import Conv
    from image_restoration_agent_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, conv3x3_weights)
    from image_restoration_agent_tpu_torch.ops.pixel_shuffle import \
        pixel_shuffle
    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        gdfn_block, gdfn_block_plain, gdfn_weights, mdta_block,
        mdta_block_plain, mdta_front, mdta_front_plain, mdta_weights)

    gen = torch.Generator().manual_seed(seed)
    b, hw = (2, 16) if quick else (S16_BATCH, S16_CROP)
    wfull = 128 if quick else hw
    rows = []
    for cname, cin, cout, s, epi in (
            ("patch_embed", 3, 48, 1, ""), ("down1_2", 48, 24, 1, ""),
            ("up2_1", 96, 192, 2, ""), ("output", 96, 3, 1, ""),
            ("output", 96, 3, 1, "res"), ("norm+conv", 48, 48, 1, "ln_pre"),
            ("up2_1", 96, 192, 2, "shuffle")):
        h, w = hw // s, wfull // s

        def make(cin=cin, cout=cout, h=h, w=w, epi=epi):
            x = _leaf(b, h, w, cin, gen=gen)
            wt = _leaf(3, 3, cin, cout, scale=(9 * cin) ** -0.5, gen=gen)
            bias = _leaf(cout, scale=0.1, gen=gen)
            k = conv3x3_weights(wt, bias, torch.float32)  # made once
            if epi == "res":
                r = _leaf(b, h, w, cout, gen=gen)
                return ([x, wt, bias, r],
                        lambda x, wt, bias, r: conv3x3(
                            x, k, res=r, params=(wt, bias)),
                        lambda x, wt, bias, r: conv3x3_plain(x, wt, bias,
                                                             res=r))
            if epi == "ln_pre":
                g, lb = _leaf(cin, scale=0.1, shift=1.0, gen=gen), \
                    _leaf(cin, scale=0.1, gen=gen)
                return ([x, wt, bias, g, lb],
                        lambda x, wt, bias, g, lb: conv3x3(
                            x, k, ln_pre=(g, lb), params=(wt, bias)),
                        lambda x, wt, bias, g, lb: conv3x3_plain(
                            x, wt, bias, ln_pre=(g, lb)))
            if epi == "shuffle":
                m = Conv(cin, cout, shuffle=2).cuda()
                with torch.no_grad():
                    m.weight.copy_(wt.detach().permute(3, 2, 0, 1))
                    m.bias.copy_(bias.detach())
                return ([x, m.weight, m.bias], lambda x, *_: m(x),
                        lambda x, wo, bo: pixel_shuffle(conv3x3_plain(
                            x, wo.permute(2, 3, 1, 0), bo), 2))
            return ([x, wt, bias],
                    lambda x, wt, bias: conv3x3(x, k, params=(wt, bias)),
                    lambda x, wt, bias: conv3x3_plain(x, wt, bias))

        library = None
        if not epi:
            xl = torch.randn(b, cin, h, w, device="cuda").contiguous(
                memory_format=torch.channels_last)
            wl = torch.randn(cout, cin, 3, 3, device="cuda").contiguous(
                memory_format=torch.channels_last)
            library = (lambda xl=xl, wl=wl: F.conv2d(xl, wl, padding=1))
        px = b * h * w
        rows.append(train_case(
            "conv3x3", f"train {cname} {b}x{h}x{w} {cin}->{cout}"
            + (f" {epi}" if epi else ""), make,
            2 * px * 9 * cin * cout,
            4 * (px * (cin + cout * (2 if epi == "res" else 1))
                 + 9 * cin * cout), library))

    for lvl, c in (("encoder1", 48), ("decoder1", 96)):
        hid = int(2.66 * c)
        p = b * hw * wfull

        def ln():
            return (_leaf(c, scale=0.1, shift=1.0, gen=gen),
                    _leaf(c, scale=0.1, gen=gen))

        def make_g(c=c, hid=hid):
            x = _leaf(b, hw, wfull, c, gen=gen)
            g = [*ln(), _leaf(c, 2 * hid, scale=c ** -0.5, gen=gen),
                 _leaf(9, 2 * hid, scale=1 / 3, gen=gen),
                 _leaf(hid, c, scale=hid ** -0.5, gen=gen)]

            def params(lw, lb, wi, wd, wo):
                return ((lw, lb), wi, None, wd, None, wo, None)

            k = gdfn_weights(*params(*g), torch.float32)
            return ([x, *g],
                    lambda x, *g: gdfn_block(x, k, fast=False,
                                             params=params(*g)),
                    lambda x, *g: gdfn_block_plain(x, *params(*g),
                                                   fast=False))

        rows.append(train_case(
            "gdfn_block", f"train {lvl} {b}x{hw}x{wfull} C{c}", make_g,
            p * (6 * c * hid + 36 * hid), 4 * (2 * p * c + 3 * c * hid)))

        def make_m(c=c):
            x = _leaf(b, hw, wfull, c, gen=gen)
            m = [*ln(), _leaf(c, 3 * c, scale=c ** -0.5, gen=gen),
                 _leaf(9, 3 * c, scale=1 / 3, gen=gen),
                 _leaf(c, c, scale=c ** -0.5, gen=gen),
                 _leaf(1, 1, 1, scale=0.1, shift=1.0, gen=gen)]

            def params(lw, lb, wq, wd, wp, t):
                return ((lw, lb), wq, None, wd, None, wp, None, t)

            k = mdta_weights(*params(*m), 1, torch.float32)
            return ([x, *m],
                    lambda x, *m: mdta_block(x, k, params(*m)),
                    lambda x, *m: mdta_block_plain(x, *params(*m), 1),
                    lambda x, *m: mdta_front(x, k, params(*m)[:5]),
                    lambda x, *m: mdta_front_plain(x, *params(*m)[:5],
                                                   num_heads=1))

        rows.append(train_case(
            "mdta_front", f"train {lvl} {b}x{hw}x{wfull} C{c} heads=1 "
            "(block)", make_m, p * (8 * c * c + 54 * c + 2 * c * c),
            4 * (2 * p * c + 4 * c * c)))
    return rows


def _trainer(dev: str, batch: int, crop: int, steps: int, work: Path):
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)
    return Trainer(build_model(S16_MODEL, device=dev, seed=0),
                   TrainConfig(total_iters=steps, batch_size=batch,
                               crop_size=crop, log_freq=1,
                               save_freq=10 ** 9, val_freq=10 ** 9),
                   work_dir=work, device=dev)


def train_exact(card: str) -> dict:
    """``S16_EXACT`` Trainer steps of ``restormer`` (full width, f32) at
    batch 1, crop 128 on the card and on the port's CPU path, from the same
    ``build_model(seed=0)`` init and the same ``paired_crop_stream``
    batches: the loss of every step within 1e-4 relative."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.train import paired_crop_stream

    b, crop, steps = S16_EXACT
    imgs = _s16_images()
    losses, secs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        for dev in ("cuda", "cpu"):
            tr = _trainer(dev, b, crop, steps, Path(td) / dev)
            t0 = time.perf_counter()
            tr.fit(paired_crop_stream(imgs, _s16_noise, b, crop, seed=0))
            _sync(dev)
            secs[dev] = time.perf_counter() - t0
            losses[dev] = [h["loss"] for h in tr.history]
            del tr
    torch.cuda.empty_cache()
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses["cuda"],
                                                  losses["cpu"]))
    return {"phase": "train_exact", "model": S16_MODEL, "batch": b,
            "crop": crop, "steps": steps, "losses_card": losses["cuda"],
            "losses_cpu": losses["cpu"], "max_rel_diff": rel,
            "tolerance": 1e-4, "seconds": secs, "card": card,
            "pass": len(losses["cuda"]) == steps and rel <= 1e-4}


def _step_split(model, lq, hq) -> dict:
    """One forward + loss and its backward (``torch.autograd.grad`` over the
    parameters, as the train step takes it) timed by CUDA events on the
    stream: ms of each and the backward's share of the two."""
    import torch

    from image_restoration_agent_tpu_torch.train import charbonnier_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    loss = charbonnier_loss(model(lq), hq)
    ev[1].record()
    torch.autograd.grad(loss, list(model.parameters()))
    ev[2].record()
    ev[2].synchronize()
    fwd, bwd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    return {"forward_ms": fwd, "backward_ms": bwd,
            "backward_share": bwd / (fwd + bwd)}


def train_path(card: str) -> dict:
    """``Trainer`` on ``restormer`` at the JAX defaults (crop 128, batch 8,
    charbonnier, lr 3e-4), f32, ``S16_STEPS`` steps of synthetic
    denoising: the median s per step over steps 5..20, the peak device
    memory, K3, K4 and K5 launches per step (every count set to 0 just
    before the steps, read just after), the loss at steps 1 and 20 (it
    must fall), one more step under torch.profiler (its top device rows)
    and one forward and backward split by CUDA events (the backward's
    share)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from image_restoration_agent_tpu_torch.train import paired_crop_stream

    stream = paired_crop_stream(_s16_images(), _s16_noise, S16_BATCH,
                                S16_CROP, seed=1)
    batches = [next(stream) for _ in range(S16_STEPS + 1)]
    marks = []

    def timed():
        for bt in batches[:S16_STEPS]:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield bt
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tr = _trainer("cuda", S16_BATCH, S16_CROP, S16_STEPS, Path(td))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state = tr.fit(timed())
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in tr.history]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.fit(iter(batches[S16_STEPS:]), state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lq, hq = (torch.from_numpy(a).cuda() for a in batches[-1])
        split = _step_split(tr.model, lq, hq)
    step_s = np.diff(marks)
    per = {k: v / S16_STEPS for k, v in counts.items() if v}
    summary = profile_summary(prof, wall, 12)
    ok = (len(losses) == S16_STEPS and losses[-1] < losses[0]
          and all(per.get(k, 0) > 0 for k in ("conv3x3", "gdfn_block",
                                               "mdta_front"))
          and all(np.isfinite(losses)))
    del tr, state
    torch.cuda.empty_cache()
    return {"phase": "train_path", "model": S16_MODEL, "dtype": "float32",
            "batch": S16_BATCH, "crop": S16_CROP, "steps": S16_STEPS,
            "median_step_s": float(np.median(step_s[4:])),
            "step_s": step_s.tolist(), "peak_mem_gb": peak / 1e9,
            "loss_step1": losses[0], "loss_step20": losses[-1],
            "launches_per_step": per, "launches": {k: v for k, v in
                                                   counts.items() if v},
            "profile": summary, "split": split, "card": card,
            "pass": bool(ok)}


def classifier_train(card: str) -> dict:
    """The classifier's data on the card against the CPU (one
    ``np.random`` Generator each): ``synthesize_multi``'s images and
    labels equal, ``build_dataset`` equal with the host's Pillow resize and
    within 1e-6 with the MATLAB resize on the device; then 50 steps of
    ``train_classifier_v3_dataset`` on the v4 recipe (``ordinal_smooth``
    0.1, lr 5e-4, batch 32, 224 px, a ``DegradationClassifierV3``) with and
    without ``device_data``, s per step, and the ``snapshot_fn`` calls."""
    import torch

    from image_restoration_agent_tpu_torch.train import classifier as tcls

    c = S16_CLS
    corpus = tcls.procedural_corpus(8, size=288, seed=7)
    ra, rb = np.random.default_rng(16), np.random.default_rng(16)
    multi_equal = True
    for img in corpus:
        (la, ya), (lb, yb) = (tcls.synthesize_multi(img, ra),
                              tcls.synthesize_multi(img, rb))
        multi_equal &= bool(np.array_equal(la, lb) and np.array_equal(ya, yb))
    t0 = time.perf_counter()
    xs, ys = tcls.build_dataset(corpus, c["n"], seed=0, size=c["size"],
                                p_multi=c["p_multi"], device="cuda")
    build_s = time.perf_counter() - t0
    xc, yc = tcls.build_dataset(corpus, c["n"], seed=0, size=c["size"],
                                p_multi=c["p_multi"], device="cpu")
    xm, ym = tcls.build_dataset(corpus, 8, seed=1, size=c["size"],
                                fast_resize=False, device="cuda")
    xmc, ymc = tcls.build_dataset(corpus, 8, seed=1, size=c["size"],
                                  fast_resize=False, device="cpu")
    resize_err = float(np.abs(xm - xmc).max())
    data_ok = (multi_equal and np.array_equal(xs, xc)
               and np.array_equal(ys, yc) and np.array_equal(ym, ymc)
               and resize_err <= 1e-6)
    runs = {}
    for device_data in (False, True):
        snaps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # device_data: chunks of 25 steps (a snapshot after the first)
        _, losses = tcls.train_classifier_v3_dataset(
            xs, ys, steps=c["steps"], batch=c["batch"], lr=c["lr"],
            ordinal_smooth=c["smooth"], snapshot_every=25,
            snapshot_fn=lambda s, step: snaps.append(step),
            device_data=device_data, log_every=25 if device_data else 0,
            device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs["device_data" if device_data else "host_batches"] = {
            "s_per_step": secs / c["steps"], "seconds": secs,
            "loss_first": losses[0], "loss_last": losses[-1],
            "snapshots": snaps, "finite": bool(np.isfinite(losses).all())}
    ok = (data_ok and all(r["finite"] for r in runs.values())
          and runs["host_batches"]["snapshots"] == [25, 50]
          and runs["device_data"]["snapshots"] == [25])
    torch.cuda.empty_cache()
    return {"phase": "classifier_train", "examples": c["n"],
            "build_dataset_s": build_s, "synthesize_multi_equal": multi_equal,
            "dataset_equal": bool(np.array_equal(xs, xc)
                                  and np.array_equal(ys, yc)),
            "matlab_resize_max_abs": resize_err, "runs": runs, "card": card,
            "pass": bool(ok)}


def retrieval_train(card: str) -> dict:
    """20 steps of ``train_retrieval_model`` (the stand-in at feature 640,
    random init from seed 0) on pairs of noisy views of 8 seeded 224 px
    images: s per step, the loss falling."""
    import torch

    from image_restoration_agent_tpu_torch.train.retrieval import \
        train_retrieval_model

    c = S16_RET
    rng = np.random.default_rng(21)
    base = rng.random((c["batch"], 224, 224, 3)).astype(np.float32)

    def pairs():
        while True:
            noise = rng.normal(0, 0.02, base.shape).astype(np.float32)
            yield base, np.clip(base + noise, 0, 1)

    t0 = time.perf_counter()
    _, losses = train_retrieval_model(pairs(), steps=c["steps"], lr=c["lr"],
                                      device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"phase": "retrieval_train", "steps": c["steps"],
            "batch": c["batch"], "s_per_step": secs / c["steps"],
            "loss_first": losses[0], "loss_last": losses[-1], "card": card,
            "pass": bool(np.isfinite(losses).all()
                         and losses[-1] < losses[0])}


def parallel_single_rank(card: str) -> dict:
    """An ``nccl`` world of one rank on the card: the hand-built
    ``make_sharded_train_step`` on a ``data x model`` mesh of 1 x 1 equals
    the ``Trainer``'s step (two steps of ``nafnet`` at 4 x 64 x 64, losses
    and parameters bit for bit); ``tiled_apply_sharded`` and
    ``tiled_apply_halo`` equal ``core.tiling.tiled_apply`` bit for bit on a
    256 x 256 NAFNet input (tile 64, overlap 16: the sharded path against
    one batch of all 25 tiles, the halo path against batches of a tile
    row); cuDNN held to its deterministic algorithms for both sides of
    each; and ``parallel.dryrun.dryrun_multichip(1)``."""
    import tempfile

    import torch
    import torch.distributed as dist

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.parallel import (
        UpdateRule, init_distributed, make_mesh, make_sharded_train_step,
        make_train_state, tiled_apply_halo, tiled_apply_sharded)
    from image_restoration_agent_tpu_torch.parallel.dryrun import (
        dryrun_multichip, free_port)
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)

    dev = init_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                           backend="nccl")
    det = torch.backends.cudnn.deterministic
    # both sides of each comparison on cuDNN's deterministic algorithms
    # (its default weight gradients sum with atomics)
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(31)
        lq = rng.random((4, 64, 64, 3), dtype=np.float32)
        hq = rng.random((4, 64, 64, 3), dtype=np.float32)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
            a = build_model("nafnet", device=dev, seed=0)
            tr = Trainer(a, TrainConfig(total_iters=2, log_freq=1),
                         work_dir=td, device=dev)
            tr.fit(iter([(lq, hq)] * 2))
        b = build_model("nafnet", device=dev, seed=0)
        tx = UpdateRule(3e-4)
        step, _, _ = make_sharded_train_step(b, tx, make_mesh(
            {"data": 1, "model": 1}))
        state = make_train_state(b, tx)
        hand = []
        for _ in range(2):
            state, loss = step(state, torch.from_numpy(lq).to(dev),
                               torch.from_numpy(hq).to(dev))
            hand.append(loss.item())
        step_equal = ([h["loss"] for h in tr.history] == hand and all(
            torch.equal(p, q) for p, q in zip(a.parameters(),
                                              b.parameters())))

        px, tile, ov = S16_TILE
        mesh = make_mesh({"tile": 1})
        img = torch.from_numpy(rng.random((px, px, 3), dtype=np.float32)
                               ).to(dev)
        with torch.no_grad():
            b.eval()
            reset_launch_counts()
            sharded = tiled_apply_sharded(b, img, mesh, tile=tile,
                                          overlap=ov, pad_multiple=8)
            halo = tiled_apply_halo(b, img, mesh, tile=tile, overlap=ov)
            counts = launch_counts()
            n = ((px - tile) // (tile - ov) + 1)
            single_all = tiled_apply(b, img, tile=tile, overlap=ov,
                                     batch=n * n, pad_multiple=8)
            single_row = tiled_apply(b, img, tile=tile, overlap=ov,
                                     batch=n, pad_multiple=1)
        diffs = {"sharded": float((sharded - single_all).abs().max()),
                 "halo": float((halo - single_row).abs().max())}
        tiles_equal = bool(torch.equal(sharded, single_all)
                           and torch.equal(halo, single_row))
        t0 = time.perf_counter()
        dry = dryrun_multichip(1)
        dry_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"phase": "parallel_single_rank", "backend": "nccl",
            "world": 1, "train_step_equal": step_equal,
            "losses": hand, "tiles_equal": tiles_equal,
            "max_abs_diff": diffs, "tile_launches": {
                k: v for k, v in counts.items() if v},
            "dryrun": dry, "dryrun_s": dry_s, "card": card,
            "pass": bool(step_equal and tiles_equal)}


def slice16_phases(phase, card: str) -> tuple:
    """Slice 16's phases in order; returns ({"train": train_path's
    result}, train_kernels' rows)."""
    import torch

    rows = phase("train_kernels", train_kernel_checks, False,
                 grad=True) or []
    torch.cuda.empty_cache()
    phase("train_exact", train_exact, card, grad=True)
    served = {"train": phase("train_path", train_path, card, grad=True)}
    phase("classifier_train", classifier_train, card, grad=True)
    phase("retrieval_train", retrieval_train, card, grad=True)
    phase("parallel_single_rank", parallel_single_rank, card, grad=True)
    return served, rows


# ---------------------------------------------------------------------------
# slice 17: Swin-family training

S17_MODEL = "swinir_sr_x4"   # SwinIR-M x4: embed 180, 6 x 6 blocks, 6 heads
S17_BATCH, S17_CROP = 8, 128  # the JAX TrainConfig's defaults (LQ 32 x 32)
S17_STEPS = 20
S17_EXACT = (2, 128, 3)       # batch, crop, steps on card and CPU
# its learning rate: at the default 3e-4 the random SwinIR-M's third loss
# moves 3.0e-4 relative between two CPU thread counts (float32 summation
# order, amplified by Adam's first sign-like steps); at 1e-4, 6e-8
S17_EXACT_LR = 1e-4
# the newly trainable families at full width, 2 Trainer steps each:
# (model, HQ crop, scale, initialisation, kernels its step must launch);
# the initialisations the serving phases give them ("registry":
# build_model's; "reference": dehazeformer_reference_init; "torch":
# torch_default_init, with which the zoo's random outputs stay near the
# image's range and IFAN's clamp does not saturate)
S17_FAMILIES = (
    ("swinir_denoise_15", 128, 1, "registry",
     ("swin_block", "token_linear", "window_attention", "conv3x3")),
    ("hat_sr_x4", 128, 4, "registry",
     ("swin_attn_block", "roll2d", "mlp_block", "window_attention",
      "conv3x3")),
    ("dehazeformer_b", 128, 1, "reference", ("wmsa", "window_attention")),
    ("ridcp", 128, 1, "torch", ("swin_block", "token_linear", "conv3x3")),
    ("xrestormer", 128, 1, "torch", ("gdfn_block", "mdta_front",
                                     "conv3x3")),
    ("mprnet", 128, 1, "torch", ("conv3x3",)),
    ("maxim_s2", 128, 1, "torch", ("conv3x3",)),
    ("maxim_s3", 128, 1, "torch", ("conv3x3",)),
    ("drbnet", 128, 1, "torch", ("conv3x3",)),
    ("ifan", 128, 1, "torch", ("conv3x3",)))


def _s17_lowres(patch, rng):
    """The SR pairs: the port's ``data/degrade.lowres`` (MATLAB bicubic
    x1/4) on the host."""
    from image_restoration_agent_tpu_torch.data.degrade import lowres
    return lowres(patch, device="cpu")


def swin_train_kernel_checks(quick: bool, seed: int = 73) -> list[dict]:
    """K1, K2, K6 and the Swin block at the Swin families' training forms
    (f32; batch 8 at crop 128, so 8 x 32 x 32 tokens at the x4 models' LR
    canvas; 2 x 16 x 16 with --quick) through their autograd functions
    (``train_case``): SwinIR-M's K1 qkv (LayerNorm + rolled gather), proj
    (gathered residual), fc1 (LayerNorm + erf-GELU) and fc2 (residual +
    scatter), its K2 with the shift bank and the bias table (N 64) and the
    whole block; HAT's K2 at window 16 (N 256) and K6 by +-8;
    DehazeFormer-b's K2 in its logit-scale mode (``wmsa``, level 0: C 24,
    2 heads, its bias differentiated); RIDCP's K1 fc2 at K 1024 (C 256)."""
    import importlib

    import torch

    from image_restoration_agent_tpu_torch.ops.roll2d import (roll2d,
                                                              roll2d_plain)
    from image_restoration_agent_tpu_torch.ops.window_attention import (
        relative_position_bias, shift_attention_mask)

    # the module (ops/__init__.py re-exports a function of its name)
    tsb = importlib.import_module(
        "image_restoration_agent_tpu_torch.ops.swin_block")
    gen = torch.Generator().manual_seed(seed)
    b, hw = (2, 16) if quick else (S17_BATCH, S17_CROP // 4)
    m = b * hw * hw
    rows = []

    def leaf(*shape, scale=1.0, shift=0.0):
        return _leaf(*shape, scale=scale, shift=shift, gen=gen)

    def k1_case(variant, c_in, c_out, ws=8, dc=0, ln=False, gelu=None,
                res=False, a_map=tsb.IDENTITY, r_map=tsb.IDENTITY,
                o_map=tsb.IDENTITY, path="swin_train"):
        geom = (b, hw, hw, ws, dc)

        def make():
            a, w = leaf(m, c_in), leaf(c_in, c_out, scale=c_in ** -0.5)
            bias = leaf(c_out, scale=0.1)
            extra = ([leaf(c_in, scale=0.1, shift=1.0), leaf(c_in, scale=0.1)]
                     if ln else []) + ([leaf(m, c_out)] if res else [])
            form = tsb.kernel_matrix(w.detach(), torch.float32)

            def split(rest):
                lnp = (rest[0], rest[1]) if ln else None
                r = rest[2 if ln else 0] if res else None
                return dict(ln=lnp, gelu=gelu, res=r, geom=geom,
                            a_map=a_map, r_map=r_map, o_map=o_map)

            return ([a, w, bias, *extra],
                    lambda a, w, bias, *rest: tsb.token_linear(
                        a, form, bias, params=w, **split(rest)),
                    lambda a, w, bias, *rest: tsb.token_linear_plain(
                        a, w, bias, **split(rest)))

        nbytes = 4 * (m * c_in + c_in * c_out + c_out + m * c_out
                      + (m * c_out if res else 0) + (2 * c_in if ln else 0))
        rows.append(train_case("token_linear", f"train {variant} {m}x{c_in}"
                               f"->{c_out}", make, 2 * m * c_in * c_out,
                               nbytes, path=path))

    c, heads = 180, 6
    k1_case("SwinIR-M qkv (LN + gather)", c, 3 * c, dc=-4, ln=True,
            a_map=tsb.GATHER)
    k1_case("SwinIR-M proj (gathered residual)", c, c, dc=-4, res=True,
            r_map=tsb.GATHER)
    k1_case("SwinIR-M fc1 (LN + erf-GELU)", c, 2 * c, ln=True, gelu="erf")
    k1_case("SwinIR-M fc2 (residual + scatter)", 2 * c, c, res=True,
            o_map=tsb.SCATTER)
    k1_case("RIDCP fc2 K1024 (residual + scatter)", 1024, 256, res=True,
            o_map=tsb.SCATTER, path="family_train")

    def k2_case(variant, ws, shift, cc, nh, path):
        n = ws * ws
        nwy = nwx = hw // ws
        bank = None
        if shift:
            bank = torch.from_numpy(shift_attention_mask(
                2 * ws, 2 * ws, ws, shift).reshape(2, 2, n, n)).cuda()
        kw = dict(num_heads=nh, nwy=nwy, nwx=nwx, fast=False)

        def make():
            qkv = leaf(m, 3 * cc)
            table = leaf((2 * ws - 1) ** 2, nh, scale=0.1)
            return ([qkv, table],
                    lambda q, t: tsb.window_attention(
                        q, relative_position_bias(t, ws), bank,
                        table=t.detach(), **kw),
                    lambda q, t: tsb.window_attention_plain(
                        q, relative_position_bias(t, ws), bank, **kw))

        # SDPA on the same q, k, v with the bias and the bank as its mask
        qh, kh, vh = torch.randn(3, m // n, nh, n, cc // nh).cuda()
        am = torch.randn(nh, n, n).cuda()[None]
        if bank is not None:
            am = am + tsb._bank_per_window(bank, nwy, nwx)[:, None]
        am = am.repeat(b, 1, 1, 1).contiguous()
        rows.append(train_case(
            "window_attention", f"train {variant} {m // n}x{n} C{cc} "
            f"heads={nh}", make, 4 * m * n * cc,
            4 * (m * 4 * cc + (2 * ws - 1) ** 2 * nh),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=am, scale=1.0), path=path))

    k2_case("SwinIR-M bank + table", 8, 4, c, heads, "swin_train")
    if hw % 16 == 0:
        k2_case("HAT window 16 bank + table", 16, 8, c, heads,
                "family_train")

    for shift in (8, -8) if hw % 16 == 0 else ():
        def make_r(shift=shift):
            x = leaf(b, hw, hw, c)
            return ([x], lambda x: roll2d(x, shift, 16),
                    lambda x: roll2d_plain(x, shift, 16))
        xl = torch.randn(b, hw, hw, c).cuda()
        rows.append(train_case("roll2d", f"train HAT {b}x{hw}x{hw}x{c} "
                               f"shift {shift:+d}", make_r, 0,
                               8 * m * c, path="family_train",
                               library=lambda xl=xl, sh=shift: torch.roll(
                                   xl, (sh, sh), (1, 2))))

    # DehazeFormer-b level 0 at crop 128: C 24, 2 heads, window 8
    dw = (2, 16) if quick else (S17_BATCH, S17_CROP)
    nwb = dw[0] * (dw[1] // 8) ** 2

    def make_w():
        qkv = leaf(nwb, 64, 72)
        rpb = leaf(2, 64, 64, scale=0.1)
        return ([qkv, rpb], lambda q, r: tsb.wmsa(q, r, num_heads=2),
                lambda q, r: tsb.wmsa_plain(q, r, num_heads=2))

    wq, wk, wv = torch.randn(3, nwb, 2, 64, 12).cuda()
    wm = torch.randn(1, 2, 64, 64).cuda()
    rows.append(train_case("wmsa", f"train DehazeFormer-b level 0 {nwb}x64 "
                           "C24 heads=2", make_w, 4 * nwb * 64 * 64 * 24,
                           4 * (nwb * 64 * 96 + 2 * 64 * 64),
                           library=lambda: torch.nn.functional
                           .scaled_dot_product_attention(
                               wq, wk, wv, attn_mask=wm, scale=12 ** -0.5),
                           path="family_train"))

    def make_block():
        x = leaf(b, hw, hw, c)
        hid = 2 * c
        ref = tsb.SwinBlockRef(
            leaf(c, scale=0.1, shift=1.0), leaf(c, scale=0.1),
            leaf(3 * c, c, scale=c ** -0.5), leaf(3 * c, scale=0.1),
            leaf(c, c, scale=c ** -0.5), leaf(c, scale=0.1),
            leaf(225, heads, scale=0.1), leaf(c, scale=0.1, shift=1.0),
            leaf(c, scale=0.1), leaf(hid, c, scale=c ** -0.5),
            leaf(hid, scale=0.1), leaf(c, hid, scale=hid ** -0.5),
            leaf(c, scale=0.1))
        form = tsb.prepare_swin_params(**ref._asdict(), num_heads=heads,
                                       ws=8, dtype=torch.float32)
        bank = torch.from_numpy(shift_attention_mask(16, 16, 8, 4).reshape(
            2, 2, 64, 64)).cuda()
        kw = dict(num_heads=heads, ws=8, dc=-4, mask_bank=bank)
        return ([x, *ref],
                lambda x, *r: tsb.swin_block(x, form, ref=tsb.SwinBlockRef(
                    *r), **kw),
                lambda x, *r: tsb.swin_block_plain(x, tsb.reference_params(
                    tsb.SwinBlockRef(*r), num_heads=heads, ws=8,
                    dtype=torch.float32), **kw))

    rows.append(train_case(
        "swin_block", f"train SwinIR-M shifted block {b}x{hw}x{hw}x{c}",
        make_block, m * (16 * c * c + 4 * 64 * c),
        4 * (2 * m * c + 8 * c * c + 225 * heads), path="swin_train"))
    return rows


def _s17_trainer(name: str, dev: str, batch: int, crop: int, steps: int,
                 work: Path, seed: int = 0, lr: float = 3e-4):
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.train import (TrainConfig,
                                                         Trainer)
    return Trainer(build_model(name, device=dev, seed=seed),
                   TrainConfig(total_iters=steps, batch_size=batch,
                               crop_size=crop, base_lr=lr, log_freq=1,
                               save_freq=10 ** 9, val_freq=10 ** 9),
                   work_dir=work, device=dev)


def _s17_batches(n: int, batch: int, crop: int, degrade, seed: int) -> list:
    from image_restoration_agent_tpu_torch.train import paired_crop_stream
    stream = paired_crop_stream(_s16_images(), degrade, batch, crop,
                                seed=seed)
    return [next(stream) for _ in range(n)]


def swin_train_path(card: str) -> dict:
    """``Trainer`` on ``swinir_sr_x4`` (SwinIR-M x4) at the JAX defaults
    (batch 8, HQ crop 128, LQ 32 by ``data/degrade.lowres``, Charbonnier,
    lr 3e-4), f32, ``S17_STEPS`` steps: the median s per step over steps
    5-20, the peak device memory, the launches per step (every count set
    to 0 just before the steps, read just after; ``swin_block``,
    ``token_linear``, ``window_attention`` and ``conv3x3`` each in every
    step), the loss falling from step 1 to 20, one more step under
    torch.profiler (its top device rows) and one forward and backward
    split by CUDA events."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = _s17_batches(S17_STEPS + 1, S17_BATCH, S17_CROP, _s17_lowres,
                           seed=17)
    marks, per_step = [], []

    def timed():
        for bt in batches[:S17_STEPS]:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            per_step.append(launch_counts())
            yield bt
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        per_step.append(launch_counts())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tr = _s17_trainer(S17_MODEL, "cuda", S17_BATCH, S17_CROP, S17_STEPS,
                          Path(td))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        state = tr.fit(timed())
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in tr.history]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.fit(iter(batches[S17_STEPS:]), state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lq, hq = (torch.from_numpy(a).cuda() for a in batches[-1])
        split = _step_split(tr.model, lq, hq)
    step_s = np.diff(marks)
    # each step's own launches: the counts before the next step's batch
    # minus those before its own
    steps = [{k: b[k] - a[k] for k in b} for a, b in zip(per_step,
                                                         per_step[1:])]
    need = ("swin_block", "token_linear", "window_attention", "conv3x3")
    every = all(st[k] > 0 for st in steps for k in need)
    per = {k: v / S17_STEPS for k, v in counts.items() if v}
    summary = profile_summary(prof, wall, 12)
    ok = (len(losses) == S17_STEPS and losses[-1] < losses[0] and every
          and all(np.isfinite(losses)))
    del tr, state
    torch.cuda.empty_cache()
    return {"phase": "swin_train_path", "model": S17_MODEL,
            "dtype": "float32", "batch": S17_BATCH, "crop": S17_CROP,
            "lq": [S17_CROP // 4] * 2, "steps": S17_STEPS,
            "median_step_s": float(np.median(step_s[4:])),
            "step_s": step_s.tolist(), "peak_mem_gb": peak / 1e9,
            "loss_step1": losses[0], "loss_step20": losses[-1],
            "launches_per_step": per, "launched_every_step": bool(every),
            "launches": {k: v for k, v in counts.items() if v},
            "profile": summary, "split": split, "card": card,
            "pass": bool(ok)}


def swin_train_exact(card: str) -> dict:
    """``S17_EXACT`` Trainer steps of ``swinir_sr_x4`` (f32, batch 2, HQ
    crop 128, lr ``S17_EXACT_LR``) on the card and on the port's CPU path
    from the same ``build_model(seed=0)`` init and the same batches: every
    loss within 1e-4 relative."""
    import tempfile

    import torch

    b, crop, steps = S17_EXACT
    batches = _s17_batches(steps, b, crop, _s17_lowres, seed=18)
    losses, secs = {}, {}
    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        for dev in ("cuda", "cpu"):
            tr = _s17_trainer(S17_MODEL, dev, b, crop, steps, Path(td) / dev,
                              lr=S17_EXACT_LR)
            t0 = time.perf_counter()
            tr.fit(iter(batches))
            _sync(dev)
            secs[dev] = time.perf_counter() - t0
            losses[dev] = [h["loss"] for h in tr.history]
            del tr
    torch.cuda.empty_cache()
    rel = max(abs(a - c) / abs(c) for a, c in zip(losses["cuda"],
                                                  losses["cpu"]))
    return {"phase": "swin_train_exact", "model": S17_MODEL, "batch": b,
            "crop": crop, "steps": steps, "lr": S17_EXACT_LR,
            "losses_card": losses["cuda"],
            "losses_cpu": losses["cpu"], "max_rel_diff": rel,
            "tolerance": 1e-4, "seconds": secs, "card": card,
            "pass": len(losses["cuda"]) == steps and rel <= 1e-4}


def family_train(card: str) -> dict:
    """Two ``Trainer`` steps of each newly trainable family at full width
    (``S17_FAMILIES``: batch 2, HQ crop 128; LQ by ``lowres`` for the x4
    models, Gaussian noise for the others), f32, then one more forward and
    backward: the losses finite, every parameter with a finite gradient
    (none missing but a model's ``gradient_free``, the gradient not all
    zero), and each family's kernels launched in its steps (counts set to
    0 just before them)."""
    import tempfile

    import torch

    from image_restoration_agent_tpu_torch.train import charbonnier_loss

    out, launches, ok = {}, {}, True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        for i, (name, crop, scale, init, need) in enumerate(S17_FAMILIES):
            batches = _s17_batches(
                3, 2, crop, _s17_lowres if scale > 1 else _s16_noise,
                seed=40 + i)
            t0 = time.perf_counter()
            tr = _s17_trainer(name, "cuda", 2, crop, 2, Path(td) / name)
            if init == "reference":
                dehazeformer_reference_init(tr.model, 0)
            elif init == "torch":
                torch_default_init(tr.model, 0)
            build_s = time.perf_counter() - t0
            reset_launch_counts()
            t0 = time.perf_counter()
            tr.fit(iter(batches[:2]))
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / 2
            counts = {k: v for k, v in launch_counts().items() if v}
            model = tr.model
            lq, hq = (torch.from_numpy(a).cuda() for a in batches[2])
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(
                charbonnier_loss(model(lq), hq), list(params.values()),
                allow_unused=True)
            free = tuple(getattr(model, "gradient_free", ()))
            missing = [n for n, g in zip(params, grads)
                       if g is None and not n.startswith(free)]
            finite = all(bool(torch.isfinite(g).all()) for g in grads
                         if g is not None)
            losses = [h["loss"] for h in tr.history]
            launched = all(counts.get(k, 0) > 0 for k in need)
            norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                        for g in grads if g is not None)))
            good = (len(losses) == 2 and bool(np.isfinite(losses).all())
                    and not missing and finite and norm > 0 and launched)
            ok = ok and good
            out[name] = {
                "crop": crop, "lq": list(batches[0][0].shape[1:3]),
                "init": init,
                "params": sum(p.numel() for p in params.values()),
                "losses": losses, "build_s": build_s, "step_s": step_s,
                "grad_norm": norm,
                "missing": missing, "finite": finite,
                "launches": counts, "pass": good}
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            del tr, model, grads, params
            torch.cuda.empty_cache()
    return {"phase": "family_train", "batch": 2, "dtype": "float32",
            "families": out, "launches": launches, "card": card,
            "pass": bool(ok)}


def slice17_phases(phase, card: str) -> tuple:
    """Slice 17's phases in order; returns ({"swin_train": ...,
    "family_train": ...}, swin_train_kernels' rows)."""
    import torch

    rows = phase("swin_train_kernels", swin_train_kernel_checks, False,
                 grad=True) or []
    torch.cuda.empty_cache()
    served = {"swin_train": phase("swin_train_path", swin_train_path, card,
                                  grad=True)}
    phase("swin_train_exact", swin_train_exact, card, grad=True)
    served["family_train"] = phase("family_train", family_train, card,
                                   grad=True)
    return served, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at a small shape only")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from image_restoration_agent_tpu_torch.device import exact_f32
    from image_restoration_agent_tpu_torch.ops import kernels

    exact_f32()
    t_start = time.perf_counter()
    failures: list[str] = []
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: ptxas_lines(log) for name, log in logs.items()}})

    shape = (1, 64, 128, 180) if args.quick else (1, 552, 1920, 180)
    rows = []

    def phase(name, fn, *a, grad=False):
        # every phase but the training ones runs as served: no graph
        t0 = time.perf_counter()
        try:
            with torch.set_grad_enabled(grad):
                out = fn(*a)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name}: raised")
            return None
        secs = time.perf_counter() - t0
        if isinstance(out, dict):
            emit({**out, "phase_seconds": secs})
            if not out.get("pass", True):
                failures.append(f"{name}: check failed")
        else:
            emit({"phase": name, "phase_seconds": secs})
        return out

    rows = phase("kernels", kernel_checks, shape) or []
    rows += phase("restormer_kernels", restormer_kernel_checks,
                  args.quick) or []
    rows += phase("hat_kernels", hat_kernel_checks, args.quick) or []
    rows += phase("dehazeformer_kernels", dehazeformer_kernel_checks,
                  args.quick) or []
    phase("dehazeformer_reflect_pad", dehazeformer_reflect_pad, args.quick)
    rows += phase("lab_kernels", lab_kernel_checks, args.quick) or []
    rows += phase("agent_kernels", agent_kernel_checks, args.quick) or []
    rows += phase("zoo_kernels", zoo_kernel_checks, args.quick) or []
    rows += phase("ridcp_kernels", ridcp_kernel_checks, args.quick) or []
    rows += phase("diffbir_kernels", diffbir_kernel_checks, args.quick) or []
    if args.quick:  # slices 15-17's checks follow their paths
        rows += phase("eval_suite_kernels", eval_suite_kernels, True) or []
        rows += phase("train_kernels", train_kernel_checks, True,
                      grad=True) or []
        rows += phase("swin_train_kernels", swin_train_kernel_checks, True,
                      grad=True) or []
    failures += [f"kernel {r['name']} {r['variant']} {r['dtype']}"
                 for r in rows if not r["pass"]]
    # each path's launch counts, read just after the path ran (with
    # --quick, the kernel checks' own)
    counts = launch_counts()
    launches = {p: counts for p in ("swinir", "restormer", "hat", "denoise",
                                    "dehaze", "nafnet", "fbcnn", "agent",
                                    "default_agent", "ridcp", "serve",
                                    "diffbir", "retrieval", "eval_suite",
                                    "exploration", "maxim_convert",
                                    "engine_profile", "train", "swin_train",
                                    "family_train",
                                    *(n for n, _, _ in ZOO_REQUESTS))}
    # the lab path: one pair chain, one head tail, one lab_strip call, each
    # counted alone
    launches["lab"] = {}
    for name, fn in (("lab_r5", lab_r5_phase), ("head_pair", head_pair_phase),
                     ("lab_strip", lab_strip_phase)):
        launches["lab"].update((phase(name, fn, args.quick) or {})
                               .get("launches", {}))
    torch.cuda.empty_cache()
    if not args.quick:
        from image_restoration_agent_tpu_torch.offline import (GOLDEN_ROOT,
                                                               load_golden)
        state = load_golden(GOLDEN_ROOT / "swinir_sr_x4_synth")["state"]
        phase("golden", golden_check)
        served = phase("main_path", main_path, state, card)
        phase("fast_vs_exact", fast_vs_exact, state)
        state = load_golden(GOLDEN_ROOT / "restormer_synth")["state"]
        phase("restormer_golden", restormer_golden)
        served_r = phase("restormer_path", restormer_path, state, card)
        phase("restormer_fast_vs_exact", restormer_fast_vs_exact, state)
        torch.cuda.empty_cache()
        state = model_state("hat_sr_x4")
        phase("hat_exact", hat_exact, state)
        served_h = phase("hat_path", hat_path, state, card)
        phase("hat_fast_vs_exact", hat_fast_vs_exact, state)
        torch.cuda.empty_cache()
        served_d = phase("swinir_denoise_path", swinir_denoise_path,
                         model_state("swinir_denoise_15"), card)
        torch.cuda.empty_cache()
        state = model_state("dehazeformer_b")
        served_z = phase("dehazeformer_path", dehazeformer_path, state, card)
        phase("dehazeformer_exact", dehazeformer_exact, state)
        phase("dehazeformer_bf16_vs_f32", dehazeformer_bf16_vs_f32, state)
        torch.cuda.empty_cache()
        launches.update({p: r["launches"] if r else {}
                         for p, r in agent_phases(phase, card).items()})
        torch.cuda.empty_cache()
        launches.update({p: r["launches"] if r else {}
                         for p, r in zoo_phases(phase, card).items()})
        torch.cuda.empty_cache()
        launches.update({p: r["launches"] if r else {}
                         for p, r in slice12_phases(phase, card).items()})
        torch.cuda.empty_cache()
        launches.update({p: r["launches"] if r else {}
                         for p, r in slice13_phases(phase, card).items()})
        torch.cuda.empty_cache()
        launches.update({p: r["launches"] if r else {}
                         for p, r in slice14_phases(phase, card).items()})
        torch.cuda.empty_cache()
        served15, rows15 = slice15_phases(phase, card)
        launches.update({p: r["launches"] if r else {}
                         for p, r in served15.items()})
        failures += [f"kernel {r['name']} {r['variant']} {r['dtype']}"
                     for r in rows15 if not r["pass"]]
        rows += rows15
        torch.cuda.empty_cache()
        served16, rows16 = slice16_phases(phase, card)
        launches.update({p: r["launches"] if r else {}
                         for p, r in served16.items()})
        failures += [f"kernel {r['name']} {r['variant']} {r['dtype']}"
                     for r in rows16 if not r["pass"]]
        rows += rows16
        torch.cuda.empty_cache()
        served17, rows17 = slice17_phases(phase, card)
        launches.update({p: r["launches"] if r else {}
                         for p, r in served17.items()})
        failures += [f"kernel {r['name']} {r['variant']} {r['dtype']}"
                     for r in rows17 if not r["pass"]]
        rows += rows17
        launches.update({
            "swinir": served["launches"] if served else {},
            "restormer": served_r["launches"] if served_r else {},
            "hat": served_h["launches"] if served_h else {},
            "denoise": served_d["launches"] if served_d else {},
            "dehaze": served_z["launches"] if served_z else {}})

    emit({"kernels": [{
        "name": f"{r['name']} [{r['variant']}, {r['dtype']}]",
        "route": r["route"], "source": r["source"],
        "replaces": r["replaces"],
        "launches": launches[r["path"]].get(r["name"], 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **{k: r[k] for k in REPLACED_MS if k in r}}
        for r in rows],
        # every path's launches by kernel, each read just after the path
        # ran (a row's "launches" is its own path's)
        "launches_by_path": {p: {k: v for k, v in c.items() if v}
                             for p, c in launches.items()}})
    print(card, flush=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "failures": failures})
    if failures or args.quick:
        return 1 if failures else 0
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
