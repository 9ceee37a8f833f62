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
   path on a 480x270 probe, PSNR >= the plain bf16-vs-f32 control - 2 dB;
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
    on the probe canvas's top-left 128x128) - 2 dB;
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
    calls each (times).
Phases 20-22 are the lab path: each counts its kernel's launches over one
call (6 ``swin_pair_block`` per chain, 1 ``conv3x3_pair`` per tail, 1
``lab_strip`` per call), with every count set to 0 just before.

Then the ``kernels`` line (each kernel's launches counted on the path
that runs it), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that last line; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
import traceback

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

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

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


def restormer_kernel_checks(quick: bool, seed: int = 3) -> list[dict]:
    """K4 and K5 (and K3 at the Restormer convs' shapes) against their plain
    versions at the 720p request's shapes (a 16x128 canvas with --quick).
    The K5 rows hold the whole MDTA block (K5 and the plain epilogue, the
    TPU kernel's function) to ``mdta_block_plain``; ``front_ms`` is K5
    alone, and ``repeatable`` says two launches gave the same bits."""
    import torch

    from image_restoration_agent_tpu_torch.ops.conv3x3 import (
        conv3x3, conv3x3_plain, conv3x3_weights)
    from image_restoration_agent_tpu_torch.ops.restormer_fused import (
        gdfn_block, gdfn_block_plain, gdfn_weights, mdta_block,
        mdta_block_plain, mdta_front, mdta_weights)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

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

    shapes = [(n, (1, 16, 128, s[3]), hd) for n, s, hd in RESTORMER_SHAPES] \
        if quick else list(RESTORMER_SHAPES)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = 4 if dtype == torch.float32 else 2
        fast = dtype == torch.bfloat16
        cases = []
        for i, (lvl, (b, h, w, c), heads) in enumerate(shapes):
            p = b * h * w
            ch = c // heads
            x32 = randn(b, h, w, c)
            x = x32.to(dtype)
            # the main path's blocks (WithBias LN, no biases), and at
            # level 2 the other forms the kernels take
            kinds = [("withbias", False)]
            if i == 1:
                kinds += [("none", False), ("biasfree", True),
                          ("withbias", True)]
            for ln_kind, bias in kinds:
                hid, g, m = weights(c, heads, ln_kind, bias)
                var = f"{lvl} {h}x{w} C{c} ln={ln_kind}" + (
                    " bias" if bias else "")
                gk = gdfn_weights(*g, dtype)
                cases.append(dict(
                    name="gdfn_block", variant=var, path="restormer",
                    kernel=lambda x=x, gk=gk: gdfn_block(x, gk, fast=fast),
                    plain=lambda x=x, g=g: gdfn_block_plain(x, *g,
                                                            fast=fast),
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
                    name="mdta_front", variant=f"{var} heads={heads} "
                    "(block)", path="restormer",
                    kernel=lambda x=x, mk=mk: mdta_block(x, mk),
                    plain=lambda x=x, m=m, hd=heads: mdta_block_plain(
                        x, *m, hd),
                    ref32=lambda x32=x32, m=m, hd=heads: mdta_block_plain(
                        x32, *m, hd),
                    extra_ms={"front_ms": lambda x=x, mk=mk: mdta_front(
                        x, mk)},
                    extra={"repeatable": bool(torch.equal(g1, g2))},
                    library=None, reps=5,
                    flops=p * (8 * c * c + 54 * c + 2 * c * ch),
                    nbytes=2 * p * c * es + 4 * c * c * es))
                del g1, g2
        for cname, cin, cout, h, w in RESTORMER_CONVS:
            if quick:
                h, w = 16, 128
            x32 = randn(1, h, w, cin)
            x = x32.to(dtype)
            wk = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
            kf = conv3x3_weights(wk, None, dtype)
            wl = wk.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xin = x.permute(0, 3, 1, 2)
            cases.append(dict(
                name="conv3x3", variant=f"restormer {cname} {h}x{w}",
                path="restormer",
                kernel=lambda x=x, kf=kf: conv3x3(x, kf),
                plain=lambda x=x, wk=wk: conv3x3_plain(x, wk),
                ref32=lambda x32=x32, wk=wk: conv3x3_plain(x32, wk),
                library=lambda xin=xin, wl=wl: torch.nn.functional.conv2d(
                    xin, wl, padding=1),
                flops=2 * h * w * 9 * cin * cout,
                nbytes=h * w * (cin + cout) * es + 9 * cin * cout * es,
                reps=5))
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

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

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


def profile_request(eng, img, model: str, top: int = 12) -> dict:
    """One more request under torch.profiler: device time by kernel, the
    library ops that launched the most of it, and the device's busy share
    of the request's wall time. Only the device's own rows (kernels,
    copies) are summed: an op's self device time repeats its kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.restore_array(img, model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def self_dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)

    def rows(evs):
        return [{"name": e.key[:80], "calls": e.count,
                 "device_ms": self_dev_us(e) / 1e3}
                for e in evs[:top] if self_dev_us(e) > 0]

    evs = sorted(prof.key_averages(), key=self_dev_us, reverse=True)
    dev = [e for e in evs if e.device_type != DeviceType.CPU]
    ops = [e for e in evs if e.device_type == DeviceType.CPU]
    busy = sum(self_dev_us(e) for e in dev) / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "device_kernels": len(dev), "top": rows(dev),
            "top_ops": rows(ops)}


def fast_vs_exact(state) -> dict:
    import torch

    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model
    from image_restoration_agent_tpu_torch.ops.swin_block import (
        pad_width_for_strips)

    h, w = 270, 480
    img = torch.from_numpy(np.random.default_rng(7).random(
        (h, w, 3), dtype=np.float32))
    ph, pw = -(-h // 8) * 8, pad_width_for_strips(w)
    bh = -(-(ph + 16) // 2 // 8) * 8
    band = dict(tile=(bh, pw), overlap=16, scale=4, batch=1, pad_to=(ph, pw))
    whole = dict(tile=None, scale=4, pad_multiple=8, pad_mode="extra",
                 pad_kind="symmetric")
    sd = {k: torch.from_numpy(v) for k, v in state.items()}

    def run(device, dtype, kw):
        m = build_model("swinir_sr_x4", device=device, dtype=dtype)
        m.load_state_dict(sd, strict=True)
        out = tiled_apply(lambda b: m(b.to(dtype)).float(),
                          img.to(device), **kw)
        return out.cpu().numpy()

    fast = run("cuda", torch.bfloat16, band)
    exact = run("cuda", torch.float32, whole)
    # the control: the plain versions (the CPU path) in bf16 vs f32
    torch.set_num_threads(8)
    ctrl16 = run("cpu", torch.bfloat16, band)
    ctrl32 = run("cpu", torch.float32, whole)
    db = range_psnr(fast, exact)
    ctrl = range_psnr(ctrl16, ctrl32)
    return {"phase": "fast_vs_exact", "probe": [h, w], "psnr_db": db,
            "control_db": ctrl, "floor_db": ctrl - 2.0,
            "exact_plain_vs_card_db": range_psnr(ctrl32, exact),
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
    out = tiled_apply(model, torch.from_numpy(g["input"]).cuda(), tile=None,
                      pad_multiple=8, pad_kind="reflect").cpu().numpy()
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
    128x128 as one forward, where the card's fast-vs-exact PSNR is also
    reported: the whole probe takes minutes on the CPU, a 256 tile two."""
    import torch

    from image_restoration_agent_tpu_torch.core.pad import pad_to_multiple
    from image_restoration_agent_tpu_torch.core.tiling import tiled_apply
    from image_restoration_agent_tpu_torch.models import build_model

    h, w = 270, 480
    img = torch.from_numpy(np.random.default_rng(8).random(
        (h, w, 3), dtype=np.float32))
    kw = dict(tile=256, overlap=32, scale=4, batch=6, pad_multiple=16,
              pad_mode="extra", pad_kind="symmetric")
    crop = pad_to_multiple(img, 16, "extra", "symmetric")[0][:128, :128]
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

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

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

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

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

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
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
    failures += [f"kernel {r['name']} {r['variant']} {r['dtype']}"
                 for r in rows if not r["pass"]]
    # each path's launch counts, read just after the path ran (with
    # --quick, the kernel checks' own)
    counts = launch_counts()
    launches = {p: counts for p in ("swinir", "restormer", "hat", "denoise",
                                    "dehaze")}
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
        for r in rows]})
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
