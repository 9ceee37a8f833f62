"""K5 (mdta_front) in bf16 on the card at the Restormer 720p request's five
block shapes (``chip_smoke.RESTORMER_SHAPES``).

    python3 profile_k5.py            # K5 and K4 ms, plan, errors vs plain
    python3 profile_k5.py --dtype float32   # the same in float32
    python3 profile_k5.py --ablate   # K5 with one phase compiled out
    python3 profile_k5.py --ablate --kernel k4f   # float32 K4 (k5f: K5)
    python3 profile_k5.py --request  # the float32 720p Restormer request

The first mode times K5 alone and K4 at the same shapes (CUDA events,
warmed up) and prints, for v, the gram and the sums of squares, the RMS and
largest error against ``mdta_front_plain`` beside the bf16 rounding control
(plain bf16 against plain f32); in float32 the largest error over the
plain version's largest magnitude (the f32 rule: at most 1e-4), K4's too,
and the float32 kernels' ptxas lines. The second builds copies of
``csrc/restormer_fused.cu`` with one phase of the bf16 kernel compiled out
(string substitutions, in a temporary directory), prints each copy's
registers and spills, and times the wrapper with each copy loaded, in two
rounds (forward, then reverse order). A copy whose pattern no longer
matches the source is skipped with a message. Needs one card and nvcc; each
line names the card and its power limit first.

The lab kernels K7 (``conv3x3_pair``) and K8 (``swin_pair_block``) take the
same two modes at the lab path's shapes (``chip_smoke.HEAD_SHAPES`` without
an activation; the SwinIR-M band, ``dc1`` 0 and +4), in bf16 (k7, k8) or
float32 (k7f, k8f: the split-TF32 kernels):

    python3 profile_k5.py --kernel k8            # ms, the two-launch rival
    python3 profile_k5.py --kernel k7 --ablate   # one phase out at a time
    python3 profile_k5.py --kernel k8f --ablate  # float32 K8, the same

``--request`` serves the 1280x720 Restormer request in float32 through
``Engine(device="cuda")`` as ``cli.py`` builds it (``chip_smoke.py``'s
``restormer_path`` image and weights): one warm-up, three timed requests,
their K4 and K5 launches.

``--root DIR`` imports the port from another checkout (for example a
``git archive`` of an earlier commit, unpacked in a gitignored directory),
so the same variants time that commit's kernels; the variants of one form
skip where the other form's source does not hold their patterns.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = "image_restoration_agent_tpu_torch"
chip_smoke = trf = kernels = None  # imported in main(), after --root

_ZERO_D2 = ("for (int o = 0; o < 2; ++o) for (int i = 0; i < 4; ++i) "
            "d[o][i] = make_float2(wa[0], wb[0]);")
# (name, [(pattern, replacement)]): each compiles one phase out
K5_VARIANTS = {
    "base": [],
    "no_gram": [("gram_step(acc, qs, ks, ldq, 16 * kk, gt, chp, lane);",
                 "{}")],
    "no_taps": [("taps_2x4(us + (r * t.hw2 + q) * LDU + grp * HC + cp, "
                 "t.hw2, LDU, wa,\n                 wb, ca, cb, d);",
                 _ZERO_D2)],
    "no_qkv": [("mma_rows_x32<QT>(d, xs + (16 * mt0 + fr) * ldx + fk, ldx, "
                "nt, ks_in,\n                         wc + grp * 4 * 32 + "
                "lane, 12);",
                "for (int i2 = 0; i2 < QT; ++i2) for (int j = 0; j < 4; ++j) "
                "d[i2][j][0] = d[i2][j][1] = d[i2][j][2] = d[i2][j][3] = "
                "0.f;")],
    "no_stage": [("if (t0 < t1) stage_halo(x, xs, tile_at(t0), C, ldx, hpr, "
                  "hc);", "cp_async_commit();"),
                 ("        stage_halo(x, xs, tile_at(tile + 1), C, ldx, hpr, "
                  "hc);", "        cp_async_commit();")],
    "no_ln": [("    if (ln_mode != 0) ln_in_place(xs, lnw, lnw + C, ln_mode, "
               "t, C, ldx, hpr);\n", "")],
    "qt2": [("      constexpr int QT = NTH == 384 ? 4 : 2;",
             "      constexpr int QT = 2;")],
}


# The first forms' variants (the WMMA kernels) apply only to a source
# that includes <mma.h>: the wgmma forms keep the same f32 code, whose
# lines some of these patterns would otherwise match.
V1 = ("#include <mma.h>", "#include <mma.h>")

# K8 (csrc/swin_pair.cu). First form: A's LN1, A's k/v (in attention(), for
# A's 16-row quarters only), A's q and attention, A's proj and MLP, B's
# block, and the element-wise epilogue of every WMMA tile.
K8_VARIANTS = {
    "base": [],
    "v1_no_a_ln1": [V1, ("    ln_rows<T>(g.np, n, g.C, g.kp,\n"
                     "               [&](int r, int k) { return to_f(x[m.src[r]"
                     " * g.C + k]); },\n"
                     "               wa.ln1_g, wa.ln1_b, m.y, L.ldc);\n", "")],
    "v1_no_a_kv": [V1, ("    tiles<false>(m.y, L.ldc, g.np, g.kp, wqkv + c0 + "
                    "g.hdp, g.ldqkv,",
                    "    if (mq == g.np) tiles<false>(m.y, L.ldc, g.np, g.kp, "
                    "wqkv + c0 + g.hdp, g.ldqkv,")],
    "v1_no_a_attn": [V1, ("    attention(m, g, wa, m.yq, 16, nq, tq, nullptr);\n",
                      "")],
    "v1_no_a_mlp": [V1, ("    proj_mlp(m, g, wa, 16, nq, [&](int r, int c) {\n"
                     "      return to_f(x[m.src[tq(r)] * g.C + c]);\n"
                     "    });\n", "")],
    "v1_no_b": [V1, ("  attention(m, g, wb, m.y, g.np, n, [](int r) { return r; }, "
                 "bk);\n", ""),
                ("  proj_mlp(m, g, wb, g.np, n,\n           [&](int r, int c) "
                 "{ return to_f(m.xb[r * L.ldc + c]); });\n", "")],
    "v1_no_epi": [V1, ("    for (int e = lane; e < 256; e += 32)\n"
                   "      epi(mf * 16 + e / 16, nf * 16 + e % 16, scr[e]);\n",
                   "")],
}

# K8's wgmma form: the attention tasks, the A windows' rows
# gathered from device memory, their LN1, the LN1 of B's window's tokens
# (both blocks), the q / k / v epilogues (bias, cast, store), tanh-GELU,
# LN2, the wgmma products (the ring still turns).
K8_VARIANTS.update({
    "no_attn": [("            attn16<KD>(Q, g.ldq, qrow, brow, KV, g.ldkv, g.nq, "
                 "h, n, w.rpb,", "            if (false) attn16<KD>(Q, g.ldq, "
                 "qrow, brow, KV, g.ldkv, g.nq, h, n, w.rpb,")],
    "no_a_gather": [("      gather64(qd % 2 ? Y : G, g.ldx, n, C, x, [&](int t) {",
                     "      if (false) gather64(qd % 2 ? Y : G, g.ldx, n, C, x, "
                     "[&](int t) {"),
                    ("            cp_async_wait<1>();  // window qd's rows (qd + "
                     "1's may fly)", "            cp_async_wait<0>();")],
    "no_a_ln1": [("          ln_rows64([&](int t) { return t < n ? A + t * "
                  "g.ldx : nullptr; },", "          if (false) ln_rows64([&]"
                  "(int t) { return t < n ? A + t * g.ldx : nullptr; },")],
    "no_x_ln1": [("      ln_rows64([&](int r) { return r < n ? X + r * g.ldx : "
                  "nullptr; }, C,", "      if (false) ln_rows64([&](int r) { "
                  "return r < n ? X + r * g.ldx : nullptr; }, C,")],
    "no_qkv_epi": [("    *reinterpret_cast<uint32_t*>(D + r * ld + c) =\n"
                    "        pack_bf16(v0 + b.x, v1 + b.y);", "    if (r < 0) "
                    "*reinterpret_cast<uint32_t*>(D + r * ld + c) =\n"
                    "        pack_bf16(v0 + b.x, v1 + b.y);")],
    "no_gelu": [("pack_bf16(gelu_sig(v0 + bb.x), gelu_sig(v1 + bb.y));",
                 "pack_bf16(v0 + bb.x, v1 + bb.y);")],
    "no_ln2": [("  x1_ln2<NCW>(x1, wg * NCW, g, w, X, red, Y);",
                "  if (false) x1_ln2<NCW>(x1, wg * NCW, g, w, X, red, Y);")],
    "no_mma": [("        wgmma_rs<NW>(acc, a[ks], b_desc(ws + ks * N * 32, "
                "N * 16),", "        if (false) wgmma_rs<NW>(acc, a[ks], "
                "b_desc(ws + ks * N * 32, N * 16),")],
})

# K7 (csrc/conv3x3_pair.cu). First form (the WMMA kernel): conv1's
# products, the u epilogue (bias, activation, cast, store), conv2's
# products, the per-chunk weight staging and the input tile's staging.
K7_VARIANTS = {
    "base": [],
    "v1_no_conv1": [V1, ("            wmma::mma_sync(acc[j], af, bf, acc[j]);",
                     "")],
    "v1_no_u_epi": [V1, ("          U[(ur * UWS + uc) * L.ldu + j * 16 + n] = "
                     "__float2bfloat16_rn(v);", "")],
    "v1_no_conv2": [V1, ("              if (nf < nfo) wmma::mma_sync(oacc[cf][nf], "
                     "af, bf[nf],\n                                           "
                     "oacc[cf][nf]);", ";")],
    "v1_no_w_stage": [V1, ("    for (int e = tid; e < 9 * cinp * (MC / 8); e += "
                       "NT) {", "    for (int e = tid; e < 0; e += NT) {"),
                      ("    for (int e = tid; e < 9 * MC * c8; e += NT) {",
                       "    for (int e = tid; e < 0; e += NT) {")],
    "v1_no_in_stage": [V1, ("  for (int e = tid; e < IH * IW * per; e += NT) {",
                        "  for (int e = tid; e < 0; e += NT) {")],
}

# K7's wgmma form: conv1's products, the u epilogue's stores,
# conv2's products, the halo's staging.
K7_VARIANTS.update({
    "no_conv1": [("            wgmma_ss<64>(acc1[i],",
                  "            if (false) wgmma_ss<64>(acc1[i],")],
    "no_u_epi": [("            *reinterpret_cast<uint32_t*>(\n"
                  "                U + ((ur * (Q_MC / 8) + j) * Q_PX + px) * 16 "
                  "+ 4 * t) =", "            if (false) *reinterpret_cast"
                  "<uint32_t*>(\n                U + ((ur * (Q_MC / 8) + j) * "
                  "Q_PX + px) * 16 + 4 * t) =")],
    "no_conv2": [("              wgmma_ss<NO>(acc2[i],",
                  "              if (false) wgmma_ss<NO>(acc2[i],")],
    "no_halo": [("    for (int e = tid; e < Q_HR * cg * Q_PX; e += Q_NT) {",
                 "    for (int e = tid; e < 0; e += Q_NT) {")],
})

# the float32 K4 (gdfn_tf32_kernel): project_in's products, the taps, the
# erf gate, project_out's products, the halo's staging, LN
K4F_VARIANTS = {
    "base": [],
    "no_in": [("    one_by_one_tf32_at(\n        TS, us, LDU4,", "    if (false) "
               "one_by_one_tf32_at(\n        TS, us, LDU4,")],
    "no_taps": [("        taps_2x4(us + (r * t.hw2 + q) * LDU4 + half * HC + "
                 "cp, t.hw2, LDU4,\n                 wa, wb, ca, cb, d);",
                 _ZERO_D2)],
    "no_gate": [("                     : 0.5f * v * (1.f + erff(v * "
                 "0.70710678118654752f));", "                     : v;")],
    "no_out": [("        for (int i = 0; i < 2; ++i) mma_split_b(pa[i][j], "
                "ah[i], al[i], b);", "        for (int i = 0; i < 2 && ks < 0; "
                "++i) mma_split_b(pa[i][j], ah[i], al[i], b);")],
    "no_stage": [("  stage_halo_f32(x, xs, t, C, ldx, hpr, HaloCopyF(x, C));",
                  "  cp_async_commit();")],
    "no_ln": [("  if (ln_mode != 0) ln_in_place_f32(xs, ln_w, ln_b, ln_mode, "
               "t, C, ldx, hpr);", "")],
}
# the float32 K5 (mdta_tf32_kernel): the qkv products, the taps, the gram,
# the halo's staging, LN
K5F_VARIANTS = {
    "base": [],
    "no_qkv": [("      one_by_one_tf32_at(TS, us, LDU5, xs,", "      if (false) "
                "one_by_one_tf32_at(TS, us, LDU5, xs,")],
    "no_taps": [("        taps_2x4(us + (r * t.hw2 + q) * LDU5 + grp * HC + cp, "
                 "t.hw2, LDU5, wa,\n                 wb, ca, cb, d);",
                 _ZERO_D2)],
    "no_gram": [("        gram_step_tf32(acc, qs, ks, ldq, 8 * kk, gt, chp, "
                 "lane);", "        {}")],
    "no_stage": [("  if (t0 < t1) stage_halo_f32(x, xs, tile_at(t0), C, ldx, "
                  "hpr, hc);", "  cp_async_commit();"),
                 ("        stage_halo_f32(x, xs, tile_at(tile + 1), C, ldx, "
                  "hpr, hc);", "        cp_async_commit();")],
    "no_ln": [("      ln_in_place_f32(xs, lnw, lnw + C, ln_mode, t, C, ldx, "
               "hpr);", "      {}")],
}

# the float32 K7 (conv3x3_pair_tf32_kernel): conv1's products, conv2's,
# the halo's staging, the activations' split
K7F_VARIANTS = {
    "base": [],
    "no_conv1": [("          wgmma_split<T_MC>(acc, hi[tap], lo[tap],",
                  "          if (false) wgmma_split<T_MC>(acc, hi[tap], "
                  "lo[tap],")],
    "no_conv2": [("            wgmma_split<NO>(acc, hi[tap], lo[tap],",
                  "            if (false) wgmma_split<NO>(acc, hi[tap], "
                  "lo[tap],")],
    "no_halo": [("    if (i >= nci) return;\n    unsigned char* hs",
                 "    return;\n    unsigned char* hs")],
    "no_split": [("  for (int i = 0; i < 4; ++i) split1(__uint_as_float(raw[i]), "
                  "hi[i], lo[i]);", "  for (int i = 0; i < 4; ++i) hi[i] = "
                  "lo[i] = raw[i];")],
}
# the float32 K8 (swin_pair_tf32_kernel): every product pass's mma (their
# loads and splits stay), the attention tasks, A's k / v passes on its four
# windows, the MLP's passes, the A windows' gathers, the LayerNorms
K8F_VARIANTS = {
    "base": [],
    "no_gemm_mma": [("          mma_tf32(acc[rb][j], al[rb], bw[j].x, bw[j].y);"
                     "\n          mma_tf32(acc[rb][j], ah[rb], bw[j].z, "
                     "bw[j].w);\n          mma_tf32(acc[rb][j], ah[rb], "
                     "bw[j].x, bw[j].y);", "          acc[rb][j][0] += "
                     "__uint_as_float(al[rb][0] ^ ah[rb][1] ^ bw[j].x);")],
    "no_attn": [("          attn_tf32(Q, g.ldq, h * hdp, qrow, brow, R, "
                 "g.ldr, hl * hdp,", "          if (false) attn_tf32(Q, "
                 "g.ldq, h * hdp, qrow, brow, R, g.ldr, hl * hdp,")],
    "no_a_kv": [("        gemm64(Y, g.ldx, g.kp, w.wkv, g.kp / 8, 0, gi * gw / 8,",
                 "        if (blk) gemm64(Y, g.ldx, g.kp, w.wkv, g.kp / 8, 0, "
                 "gi * gw / 8,")],
    "no_mlp": [("      gemm64(Y, g.ldx, g.kp, w.w1, g.kp / 8, 0, h0 / 8,",
                "      if (false) gemm64(Y, g.ldx, g.kp, w.w1, g.kp / 8, 0, "
                "h0 / 8,"),
               ("      gemm64(Hc, g.ldq, g.hc, w.w2, g.hidp / 8, h0 / 8, 0,",
                "      if (false) gemm64(Hc, g.ldq, g.hc, w.w2, g.hidp / 8, "
                "h0 / 8, 0,")],
    "no_a_gather": [("        gather_f32(Y, g.ldx, n, C, g.vec, [&](int t) {",
                     "        if (false) gather_f32(Y, g.ldx, n, C, g.vec, "
                     "[&](int t) {")],
    "no_ln": [("    const float* p = src(r);\n    float* yr = Y + r * ld;\n"
               "    if (p == nullptr) {", "    const float* p = src(r);\n"
               "    float* yr = Y + r * ld;\n    if (true) {")],
}

# per kernel: (source, variants, the ptxas lines to print)
KERNELS = {"k5": ("restormer_fused", "K5_VARIANTS", "mdta_mma"),
           "k4f": ("restormer_fused", "K4F_VARIANTS", "gdfn_tf32"),
           "k5f": ("restormer_fused", "K5F_VARIANTS", "mdta_tf32"),
           "k7": ("conv3x3_pair", "K7_VARIANTS", "conv3x3_pair"),
           "k8": ("swin_pair", "K8_VARIANTS", "swin_pair"),
           "k7f": ("conv3x3_pair", "K7F_VARIANTS", "conv3x3_pair_tf32"),
           "k8f": ("swin_pair", "K8F_VARIANTS", "swin_pair_tf32")}


def _lab_cases(torch, kernel: str):
    """(name, kernel call, plain call, f32 plain call, two-launch rival) at
    the lab path's shapes, chip_smoke's weight distributions, in bf16 (k7,
    k8) or float32 (k7f, k8f)."""
    conv = importlib.import_module(f"{PKG}.ops.conv3x3")
    sb = importlib.import_module(f"{PKG}.ops.swin_block")
    wa_ = importlib.import_module(f"{PKG}.ops.window_attention")
    gen = torch.Generator().manual_seed(19)
    dev = torch.device("cuda")
    bf = torch.float32 if kernel.endswith("f") else torch.bfloat16

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    if kernel.startswith("k7"):
        cin, cmid, cout = 64, 256, 12
        w1 = randn(3, 3, cin, cmid, scale=(9 * cin) ** -0.5)
        b1 = randn(cmid, scale=0.1)
        w2 = randn(3, 3, cmid, cout, scale=(9 * cmid) ** -0.5)
        b2 = randn(cout, scale=0.1)
        kp = conv.conv3x3_pair_weights(w1, b1, w2, b2, bf)
        k1, k2 = conv.conv3x3_weights(w1, b1, bf), conv.conv3x3_weights(
            w2, b2, bf)
        for shape in chip_smoke.HEAD_SHAPES:
            x32 = randn(*shape)
            x = x32.to(bf)
            yield (f"{shape[1]}x{shape[2]}",
                   lambda x=x: conv.conv3x3_pair(x, kp),
                   lambda x=x: conv.conv3x3_pair_plain(x, w1, b1, w2, b2),
                   lambda x32=x32: conv.conv3x3_pair_plain(x32, w1, b1, w2,
                                                           b2),
                   lambda x=x: conv.conv3x3(conv.conv3x3(x, k1), k2))
        return
    c, heads, ws, hid = 180, 6, 8, 360
    n = ws * ws

    def wts():
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

    w = (wts(), wts())
    pa, pb = (sb.prepare_swin_params(**d, num_heads=heads, ws=ws, dtype=bf)
              for d in w)
    pa32, pb32 = (sb.prepare_swin_params(**d, num_heads=heads, ws=ws,
                                         dtype=torch.float32) for d in w)
    bank = torch.from_numpy(wa_.shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n)).to(dev)
    x32 = randn(1, 552, 1920, c)
    x = x32.to(bf)
    for dc1 in (0, ws // 2):
        kw = dict(num_heads=heads, ws=ws, dc1=dc1)
        yield (f"552x1920 dc1={dc1:+d}",
               lambda kw=kw: sb.swin_pair_block(x, pa, pb, bank, **kw),
               lambda kw=kw: sb.swin_pair_block_plain(x, pa, pb, bank, **kw),
               lambda kw=kw: sb.swin_pair_block_plain(x32, pa32, pb32, bank,
                                                      **kw),
               lambda d=dc1: sb.swin_block(
                   sb.swin_block(x, pa, num_heads=heads, ws=ws, dc=d,
                                 fast=True), pb, num_heads=heads, ws=ws,
                   dc=-ws // 2, mask_bank=bank, fast=True))


def lab_times(kernel: str, reps: int = 5) -> None:
    """K7 or K8: ms, the two-launch rival's ms, repeatable bits, and the
    RMS and largest error against the plain version beside the bf16
    rounding control (in float32 the control is 0, and ``max_rel`` the
    largest error over the plain version's largest magnitude)."""
    import torch
    card = chip_smoke.nvidia_smi_line()
    kernels.load(KERNELS[kernel][0])
    print(json.dumps({"card": card, "ptxas": [
        ln for ln in chip_smoke.ptxas_lines(kernels.build_log(
            KERNELS[kernel][0])) if KERNELS[kernel][2] in ln]}), flush=True)
    for name, fn, plain, ref, rival in _lab_cases(torch, kernel):
        got, again = fn(), fn()
        want, r32 = plain().float(), ref().float()
        d, dc = got.float() - want, want - r32
        row = dict(card=card, kernel=kernel, case=name,
                   ms=chip_smoke.cuda_ms(fn, reps),
                   two_launch_ms=chip_smoke.cuda_ms(rival, reps),
                   repeatable=bool(torch.equal(got, again)),
                   rms=float(d.square().mean().sqrt()),
                   control_rms=float(dc.square().mean().sqrt()),
                   max=float(d.abs().max()), control_max=float(dc.abs().max()),
                   max_rel=float(d.abs().max() / want.abs().max()))
        print(json.dumps(row), flush=True)
        del got, again, want, r32, d, dc
        torch.cuda.empty_cache()


def _cases(torch, with_plain: bool, dtype=None):
    """(level, x32, x, front params, MdtaWeights) at the five shapes:
    WithBias LN, no biases (the main path's blocks), seed 3; x and the
    form in ``dtype`` (default bf16)."""
    dtype = dtype or torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    dev = torch.device("cuda")

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    for lvl, (b, h, w, c), heads in chip_smoke.RESTORMER_SHAPES:
        x32 = randn(b, h, w, c)
        ln = (1 + randn(c, scale=0.1), randn(c, scale=0.1))
        m = (ln, randn(c, 3 * c, scale=c ** -0.5), None,
             randn(9, 3 * c, scale=1 / 3), None)
        mk = trf.mdta_weights(*m, randn(c, c, scale=c ** -0.5), None,
                              0.5 + torch.rand(heads, generator=gen).to(dev),
                              heads, dtype)
        yield lvl, heads, (x32 if with_plain else None), x32.to(dtype), m, mk


def _k4_cases(torch, dtype):
    """(level, x, GdfnWeights) at the five shapes: WithBias LN, no biases,
    seed 4."""
    gen = torch.Generator().manual_seed(4)

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).cuda()

    for lvl, (b, h, w, c), _ in chip_smoke.RESTORMER_SHAPES:
        hid = int(2.66 * c)
        g = ((1 + randn(c, scale=0.1), randn(c, scale=0.1)),
             randn(c, 2 * hid, scale=c ** -0.5), None,
             randn(9, 2 * hid, scale=1 / 3), None,
             randn(hid, c, scale=hid ** -0.5), None)
        yield lvl, randn(b, h, w, c).to(dtype), trf.gdfn_weights(*g, dtype)


def _plan_of(fn, *args):
    """A plan as a dict, or None where this checkout's planner does not
    take these arguments (an earlier commit under --root)."""
    try:
        return fn(*args)._asdict()
    except TypeError:
        return None


def times(reps: int = 20, dtype_name: str = "bfloat16") -> None:
    import torch
    card = chip_smoke.nvidia_smi_line()
    dtype = getattr(torch, dtype_name)
    if dtype == torch.float32:
        lines = chip_smoke.ptxas_lines(kernels.build_log("restormer_fused"))
        print(json.dumps(dict(card=card, ptxas=[
            ln for ln in lines if "tf32" in ln or "f32" in ln.split(":")[0]
        ])), flush=True)
    for lvl, heads, x32, x, m, mk in _cases(torch, True, dtype):
        c = x.shape[-1]
        got = trf.mdta_front(x, mk)
        again = trf.mdta_front(x, mk)
        want = trf.mdta_front_plain(x, *m, heads)
        ref = trf.mdta_front_plain(x32, *m, heads)
        errs = {}
        for name, a, b, r in zip(("v", "gram", "ssq"), got, want, ref):
            d = a.float() - b.float()
            dc = b.float() - r.float()
            errs[name] = dict(rms=float(d.square().mean().sqrt()),
                              control_rms=float(dc.square().mean().sqrt()),
                              max=float(d.abs().max()),
                              control_max=float(dc.abs().max()),
                              rel_max=float(d.abs().max()
                                            / b.float().abs().max()))
        k5 = chip_smoke.cuda_ms(lambda: trf.mdta_front(x, mk), reps)
        hid = int(2.66 * c)
        gen = torch.Generator().manual_seed(4)
        g = (m[0], (torch.randn(c, 2 * hid, generator=gen) * c ** -0.5)
             .cuda(), None, (torch.randn(9, 2 * hid, generator=gen) / 3)
             .cuda(), None, (torch.randn(hid, c, generator=gen)
                             * hid ** -0.5).cuda(), None)
        fast = dtype == torch.bfloat16
        gk = trf.gdfn_weights(*g, dtype)
        y = trf.gdfn_block(x, gk, fast=fast)
        y_want = trf.gdfn_block_plain(x, *g, fast=fast).float()
        k4_err = float((y.float() - y_want).abs().max()
                       / y_want.abs().max())
        k4_repeat = torch.equal(y, trf.gdfn_block(x, gk, fast=fast))
        k4 = chip_smoke.cuda_ms(lambda: trf.gdfn_block(x, gk, fast=fast),
                                reps)
        print(json.dumps(dict(
            card=card, dtype=dtype_name, shape=lvl, k5_ms=k5, k4_ms=k4,
            plan=_plan_of(trf.mdta_plan, c, heads, dtype),
            k4_plan=_plan_of(trf.gdfn_plan, c, dtype),
            repeatable=all(torch.equal(a, b) for a, b in zip(got, again)),
            k4_repeatable=k4_repeat, k4_rel_max=k4_err,
            errors=errs)), flush=True)
        del y, y_want
        del got, again, want, ref
        torch.cuda.empty_cache()


def f32_request(requests: int = 3) -> None:
    """The float32 720p Restormer request (``--request``)."""
    import time

    import numpy as np
    import torch

    engine = importlib.import_module(f"{PKG}.engine")
    img = np.random.default_rng(1).random((720, 1280, 3), dtype=np.float32)
    eng = engine.Engine(device="cuda")
    eng.set_weights("restormer", chip_smoke.model_state("restormer"))
    eng.restore_array(img, "restormer")
    torch.cuda.synchronize()
    n0 = trf.gdfn_block.launches, trf.mdta_front.launches
    secs = []
    for _ in range(requests):
        t0 = time.perf_counter()
        res = eng.restore_array(img, "restormer")
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print(json.dumps(dict(
        card=chip_smoke.nvidia_smi_line(), dtype="float32", seconds=secs,
        mp_per_s=1280 * 720 / 1e6 / min(secs),
        k4=trf.gdfn_block.launches - n0[0],
        k5=trf.mdta_front.launches - n0[1],
        finite=bool(np.isfinite(res.image).all()))), flush=True)


def _build(tmp: Path, kernel: str) -> dict:
    source, table, prefix = KERNELS[kernel]
    variants = globals()[table]
    src_text = (kernels.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, subs in variants.items():
        if any(a not in src_text for a, _ in subs):
            print(name, "skipped: its pattern is not in the source",
                  flush=True)
            continue
        s = src_text
        for a, b in subs:
            s = s.replace(a, b)
        src = tmp / f"{name}.cu"
        src.write_text(s)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(name, "failed:", log[-3000:], flush=True)
            continue
        libs[name] = ctypes.CDLL(str(tmp / f"{name}.so"))
        print(json.dumps({"variant": name, "ptxas": [
            ln for ln in chip_smoke.ptxas_lines(log) if prefix in ln]}),
            flush=True)
    return libs


def ablate(kernel: str, reps: int = 10) -> None:
    """Every variant of ``kernel`` timed at its shapes, in two rounds
    (forward, then reverse order)."""
    import torch
    card = chip_smoke.nvidia_smi_line()
    source = KERNELS[kernel][0]
    with tempfile.TemporaryDirectory() as d:
        libs = _build(Path(d), kernel)
        if kernel == "k5":
            cases = [(lvl, lambda x=x, mk=mk: trf.mdta_front(x, mk))
                     for lvl, _, _, x, _, mk in _cases(torch, False)]
        elif kernel == "k5f":
            cases = [(lvl, lambda x=x, mk=mk: trf.mdta_front(x, mk))
                     for lvl, _, _, x, _, mk in _cases(torch, False,
                                                       torch.float32)]
        elif kernel == "k4f":
            cases = [(lvl, lambda x=x, gk=gk: trf.gdfn_block(x, gk,
                                                             fast=False))
                     for lvl, x, gk in _k4_cases(torch, torch.float32)]
        else:
            cases = [(name, fn) for name, fn, *_ in _lab_cases(torch, kernel)]
            reps = min(reps, 5)
        out: dict = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                kernels._libs[source] = libs[name]
                for case, fn in cases:
                    out.setdefault(name, {}).setdefault(case, []).append(
                        chip_smoke.cuda_ms(fn, reps))
        kernels._libs.pop(source, None)
        for name, v in out.items():
            print(json.dumps({"card": card, "variant": name, "ms": v}),
                  flush=True)


def main() -> int:
    global chip_smoke, trf, kernels
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="time copies of the kernel with one phase out")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k5")
    ap.add_argument("--root", help="import the port from this checkout")
    ap.add_argument("--request", action="store_true",
                    help="time the float32 720p Restormer request")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="K4's and K5's dtype (k5)")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("profile_k5: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    chip_smoke = cs
    trf = importlib.import_module(f"{PKG}.ops.restormer_fused")
    kernels = importlib.import_module(f"{PKG}.ops.kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        if args.request:
            f32_request()
        elif args.ablate:
            ablate(args.kernel)
        elif args.kernel == "k5":
            times(dtype_name=args.dtype)
        else:
            lab_times(args.kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
