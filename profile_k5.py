"""K5 (mdta_front) in bf16 on the card at the Restormer 720p request's five
block shapes (``chip_smoke.RESTORMER_SHAPES``).

    python3 profile_k5.py            # K5 and K4 ms, plan, errors vs plain
    python3 profile_k5.py --ablate   # K5 with one phase compiled out

The first mode times K5 alone and K4 at the same shapes (CUDA events,
warmed up) and prints, for v, the gram and the sums of squares, the RMS and
largest error against ``mdta_front_plain`` beside the bf16 rounding control
(plain bf16 against plain f32). The second builds copies of
``csrc/restormer_fused.cu`` with one phase of the bf16 kernel compiled out
(string substitutions, in a temporary directory), prints each copy's
registers and spills, and times the wrapper with each copy loaded, in two
rounds (forward, then reverse order). A copy whose pattern no longer
matches the source is skipped with a message. Needs one card and nvcc; each
line names the card and its power limit first.
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

import chip_smoke

trf = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.restormer_fused")
kernels = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.kernels")

_ZERO_D2 = ("for (int o = 0; o < 2; ++o) for (int i = 0; i < 4; ++i) "
            "d[o][i] = make_float2(wa[0], wb[0]);")
# (name, [(pattern, replacement)]): each compiles one phase out
VARIANTS = {
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


def _cases(torch, with_plain: bool):
    """(level, x32, x, front params, MdtaWeights) at the five shapes:
    WithBias LN, no biases (the main path's blocks), seed 3."""
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
                              heads, torch.bfloat16)
        yield lvl, heads, (x32 if with_plain else None), \
            x32.to(torch.bfloat16), m, mk


def times(reps: int = 20) -> None:
    import torch
    card = chip_smoke.nvidia_smi_line()
    for lvl, heads, x32, x, m, mk in _cases(torch, True):
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
                              control_max=float(dc.abs().max()))
        k5 = chip_smoke.cuda_ms(lambda: trf.mdta_front(x, mk), reps)
        hid = int(2.66 * c)
        gen = torch.Generator().manual_seed(4)
        g = (m[0], (torch.randn(c, 2 * hid, generator=gen) * c ** -0.5)
             .cuda(), None, (torch.randn(9, 2 * hid, generator=gen) / 3)
             .cuda(), None, (torch.randn(hid, c, generator=gen)
                             * hid ** -0.5).cuda(), None)
        gk = trf.gdfn_weights(*g, torch.bfloat16)
        k4 = chip_smoke.cuda_ms(lambda: trf.gdfn_block(x, gk, fast=True),
                                reps)
        print(json.dumps(dict(
            card=card, shape=lvl, k5_ms=k5, k4_ms=k4,
            plan=trf.mdta_plan(c, heads)._asdict(),
            repeatable=all(torch.equal(a, b) for a, b in zip(got, again)),
            errors=errs)), flush=True)
        del got, again, want, ref
        torch.cuda.empty_cache()


def _build(tmp: Path) -> dict:
    src_text = (kernels.CSRC / "restormer_fused.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
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
            ln for ln in chip_smoke.ptxas_lines(log)
            if ln.startswith("mdta_mma")]}), flush=True)
    return libs


def ablate(reps: int = 10) -> None:
    import torch
    card = chip_smoke.nvidia_smi_line()
    with tempfile.TemporaryDirectory() as d:
        libs = _build(Path(d))
        cases = [(lvl, x, mk) for lvl, _, _, x, _, mk in _cases(torch, False)]
        out: dict = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                kernels._libs["restormer_fused"] = libs[name]
                for lvl, x, mk in cases:
                    out.setdefault(name, {}).setdefault(lvl, []).append(
                        chip_smoke.cuda_ms(lambda: trf.mdta_front(x, mk),
                                           reps))
        kernels._libs.pop("restormer_fused", None)
        for name, v in out.items():
            print(json.dumps({"card": card, "variant": name, "ms": v}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ablate", action="store_true",
                    help="time copies of the kernel with one phase out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_k5: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ablate() if args.ablate else times()
    return 0


if __name__ == "__main__":
    sys.exit(main())
