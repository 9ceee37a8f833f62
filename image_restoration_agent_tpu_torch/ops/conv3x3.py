"""Fused SAME 3x3 convolution (stride 1) with bias, LeakyReLU, residual,
folded cyclic roll and input LayerNorm.

Replaces ``image_restoration_agent_tpu/ops/conv3x3.py:conv3x3_pallas`` (the
TPU row-strip MXU kernel). The CUDA kernel is ``csrc/conv3x3.cu`` (K3):

- What bounds it on the H100: at the serving shape (552x1920, 180->180)
  the conv is 6.1e11 FLOP against 0.76 GB of bf16 input and output, about
  800 FLOP per byte, so the tensor-core rate bounds it (0.62 ms in bf16);
  the f32 exact path runs three TF32 passes (two where the weights are
  bf16-rounded) on the tensor cores, bound by 3 x FLOP at 495 TFLOP/s
  (3.7 ms) where FP32 FMA would be bound by 67 TFLOP/s (9.2 ms).
- Design: an implicit GEMM with no im2col in device memory; the folded
  roll is resolved in the load addresses (modular indices) and SAME zero
  padding applied at the edges of the rolled canvas; with ``ln_pre`` each
  halo pixel's LayerNorm statistics come first, the input is normalized
  while it is staged, and the zero padding applies to the LN *output*
  (LN(0) = bias is not what the reference pads with). Bias, activation and
  residual are applied in float32 before the single cast on store.
- bf16 (the serving mode): ``wgmma`` on the tensor cores
  (``csrc/sm90_gemm.cuh``). A block owns 2 output rows x 64 pixels x one
  slice of at most 256 output channels (two warpgroups, one m64 row
  each); the (2+2) x 66 halo is staged once for every output channel, 16
  input channels a stage, through a 2-4 stage ring whose weight half
  arrives by one bulk copy per stage from the packed form
  (:func:`conv3x3_weights`), and the epilogue runs from the accumulator
  registers. :func:`conv3x3_plan` is the launch plan.
- f32 (the exact mode): split TF32 on ``wgmma``. The weights are kept as
  ``wh = rna_tf32(w)`` and ``wl = w - wh`` (exact, so ``wh + wl == w``;
  no ``wl`` where the weights are bf16-rounded, as DiffBIR's served
  weights are), the activations split in registers into ``xh`` and
  ``xl``, and ``xl wh + xh wl + xh wh`` summed in float32: each product
  off by about 2^-21 relative, where plain TF32 keeps about three digits.
  A block owns 128 pixels (8 x 16 or another of four tile shapes, the
  rows of a narrow canvas flattened into it) and a slice of at most 128
  output channels, 8 input channels a stage; where the tiles cannot fill
  the card the input channels are split across blocks and summed in a
  fixed order by a second pass (:func:`conv3x3_plan`).

:func:`conv3x3_pair` replaces ``conv3x3_pair_pallas`` (two chained SAME
convs, the intermediate ``u`` kept on chip) with K7,
``csrc/conv3x3_pair.cu``: a block stages one input tile with a 2-pixel
halo, computes ``u`` chunk by chunk on the tile plus a 1-pixel ring into
shared memory, and sums each chunk's conv2 into float32 accumulators.
Both convs run on ``wgmma``, the weights streamed through shared memory by
bulk copies from the packed form of :func:`conv3x3_pair_weights`: in bf16
persistent blocks walk 6 x 62 output tiles, the halo and ``u`` read in
place by descriptor at every tap; in float32 split TF32 as K3's float32
kernel (a block a 6 x 30 tile, the halo streamed 8 input channels a stage,
the activations split in registers, both weight parts from the form); see
the source for what bounds it. No served
path runs it: the x4 head keeps the JAX package's two-conv form
(``lab/head_pair.py`` runs both).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import exact_f32
from . import kernels
from .autograd import forbid_grad, kernel_function
from .layernorm import layer_norm_lanes

_ACTS = {None: 0, "lrelu": 1, "lrelu2": 2}
_SLOPES = {"lrelu": 0.01, "lrelu2": 0.2}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor | None = None, *, act: str | None = None,
                  res: torch.Tensor | None = None, roll: int = 0,
                  ln_pre: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3x3`: the same function with the
    same cast points (LN output cast to ``x.dtype``, float32 accumulation,
    one cast of the result)."""
    dt = x.dtype
    if x.is_cuda:  # the float32 reference conv must not run in TF32
        exact_f32()
    if ln_pre is not None:
        x = layer_norm_lanes(x, *ln_pre)
    xf = x.float()
    if roll:
        xf = torch.roll(xf, (roll, roll), dims=(1, 2))
    y = F.conv2d(xf.permute(0, 3, 1, 2),
                 w.to(dt).float().permute(3, 2, 0, 1), padding=1)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if act is not None:
        y = F.leaky_relu(y, _SLOPES[act])
    if res is not None:
        y = y + res.float()
    return y.to(dt)


class Conv3x3Weights(NamedTuple):
    """K3's weight form, made once per weight (:func:`conv3x3_weights`),
    in the packed order the tensor-core kernel copies one stage at a time.
    In bfloat16 (slices, Cin/16, 9 taps, 2, NS/8, 8, 8): for each
    output-channel slice of NS columns and each 16-channel chunk of the
    input, the 9 taps' 16 x NS blocks as 8 x 8 core matrices (8 output
    channels x 8 input channels, input channels fastest), zero-padded. In
    float32 the split-TF32 form (slices, Cin/8, parts, 9 taps, 2, NS/8, 8,
    4): 8-channel chunks, core matrices of 8 output channels x 4 input
    channels, and the parts ``wh`` and, where the weight has one, ``wl``
    (:func:`kernels.tf32_split`: ``wh + wl == w`` bit for bit). The bias in
    float32. ``cin`` and ``cout`` are the true channel counts."""

    w: torch.Tensor
    b: torch.Tensor | None
    cin: int
    cout: int

    @property
    def parts(self) -> int:
        """Split-TF32 parts of a float32 form (1: ``wh`` alone), else 1."""
        return self.w.shape[2] if self.w.dim() == 8 else 1

    @property
    def hwio(self) -> torch.Tensor:
        """The (3, 3, Cin, Cout) weight this form holds (in float32 ``wh +
        wl``, the weight it was made from bit for bit)."""
        w = self.w
        if w.dim() == 8:
            w = w[:, :, 0] + w[:, :, 1] if w.shape[2] == 2 else w[:, :, 0]
        if w.dim() == 7:
            w = _unpack_taps(w)
        return w[:, :, :self.cin, :self.cout]


def conv3x3_weights(w: torch.Tensor, b: torch.Tensor | None,
                    dtype: torch.dtype) -> Conv3x3Weights:
    """The kernel form of (3, 3, Cin, Cout) weights and a bias."""
    cin, cout = w.shape[2], w.shape[3]
    if dtype == torch.float32:  # split from the source type (bf16: exact)
        parts = kernels.tf32_split(w.detach())
        nsl, ns = conv3x3_f32_slices(cout, len(parts))
        wk = torch.stack([_pack_taps(p, nsl, ns, CONV_F32_KC)
                          for p in parts], dim=2)
    else:
        wk = w.detach().to(dtype)
    if dtype == torch.bfloat16:
        wk = _pack_taps(wk, *kernels.gemm_slices(cout))
    bk = None if b is None else b.detach().float().contiguous()
    return Conv3x3Weights(wk.contiguous(), bk, cin, cout)


def _pack_taps(w: torch.Tensor, nsl: int, ns: int,
               kc: int = 16) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> K3's packed order (nsl, Cin/kc, 9, 2, ns/8, 8,
    kc/2), Cin zero-padded to kc (16 in bf16, 8 in float32) and Cout to
    nsl * ns."""
    cin, cout = w.shape[2], w.shape[3]
    nc = -(-cin // kc)
    w = F.pad(w, (0, nsl * ns - cout, 0, nc * kc - cin))
    # (tap, chunk, k half, k, slice, n group, n) -> (slice, chunk, tap,
    # k half, n group, n, k)
    return w.reshape(9, nc, 2, kc // 2, nsl, ns // 8, 8).permute(
        4, 1, 0, 2, 5, 6, 3)


def _unpack_taps(w: torch.Tensor) -> torch.Tensor:
    """The padded (3, 3, Cin, Cout) weight of a :func:`_pack_taps` form."""
    nsl, nc, ns, kc = w.shape[0], w.shape[1], w.shape[4] * 8, w.shape[6] * 2
    return w.permute(2, 1, 3, 6, 0, 4, 5).reshape(3, 3, nc * kc, nsl * ns)


# conv3x3_mma_kernel's tile and shared memory (csrc/conv3x3.cu: M_TH, TP,
# M_KC, M_FIXED, M_HALO_BYTES)
CONV_ROWS, CONV_PIXELS, CONV_KC = 2, 64, 16
_CONV_FIXED = 128 + 16 * (CONV_ROWS + 2) * (CONV_PIXELS + 2)
_CONV_HALO = (CONV_ROWS + 2) * (CONV_PIXELS + 2) * CONV_KC * 2


def conv3x3_smem(ns: int, stages: int) -> int:
    return _CONV_FIXED + stages * (_CONV_HALO + 9 * ns * CONV_KC * 2)


# conv3x3_tf32_kernel's tile and shared memory (csrc/conv3x3.cu: F_PIX,
# F_KC, F_FIXED, F_HALO_BYTES): 128 output pixels a block, TR x TC with TC
# one of CONV_F32_TILE_COLS, 8 input channels a stage, the halo stage
# sized for the widest tile (4 x 66 pixels)
CONV_F32_PIXELS, CONV_F32_KC = 128, 8
CONV_F32_TILE_COLS = (8, 16, 32, 64)
_F32_MAXHALO = 4 * 66
_F32_FIXED = 128 + 16 * _F32_MAXHALO
_F32_HALO = _F32_MAXHALO * CONV_F32_KC * 4
# the most K parts a float32 launch is split into, and the fewest
# 8-channel chunks a part takes
CONV_F32_MAX_SPLIT, CONV_F32_MIN_CHUNKS = 16, 4


def conv3x3_f32_smem(ns: int, parts: int, stages: int) -> int:
    return _F32_FIXED + stages * (_F32_HALO + 9 * CONV_F32_KC * ns * 4
                                  * parts)


def conv3x3_f32_slices(cout: int, parts: int) -> tuple[int, int]:
    """(slices, NS) of the float32 K3: at most 128 output channels a slice
    with ``wh`` alone, 96 with ``wh`` and ``wl`` (three stages of both fit
    in shared memory)."""
    return kernels.tf32_slices(cout, 128 if parts == 1 else 96)


def _f32_tile_cols(h: int, w: int) -> int:
    """The float32 tile's columns: the fewest halo pixels staged over the
    canvas, the wider tile on a tie (16 x 16 and 32 x 32 levels fill 8 x
    16 tiles; wide canvases take 8 x 16 too, 180 halo pixels a tile
    against 264 for 2 x 64)."""
    def staged(c):
        r = CONV_F32_PIXELS // c
        return -(-h // r) * -(-w // c) * (r + 2) * (c + 2)
    return min(CONV_F32_TILE_COLS, key=lambda c: (staged(c), -c))


@functools.lru_cache(maxsize=4096)
def conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype = torch.bfloat16, parts: int = 1,
                 sms: int = kernels.H100_SMS) -> kernels.LaunchPlan:
    """The K3 launch for a (b, h, w, cin) -> cout conv.

    bf16: one block per (2 rows, 64 pixels, output-channel slice), the
    deepest ring of 2-4 stages that fits (each stage a 16-channel chunk: 9
    x 16 x NS weights and the 4 x 66-pixel halo).

    float32 (``parts`` 1 or 2: the weight form's split-TF32 parts): one
    block per (128-pixel tile of ``tile`` columns, K part, output-channel
    slice); the deepest ring of 2-5 stages that fits (each stage an
    8-channel chunk: 9 x 8 x NS weights of each part and the halo). Where
    the tiles and slices make fewer blocks than ``sms``, the 8-channel
    chunks are cut into ``split`` contiguous parts (as many as keep one
    wave, at most 16, at least 4 chunks a part), summed by a second pass in
    a fixed order. :func:`conv3x3_blocks` lists what each block covers."""
    if dtype == torch.bfloat16:
        nsl, ns = kernels.gemm_slices(cout)
        stages = max(s for s in (2, 3, 4)
                     if s == 2 or conv3x3_smem(ns, s) <= kernels.SMEM_LIMIT)
        grid = b * -(-h // CONV_ROWS) * -(-w // CONV_PIXELS) * nsl
        return kernels.LaunchPlan(grid, 256, nsl, ns, stages,
                                  conv3x3_smem(ns, stages))
    nsl, ns = conv3x3_f32_slices(cout, parts)
    tc = _f32_tile_cols(h, w)
    tr = CONV_F32_PIXELS // tc
    blocks = b * -(-h // tr) * -(-w // tc) * nsl
    nc = -(-cin // CONV_F32_KC)
    split = 1
    if blocks < sms:
        split = max(1, min(sms // blocks, nc // CONV_F32_MIN_CHUNKS,
                           CONV_F32_MAX_SPLIT))
    stages = max(s for s in (2, 3, 4, 5)
                 if s == 2 or conv3x3_f32_smem(ns, parts, s)
                 <= kernels.SMEM_LIMIT)
    return kernels.LaunchPlan(blocks * split, 256, nsl, ns, stages,
                              conv3x3_f32_smem(ns, parts, stages), 0, tc,
                              split)


def conv3x3_blocks(plan: kernels.LaunchPlan, b: int, h: int, w: int,
                   cin: int, cout: int):
    """What each block of a float32 :func:`conv3x3_plan` launch computes,
    in grid order, by the kernel's own block decode (csrc/conv3x3.cu:
    conv3x3_tf32_kernel): (image, rows y0..y1, columns x0..x1, output
    channels n0..n1, input channels c0..c1), ends exclusive and clipped to
    the conv's shape."""
    tc = plan.tile
    tr = CONV_F32_PIXELS // tc
    nxt, nyt = -(-w // tc), -(-h // tr)
    nc = -(-cin // CONV_F32_KC)
    for bid in range(plan.grid):
        sl, rest = bid % plan.slices, bid // plan.slices
        sp, rest = rest % plan.split, rest // plan.split
        x0, rest = rest % nxt * tc, rest // nxt
        y0, bb = rest % nyt * tr, rest // nyt
        c0 = sp * nc // plan.split
        c1 = (sp + 1) * nc // plan.split
        yield (bb, y0, min(y0 + tr, h), x0, min(x0 + tc, w),
               sl * plan.ns, min(sl * plan.ns + plan.ns, cout),
               c0 * CONV_F32_KC, min(c1 * CONV_F32_KC, cin))


def conv3x3_fits(h: int, w: int) -> bool:
    """The shape rule by which the JAX package's heads send a conv to its
    TPU kernel (``conv3x3_supported`` less its TPU memory budget, which the
    serving shapes meet): H and W multiples of 8, W >= 128. The port's
    ``upsample_tail`` follows it, so both run the same convs as kernels."""
    return h % 8 == 0 and w % 8 == 0 and w >= 128


def _conv3x3_cuda(x, k: Conv3x3Weights, act, res, roll, ln_pre):
    bsz, h, wd, cin = x.shape
    cout = k.cout
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dtype == torch.bfloat16:
        plan = conv3x3_plan(bsz, h, wd, cin, cout)
        want = (plan.slices, -(-cin // 16), 9, 2, plan.ns // 8, 8, 8)
    else:
        plan = conv3x3_plan(bsz, h, wd, cin, cout, torch.float32,
                            parts=k.parts, sms=kernels.sm_count(x.device))
        want = (plan.slices, -(-cin // CONV_F32_KC), k.parts, 9, 2,
                plan.ns // 8, 8, 4)
    if k.cin != cin or k.w.dtype != x.dtype or not k.w.is_contiguous() \
            or k.w.shape != want:
        raise ValueError(f"weight {tuple(k.w.shape)} {k.w.dtype} is not the "
                         f"kernel form for input {tuple(x.shape)} {x.dtype}")
    if k.b is not None and (k.b.dtype != torch.float32
                            or k.b.shape != (cout,)):
        raise ValueError("conv3x3 bias must be float32 (Cout,)")
    x = x.contiguous()
    wk, bk = k.w, k.b
    if res is not None:
        if res.shape != (bsz, h, wd, cout) or res.dtype != x.dtype:
            raise ValueError(f"residual {tuple(res.shape)} {res.dtype} "
                             f"does not fit output {(bsz, h, wd, cout)}")
        res = res.contiguous()
    lg = lb = None
    if ln_pre is not None:
        lg, lb = (p.float().contiguous() for p in ln_pre)
    for t in (wk, bk, res, lg, lb):
        if t is not None and t.device != x.device:
            raise ValueError("conv3x3 operands on different devices")
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = kernels.load("conv3x3")

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = [ptr(x), ptr(wk), ptr(bk), ptr(res), ptr(lg), ptr(lb), ptr(out)]
    if x.dtype == torch.bfloat16:
        fn = lib.conv3x3_bf16
        args += [bsz, h, wd, cin, cout, int(roll), _ACTS[act], plan.ns,
                 plan.stages, plan.smem]
    else:
        # split K's float32 partial sums, added in order by a second pass
        ws = torch.empty((plan.split, bsz * h * wd, cout),
                         dtype=torch.float32, device=x.device) \
            if plan.split > 1 else None
        fn = lib.conv3x3_f32
        args += [ptr(ws), bsz, h, wd, cin, cout, int(roll), _ACTS[act],
                 plan.ns, k.parts, plan.tile, plan.split, plan.stages,
                 plan.smem, int(cin % 4 == 0 and x.data_ptr() % 16 == 0)]
    npt = 8 if x.dtype == torch.float32 else 7
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * npt \
        + [ctypes.c_int] * (len(args) - npt) + [ctypes.c_void_p]
    err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "conv3x3")
    conv3x3.launches += 1
    return out


def _conv3x3_launch(side, x, w, b, res, lg, lb):
    form, act, roll = side
    k = form if form is not None else conv3x3_weights(w, b, x.dtype)
    return _conv3x3_cuda(x, k, act, res, roll,
                         None if lg is None else (lg, lb))


def _conv3x3_plain(side, x, w, b, res, lg, lb):
    form, act, roll = side
    if w is None:  # the kernel form alone: its weights are constants
        w, b = form.hwio, form.b
    return conv3x3_plain(x, w, b, act=act, res=res, roll=roll,
                         ln_pre=None if lg is None else (lg, lb))


_conv3x3_function = kernel_function("conv3x3", _conv3x3_launch,
                                    _conv3x3_plain)


def conv3x3(x: torch.Tensor, w: torch.Tensor | Conv3x3Weights,
            b: torch.Tensor | None = None, *, act: str | None = None,
            res: torch.Tensor | None = None, roll: int = 0,
            ln_pre: tuple[torch.Tensor, torch.Tensor] | None = None,
            params: tuple | None = None) -> torch.Tensor:
    """SAME 3x3 conv, stride 1, channels-last.

    Args:
        x: (B, H, W, Cin), float32 or bfloat16.
        w: (3, 3, Cin, Cout) weights (the JAX package's HWIO layout), or
            their kernel form from :func:`conv3x3_weights` for ``x.dtype``,
            which holds the bias (``b`` is then None). Callers that launch
            a weight more than once keep its kernel form.
        b: optional (Cout,) bias.
        act: None | "lrelu" (slope 0.01) | "lrelu2" (slope 0.2).
        res: optional (B, H, W, Cout) residual, added after ``act``.
        roll: convolve the cyclically rolled canvas
            ``torch.roll(x, (roll, roll), dims=(1, 2))`` (any size), without
            a separate roll pass.
        ln_pre: optional (scale, bias) of a LayerNorm over Cin (eps 1e-5)
            applied before the conv; the zero padding applies to its output.
        params: with a kernel form ``w``, the (HWIO weight, bias or None)
            it was made from; gradients reach them. Without, the form's
            weights are constants.

    A CUDA tensor runs the K3 kernel (``csrc/conv3x3.cu``) or raises; a CPU
    tensor runs :func:`conv3x3_plain`. Under autograd the backward is
    :func:`conv3x3_plain`'s VJP (``ops/autograd.py``) in every input:
    ``x``, the weights, the bias, ``res`` and the LayerNorm's parameters.
    """
    if isinstance(w, Conv3x3Weights):
        if b is not None:
            raise ValueError("the kernel form holds the bias; pass b=None")
        form, (wd, bd) = w, params or (None, None)
    else:
        form, wd, bd = None, w, b
    lg, lb = ln_pre if ln_pre is not None else (None, None)
    return _conv3x3_function((form, act, roll), x, wd, bd, res, lg, lb)


conv3x3.launches = 0


# ---------------------------------------------------------------------------
# conv3x3_pair: two chained SAME convs in one launch (K7)

# the card's limits (both kernels' staging) and K7's bf16 tile: 6 x 62
# outputs, u on 8 x 64, the input on 10 x 66
PAIR_MAX_CIN = 64
PAIR_MAX_COUT = 32
PAIR_ROWS, PAIR_COLS = 6, 62
# its stage table holds 64 stages a tile (Q_MAXSEQ): 10 chunks of u
PAIR_MAX_CMID_BF16 = 640


def _check_pair(x, w1, w2, act_mid):
    _, h, wd, cin = x.shape
    if not conv3x3_fits(h, wd):
        raise ValueError(f"conv3x3_pair needs H % 8 == 0, W % 8 == 0 and "
                         f"W >= 128 (got {h}x{wd})")
    if act_mid not in (None, "lrelu"):
        raise ValueError(f"conv3x3_pair: act_mid must be None or 'lrelu', "
                         f"not {act_mid!r}")
    if w1.shape[:3] != (3, 3, cin) or w2.shape[:3] != (3, 3, w1.shape[3]):
        raise ValueError(f"conv3x3_pair: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not chain from Cin {cin}")


def conv3x3_pair_plain(x, w1, b1, w2, b2, *, act_mid=None):
    """Plain PyTorch version of :func:`conv3x3_pair`: two
    :func:`conv3x3_plain` calls, so ``u`` is cast to ``x.dtype`` between
    them, as the TPU kernel casts it."""
    _check_pair(x, w1, w2, act_mid)
    u = conv3x3_plain(x, w1, b1, act=act_mid)
    return conv3x3_plain(u, w2, b2)


class Conv3x3PairWeights(NamedTuple):
    """K7's weight form (:func:`conv3x3_pair_weights`), made once per
    weight, in K3's packed order (:func:`_pack_taps`), the kernel's
    64-channel chunks of u as ``w1``'s slices. In bfloat16 ``w1`` (Cmid/64,
    Cin/16, 9, 2, 8, 8, 8), Cin padded to 16 and Cmid to 64; ``w2`` (1,
    Cmid/16, 9, 2, Cout/8, 8, 8), Cout padded to 8. In float32 the
    split-TF32 form with both parts, ``wh = tf32_round(w)`` and ``wl = w -
    wh`` (``wh + wl == w`` bit for bit), as K3's float32 form: ``w1``
    (Cmid/64, Cin/8, 2, 9, 2, 8, 8, 4), Cin padded to 8; ``w2`` (1, Cmid/8,
    2, 9, 2, Cout/8, 8, 4), Cmid padded to 64 and Cout to 8, 16 or 32. The
    biases float32, zero-padded to the padded widths."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    cin: int
    cmid: int
    cout: int

    @property
    def hwio(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """(w1, b1, w2, b2) as the (3, 3, Cin, Cmid) and (3, 3, Cmid,
        Cout) weights and their biases this form holds."""
        w1, w2 = (_unpack_taps(w[:, :, 0] + w[:, :, 1] if w.dim() == 8
                               else w) for w in (self.w1, self.w2))
        return (w1[:, :, :self.cin, :self.cmid], self.b1[:self.cmid],
                w2[:, :, :self.cmid, :self.cout], self.b2[:self.cout])


# K7's chunk of Cmid (csrc/conv3x3_pair.cu: Q_MC, T_MC)
PAIR_CHUNK = 64
# the float32 kernel's tile (csrc/conv3x3_pair.cu: T_TH, T_TW) and its
# conv2 widths: Cout padded to one of these
PAIR_F32_ROWS, PAIR_F32_COLS = 6, 30
PAIR_F32_COUT = (8, 16, 32)


def pair_f32_coutp(cout: int) -> int:
    """Cout padded to the float32 K7's conv2 width."""
    return next(n for n in PAIR_F32_COUT if n >= cout)


def _pair_split(w: torch.Tensor, nsl: int, ns: int) -> torch.Tensor:
    """Both split-TF32 parts of a float32 weight in K3's float32 packed
    order, stacked as dim 2 (the kernel always runs three products)."""
    wh = kernels.tf32_round(w.float().contiguous())
    return torch.stack([_pack_taps(p, nsl, ns, CONV_F32_KC)
                        for p in (wh, w.float() - wh)], dim=2)


def conv3x3_pair_weights(w1, b1, w2, b2, dtype) -> Conv3x3PairWeights:
    cin, cmid, cout = w1.shape[2], w1.shape[3], w2.shape[3]
    k1, k2 = w1.detach().to(dtype), w2.detach().to(dtype)
    pm = -cmid % PAIR_CHUNK
    if dtype == torch.bfloat16:
        po = -cout % 8
        k1 = _pack_taps(k1, (cmid + pm) // PAIR_CHUNK, PAIR_CHUNK)
        k2 = _pack_taps(F.pad(k2, (0, 0, 0, pm)), 1, cout + po)
    else:
        po = pair_f32_coutp(cout) - cout
        k1 = _pair_split(k1, (cmid + pm) // PAIR_CHUNK, PAIR_CHUNK)
        k2 = _pair_split(F.pad(k2, (0, 0, 0, pm)), 1, cout + po)
    return Conv3x3PairWeights(
        k1.contiguous(), F.pad(b1.detach().float(), (0, pm)).contiguous(),
        k2.contiguous(), F.pad(b2.detach().float(), (0, po)).contiguous(),
        cin, cmid, cout)


_PAIR_BF16_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]
_PAIR_F32_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


def _conv3x3_pair_cuda(x, k: Conv3x3PairWeights, act_mid):
    bsz, h, wd, cin = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_pair kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if cin > PAIR_MAX_CIN or k.cout > PAIR_MAX_COUT:
        raise ValueError(f"conv3x3_pair on the card holds the whole input "
                         f"tile in shared memory: Cin <= {PAIR_MAX_CIN} and "
                         f"Cout <= {PAIR_MAX_COUT} (got {cin}, {k.cout})")
    for t in (k.w1, k.b1, k.w2, k.b2):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3_pair operands on different devices")
    if k.w1.dtype != x.dtype or k.w2.dtype != x.dtype:
        raise ValueError("conv3x3_pair weights are not the kernel form for "
                         f"{x.dtype}")
    if x.dtype == torch.bfloat16 and k.cmid > PAIR_MAX_CMID_BF16:
        raise ValueError(f"bf16 conv3x3_pair on the card streams at most "
                         f"{PAIR_MAX_CMID_BF16} channels of u a tile "
                         f"(got Cmid {k.cmid})")
    x = x.contiguous()
    out = torch.empty((bsz, h, wd, k.cout), dtype=x.dtype, device=x.device)
    cmidp = k.w1.shape[0] * PAIR_CHUNK
    if x.dtype == torch.bfloat16:
        cinp, coutp = k.w1.shape[1] * 16, k.w2.shape[4] * 8
        tiles = bsz * -(-h // PAIR_ROWS) * -(-wd // PAIR_COLS)
        fn = kernels.function("conv3x3_pair", "conv3x3_pair_bf16",
                              _PAIR_BF16_ARGS)
        err = fn(x.data_ptr(), k.w1.data_ptr(), k.b1.data_ptr(),
                 k.w2.data_ptr(), k.b2.data_ptr(), out.data_ptr(), bsz, h, wd,
                 cin, cinp, cmidp, k.cout, coutp, _ACTS[act_mid],
                 min(tiles, kernels.sm_count(x.device)), kernels.stream(x))
    else:
        if k.w1.dim() != 8 or k.w2.dim() != 8:
            raise ValueError("conv3x3_pair weights are not the float32 "
                             "split-TF32 form")
        fn = kernels.function("conv3x3_pair", "conv3x3_pair",
                              _PAIR_F32_ARGS)
        err = fn(x.data_ptr(), k.w1.data_ptr(), k.b1.data_ptr(),
                 k.w2.data_ptr(), k.b2.data_ptr(), out.data_ptr(), bsz, h, wd,
                 cin, cmidp, k.cout, k.w2.shape[5] * 8, _ACTS[act_mid],
                 int(cin % 4 == 0 and x.data_ptr() % 16 == 0),
                 kernels.stream(x))
    kernels.check(err, "conv3x3_pair")
    conv3x3_pair.launches += 1
    return out


def pair_conv_tile_plain(a: torch.Tensor, w: torch.Tensor,
                         dx: int) -> torch.Tensor:
    """Plain version of :func:`pair_conv_tile`."""
    return a.float()[dx:dx + 64] @ w.float()


def pair_conv_tile(a: torch.Tensor, w: torch.Tensor, dx: int) -> torch.Tensor:
    """K7's product form, its own check: ``a`` (66, K) bf16 pixels x
    channels (K 16..64 a multiple of 16), staged as K7 stages its halo and
    read by a no-swizzle descriptor from pixel ``dx`` (0-2) on; ``w`` (K,
    N) bf16 (N 16 or 64), packed as one :func:`kernel_matrix` slice; returns
    ``a[dx:dx + 64] @ w`` in float32 (one warpgroup, one wgmma a k16 step).
    A CPU tensor takes :func:`pair_conv_tile_plain`."""
    if not a.is_cuda:
        return pair_conv_tile_plain(a, w, dx)
    from .swin_block import _core_matrices
    k, n = w.shape
    a = a.contiguous()
    wp = _core_matrices(w.to(torch.bfloat16), 1, n).contiguous()
    out = torch.empty((64, n), dtype=torch.float32, device=a.device)
    fn = kernels.function("conv3x3_pair", "pair_conv_tile",
                          [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                          + [ctypes.c_void_p])
    err = fn(a.data_ptr(), wp.data_ptr(), out.data_ptr(), k, n, dx,
             kernels.stream(a))
    kernels.check(err, "pair_conv_tile")
    return out


def conv3x3_pair(x, w1, b1=None, w2=None, b2=None, *, act_mid=None):
    """``conv3x3(act_mid(conv3x3(x, w1) + b1), w2) + b2``, both SAME with
    zero padding: the TPU's ``conv3x3_pair_pallas``.

    Args:
        x: (B, H, W, Cin), float32 or bfloat16, H and W multiples of 8,
            W >= 128 (the TPU kernel's shape rule; ValueError otherwise).
        w1, b1: (3, 3, Cin, Cmid) and (Cmid,); w2, b2: (3, 3, Cmid, Cout)
            and (Cout,). Or ``w1`` is their :func:`conv3x3_pair_weights`
            form for ``x.dtype`` and the rest are None.
        act_mid: None or "lrelu" (slope 0.01), applied to ``u``.

    Cast points are the TPU kernel's: conv1 sums in float32, then ``+ b1``
    and the activation, then ``u`` is cast to ``x.dtype``; conv2 sums in
    float32, then ``+ b2`` and one cast. The padding around ``u`` is zero
    at every width (where the JAX kernel's 960-column chunk split pads W,
    its padded column of ``u`` is ``act(b1 + conv1 of the edge)``, and the
    last output column differs).

    A CUDA tensor runs one K7 launch (``csrc/conv3x3_pair.cu``; Cin <= 64,
    Cout <= 32) or raises; a CPU tensor runs :func:`conv3x3_pair_plain`.
    """
    forbid_grad("conv3x3_pair", x, w1, b1, w2, b2)
    if isinstance(w1, Conv3x3PairWeights):
        k = w1
        w1, b1, w2, b2 = k.hwio
    else:
        k = None
    _check_pair(x, w1, w2, act_mid)
    if not x.is_cuda:
        return conv3x3_pair_plain(x, w1, b1, w2, b2, act_mid=act_mid)
    if k is None:
        k = conv3x3_pair_weights(w1, b1, w2, b2, x.dtype)
    return _conv3x3_pair_cuda(x, k, act_mid)


conv3x3_pair.launches = 0


def conv_after_shuffle_weights(w: torch.Tensor, r: int) -> torch.Tensor:
    """Weights for running a conv before the pixel-shuffle:
    ``conv(pixel_shuffle(x, r), w) == pixel_shuffle(conv(x, w'), r)``.

    Args:
        w: (k, k, Cin, Cout) weights (k odd) of the conv after the shuffle.
        r: the pixel-shuffle factor.
    Returns:
        (kp, kp, Cin*r^2, Cout*r^2), kp = 2 * ceil((k // 2) / r) + 1. (Bias:
        ``b.repeat_interleave(r * r)``.)
    """
    k, _, cin, cout = w.shape
    if k % 2 != 1:
        raise ValueError(f"odd kernel size required, got {k}")
    rad = k // 2
    radp = -(-rad // r)
    kp = 2 * radp + 1
    wp = w.new_zeros(kp, kp, cin * r * r, cout * r * r)
    for i in range(r):
        for j in range(r):
            for dy in range(-rad, rad + 1):
                for dx in range(-rad, rad + 1):
                    a, dyp = (i + dy) % r, (i + dy) // r
                    bb, dxp = (j + dx) % r, (j + dx) // r
                    wp[dyp + radp, dxp + radp, a * r + bb::r * r,
                       i * r + j::r * r] = w[dy + rad, dx + rad]
    return wp


def compose_conv_weights(wa: torch.Tensor, ba: torch.Tensor,
                         wb: torch.Tensor, bb: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weights and bias of ``conv_b(conv_a(x) + ba) + bb`` as one conv
    (kernel ka + kb - 1), in float32. Exact in the interior; within a
    (ka//2 + kb//2)-pixel border ring the zero padding differs, so callers
    recompute the ring sequentially."""
    ka, _, cin, _ = wa.shape
    kb, _, _, cout = wb.shape
    waf, wbf = wa.float(), wb.float()
    w = waf.new_zeros(ka + kb - 1, ka + kb - 1, cin, cout)
    for dy in range(kb):
        for dx in range(kb):
            w[dy:dy + ka, dx:dx + ka] += torch.einsum("ijcm,mo->ijco", waf,
                                                      wbf[dy, dx])
    b = bb.float() + ba.float() @ wbf.sum(dim=(0, 1))
    return w, b
