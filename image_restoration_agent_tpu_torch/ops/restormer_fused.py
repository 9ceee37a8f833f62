"""Restormer's two fused blocks, GDFN and MDTA, on one (B, H, W, C) canvas.

Replaces ``image_restoration_agent_tpu/ops/restormer_fused.py``:

- ``gdfn_block_pallas`` by :func:`gdfn_block` (K4):
  ``x + project_out(gelu(dw(1x1_a(LN(x)))) * dw(1x1_b(LN(x))))``;
- ``mdta_block_pallas`` by :func:`mdta_block`: the front kernel
  ``_mdta_kernel`` by :func:`mdta_front` (K5: LN, the qkv 1x1, the
  depthwise 3x3; it writes only ``v``, the float32 q^T k gram and the
  per-channel sums of squares of q and k), then :func:`mdta_epilogue`,
  plain PyTorch as the JAX package leaves it to XLA: the reciprocal norms
  (``F.normalize``), temperature, a float32 softmax, ``project_out`` folded
  into one per-sample (C, C) matrix ``M``, and ``v @ M`` plus the residual.

Cast points (the TPU kernels', kept by the CUDA kernels and the plain
versions alike): the LN output is cast to ``x.dtype``; each 1x1 sums in
float32, adds its bias and is cast to ``x.dtype``; the 1-pixel ring of the
1x1 output outside the canvas is zero (the depthwise conv's SAME padding
applies to the 1x1 *output*, which is not zero where a bias is); the
depthwise conv sums in float32; in GDFN the gate is cast to ``x.dtype``
before ``project_out``, which sums in float32 and adds bias and residual in
float32 before one cast; in MDTA the gram is taken over q and k cast to
``x.dtype``, the sums of squares over the float32 q and k. ``fast`` (the
bf16 serving mode) takes the tanh GELU, else the erf GELU.

The CUDA kernels are ``csrc/restormer_fused.cu``:

- What bounds them on the H100: per pixel GDFN does ~6*C*hid FLOP
  (hid = int(2.66 C)) against 4*C bytes of bf16 in and out, 16*hid FLOP
  per byte (2,000 at C 48): the arithmetic bounds it, and in bf16 the
  tensor-core rate. MDTA's front is ~6*C^2 FLOP per pixel against 4*C
  bytes (1.5*C FLOP per byte), bound the same way.
- Design: a block owns a tile of output pixels and stages LN(x) over the
  tile plus its 1-pixel halo in shared memory once. The depthwise conv
  splits the hidden channels into independent chunks of :data:`CHUNK`, so
  per chunk the block runs the 1x1 over the halo, the ring zeroing, the
  nine taps and (GDFN) the gate and a partial ``project_out``, or (MDTA)
  stores q and k of the tile and writes v. Nothing of width ``2*hid`` or
  ``3*C`` reaches device memory. The weights are split and zero-padded
  once per weight (:func:`gdfn_weights`, :func:`mdta_weights`): chunk
  ``i`` of every group sits side by side, so one product covers x1 and x2
  (or q, k and v).
- K4 in bf16 runs both 1x1 products on the tensor cores (``mma.sync``
  m16n8k16, float32 accumulators): A by ``ldmatrix`` from the staged halo
  or gate tile, B as fragments read from a packed form made once per
  weight (:func:`frag_pack`), and ``project_out``'s accumulators stay in
  registers across all chunks (48 floats a thread). The tile is chosen
  per C (:func:`gdfn_plan`): 16x32 up to C 48 (halo 1.20x the outputs),
  16x16 at C 96 (1.27x), 8x16 at C 192 (1.41x), 8x8 at C 384 (1.56x), so
  that the (pixels x C) accumulator fits the block's registers. The
  depthwise taps and the GELU gate stay float32 FMA from shared memory.
- K5 in bf16 shares K4's staging, 1x1 and tap code: the qkv 1x1 on the
  tensor cores from a packed form (``w_qkv_f``, chunk ``i``'s 96
  interleaved q/k/v columns), the taps in float32, v stored in bf16, q and
  k rounded to bf16 into pixel-major tiles, and the per-head gram q_h^T k_h
  on ``mma.sync`` with A and B by ``ldmatrix.trans`` from those tiles. The
  gram's accumulators stay in registers across the block's whole run of
  tiles: warp ``w`` owns a gram tile of (m16, n8) mma tiles of one head,
  the smallest of 1x2, 1x3, 3x2 and 3x3 whose tiles the warps hold, so no
  warp takes two (8 to 36 floats a thread: they stay live through every
  phase, and 36 at every shape made the taps spill); 384-thread blocks
  (168 registers) for the first three, 512 for 3x3 (C 384, 8 heads). A
  ragged head width is padded to 16 (the padded rows and columns are
  dropped). The tile is chosen per (C, heads) (:func:`mdta_plan`): 16x16 up
  to C 48, 12x16 at C 96, 8x16 at C 192, 8x8 at C 384, the largest whose
  shared memory fits now that the gram has left it.
- K4 and K5 in f32 run their products on FP32 FMA (4x4 outputs per
  thread) with a float32 ``project_out`` tile or gram in shared memory.
- MDTA's cross-block sums: each block takes a fixed run of tiles of one
  sample and keeps its sums; a second launch sums the per-block partials
  in block order. No atomics, so the result is the same bit for bit from
  run to run on one card and shape. The gram is kept only for the
  per-head diagonal blocks (B, heads, C_h, C_h): the epilogue reads
  nothing else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import exact_f32
from . import kernels
from .autograd import kernel_function

CHUNK = 32          # hidden channels per chunk (csrc/restormer_fused.cu: HC)
_VMEM_BUDGET = 96 * 1024 * 1024
_MAX_CHUNK = 768
_DT = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# the JAX package's shape rule


def _grid_for(h: int, w: int, cin: int, ftot: int):
    """(rrows, col_chunk, n_chunks) or None: a copy of the TPU kernels' grid
    choice, kept whole (its TPU memory estimate included) because it
    decides which blocks the JAX package sends to the fused kernels."""
    nch = None
    for n in range(-(-w // _MAX_CHUNK), 17):
        if w % n == 0 and (w // n) % 8 == 0 and w // n >= 128:
            nch = n
            break
    if nch is None:
        return None
    cc = w // nch
    for r in (16, 8):
        if h % r:
            continue
        m = (r + 2) * (cc + 2)
        est = (2 * ((r + 2) * (cc + 16) * cin * 2)
               + m * cin * 4
               + 2 * (m * ftot * 4)
               + r * cc * ftot * 4
               + 9 * cin * ftot * 2
               + 2 * (r * cc * cin * 2))
        if est <= _VMEM_BUDGET:
            return r, cc, nch
    return None


def restormer_fused_supported(h: int, w: int, cin: int, ftot: int) -> bool:
    """Whether the JAX package runs a block of this shape through its fused
    kernels (``ops/restormer_fused.py:restormer_fused_supported``). The port
    routes by the same rule: the fused and unfused routes round at
    different points in bf16, so a routing difference would show as a
    parity difference."""
    if h % 8 != 0 or w % 8 != 0 or w < 128:
        return False
    return _grid_for(h, w, cin, ftot) is not None


# ---------------------------------------------------------------------------
# shared pieces of the plain versions


def _apply_ln(x: torch.Tensor, ln) -> torch.Tensor:
    """The fused blocks' LayerNorm over channels: float32 two-pass stats,
    eps 1e-5, rsqrt; ``ln`` None | (scale,) BiasFree (mean kept) |
    (scale, bias); result cast to ``x.dtype``."""
    if ln is None:
        return x
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + 1e-5)
    if len(ln) == 1 or ln[1] is None:
        y = xf * rs * ln[0].float()
    else:
        y = (xf - mu) * rs * ln[0].float() + ln[1].float()
    return y.to(x.dtype)


def _one_by_one_dw(y, w, b, dw, bdw):
    """1x1 (float32 sums, bias, cast to ``y.dtype``) then the depthwise 3x3
    with zero padding of the 1x1 output (float32 sums, then its bias)."""
    dt = y.dtype
    u = y.float() @ w.to(dt).float()
    if b is not None:
        u = u + b.float()
    u = u.to(dt).float()
    f = u.shape[-1]
    d = F.conv2d(u.permute(0, 3, 1, 2), dw.float().t().reshape(f, 1, 3, 3),
                 padding=1, groups=f).permute(0, 2, 3, 1)
    if bdw is not None:
        d = d + bdw.float()
    return d


def _gelu_gate(x1: torch.Tensor, x2: torch.Tensor, fast: bool
               ) -> torch.Tensor:
    if fast:
        return 0.5 * x1 * (1.0 + torch.tanh(
            0.7978845608028654 * (x1 + 0.044715 * x1 * x1 * x1))) * x2
    return 0.5 * x1 * (1.0 + torch.erf(x1 * 2.0 ** -0.5)) * x2


def _interleave(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(..., groups*F) -> (..., nch*groups*CHUNK): each group zero-padded to
    nch*CHUNK channels, chunk ``i`` of every group side by side."""
    *lead, gf = t.shape
    f = gf // groups
    nch = -(-f // CHUNK)
    t = F.pad(t.reshape(*lead, groups, f), (0, nch * CHUNK - f))
    t = t.reshape(*lead, groups, nch, CHUNK).transpose(-3, -2)
    return t.reshape(*lead, nch * groups * CHUNK).contiguous()


def _ln_mode(ln) -> int:
    if ln is None:
        return 0
    return 1 if len(ln) == 1 or ln[1] is None else 2


def _f32(t):
    return None if t is None else t.detach().float().contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


_plans: dict[tuple, tuple[int, int, int]] = {}


def _plan(kind: int, dtype: torch.dtype, c: int, heads: int
          ) -> tuple[int, int, int]:
    """(tile rows, tile cols, shared bytes) the kernel takes for C."""
    key = (kind, dtype, c, heads)
    if key not in _plans:
        lib = kernels.load("restormer_fused")
        fn = lib.restormer_plan
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        out = (ctypes.c_int * 3)()
        if fn(kind, _DT[dtype], c, heads, out) != 0:
            raise ValueError(f"no tile of the restormer kernel {kind} fits "
                             f"shared memory at C={c}, heads={heads}")
        _plans[key] = (out[0], out[1], out[2])
    return _plans[key]


def _check_x(x: torch.Tensor, c: int, what: str) -> torch.Tensor:
    if x.dtype not in _DT:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.ndim != 4 or x.shape[-1] != c:
        raise ValueError(f"{what}: input {tuple(x.shape)} is not "
                         f"(B, H, W, {c})")
    if c % 4:
        raise ValueError(f"{what} kernel takes C a multiple of 4, not {c}")
    return x.contiguous()


def _check_on(x: torch.Tensor, tensors, dtype, what: str) -> None:
    if dtype != x.dtype:
        raise ValueError(f"{what}: weights in kernel form for {dtype}, "
                         f"input {x.dtype}")
    for t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: operands on different devices")


# ---------------------------------------------------------------------------
# K4: GDFN


class GdfnPlan(NamedTuple):
    """K4's bf16 launch plan for one C: a ``th`` x ``tw`` output tile per
    block of ``threads`` threads; project_out's (th*tw, C) output as warp
    tiles of ``mt`` m16 rows x ``ntw`` n8 columns, ``wn`` warps across the
    ``cols`` = 8*ntw*wn >= C columns; ``smem`` bytes of shared memory
    (``csrc/restormer_fused.cu``: gdfn_mma_smem)."""

    th: int
    tw: int
    threads: int
    mt: int
    ntw: int
    wn: int
    cols: int
    smem: int


# (largest C, th, tw, threads, mt, ntw, wn): each keeps project_out's
# accumulators at 48 floats a thread (th*tw*cols = 48 * threads)
_GDFN_PLANS = ((48, 16, 32, 512, 2, 6, 1), (96, 16, 16, 512, 2, 6, 2),
               (192, 8, 16, 512, 1, 12, 2), (384, 8, 8, 512, 1, 12, 4))


def gdfn_plan(c: int) -> GdfnPlan:
    """The bf16 K4 plan for C (the first of :data:`_GDFN_PLANS` whose
    columns hold C)."""
    for cmax, th, tw, threads, mt, ntw, wn in _GDFN_PLANS:
        if c <= cmax:
            hp = (th + 2) * (tw + 2)
            smem = 2 * ((-(-hp // 16) * 16) * (-(-c // 16) * 16 + 8)
                        + hp * (2 * CHUNK + 8) + th * tw * (CHUNK + 8))
            return GdfnPlan(th, tw, threads, mt, ntw, wn, 8 * ntw * wn, smem)
    raise ValueError(f"gdfn_block's bf16 kernel takes C <= 384, not {c}")


def frag_pack(w: torch.Tensor, kp: int, np_: int | None = None
              ) -> torch.Tensor:
    """(K, N) -> the mma.sync m16n8k16 B fragments of ``csrc/common.cuh``
    (mma_bf16), (kp/16, np_/8, 32, 4): K zero-padded to ``kp`` and N to
    ``np_`` (multiples of 16 and 8), each 16 x 8 block as 32 lanes of 4
    values, lane 4g + t holding B[2t, g], B[2t+1, g], B[2t+8, g], B[2t+9, g]
    (one 8-byte load a lane, 256 contiguous bytes a warp)."""
    k, n = w.shape
    np_ = n if np_ is None else np_
    w = F.pad(w, (0, np_ - n, 0, kp - k))
    w = w.reshape(kp // 16, 2, 4, 2, np_ // 8, 8)
    return w.permute(0, 4, 5, 2, 1, 3).reshape(kp // 16, np_ // 8, 32, 4)


class GdfnWeights(NamedTuple):
    """One GDFN's weights: ``params`` as given (the plain version's
    operands) and their kernel form for ``dtype``, made once per weight by
    :func:`gdfn_weights`: the 1x1 weights in ``dtype``, w_in and the
    depthwise weights and biases chunk-interleaved (x1 and x2 chunk ``i``
    side by side, the ragged hidden width zero-padded to a multiple of
    :data:`CHUNK`), w_out zero-padded to (nch*CHUNK, C rounded up to 4);
    LN, depthwise weights and every bias in float32. In bf16 also the
    tensor-core kernel's forms: ``w_in_f`` (nch, C16/16, 8, 32, 4), chunk
    ``i``'s 64 interleaved columns as :func:`frag_pack` fragments (C16 = C
    rounded up to 16), and ``w_out_f`` (nch, 2, NP/8, 32, 4), chunk ``i``'s
    32 rows of w_out over the plan's NP >= C columns; None in f32."""

    params: tuple
    dtype: torch.dtype
    c: int
    nch: int
    ln_w: torch.Tensor | None
    ln_b: torch.Tensor | None
    w_in: torch.Tensor
    b_in: torch.Tensor | None
    w_dw: torch.Tensor
    b_dw: torch.Tensor | None
    w_out: torch.Tensor
    b_out: torch.Tensor | None
    w_in_f: torch.Tensor | None = None
    w_out_f: torch.Tensor | None = None


def gdfn_weights(ln, w_in, b_in, w_dw, b_dw, w_out, b_out,
                 dtype: torch.dtype) -> GdfnWeights:
    """The kernel form of one GDFN (see :func:`gdfn_block_plain` for the
    layouts)."""
    c, f2 = w_in.shape
    hid = f2 // 2
    nch = -(-hid // CHUNK)
    wo = w_out.detach().to(dtype)
    wo = F.pad(wo, (0, -c % 4, 0, nch * CHUNK - hid)).contiguous()
    wi = _interleave(w_in.detach().to(dtype), 2)
    w_in_f = w_out_f = None
    if dtype == torch.bfloat16:
        plan = gdfn_plan(c)
        c16 = -(-c // 16) * 16
        w_in_f = torch.stack([frag_pack(wi[:, 2 * CHUNK * i:
                                           2 * CHUNK * (i + 1)], c16)
                              for i in range(nch)]).contiguous()
        w_out_f = torch.stack([frag_pack(wo[CHUNK * i:CHUNK * (i + 1), :c],
                                         CHUNK, plan.cols)
                               for i in range(nch)]).contiguous()
    return GdfnWeights(
        params=(ln, w_in, b_in, w_dw, b_dw, w_out, b_out), dtype=dtype,
        c=c, nch=nch,
        ln_w=None if ln is None else _f32(ln[0]),
        ln_b=None if _ln_mode(ln) != 2 else _f32(ln[1]),
        w_in=wi,
        b_in=None if b_in is None else _interleave(_f32(b_in), 2),
        w_dw=_interleave(_f32(w_dw), 2),
        b_dw=None if b_dw is None else _interleave(_f32(b_dw), 2),
        w_out=wo, b_out=_f32(b_out), w_in_f=w_in_f, w_out_f=w_out_f)


def gdfn_block_plain(x, ln, w_in, b_in, w_dw, b_dw, w_out, b_out, *,
                     fast: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`gdfn_block`, with its cast points.

    Args:
        x: (B, H, W, C).
        ln: None | (scale,) BiasFree | (scale, bias).
        w_in: (C, 2*hid) project_in; w_dw: (9, 2*hid) depthwise taps
            (row ``3*dy + dx``); w_out: (hid, C) project_out.
        b_in, b_dw, b_out: optional biases.
        fast: tanh GELU (the bf16 serving mode), else erf GELU.
    """
    if x.is_cuda:
        exact_f32()
    dt = x.dtype
    hid = w_out.shape[0]
    d = _one_by_one_dw(_apply_ln(x, ln), w_in, b_in, w_dw, b_dw)
    gate = _gelu_gate(d[..., :hid], d[..., hid:], fast).to(dt)
    y = gate.float() @ w_out.to(dt).float()
    if b_out is not None:
        y = y + b_out.float()
    return (y + x.float()).to(dt)


def _gdfn_cuda(x: torch.Tensor, k: GdfnWeights, fast: bool) -> torch.Tensor:
    x = _check_x(x, k.c, "gdfn_block")
    _check_on(x, (k.w_in, k.w_dw, k.w_out, k.ln_w), k.dtype, "gdfn_block")
    bsz, h, w, c = x.shape
    out = torch.empty_like(x)
    lib = kernels.load("restormer_fused")
    if x.dtype == torch.float32:
        th, tw, smem = _plan(0, x.dtype, c, 1)
        fn = lib.gdfn_block_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        err = fn(_ptr(x), _ptr(k.ln_w), _ptr(k.ln_b), _ptr(k.w_in),
                 _ptr(k.b_in), _ptr(k.w_dw), _ptr(k.b_dw), _ptr(k.w_out),
                 _ptr(k.b_out), _ptr(out), bsz, h, w, c, k.nch,
                 _ln_mode(k.params[0]), int(fast), th, tw, smem,
                 torch.cuda.current_stream(x.device).cuda_stream)
    else:
        p = gdfn_plan(c)
        fn = lib.gdfn_block_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 \
            + [ctypes.c_void_p]
        err = fn(_ptr(x), _ptr(k.ln_w), _ptr(k.ln_b), _ptr(k.w_in_f),
                 _ptr(k.b_in), _ptr(k.w_dw), _ptr(k.b_dw), _ptr(k.w_out_f),
                 _ptr(k.b_out), _ptr(out), bsz, h, w, c, k.nch,
                 _ln_mode(k.params[0]), int(fast), p.th, p.tw, p.threads,
                 p.mt, p.wn, p.smem,
                 torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(err, "gdfn_block")
    gdfn_block.launches += 1
    return out


def _ln_tuple(n: int, ln_w, ln_b):
    """The ``ln`` argument from its flattened (arity, scale, bias)."""
    return None if n == 0 else (ln_w,) if n == 1 else (ln_w, ln_b)


def _flat_ln(ln) -> tuple:
    """(arity, scale, bias) of an ``ln`` argument."""
    if ln is None:
        return 0, None, None
    return len(ln), ln[0], ln[1] if len(ln) > 1 else None


def _gdfn_launch(side, x, *params):
    return _gdfn_cuda(x, side[0], side[1])


def _gdfn_plain(side, x, ln_w, ln_b, *params):
    return gdfn_block_plain(x, _ln_tuple(side[2], ln_w, ln_b), *params,
                            fast=side[1])


_gdfn_function = kernel_function("gdfn_block", _gdfn_launch, _gdfn_plain)


def gdfn_block(x: torch.Tensor, w: GdfnWeights, *, fast: bool,
               params: tuple | None = None) -> torch.Tensor:
    """``x + GDFN(LN(x))`` in one launch (K4, ``csrc/restormer_fused.cu``)
    on a CUDA tensor, or raises; :func:`gdfn_block_plain` on a CPU tensor.
    ``w`` is the kernel form from :func:`gdfn_weights` for ``x.dtype``;
    ``params`` the (ln, w_in, b_in, w_dw, b_dw, w_out, b_out) it was made
    from (default ``w.params``), which autograd differentiates through
    :func:`gdfn_block_plain`'s VJP (``ops/autograd.py``)."""
    ln, *rest = params if params is not None else w.params
    n, ln_w, ln_b = _flat_ln(ln)
    return _gdfn_function((w, fast, n), x, ln_w, ln_b, *rest)


gdfn_block.launches = 0


# ---------------------------------------------------------------------------
# K5: MDTA front, and the epilogue


class MdtaWeights(NamedTuple):
    """One MDTA's weights: ``params`` as given and the kernel form of its
    front for ``dtype`` (made once per weight by :func:`mdta_weights`):
    w_qkv in ``dtype`` and the depthwise weights and biases in float32,
    chunk-interleaved (q, k and v chunk ``i`` side by side, each zero-padded
    to a multiple of :data:`CHUNK` channels); the epilogue's temperature,
    projection (C_in, C_out) and bias in float32. In bf16 also the
    tensor-core kernel's ``w_qkv_f`` (nch, C16/16, 12, 32, 4): chunk ``i``'s
    96 interleaved columns as :func:`frag_pack` fragments (C16 = C rounded
    up to 16); None in f32."""

    params: tuple
    dtype: torch.dtype
    c: int
    nch: int
    num_heads: int
    ln_w: torch.Tensor | None
    ln_b: torch.Tensor | None
    w_qkv: torch.Tensor
    b_qkv: torch.Tensor | None
    w_dw: torch.Tensor
    b_dw: torch.Tensor | None
    temperature: torch.Tensor
    w_proj: torch.Tensor
    b_proj: torch.Tensor | None
    w_qkv_f: torch.Tensor | None = None


def mdta_weights(ln, w_qkv, b_qkv, w_dw, b_dw, w_proj, b_proj, temperature,
                 num_heads: int, dtype: torch.dtype) -> MdtaWeights:
    """The kernel form of one MDTA (see :func:`mdta_block_plain` for the
    layouts)."""
    c = w_qkv.shape[0]
    nch = -(-c // CHUNK)
    wq = _interleave(w_qkv.detach().to(dtype), 3)
    w_qkv_f = None
    if dtype == torch.bfloat16:
        c16 = -(-c // 16) * 16
        w_qkv_f = torch.stack([frag_pack(wq[:, 3 * CHUNK * i:
                                            3 * CHUNK * (i + 1)], c16)
                               for i in range(nch)]).contiguous()
    return MdtaWeights(
        params=(ln, w_qkv, b_qkv, w_dw, b_dw), dtype=dtype, c=c,
        nch=nch, num_heads=num_heads,
        ln_w=None if ln is None else _f32(ln[0]),
        ln_b=None if _ln_mode(ln) != 2 else _f32(ln[1]),
        w_qkv=wq,
        b_qkv=None if b_qkv is None else _interleave(_f32(b_qkv), 3),
        w_dw=_interleave(_f32(w_dw), 3),
        b_dw=None if b_dw is None else _interleave(_f32(b_dw), 3),
        temperature=_f32(temperature).reshape(num_heads),
        w_proj=_f32(w_proj), b_proj=_f32(b_proj), w_qkv_f=w_qkv_f)


def mdta_front_plain(x, ln, w_qkv, b_qkv, w_dw, b_dw, num_heads: int):
    """Plain PyTorch version of :func:`mdta_front`.

    Args:
        x: (B, H, W, C); ln as in :func:`gdfn_block_plain`.
        w_qkv: (C, 3C); w_dw: (9, 3C); b_qkv, b_dw: optional.

    Returns:
        v (B, H, W, C) in ``x.dtype``; the per-head gram (B, heads, C_h,
        C_h) float32 of q and k cast to ``x.dtype``; the sums of squares
        (B, 2, C) float32 of the float32 q and k.
    """
    if x.is_cuda:
        exact_f32()
    dt = x.dtype
    bsz, h, w, c = x.shape
    ch = c // num_heads
    d = _one_by_one_dw(_apply_ln(x, ln), w_qkv, b_qkv, w_dw, b_dw)
    q, k, v = d[..., :c], d[..., c:2 * c], d[..., 2 * c:]
    qd = q.to(dt).float().reshape(bsz, h * w, num_heads, ch)
    kd = k.to(dt).float().reshape(bsz, h * w, num_heads, ch)
    gram = torch.einsum("bphc,bphd->bhcd", qd, kd)
    ssq = torch.stack([q.square().sum(dim=(1, 2)),
                       k.square().sum(dim=(1, 2))], dim=1)
    return v.to(dt), gram, ssq


class MdtaPlan(NamedTuple):
    """K5's bf16 launch plan for one (C, heads): a ``th`` x ``tw`` output
    tile per block of ``threads`` threads; the per-head gram as ``tiles``
    gram tiles of ``mw`` x ``nw8`` (m16, n8) mma tiles of one head, a warp
    each; where the gram tiles outnumber the warps, ``slices`` blocks share
    a run of tiles, each holding a slice of the gram tiles; ``smem`` bytes
    of shared memory (``csrc/restormer_fused.cu``: mdta_mma_smem)."""

    th: int
    tw: int
    threads: int
    mw: int
    nw8: int
    tiles: int
    slices: int
    smem: int


# output tiles, largest first: the plan takes the first whose shared
# memory fits (halo 1.27x the outputs at 16x16, 1.31x at 12x16)
_MDTA_TILES = ((16, 16), (12, 16), (8, 16), (8, 8), (4, 8), (4, 4))
# the gram tiles (m16 x n8 mma tiles) and block sizes the kernel is
# instantiated for (csrc/restormer_fused.cu: IRK_GRAM_SHAPES), fewest
# accumulators first: 384 threads keep 168 registers a thread (no spills),
# 3x3 tiles need 512 threads' 16 warps at C 384 with 8 heads
GRAM_SHAPES = ((1, 2, 384), (1, 3, 384), (3, 2, 384), (3, 3, 512))


def mdta_ldq(c: int, heads: int) -> int:
    """Row stride of K5's q and k tiles: every head at its width rounded
    up to 16 columns, + 8."""
    return heads * (-(-(c // heads) // 16) * 16) + 8


def mdta_smem(c: int, heads: int, th: int, tw: int, nw: int) -> int:
    """Shared bytes of K5's bf16 kernel (``mdta_mma_smem``)."""
    cq = -(-c // CHUNK) * CHUNK
    hp = (th + 2) * (tw + 2)
    return 4 * (2 * cq + nw * 2 * CHUNK + 2 * c) + 2 * (
        -(-hp // 16) * 16 * (-(-c // 16) * 16 + 8) + hp * (3 * CHUNK + 8)
        + 2 * th * tw * mdta_ldq(c, heads))


def gram_shape(c: int, heads: int) -> tuple[int, int, int, int]:
    """(mw, nw8, threads, gram tiles): the first of :data:`GRAM_SHAPES`
    whose gram tiles the block's warps hold, else the largest."""
    mh = -(-(c // heads) // 16)
    for mw, nw8, threads in GRAM_SHAPES:
        tiles = heads * -(-mh // mw) * -(-2 * mh // nw8)
        if tiles <= threads // 32:
            break
    return mw, nw8, threads, tiles


def mdta_plan(c: int, heads: int) -> MdtaPlan:
    """The bf16 K5 plan for (C, heads): the gram tile of
    :func:`gram_shape`; the largest of :data:`_MDTA_TILES` whose shared
    memory fits."""
    if c % 4 or c % heads or (c // heads) % 4:
        raise ValueError(f"mdta_front's bf16 kernel takes C and C/heads "
                         f"multiples of 4, not {c}/{heads}")
    mw, nw8, threads, tiles = gram_shape(c, heads)
    nw = threads // 32
    for th, tw in _MDTA_TILES:
        smem = mdta_smem(c, heads, th, tw, nw)
        if smem <= kernels.SMEM_LIMIT:
            return MdtaPlan(th, tw, threads, mw, nw8, tiles,
                            -(-tiles // nw), smem)
    raise ValueError(f"no tile of mdta_front's bf16 kernel fits shared "
                     f"memory at C={c}, heads={heads}")


def mdta_blocks(bsz: int, ntiles: int, slices: int, sms: int) -> int:
    """K5's bf16 blocks a sample (times ``slices``): one block an SM
    (its shared memory), each a run of ``ceil(ntiles / nb)`` or one fewer
    tiles, the fewest blocks that keep the longest run."""
    nb = max(1, min(ntiles, sms // (bsz * slices)))
    return -(-ntiles // -(-ntiles // nb))


def _mdta_cuda(x: torch.Tensor, k: MdtaWeights):
    x = _check_x(x, k.c, "mdta_front")
    _check_on(x, (k.w_qkv, k.w_dw, k.ln_w), k.dtype, "mdta_front")
    bsz, h, w, c = x.shape
    heads = k.num_heads
    ch = c // heads
    if c % heads or ch % 4:
        raise ValueError(f"mdta_front kernel takes C/heads a multiple of 4, "
                         f"not {c}/{heads}")
    cq = k.nch * CHUNK
    v = torch.empty_like(x)
    gram = torch.empty((bsz, heads, ch, ch), dtype=torch.float32,
                       device=x.device)
    ssq = torch.empty((bsz, 2, c), dtype=torch.float32, device=x.device)
    lib = kernels.load("restormer_fused")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        th, tw, smem = _plan(1, x.dtype, c, heads)
        ntiles = -(-h // th) * -(-w // tw)
        per_sm = max(1, min(8, (228 * 1024) // (smem + 1024)))
        nb = max(1, min(ntiles, kernels.sm_count(x.device) * per_sm // bsz))
        part = torch.empty((bsz * nb, heads * ch * ch + 2 * cq),
                           dtype=torch.float32, device=x.device)
        fn = lib.mdta_front_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        err = fn(_ptr(x), _ptr(k.ln_w), _ptr(k.ln_b), _ptr(k.w_qkv),
                 _ptr(k.b_qkv), _ptr(k.w_dw), _ptr(k.b_dw), _ptr(v),
                 _ptr(part), _ptr(gram), _ptr(ssq), bsz, h, w, c, k.nch,
                 heads, _ln_mode(k.params[0]), th, tw, smem, nb, stream)
    else:
        p = mdta_plan(c, heads)
        ntiles = -(-h // p.th) * -(-w // p.tw)
        nb = mdta_blocks(bsz, ntiles, p.slices, kernels.sm_count(x.device))
        part = torch.empty((bsz * nb, heads * ch * ch + 2 * cq),
                           dtype=torch.float32, device=x.device)
        fn = lib.mdta_front_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        err = fn(_ptr(x), _ptr(k.ln_w), _ptr(k.ln_b), _ptr(k.w_qkv_f),
                 _ptr(k.b_qkv), _ptr(k.w_dw), _ptr(k.b_dw), _ptr(v),
                 _ptr(part), _ptr(gram), _ptr(ssq), bsz, h, w, c, k.nch,
                 heads, _ln_mode(k.params[0]), p.th, p.tw, p.threads, p.mw,
                 p.nw8, p.slices, p.smem, nb, stream)
    kernels.check(err, "mdta_front")
    mdta_front.launches += 1
    return v, gram, ssq


def _mdta_launch(side, x, *params):
    return _mdta_cuda(x, side[0])


def _mdta_plain(side, x, ln_w, ln_b, *params):
    return mdta_front_plain(x, _ln_tuple(side[1], ln_w, ln_b), *params,
                            num_heads=side[0].num_heads)


_mdta_function = kernel_function("mdta_front", _mdta_launch, _mdta_plain)


def mdta_front(x: torch.Tensor, w: MdtaWeights,
               params: tuple | None = None):
    """MDTA's front (K5, ``csrc/restormer_fused.cu``) on a CUDA tensor, or
    raises; :func:`mdta_front_plain` on a CPU tensor. Returns (v, gram,
    ssq) as :func:`mdta_front_plain` does. ``params`` is the (ln, w_qkv,
    b_qkv, w_dw, b_dw) ``w`` was made from (default ``w.params``), which
    autograd differentiates through :func:`mdta_front_plain`'s VJP
    (``ops/autograd.py``)."""
    ln, *rest = params if params is not None else w.params
    n, ln_w, ln_b = _flat_ln(ln)
    return _mdta_function((w, n), x, ln_w, ln_b, *rest)


mdta_front.launches = 0


def gram_tile_plain(q: torch.Tensor, k: torch.Tensor, heads: int
                    ) -> torch.Tensor:
    """Plain version of :func:`gram_tile`: the per-head q_h^T k_h of (P, C)
    q and k, float32 sums, (heads, C/heads, C/heads)."""
    p, c = q.shape
    ch = c // heads
    return torch.einsum("phc,phd->hcd", q.float().reshape(p, heads, ch),
                        k.float().reshape(p, heads, ch))


def gram_tile(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """K5's gram step alone (``csrc/restormer_fused.cu``: gram_tile_kernel,
    A = q_h^T and B = k_h by ldmatrix.trans, at the gram tile
    :func:`gram_shape` gives K5 for (C, heads)), the step's own check: q
    and k (P, C) bf16, P a multiple of 16; returns the per-head gram
    (heads, C/heads, C/heads) float32. A CPU tensor takes
    :func:`gram_tile_plain`."""
    if not q.is_cuda:
        return gram_tile_plain(q, k, heads)
    p, c = q.shape
    if k.shape != q.shape or p % 16 or p < 16 or c % heads \
            or (c // heads) % 4 or q.dtype != torch.bfloat16 \
            or k.dtype != torch.bfloat16:
        raise ValueError("gram_tile takes (P, C) bf16 q and k, P a multiple "
                         "of 16, C/heads a multiple of 4")
    ch = c // heads
    q, k = q.contiguous(), k.contiguous()
    out = torch.empty((heads, ch, ch), dtype=torch.float32, device=q.device)
    mw, nw8, _, _ = gram_shape(c, heads)
    fn = kernels.load("restormer_fused").mdta_gram_tile
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    err = fn(q.data_ptr(), k.data_ptr(), out.data_ptr(), p, c, heads, mw,
             nw8, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "gram_tile")
    return out


def mdta_epilogue(x, v, gram, ssq, temperature, w_proj, b_proj,
                  num_heads: int) -> torch.Tensor:
    """``x + project_out(attention(v))`` from the front's outputs, plain
    PyTorch (the JAX package's XLA epilogue).

    Args:
        x, v: (B, H, W, C); gram (B, heads, C_h, C_h); ssq (B, 2, C).
        temperature: (heads,); w_proj: (C_in, C_out); b_proj: optional.
    """
    dt = x.dtype
    bsz, h, w, c = x.shape
    ch = c // num_heads
    rq = 1.0 / ssq[:, 0].sqrt().clamp_min(1e-12)
    rk = 1.0 / ssq[:, 1].sqrt().clamp_min(1e-12)
    temp = temperature.float().reshape(1, num_heads, 1, 1)
    logits = (gram * rq.reshape(bsz, num_heads, ch, 1)
              * rk.reshape(bsz, num_heads, 1, ch) * temp)
    attn = torch.softmax(logits, dim=-1)
    m = torch.einsum("bhcd,hco->bhdo", attn,
                     w_proj.float().reshape(num_heads, ch, c))
    m = m.reshape(bsz, c, c).to(dt)
    vr = v.reshape(bsz, h * w, c)
    if b_proj is None:
        out = torch.bmm(vr, m)
    else:
        out = (torch.bmm(vr.float(), m.float()) + b_proj.float()).to(dt)
    return x + out.reshape(bsz, h, w, c)


def mdta_block(x: torch.Tensor, w: MdtaWeights,
               params: tuple | None = None) -> torch.Tensor:
    """``x + project_out(MDTA(LN(x)))``: :func:`mdta_front` then
    :func:`mdta_epilogue`. ``params`` is :func:`mdta_block_plain`'s (ln,
    w_qkv, b_qkv, w_dw, b_dw, w_proj, b_proj, temperature) that ``w`` was
    made from: the differentiable inputs (default: ``w``'s own, the
    epilogue's in float32)."""
    if params is None:
        params = (*w.params, w.w_proj, w.b_proj, w.temperature)
    v, gram, ssq = mdta_front(x, w, params[:5])
    w_proj, b_proj, temperature = params[5:]
    return mdta_epilogue(x, v, gram, ssq, temperature, w_proj, b_proj,
                         w.num_heads)


def mdta_block_plain(x, ln, w_qkv, b_qkv, w_dw, b_dw, w_proj, b_proj,
                     temperature, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`mdta_block` (layouts of
    :func:`mdta_front_plain` and :func:`mdta_epilogue`)."""
    v, gram, ssq = mdta_front_plain(x, ln, w_qkv, b_qkv, w_dw, b_dw,
                                    num_heads)
    return mdta_epilogue(x, v, gram, ssq, temperature, w_proj, b_proj,
                         num_heads)
