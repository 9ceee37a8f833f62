"""One full Swin block on a (B, H, W, C) canvas, with the cyclic shift
folded into the block's reads.

Replaces ``image_restoration_agent_tpu/ops/pallas_attention.py``:

- ``swin_strip_pallas`` (the strip kernel: bodies ``_strip_kernel_paired``
  and ``_fastmath_block_core``; ``_strip_kernel`` in its stacked form) by
  :func:`swin_block`, and with ``mlp=None`` (HAT's call) by
  :func:`swin_attn_block`;
- ``mlp_block_pallas`` by :func:`mlp_block`;
- ``wmsa_block_pallas`` (the partition route over ``(nWB, N, C)``
  windows with the full ``(nW, N, N)`` mask) by :func:`wmsa_block`.

Semantics (the JAX kernel's): the block reads ``roll(x, (dc, dc))``, runs
LN1 -> qkv -> per-head window attention with the relative-position bias
and, for shifted blocks, the ``(2, 2, N, N)`` edge-mask bank picked by the
window's position in the output frame -> proj -> +residual, then LN2 ->
fc1 -> GELU -> fc2 -> +residual, and writes its output in the rolled frame.
Two numerics modes, as on the TPU:

- exact (float32): max-subtracted softmax, erf-GELU;
- fast (the bf16 serving mode, the TPU's ``paired2r``): logits in base 2
  with ``exp2(min(l, 86.56))`` and no max subtraction, normalization by a
  reciprocal multiply, tanh-GELU, and the attention half's output kept in
  float32 into the MLP half. bf16 casts sit where the TPU kernel casts: the
  LN outputs, q/k/v, ``p`` before AV, the attention output, the GELU output.

A canvas with an odd number of windows per row (or an odd head count) took
the TPU kernel's stacked fallback: exact softmax, the attention half's
output cast to the canvas dtype, and the MLP half as ``mlp_block``. The
port keeps that behaviour.

Two differences at rounding level only: the attention scale ``hd**-0.5``
is folded into the q weights on every path (the stacked TPU body scaled the
logits instead), and in fast mode log2(e) multiplies the float32 logits
rather than being folded into the bf16 q weights as on the TPU.

The CUDA path is two hand-written kernels in ``csrc/swin_block.cu``:

- K1 ``token_linear``: a GEMM over tokens with a fused prologue (LayerNorm
  with float32 two-pass statistics; a gather that reads token ``t`` of
  window order from ``x[(i - dc) mod H, (j - dc) mod W]``) and a fused
  epilogue (bias, erf- or tanh-GELU, residual, and a scatter from window
  order to the output frame). In bf16 a block reads its 64 rows once into
  a shared-memory panel and streams the weight (zero-padded once, when the
  block's weights are prepared) through two buffers with ``cp.async``; the products are WMMA 16x16x16
  bf16 fragments with float32 accumulators. In f32 it runs 64x64 tiles on
  FP32 FMA (no TF32).
- K2 ``window_attention``: N = ws^2 <= 256 tokens per window; q, k, v, the
  logits and ``p`` live in shared memory. In bf16 at N <= 64 one block
  handles a window's heads in turn with QK^T and PV on the tensor cores
  and the softmax in float32 between them; at 64 < N <= 256 (HAT's window
  16) one block per (window, head, 64-query chunk), its 64 x N float32
  logits in shared memory and ``p`` written over them in bf16. In f32 one
  block per (window, head) on FP32 FMA, per (window, head, 64-query chunk)
  at N > 64. The mask is the
  strip kernel's (2, 2, N, N) edge bank or the wmsa kernels' full
  (nW, N, N) mask.

One block is five launches: K1 (LN1 + gather -> qkv), K2, K1 (proj +
gathered residual), then ``mlp_block``'s two K1 (LN2 -> fc1 + GELU; fc2 +
residual + scatter).

What bounds it on the H100: one block at the serving shape (552x1920,
C 180, 6 heads) is 6.0e11 FLOP against 0.76 GB of bf16 input and output,
so the tensor-core rate bounds it (about 0.6 ms in bf16; 8.9 ms on the
FP32 pipes in f32). This form still writes the qkv, attention, x1 and
hidden intermediates to device memory (about 7 GB of traffic per block in
bf16) and uses WMMA rather than ``wgmma``; keeping the block on chip is
later work.

``pad_width_for_strips`` and ``strip_chunk_width`` are kept only so that
the port pads the band canvas exactly as the JAX engine does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import kernels
from .layernorm import layer_norm_lanes
from .window_attention import (relative_position_bias, window_partition,
                               window_reverse)

LOG2E = 1.4426950408889634
EXP2_CLAMP = 86.56  # 60 * log2(e): the TPU kernel's clamp

# row maps of K1: token order of the rows it reads / writes
IDENTITY, GATHER, SCATTER = 0, 1, 2


def strip_chunk_width(w: int, ws: int = 8) -> int | None:
    """The JAX strip kernel's column-chunk width for a canvas of width
    ``w``: a divisor in [128, 384] holding an even number of windows,
    lane-aligned ones first; None if there is none."""
    cands = [d for d in range(128, 385, 2 * ws) if w % d == 0]
    if not cands:
        return None
    aligned = [d for d in cands if d % 128 == 0]
    if aligned:
        return max(aligned)
    return min(cands, key=lambda d: (abs(d - 256), -d))


def pad_width_for_strips(w: int, ws: int = 8) -> int:
    """Smallest W' >= w (multiple of ws) with a strip chunk divisor: the
    band canvas width the JAX engine pads to."""
    wp = -(-w // ws) * ws
    while strip_chunk_width(wp, ws) is None:
        wp += ws
    return wp


class SwinBlockParams(NamedTuple):
    """One block's weights in kernel form: matrices (K, N) row-major in
    the compute dtype with the logit scale folded into the q columns (in
    bfloat16 zero-padded to K/32 x N/64, see :func:`kernel_matrix`);
    vectors and the (heads, N, N) relative-position bias in float32."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor
    rpb: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor

    @property
    def mlp(self) -> tuple[torch.Tensor, ...]:
        return (self.ln2_w, self.ln2_b, self.w1, self.b1, self.w2, self.b2)


def kernel_matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K1's weight form of a (K, N) matrix: contiguous in ``dtype``, and in
    bfloat16 zero-padded to K/32 x N/64, so the tensor-core path streams it
    in aligned 16-byte copies. The true K and N are the rows of the operand
    and the length of the bias."""
    w = w.to(dtype)
    if dtype == torch.bfloat16:
        w = F.pad(w, (0, -w.shape[1] % 64, 0, -w.shape[0] % 32))
    return w.contiguous()


def _dense(w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The true (K, N) matrix of a kernel-form weight, in float32."""
    return w[:k, :n].float()


def prepare_swin_params(*, norm1_w, norm1_b, qkv_w, qkv_b, proj_w, proj_b,
                        rpb_table, norm2_w, norm2_b, fc1_w, fc1_b, fc2_w,
                        fc2_b, num_heads: int, ws: int,
                        dtype: torch.dtype) -> SwinBlockParams:
    """Kernel-form weights from reference-layout (torch ``nn.Linear``)
    tensors. The attention scale ``hd**-0.5`` is folded into the q columns
    of the qkv weight and bias, as the TPU kernel folds it."""
    c = qkv_w.shape[1]
    scale = (c // num_heads) ** -0.5
    wqkv = qkv_w.detach().float().t().clone()
    bqkv = qkv_b.detach().float().clone()
    wqkv[:, :c] *= scale
    bqkv[:c] *= scale

    def mat(w):
        return kernel_matrix(w.detach().float().t(), dtype)

    def vec(v):
        return v.detach().float().contiguous()

    return SwinBlockParams(
        vec(norm1_w), vec(norm1_b), kernel_matrix(wqkv, dtype),
        bqkv.contiguous(), mat(proj_w), vec(proj_b),
        relative_position_bias(rpb_table.detach().float(), ws).contiguous(),
        vec(norm2_w), vec(norm2_b), mat(fc1_w), vec(fc1_b), mat(fc2_w),
        vec(fc2_b))


def _paired(w: int, ws: int, num_heads: int) -> bool:
    """The TPU kernel's paired bodies need an even window count per row and
    an even head count; otherwise it ran the stacked fallback."""
    return (w // ws) % 2 == 0 and num_heads % 2 == 0


# ---------------------------------------------------------------------------
# K1: token_linear


def _row_map(m: int, mode: int, geom, device) -> torch.Tensor:
    """Row index of token ``t`` (window order) under a K1 row map; the same
    arithmetic as ``map_row`` in ``csrc/swin_block.cu``."""
    t = torch.arange(m, device=device)
    if mode == IDENTITY:
        return t
    b_, h, w, ws, dc = geom
    n = ws * ws
    win, r = t // n, t % n
    iy, ix = r // ws, r % ws
    nwx, nwy = w // ws, h // ws
    wx, wy, b = win % nwx, (win // nwx) % nwy, win // (nwx * nwy)
    i, j = wy * ws + iy, wx * ws + ix
    if mode == GATHER:
        i, j = (i - dc) % h, (j - dc) % w
    return (b * h + i) * w + j


def _gelu(v: torch.Tensor, kind: str | None) -> torch.Tensor:
    if kind == "erf":
        return F.gelu(v)
    if kind == "tanh":
        return 0.5 * v * (1.0 + torch.tanh(0.7978845608
                                           * (v + 0.044715 * v * v * v)))
    return v


def token_linear_plain(a, w, b, *, ln=None, gelu=None, res=None, geom=None,
                       a_map=IDENTITY, r_map=IDENTITY, o_map=IDENTITY,
                       out_dtype=None):
    """Plain version of K1: ``out[o(t)] = act(prologue(a[g(t)]) @ w + b)
    (+ res[r(t)])`` over the M rows of ``a``; the operand of the product is
    rounded to ``w.dtype``, everything else is float32 until the store."""
    m, k = a.shape
    n = b.shape[0]
    dev = a.device
    rows = a[_row_map(m, a_map, geom, dev)]
    y = layer_norm_lanes(rows.float(), *ln) if ln is not None else rows.float()
    y = y.to(w.dtype).float()
    v = _gelu(y @ _dense(w, k, n) + b.float(), gelu)
    if res is not None:
        v = v + res[_row_map(m, r_map, geom, dev)].float()
    out = torch.empty((m, n), dtype=out_dtype or w.dtype, device=dev)
    out[_row_map(m, o_map, geom, dev)] = v.to(out.dtype)
    return out


_GELU = {None: 0, "erf": 1, "tanh": 2}
_DT = {torch.float32: 0, torch.bfloat16: 1}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _token_linear_cuda(a, w, b, ln, gelu, res, geom, a_map, r_map, o_map,
                       out_dtype):
    m, k = a.shape
    n = b.shape[0]
    want = (k, n)
    if w.dtype == torch.bfloat16:
        want = (k + -k % 32, n + -n % 64)
    if w.shape != want:
        raise ValueError(f"weight {tuple(w.shape)} is not the kernel form "
                         f"{want} (kernel_matrix) for K={k}, N={n}")
    for t in (a, w, res):
        if t is not None and (t.dtype not in _DT or not t.is_contiguous()
                              or t.device != a.device):
            raise ValueError("token_linear takes contiguous float32/bfloat16 "
                             "operands on one device")
    if b.dtype != torch.float32 or b.dim() != 1:
        raise ValueError("token_linear bias must be float32 (N,)")
    if res is not None and res.shape[-1] != n:
        raise ValueError("residual width differs from the output width")
    if ln is not None and any(p.dtype != torch.float32 or p.shape != (k,)
                              for p in ln):
        raise ValueError("token_linear LayerNorm parameters must be "
                         "float32 (K,)")
    if (a_map, r_map, o_map) != (IDENTITY,) * 3:
        bb, hh, ww, ws = geom[:4] if geom is not None else (0, 0, 0, 1)
        if bb * hh * ww != m or hh % ws or ww % ws:
            raise ValueError(f"row maps need geom (B, H, W, ws, dc) with "
                             f"B*H*W == {m} rows and H, W multiples of ws")
    if w.dtype == torch.bfloat16:
        # the tensor-core path holds each row in registers (K % 4, K <= 512,
        # 16-byte aligned rows) and streams the padded weight in 16-byte
        # copies
        if k % 4 or k > 512 or a.data_ptr() % 16:
            raise ValueError(f"bf16 token_linear needs K % 4 == 0, K <= 512 "
                             f"and 16-byte aligned rows (K={k})")
    g = geom or (1, 1, 1, 1, 0)
    out = torch.empty((m, n), dtype=out_dtype or w.dtype, device=a.device)
    fn = kernels.load("swin_block").token_linear
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lg, lb = ln if ln is not None else (None, None)
    err = fn(_ptr(a), _DT[a.dtype], _ptr(w), _DT[w.dtype], w.shape[1],
             _ptr(b), _ptr(res), _DT[res.dtype] if res is not None else 0,
             _ptr(out), _DT[out.dtype], _ptr(lg), _ptr(lb), m, k, n,
             _GELU[gelu], *g, a_map, r_map, o_map,
             torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(err, "token_linear")
    token_linear.launches += 1
    return out


def token_linear(a, w, b, *, ln=None, gelu=None, res=None, geom=None,
                 a_map=IDENTITY, r_map=IDENTITY, o_map=IDENTITY,
                 out_dtype=None):
    """K1: a GEMM over token rows with fused LayerNorm/gather prologue and
    bias/GELU/residual/scatter epilogue.

    Args:
        a: (M, K) rows, float32 or bfloat16.
        w: a (K, N) weight in its kernel form (:func:`kernel_matrix`) for
            the compute dtype (float32 or bfloat16).
        b: (N,) float32 bias; its length is the output width N.
        ln: optional (scale, bias), float32 (K,): LayerNorm of each row.
        gelu: None | "erf" | "tanh".
        res: optional residual rows of width N, read through ``r_map``.
        geom: (B, H, W, ws, dc) for the window-order row maps.
        a_map / r_map / o_map: IDENTITY, GATHER (window order -> source
            pixel of the rolled canvas) or SCATTER (window order -> pixel
            of the output frame).
        out_dtype: dtype of the (M, N) output (default ``w.dtype``).
    """
    if a.is_cuda:
        return _token_linear_cuda(a, w, b, ln, gelu, res, geom, a_map,
                                  r_map, o_map, out_dtype)
    return token_linear_plain(a, w, b, ln=ln, gelu=gelu, res=res, geom=geom,
                              a_map=a_map, r_map=r_map, o_map=o_map,
                              out_dtype=out_dtype)


token_linear.launches = 0


# ---------------------------------------------------------------------------
# K2: window_attention


def _bank_per_window(bank: torch.Tensor, nwy: int, nwx: int) -> torch.Tensor:
    """(nwy*nwx, N, N) masks: bank[is_last_window_row, is_last_window_col]."""
    re_ = (torch.arange(nwy, device=bank.device) == nwy - 1).long()
    ce_ = (torch.arange(nwx, device=bank.device) == nwx - 1).long()
    return bank[re_[:, None], ce_[None, :]].reshape(nwy * nwx, *bank.shape[2:])


def _softmax(s: torch.Tensor, fast: bool) -> torch.Tensor:
    if fast:  # base-2 logits, clamp instead of max subtraction
        e = torch.exp2(torch.clamp(s, max=EXP2_CLAMP))
        return e * (1.0 / e.sum(dim=-1, keepdim=True))
    return torch.softmax(s, dim=-1)


def window_attention_plain(qkv, rpb, bank, *, num_heads, nwy, nwx, fast,
                           mask=None):
    """Plain version of K2 on window-order rows: ``(T, 3C) -> (T, C)`` with
    q pre-scaled, logits ``q.k + rpb (+ bank or mask)`` (times log2 e in
    fast mode), ``p`` cast to the qkv dtype before AV."""
    t, c3 = qkv.shape
    c = c3 // 3
    n = rpb.shape[-1]
    hd = c // num_heads
    q, k, v = (qkv.reshape(-1, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
               .float())
    s = q @ k.transpose(-1, -2) + rpb[None]
    if bank is not None:
        s = s.reshape(-1, nwy * nwx, num_heads, n, n) \
            + _bank_per_window(bank, nwy, nwx)[None, :, None]
        s = s.reshape(-1, num_heads, n, n)
    elif mask is not None:
        s = s.reshape(-1, mask.shape[0], num_heads, n, n) \
            + mask[None, :, None]
        s = s.reshape(-1, num_heads, n, n)
    if fast:
        s = s * LOG2E
    p = _softmax(s, fast).to(qkv.dtype).float()
    o = p @ v
    return o.permute(0, 2, 1, 3).reshape(t, c).to(qkv.dtype)


def _check_f32(t, shape, what):
    if t is not None and (t.dtype != torch.float32 or t.shape != shape
                          or not t.is_contiguous()):
        raise ValueError(f"{what} must be contiguous float32 {shape}")


def _window_attention_cuda(qkv, rpb, bank, num_heads, nwy, nwx, fast,
                           mask):
    t, c3 = qkv.shape
    c = c3 // 3
    n = rpb.shape[-1]
    hd = c // num_heads
    if qkv.dtype not in _DT or not qkv.is_contiguous():
        raise ValueError("window_attention takes contiguous float32 or "
                         "bfloat16 qkv")
    nw = mask.shape[0] if mask is not None else nwy * nwx
    if n > 256 or hd > 64 or c % num_heads or t % n or (t // n) % nw:
        raise ValueError(f"window_attention: N={n}, head width {hd}, "
                         f"{t} rows do not fit the kernel")
    if qkv.dtype == torch.bfloat16 and n > 64 and (hd % 2
                                                   or qkv.data_ptr() % 4):
        raise ValueError("bf16 window_attention at N > 64 copies bf16 "
                         "pairs: it needs an even head width and a 4-byte "
                         "aligned qkv")
    if bank is not None and mask is not None:
        raise ValueError("window_attention takes a bank or a mask, not both")
    _check_f32(rpb, (num_heads, n, n), "rpb")
    _check_f32(bank, (2, 2, n, n), "bank")
    _check_f32(mask, (nw, n, n), "mask")
    out = torch.empty((t, c), dtype=qkv.dtype, device=qkv.device)
    fn = kernels.load("swin_block").window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    err = fn(_ptr(qkv), _DT[qkv.dtype], _ptr(rpb), _ptr(bank), _ptr(mask),
             nw, _ptr(out), t // n, n, c, num_heads, nwy, nwx, int(fast),
             torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "window_attention")
    window_attention.launches += 1
    return out


def window_attention(qkv, rpb, bank, *, num_heads, nwy, nwx, fast,
                     mask=None):
    """K2: attention of every (window, head) over window-order rows.

    Args:
        qkv: (T, 3C) rows in window order (q | k | v), q pre-scaled; N =
            rpb's last dim, N <= 256 and head width <= 64 on the card.
        rpb: (heads, N, N) float32 relative-position bias.
        bank: None or the (2, 2, N, N) float32 shift-mask bank, picked per
            window by [is_last_window_row, is_last_window_col].
        nwy, nwx: windows per image column / row (bank mode).
        fast: base-2 clamp softmax with reciprocal normalization.
        mask: None or the full (nW, N, N) float32 mask (the TPU wmsa
            kernels' contract): window ``w`` adds ``mask[w % nW]``. Not
            with ``bank``.
    """
    if qkv.is_cuda:
        return _window_attention_cuda(qkv, rpb, bank, num_heads, nwy, nwx,
                                      fast, mask)
    return window_attention_plain(qkv, rpb, bank, num_heads=num_heads,
                                  nwy=nwy, nwx=nwx, fast=fast, mask=mask)


window_attention.launches = 0


# ---------------------------------------------------------------------------
# mlp_block and swin_block


def mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, *, fast=False,
                    out_dtype=None, scatter=None):
    """Plain version of :func:`mlp_block`."""
    dt = w1.dtype
    c, hid = x.shape[-1], b1.shape[0]
    xf = x.float()
    y = layer_norm_lanes(xf, ln_w, ln_b).to(dt).float()
    hdn = _gelu(y @ _dense(w1, c, hid) + b1.float(), "tanh" if fast else "erf")
    o = xf + (hdn.to(dt).float() @ _dense(w2, hid, c) + b2.float())
    o = o.to(out_dtype or x.dtype)
    if scatter is None:
        return o
    b, h, w, ws = scatter[:4]
    c = o.shape[-1]
    o = o.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return o.reshape(b, h, w, c)


def _mlp_block_cuda(x, ln_w, ln_b, w1, b1, w2, b2, fast, out_dtype,
                    scatter):
    hdn = token_linear(x, w1, b1, ln=(ln_w, ln_b),
                       gelu="tanh" if fast else "erf", out_dtype=w1.dtype)
    geom = None if scatter is None else (*scatter[:4], 0)
    out = token_linear(hdn, w2, b2, res=x, geom=geom,
                       o_map=SCATTER if scatter is not None else IDENTITY,
                       out_dtype=out_dtype or x.dtype)
    mlp_block.launches += 1
    if scatter is not None:
        out = out.reshape(*scatter[:3], -1)
    return out


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, *, fast=False, out_dtype=None,
              scatter=None):
    """LN -> fc1 -> GELU -> fc2 -> +residual over (T, C) tokens.

    ``w1`` (C, hidden) and ``w2`` (hidden, C) are in their kernel form
    (:func:`kernel_matrix`) for the compute dtype; the LN parameters and
    biases float32. ``fast`` takes tanh-GELU (else erf).
    With ``scatter = (B, H, W, ws, ...)`` the rows are in window order and
    the result is written as the (B, H, W, C) canvas. Two K1 launches on a
    CUDA tensor; :func:`mlp_block_plain` on a CPU tensor."""
    if x.is_cuda:
        return _mlp_block_cuda(x, ln_w, ln_b, w1, b1, w2, b2, fast,
                               out_dtype, scatter)
    return mlp_block_plain(x, ln_w, ln_b, w1, b1, w2, b2, fast=fast,
                           out_dtype=out_dtype, scatter=scatter)


mlp_block.launches = 0


def _check_block(x, ws, dc):
    b, h, w, c = x.shape
    if h % ws or w % ws:
        raise ValueError(f"canvas {h}x{w} is not a multiple of window {ws}")
    if abs(dc) > ws:
        raise ValueError(f"roll {dc} larger than the window {ws}")


def swin_block_plain(x, p: SwinBlockParams, *, num_heads: int, ws: int,
                     dc: int = 0, mask_bank=None, fast: bool = False):
    """Plain PyTorch version of :func:`swin_block`: roll, window partition,
    then the block with the same cast points as the kernels."""
    _check_block(x, ws, dc)
    b, h, w, c = x.shape
    dt = p.wqkv.dtype
    paired = _paired(w, ws, num_heads)
    fast = fast and paired
    xr = torch.roll(x, (dc, dc), dims=(1, 2)) if dc else x
    xw = window_partition(xr, ws).reshape(-1, c).float()
    y = layer_norm_lanes(xw, p.ln1_w, p.ln1_b).to(dt).float()
    qkv = (y @ _dense(p.wqkv, c, 3 * c) + p.bqkv).to(dt)
    a = window_attention_plain(qkv, p.rpb, mask_bank, num_heads=num_heads,
                               nwy=h // ws, nwx=w // ws, fast=fast)
    x1 = a.float() @ _dense(p.wproj, c, c) + p.bproj + xw
    if not paired:
        x1 = x1.to(x.dtype)
    return mlp_block_plain(x1, *p.mlp, fast=fast, out_dtype=x.dtype,
                           scatter=(b, h, w, ws))


def swin_block_composed(x, p: SwinBlockParams, *, num_heads: int, ws: int,
                        dc: int = 0, mask_bank=None, fast: bool = False):
    """The block as the kernel sequence (K1, K2, K1, then mlp_block's two
    K1): what :func:`swin_block` launches on a CUDA tensor. On a CPU tensor
    every step runs its kernel's plain version."""
    _check_block(x, ws, dc)
    b, h, w, c = x.shape
    paired = _paired(w, ws, num_heads)
    fast = fast and paired
    geom = (b, h, w, ws, dc)
    xt = x.contiguous().reshape(-1, c)
    qkv = token_linear(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b), geom=geom,
                       a_map=GATHER)
    a = window_attention(qkv, p.rpb, mask_bank, num_heads=num_heads,
                         nwy=h // ws, nwx=w // ws, fast=fast)
    x1 = token_linear(a, p.wproj, p.bproj, res=xt, geom=geom, r_map=GATHER,
                      out_dtype=torch.float32 if paired else x.dtype)
    return mlp_block(x1, *p.mlp, fast=fast, out_dtype=x.dtype, scatter=geom)


def swin_block(x, p: SwinBlockParams, *, num_heads: int, ws: int,
               dc: int = 0, mask_bank=None, fast: bool = False):
    """One Swin block over ``x`` (B, H, W, C) read through
    ``roll(x, (dc, dc))``; the output stays in that rolled frame.

    Args:
        x: (B, H, W, C), H and W multiples of ``ws``.
        p: :class:`SwinBlockParams` (see :func:`prepare_swin_params`).
        num_heads, ws: heads and window size (N = ws^2 <= 64 on the card).
        dc: the folded roll, |dc| <= ws.
        mask_bank: None, or the (2, 2, N, N) float32 shift-mask bank.
        fast: the bf16 serving numerics (see the module docstring).

    A CUDA tensor runs the kernels (:func:`swin_block_composed`) or raises;
    a CPU tensor runs :func:`swin_block_plain`.
    """
    if x.is_cuda:
        out = swin_block_composed(x, p, num_heads=num_heads, ws=ws, dc=dc,
                                  mask_bank=mask_bank, fast=fast)
        swin_block.launches += 1
        return out
    return swin_block_plain(x, p, num_heads=num_heads, ws=ws, dc=dc,
                            mask_bank=mask_bank, fast=fast)


swin_block.launches = 0


# ---------------------------------------------------------------------------
# swin_attn_block (HAT's half block) and wmsa_block (the partition route)


def swin_attn_block_plain(x, p: SwinBlockParams, *, num_heads: int, ws: int,
                          dc: int = 0, mask_bank=None, fast: bool = False):
    """Plain PyTorch version of :func:`swin_attn_block`."""
    _check_block(x, ws, dc)
    b, h, w, c = x.shape
    dt = p.wqkv.dtype
    fast = fast and _paired(w, ws, num_heads)
    xr = torch.roll(x, (dc, dc), dims=(1, 2)) if dc else x
    xw = window_partition(xr, ws).reshape(-1, c).float()
    y = layer_norm_lanes(xw, p.ln1_w, p.ln1_b).to(dt).float()
    qkv = (y @ _dense(p.wqkv, c, 3 * c) + p.bqkv).to(dt)
    a = window_attention_plain(qkv, p.rpb, mask_bank, num_heads=num_heads,
                               nwy=h // ws, nwx=w // ws, fast=fast)
    x1 = (a.float() @ _dense(p.wproj, c, c) + p.bproj + xw).to(x.dtype)
    return window_reverse(x1.reshape(-1, ws, ws, c), ws, h, w)


def swin_attn_block(x, p: SwinBlockParams, *, num_heads: int, ws: int,
                    dc: int = 0, mask_bank=None, fast: bool = False):
    """The attention half of a Swin block over ``x`` (B, H, W, C) read
    through ``roll(x, (dc, dc))``: ``xr + proj(attn(LN1(xr)))`` in the
    rolled frame, in ``x``'s dtype. The TPU's ``swin_strip_pallas`` with
    ``mlp=None``, HAT's call: numerics as :func:`swin_block`'s (``fast``
    where the windows per row and the heads are even), ``p``'s MLP
    weights unused.

    A CUDA tensor runs three launches (K1 LN1 + gather -> qkv, K2, K1 proj
    + gathered residual scattered to the rolled frame) or raises; a CPU
    tensor runs :func:`swin_attn_block_plain`.
    """
    if not x.is_cuda:
        return swin_attn_block_plain(x, p, num_heads=num_heads, ws=ws, dc=dc,
                                     mask_bank=mask_bank, fast=fast)
    _check_block(x, ws, dc)
    b, h, w, c = x.shape
    fast = fast and _paired(w, ws, num_heads)
    geom = (b, h, w, ws, dc)
    xt = x.contiguous().reshape(-1, c)
    qkv = token_linear(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b), geom=geom,
                       a_map=GATHER)
    a = window_attention(qkv, p.rpb, mask_bank, num_heads=num_heads,
                         nwy=h // ws, nwx=w // ws, fast=fast)
    out = token_linear(a, p.wproj, p.bproj, res=xt, geom=geom, r_map=GATHER,
                       o_map=SCATTER, out_dtype=x.dtype)
    swin_attn_block.launches += 1
    return out.reshape(b, h, w, c)


swin_attn_block.launches = 0


def wmsa_block_plain(xw, p: SwinBlockParams, *, num_heads: int, mask=None):
    """Plain PyTorch version of :func:`wmsa_block`."""
    nwb, n, c = xw.shape
    dt = p.wqkv.dtype
    xf = xw.reshape(-1, c).float()
    y = layer_norm_lanes(xf, p.ln1_w, p.ln1_b).to(dt).float()
    qkv = (y @ _dense(p.wqkv, c, 3 * c) + p.bqkv).to(dt)
    a = window_attention_plain(qkv, p.rpb, None, num_heads=num_heads,
                               nwy=1, nwx=1, fast=False, mask=mask)
    out = a.float() @ _dense(p.wproj, c, c) + p.bproj + xf
    return out.to(xw.dtype).reshape(nwb, n, c)


def wmsa_block(xw, p: SwinBlockParams, *, num_heads: int, mask=None):
    """``xw + proj(attn(LN1(xw)))`` over partitioned windows: the TPU's
    ``wmsa_block_pallas``.

    Args:
        xw: (nWB, N, C) windows (N <= 256 on the card), in the dtype ``p``
            was prepared for.
        p: :class:`SwinBlockParams` (its MLP weights unused).
        mask: None or the (nW, N, N) float32 shift mask; window ``w`` adds
            ``mask[w % nW]``.

    Exact softmax in both dtypes. Cast points are the TPU kernel's: the LN
    output, qkv and the attention output in ``xw``'s dtype, proj +
    residual in float32 and one cast (the attention scale is folded into
    the q weights). A CUDA tensor runs three launches (K1 LN1 -> qkv, K2
    in full-mask mode, K1 proj + residual) or raises; a CPU tensor runs
    :func:`wmsa_block_plain`.
    """
    if not xw.is_cuda:
        return wmsa_block_plain(xw, p, num_heads=num_heads, mask=mask)
    nwb, n, c = xw.shape
    xt = xw.contiguous().reshape(-1, c)
    qkv = token_linear(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b))
    a = window_attention(qkv, p.rpb, None, num_heads=num_heads, nwy=1,
                         nwx=1, fast=False, mask=mask)
    out = token_linear(a, p.wproj, p.bproj, res=xt, out_dtype=xw.dtype)
    wmsa_block.launches += 1
    return out.reshape(nwb, n, c)


wmsa_block.launches = 0

_COUNTED = (swin_block, swin_attn_block, wmsa_block, mlp_block, token_linear,
            window_attention)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}

