"""One full Swin block on a (B, H, W, C) canvas, with the cyclic shift
folded into the block's reads.

Replaces ``image_restoration_agent_tpu/ops/pallas_attention.py``:

- ``swin_strip_pallas`` (the strip kernel: bodies ``_strip_kernel_paired``
  and ``_fastmath_block_core``; ``_strip_kernel`` in its stacked form) by
  :func:`swin_block`, and with ``mlp=None`` (HAT's call) by
  :func:`swin_attn_block`;
- ``mlp_block_pallas`` by :func:`mlp_block`;
- ``wmsa_block_pallas`` (the partition route over ``(nWB, N, C)``
  windows with the full ``(nW, N, N)`` mask) by :func:`wmsa_block`;
- ``wmsa_pallas`` (the window-MHSA core from packed ``(nWB, N, 3C)`` qkv,
  q unscaled and the float32 product scaled by ``head_dim**-0.5``:
  DehazeFormer's call) by :func:`wmsa`, K2 in its logit-scale mode.

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

The block's CUDA path is two hand-written kernels in
``csrc/swin_block.cu``:

- K1 ``token_linear``: a GEMM over tokens with a fused prologue (LayerNorm
  with float32 two-pass statistics; a gather that reads token ``t`` of
  window order from ``x[(i - dc) mod H, (j - dc) mod W]``) and a fused
  epilogue (bias, erf- or tanh-GELU, residual, and a scatter from window
  order to the output frame). In bf16 it runs on ``wgmma``
  (``csrc/sm90_gemm.cuh``): persistent blocks, each holding one slice of
  at most 192 output columns of the weight in shared memory for its whole
  walk (bulk-copied once from the packed form of :func:`kernel_matrix`);
  a producer warpgroup gathers and normalizes 64-row tiles into a ring of
  stages while two consumer warpgroups multiply and run the epilogue from
  their accumulator registers (:func:`token_linear_plan` is the launch
  plan). Past K 512 (RIDCP's fc2 at K 1024) a stage holds a chunk of K
  rather than whole rows, the consumer walks a tile's chunks into one
  float32 accumulator, and the LayerNorm prologue is not taken. In f32 it
  runs 64x64 tiles on FP32 FMA (no TF32), any K.
- K2 ``window_attention``: N = ws^2 <= 256 tokens per window, logits
  ``(q.k) * scale + bias`` (``scale`` 1 where q is pre-scaled). In bf16 the
  products run on ``mma.sync`` with each warp's 16 x N logits, softmax
  and ``p`` in registers (``p`` normalized in float32, then rounded to bf16
  as PV's A fragments); at N <= 64 one block per window stages every
  head's q, k, v from the window's contiguous rows at once, at N > 64 one
  block per (window, head), a warp pair splitting each row block's keys.
  In f32 one block per (window, head), both products tiled in registers
  on FP32 FMA. The bias is the dense (heads, N, N) ``rpb``, or rebuilt in
  shared memory from the ((2ws-1)^2, heads) table where the block has one
  (:attr:`SwinBlockParams.rpb_table`); the mask is the strip kernel's
  (2, 2, N, N) edge bank or the wmsa kernels' full (nW, N, N) mask, read
  as a bit form where it holds one value (:func:`mask_bits`), its
  all-zero bank entries skipped (:func:`bank_zero_flags`).

One block is five launches: K1 (LN1 + gather -> qkv), K2, K1 (proj +
gathered residual), then ``mlp_block``'s two K1 (LN2 -> fc1 + GELU; fc2 +
residual + scatter).

:func:`wmsa` is K2 alone, DehazeFormer's call: N 64, head widths 12 and
16 (the bf16 kernel pads both to 16 in its fragments). At the 1080p
request's level 0 (32776 windows, C 24) it reads and writes 0.40 GB in
bf16, so memory bounds it (0.12 ms on the H100).

What bounds it on the H100: one block at the serving shape (552x1920,
C 180, 6 heads) is 6.0e11 FLOP against 0.76 GB of bf16 input and output,
so the tensor-core rate bounds it (about 0.6 ms in bf16; 8.9 ms on the
FP32 pipes in f32). This form still writes the qkv, attention, x1 and
hidden intermediates to device memory (about 7 GB of traffic per block in
bf16); keeping the block on chip is later work.

:func:`swin_pair_block` replaces ``swin_pair_strip_pallas`` (an RSTB's
unshifted + shifted block pair in one launch, block A's output kept on
chip) with K8, ``csrc/swin_pair.cu``: per output window of block B, block
A's k and v on the four A windows that B's window overlaps (about 35% more
FLOP than the pair's own work), A's q, proj and MLP on B's 64 tokens at
once, then block B. In bf16 every product is a 64-row ``wgmma`` with the
weights streamed through shared memory by bulk copies from the packed
form of :func:`swin_pair_weights` (persistent blocks, the ring refilled
by thread 0); the attention runs on ``mma.sync``. No served path runs it
(``lab/lab_r5.py`` does).

``pad_width_for_strips`` and ``strip_chunk_width`` are kept only so that
the port pads the band canvas exactly as the JAX engine does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import kernels
from .autograd import forbid_grad, kernel_function
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
    """One block's weights in kernel form: matrices (K, N) in the compute
    dtype with the logit scale folded into the q columns (row-major in
    float32, packed in bfloat16, see :func:`kernel_matrix`); vectors and
    the (heads, N, N) relative-position bias in float32. ``rpb_table`` is
    the ((2ws-1)^2, heads) float32 table ``rpb`` was made from, where the
    caller has it: K2 then rebuilds the bias in shared memory from it
    (:func:`window_attention`'s ``table``)."""

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
    rpb_table: torch.Tensor | None = None

    @property
    def mlp(self) -> tuple[torch.Tensor, ...]:
        return (self.ln2_w, self.ln2_b, self.w1, self.b1, self.w2, self.b2)


class SwinBlockRef(NamedTuple):
    """One block's reference-layout tensors (``nn.LayerNorm`` scale and
    shift, ``nn.Linear`` weights (out, in) and biases, the ((2ws-1)^2,
    heads) bias table): what :func:`prepare_swin_params` makes the kernel
    form from, and what the wrappers' gradients reach (their ``ref``)."""

    norm1_w: torch.Tensor
    norm1_b: torch.Tensor
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    rpb_table: torch.Tensor
    norm2_w: torch.Tensor
    norm2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor

    @property
    def mlp(self) -> tuple[torch.Tensor, ...]:
        """:func:`mlp_block`'s ``params``."""
        return (self.norm2_w, self.norm2_b, self.fc1_w, self.fc1_b,
                self.fc2_w, self.fc2_b)


def _q_fold(c: int, num_heads: int, device) -> torch.Tensor:
    """(3C,) float32: the attention scale on the q columns, 1 elsewhere."""
    f = torch.ones(3 * c, device=device)
    f[:c] = (c // num_heads) ** -0.5
    return f


def reference_params(ref: SwinBlockRef, *, num_heads: int, ws: int,
                     dtype: torch.dtype) -> SwinBlockParams:
    """The values of :func:`prepare_swin_params`'s form, made
    differentiably from ``ref``: (K, N) matrices in ``dtype`` (not packed:
    the plain versions read either), the q columns scaled, vectors and the
    gathered bias float32. The plain versions run on it where a gradient is
    taken (the backward's recompute)."""
    c = ref.qkv_w.shape[1]
    fold = _q_fold(c, num_heads, ref.qkv_w.device)
    return SwinBlockParams(
        ref.norm1_w.float(), ref.norm1_b.float(),
        (ref.qkv_w.t().float() * fold).to(dtype), ref.qkv_b.float() * fold,
        ref.proj_w.t().to(dtype), ref.proj_b.float(),
        relative_position_bias(ref.rpb_table.float(), ws),
        *_mlp_reference(ref.mlp, dtype))


def _mlp_reference(params, dtype) -> tuple[torch.Tensor, ...]:
    """:func:`mlp_block`'s (ln_w, ln_b, w1, b1, w2, b2) from its reference
    ``params`` (LN scale and shift, fc1 and fc2 as ``nn.Linear``)."""
    lw, lb, w1, b1, w2, b2 = params
    return (lw.float(), lb.float(), w1.t().to(dtype), b1.float(),
            w2.t().to(dtype), b2.float())


def _block_params(p: SwinBlockParams, ref, num_heads: int, ws: int
                  ) -> SwinBlockParams:
    """What a wrapper's plain version runs on: the form ``p``, or where a
    gradient is being taken and the caller gave its reference tensors
    ``ref``, the same values made from them (:func:`reference_params`)."""
    if ref and torch.is_grad_enabled():
        return reference_params(SwinBlockRef(*ref), num_heads=num_heads,
                                ws=ws, dtype=p.wqkv.dtype)
    return p


def kernel_matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """K1's weight form of a (K, N) matrix, contiguous in ``dtype``: in
    float32 the matrix itself; in bfloat16 the order the tensor-core kernel
    bulk-copies into shared memory, (slices, K/8, NS/8, 8, 8): N cut into
    :func:`token_linear_slices` slices of NS columns, each slice's K x NS
    block as 8 x 8 core matrices (8 columns x 8 k, k fastest), K padded to
    64 (the A operand's 128-byte swizzle blocks), zero-padded. The true K
    and N are the rows of the operand and the length of the bias
    (:func:`_dense` recovers the matrix)."""
    w = w.to(dtype)
    if dtype == torch.bfloat16:
        nsl, ns, _ = token_linear_slices(*w.shape)
        w = _core_matrices(w, nsl, ns)
    return w.contiguous()


def _core_matrices(w: torch.Tensor, nsl: int, ns: int) -> torch.Tensor:
    """(K, N) -> (nsl, K/8, ns/8, 8, 8), K zero-padded to 64 and N to
    nsl * ns: the packed order of :func:`kernel_matrix`."""
    k, n = w.shape
    kp = -(-k // 64) * 64
    w = F.pad(w, (0, nsl * ns - n, 0, kp - k))
    return w.reshape(kp // 8, 8, nsl, ns // 8, 8).permute(2, 0, 3, 4, 1)


def _dense(w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The true (K, N) matrix of a kernel-form weight, in float32."""
    if w.dim() == 5:
        nsl, kg, ng = w.shape[:3]
        w = w.permute(1, 4, 0, 2, 3).reshape(kg * 8, nsl * ng * 8)
    return w[:k, :n].float()


def prepare_swin_params(*, norm1_w, norm1_b, qkv_w, qkv_b, proj_w, proj_b,
                        rpb_table, norm2_w, norm2_b, fc1_w, fc1_b, fc2_w,
                        fc2_b, num_heads: int, ws: int,
                        dtype: torch.dtype) -> SwinBlockParams:
    """Kernel-form weights from reference-layout (torch ``nn.Linear``)
    tensors. The attention scale ``hd**-0.5`` is folded into the q columns
    of the qkv weight and bias, as the TPU kernel folds it."""
    table = rpb_table.detach().float()
    return kernel_params(
        norm1_w, norm1_b, qkv_w.detach().t(), qkv_b, proj_w.detach().t(),
        proj_b, relative_position_bias(table, ws), norm2_w, norm2_b,
        fc1_w.detach().t(), fc1_b, fc2_w.detach().t(), fc2_b,
        num_heads=num_heads, dtype=dtype)._replace(
            rpb_table=table.contiguous())


def kernel_params(ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, rpb, ln2_w, ln2_b,
                  w1, b1, w2, b2, *, num_heads: int,
                  dtype: torch.dtype) -> SwinBlockParams:
    """Kernel-form weights from the TPU strip kernels' layout: matrices
    (K, N) applied as ``x @ w``, the (heads, N, N) relative-position bias;
    the attention scale folded into the q columns."""
    fold = _q_fold(wqkv.shape[0], num_heads, wqkv.device)
    wqkv = wqkv.detach().float() * fold
    bqkv = bqkv.detach().float() * fold

    def mat(w):
        return kernel_matrix(w.detach().float(), dtype)

    def vec(v):
        return v.detach().float().contiguous()

    return SwinBlockParams(
        vec(ln1_w), vec(ln1_b), kernel_matrix(wqkv, dtype),
        bqkv.contiguous(), mat(wproj), vec(bproj), vec(rpb), vec(ln2_w),
        vec(ln2_b), mat(w1), vec(b1), mat(w2), vec(b2))


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


# token_linear_mma_kernel's tile and shared memory (csrc/swin_block.cu:
# L_TM, l_smem_bytes): four warpgroups, 64-row tiles, an even ring of 2-8
LINEAR_ROWS, LINEAR_MAX_STAGES = 64, 8
# the widest slice: 512 threads leave 128 registers a thread at launch, too
# few for an m64n256 accumulator
LINEAR_MAX_N = 192


def _round1k(v: int) -> int:
    return -(-v // 1024) * 1024


# the widest K a stage holds whole rows of (and the LayerNorm prologue
# takes), and the widest K the kernel takes at all (in chunks)
LINEAR_ROW_K, LINEAR_MAX_K = 512, 2048


def token_linear_smem(k: int, ns: int, stages: int,
                      chunk: int | None = None) -> int:
    """Shared memory of a bf16 K1 block: ``stages`` A stages of ``chunk``
    64-k blocks each (default: whole rows) beside the K x NS weight."""
    kp = -(-k // 64) * 64
    cb = kp // 64 if chunk is None else chunk
    head = _round1k(256 + stages * 3 * LINEAR_ROWS * 4 + 4 * ns + 8 * kp)
    return head + _round1k(kp * ns * 2) + stages * LINEAR_ROWS * cb * 128


def _linear_form(k: int, n: int) -> tuple[int, int, int, int]:
    """(slices, NS, stages, chunk) of the bf16 K1: see
    :func:`token_linear_slices`; ``chunk`` is the 64-k blocks an A stage
    holds."""
    nsl = -(-n // LINEAR_MAX_N)
    kb = -(-k // 64)
    if k % 4 or k > LINEAR_MAX_K:
        return nsl, kernels.gemm_width(-(-n // nsl)), 0, kb
    while True:
        ns = kernels.gemm_width(-(-n // nsl))
        if k <= LINEAR_ROW_K:
            fits = [s for s in range(2, LINEAR_MAX_STAGES + 1, 2)
                    if token_linear_smem(k, ns, s) <= kernels.SMEM_LIMIT]
            if fits:
                return nsl, ns, max(fits), kb
        else:
            # balanced chunks of at most 8 blocks (512 k); the most k in
            # flight (at least 4 blocks), then a ring of 4 (two stages a
            # producer-consumer pair), then the wider chunk
            fits = [(s * cb, min(s, 4), cb, s)
                    for cb in sorted({-(-kb // c)
                                      for c in range(-(-kb // 8), kb + 1)})
                    for s in range(2, LINEAR_MAX_STAGES + 1, 2)
                    if token_linear_smem(k, ns, s, cb) <= kernels.SMEM_LIMIT]
            best = max(fits, default=(0, 0, 0, 0))
            if best[0] >= 4:
                return nsl, ns, best[3], best[2]
        if ns == kernels.GEMM_WIDTHS[0]:
            raise ValueError(f"no bf16 token_linear plan holds K={k}")
        nsl += 1


def token_linear_slices(k: int, n: int) -> tuple[int, int, int]:
    """(slices, NS, stages) of the bf16 K1 for a (K, N) weight: the fewest
    slices of at most 192 columns whose NS-column weight block stays in
    shared memory beside a ring of at least two 64-row A stages (qkv 540
    as 3 x 184, fc1 360 as 2 x 184, proj 180 as 184; fc2 at K 360 as
    2 x 96), with the deepest even ring that fits (its two
    producer-consumer pairs take alternate stages). Past K 512 a stage
    holds a chunk of K, not whole rows, and the plan takes the fewest
    slices with at least four 64-k blocks of A in flight (RIDCP's fc2 at
    K 1024: 4 x 64, four stages of 128 k). A K the kernel does not take
    (K % 4 or K > 2048) gets the slices and no stages."""
    return _linear_form(k, n)[:3]


def token_linear_plan(m: int, k: int, n: int, sms: int) -> kernels.LaunchPlan:
    """The bf16 K1 launch: persistent blocks, ``sms // slices`` a slice
    (no more than the 64-row tiles), each walking tiles b, b + step, ...
    of its slice; 512 threads (two producer and two consumer
    warpgroups); ``chunk`` 64-k blocks an A stage."""
    nsl, ns, stages, cb = _linear_form(k, n)
    per = max(1, min(-(-m // LINEAR_ROWS), sms // nsl))
    return kernels.LaunchPlan(nsl * per, 512, nsl, ns, stages,
                              token_linear_smem(k, ns, stages, cb), cb)


def _token_linear_cuda(a, w, b, ln, gelu, res, geom, a_map, r_map, o_map,
                       out_dtype):
    m, k = a.shape
    n = b.shape[0]
    plan = None
    if w.dtype == torch.bfloat16:
        # the tensor-core path reads each row in 8- or 16-byte pieces
        # (K % 4, 16-byte aligned rows), holds row indices in 32 bits and
        # normalizes whole rows only (LayerNorm at K <= 512)
        if (k % 4 or k > LINEAR_MAX_K or a.data_ptr() % 16 or m >= 2 ** 31
                or (ln is not None and k > LINEAR_ROW_K)):
            raise ValueError(
                f"bf16 token_linear needs K % 4 == 0, K <= {LINEAR_MAX_K} "
                f"(K <= {LINEAR_ROW_K} with LayerNorm), 16-byte aligned "
                f"rows and M < 2^31 (K={k})")
        plan = token_linear_plan(m, k, n, kernels.sm_count(a.device))
        want = (plan.slices, -(-k // 64) * 8, plan.ns // 8, 8, 8)
    else:
        want = (k, n)
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
    g = geom or (1, 1, 1, 1, 0)
    out = torch.empty((m, n), dtype=out_dtype or w.dtype, device=a.device)
    fn = kernels.load("swin_block").token_linear
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lg, lb = ln if ln is not None else (None, None)
    ns, stages, cb, smem, grid = (plan.ns, plan.stages, plan.chunk,
                                  plan.smem, plan.grid) \
        if plan is not None else (0, 0, 0, 0, 0)
    err = fn(_ptr(a), _DT[a.dtype], _ptr(w), _DT[w.dtype], ns,
             _ptr(b), _ptr(res), _DT[res.dtype] if res is not None else 0,
             _ptr(out), _DT[out.dtype], _ptr(lg), _ptr(lb), m, k, n,
             _GELU[gelu], *g, a_map, r_map, o_map, stages, cb, smem, grid,
             torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(err, "token_linear")
    token_linear.launches += 1
    return out


def _token_linear_launch(side, a, wd, b, lg, lb, res):
    w, gelu, geom, a_map, r_map, o_map, out_dtype = side
    return _token_linear_cuda(a, w, b, None if lg is None else (lg, lb),
                              gelu, res, geom, a_map, r_map, o_map,
                              out_dtype)


def _token_linear_plain(side, a, wd, b, lg, lb, res):
    w, gelu, geom, a_map, r_map, o_map, out_dtype = side
    if wd is not None and torch.is_grad_enabled():
        w = wd.to(w.dtype)
    return token_linear_plain(a, w, b, ln=None if lg is None else (lg, lb),
                              gelu=gelu, res=res, geom=geom, a_map=a_map,
                              r_map=r_map, o_map=o_map, out_dtype=out_dtype)


_token_linear_function = kernel_function(
    "token_linear", _token_linear_launch, _token_linear_plain)


def token_linear(a, w, b, *, ln=None, gelu=None, res=None, geom=None,
                 a_map=IDENTITY, r_map=IDENTITY, o_map=IDENTITY,
                 out_dtype=None, params=None):
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
        params: the (K, N) float32 matrix ``w`` was made from; gradients
            reach it. Without, the form's weights are constants.

    A CUDA tensor runs the kernel or raises; a CPU tensor runs
    :func:`token_linear_plain`. Under autograd the backward is
    :func:`token_linear_plain`'s VJP (``ops/autograd.py``) in ``a``,
    ``params``, ``b``, the LayerNorm's parameters and ``res``.
    """
    lg, lb = ln if ln is not None else (None, None)
    return _token_linear_function(
        (w, gelu, geom, a_map, r_map, o_map, out_dtype), a, params, b, lg,
        lb, res)


token_linear.launches = 0


def gemm_tile_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gemm_tile`: ``a @ w`` in float32."""
    return a.float() @ w.float()


def gemm_tile(a: torch.Tensor, w: torch.Tensor, *,
              a_in_registers: bool) -> torch.Tensor:
    """One 64-row tile through the Hopper GEMM core (``csrc/sm90_gemm.cuh``,
    one warpgroup), the core's own check: ``a`` (64, K) bf16 with K in
    16..64 a multiple of 16, ``w`` a (K, N) bf16 weight with N one
    instantiated width, packed here as one :func:`kernel_matrix` slice;
    returns the (64, N) float32 product, A read by descriptor or, with
    ``a_in_registers``, by ldmatrix into registers (K3's form). A CPU
    tensor takes :func:`gemm_tile_plain`."""
    if not a.is_cuda:
        return gemm_tile_plain(a, w)
    k, n = w.shape
    if a.shape != (64, k) or k % 16 or not 16 <= k <= 64 \
            or n not in kernels.GEMM_WIDTHS or a.dtype != torch.bfloat16 \
            or w.dtype != torch.bfloat16:
        raise ValueError("gemm_tile takes a (64, K) and a (K, N) bf16 "
                         "tile, K in 16..64, N an instantiated width")
    a, w = a.contiguous(), _core_matrices(w, 1, n).contiguous()
    out = torch.empty((64, n), dtype=torch.float32, device=a.device)
    fn = kernels.load("swin_block").gemm_tile
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
             int(a_in_registers),
             torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(err, "gemm_tile")
    return out


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
                           mask=None, scale: float = 1.0):
    """Plain version of K2 on window-order rows: ``(T, 3C) -> (T, C)``,
    logits ``(q.k) * scale + rpb (+ bank or mask)`` in float32 (times log2 e
    in fast mode; ``scale`` 1 where q is pre-scaled), ``p`` cast to the qkv
    dtype before AV."""
    t, c3 = qkv.shape
    c = c3 // 3
    n = rpb.shape[-1]
    hd = c // num_heads
    q, k, v = (qkv.reshape(-1, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
               .float())
    s = (q @ k.transpose(-1, -2)) * scale + rpb[None]
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


def _cached(t: torch.Tensor, key: str, make):
    """``make(t)``, computed once per tensor and kept on it, keyed by its
    version (an in-place edit recomputes it)."""
    hit = getattr(t, key, None)
    if hit is not None and hit[0] == t._version:
        return hit[1]
    val = make(t)
    setattr(t, key, (t._version, val))
    return val


def bank_zero_flags(bank: torch.Tensor) -> int:
    """Bit k set where entry k = 2 * is_last_row + is_last_col of the
    (2, 2, N, N) bank is all zero: K2 adds nothing for those windows (for
    a shift mask, every window off the last row and column)."""
    def make(b):
        zero = (b.reshape(4, -1) == 0).all(dim=1).tolist()
        return sum(1 << k for k, z in enumerate(zero) if z)
    return _cached(bank, "_irk_zero_flags", make)


def mask_bits(m: torch.Tensor):
    """The bit form K2 reads of a (..., N, N) mask (the (nW, N, N) full
    mask, or the (2, 2, N, N) bank as E = 4 entries) whose entries are 0
    or one value v (a shift mask: 0 and -100): (bits, v), bits (E, N,
    Np / 32) int32 with bit j % 32 of word j // 32 of row i set where the
    entry is v (Np = N padded to 64, 128 or 256, the padding 0); None for
    any other mask (the kernel then reads it as float32). 32x fewer bytes
    than the float32 mask; computed once per mask."""
    def make(t):
        n = t.shape[-1]
        t = t.reshape(-1, n, n)
        e = t.shape[0]
        nz = t != 0
        vals = t[nz]
        v = float(vals[0]) if vals.numel() else 0.0
        if vals.numel() and not bool((vals == v).all()):
            return None
        np_ = 64 if n <= 64 else 128 if n <= 128 else 256
        b = F.pad(nz, (0, np_ - n)).reshape(e, n, np_ // 32, 32).long()
        w = (b << torch.arange(32, device=t.device)).sum(-1)
        w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)
        return w.to(torch.int32).contiguous(), v
    return _cached(m, "_irk_bits", make)


def _window_attention_cuda(qkv, rpb, bank, num_heads, nwy, nwx, fast,
                           mask, scale, table):
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
    if qkv.dtype == torch.bfloat16 and (hd % 2 or qkv.data_ptr() % 4):
        raise ValueError("bf16 window_attention reads bf16 pairs: it needs "
                         "an even head width and a 4-byte aligned qkv")
    if bank is not None and mask is not None:
        raise ValueError("window_attention takes a bank or a mask, not both")
    ws = round(n ** 0.5)
    if table is not None:
        _check_f32(table, ((2 * ws - 1) ** 2, num_heads), "table")
        if ws * ws != n:
            raise ValueError(f"a bias table needs a square window, N={n}")
    _check_f32(rpb, (num_heads, n, n), "rpb")
    _check_f32(bank, (2, 2, n, n), "bank")
    _check_f32(mask, (nw, n, n), "mask")
    out = torch.empty((t, c), dtype=qkv.dtype, device=qkv.device)
    fn = kernels.load("swin_block").window_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p] \
        + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    dense = bank if bank is not None else mask
    bits = None if dense is None else mask_bits(dense)
    err = fn(_ptr(qkv), _DT[qkv.dtype],
             None if table is not None else _ptr(rpb), _ptr(table), ws,
             _ptr(bank), 0 if bank is None else bank_zero_flags(bank),
             _ptr(mask), nw, None if bits is None else _ptr(bits[0]),
             0.0 if bits is None else bits[1], _ptr(out), t // n, n, c,
             num_heads, nwy, nwx, int(fast), float(scale),
             torch.cuda.current_stream(qkv.device).cuda_stream)
    kernels.check(err, "window_attention")
    window_attention.launches += 1
    return out


def _window_attention_launch(side, qkv, rpb):
    bank, mask, table, num_heads, nwy, nwx, fast, scale = side
    # a bias that carries a gradient may be a view (the table's gather)
    return _window_attention_cuda(qkv, rpb.contiguous(), bank, num_heads,
                                  nwy, nwx, fast, mask, scale, table)


def _window_attention_plain(side, qkv, rpb):
    bank, mask, _, num_heads, nwy, nwx, fast, scale = side
    return window_attention_plain(qkv, rpb, bank, num_heads=num_heads,
                                  nwy=nwy, nwx=nwx, fast=fast, mask=mask,
                                  scale=scale)


_window_attention_function = kernel_function(
    "window_attention", _window_attention_launch, _window_attention_plain)


def window_attention(qkv, rpb, bank, *, num_heads, nwy, nwx, fast,
                     mask=None, scale: float = 1.0, table=None):
    """K2: attention of every (window, head) over window-order rows.

    Args:
        qkv: (T, 3C) rows in window order (q | k | v); N = rpb's last dim,
            N <= 256 and head width <= 64 on the card (even in bf16).
        rpb: (heads, N, N) float32 relative-position bias.
        bank: None or the (2, 2, N, N) float32 shift-mask bank, picked per
            window by [is_last_window_row, is_last_window_col].
        nwy, nwx: windows per image column / row (bank mode).
        fast: base-2 clamp softmax with reciprocal normalization.
        mask: None or the full (nW, N, N) float32 mask (the TPU wmsa
            kernels' contract): window ``w`` adds ``mask[w % nW]``. Not
            with ``bank``.
        scale: float32 factor on the q.k product before the bias: 1.0 for
            the Swin block's callers, whose q weights carry the attention
            scale; ``head_dim**-0.5`` for :func:`wmsa` (q unscaled).
        table: None, or the ((2ws-1)^2, heads) float32 table ``rpb`` was
            made from by the relative-position index (``ops/window_attention
            .py:relative_position_bias``): the kernel then stages the table
            and rebuilds ``rpb`` from it (``csrc/swin_block.cu``: bias_row)
            instead of reading the dense form. The same values, so the plain
            version ignores it.

    On a CUDA tensor one launch of ``csrc/swin_block.cu``'s K2 (design
    there): in bf16 ``mma.sync`` tensor-core products with each warp's 16
    x N logits, softmax and ``p`` in registers, one block per window at N
    <= 64 (every head from one staging of the window's rows) or per
    (window, head) above; in f32 FP32-FMA products tiled in registers, one
    block per (window, head). Bank entries that are all zero are skipped
    (:func:`bank_zero_flags`). Under autograd the backward is
    :func:`window_attention_plain`'s VJP (``ops/autograd.py``) in ``qkv``
    and ``rpb``; the bank, mask and table are constants.
    """
    return _window_attention_function(
        (bank, mask, table, num_heads, nwy, nwx, fast, scale), qkv, rpb)


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


def _mlp_block_launch(side, x, *params):
    form, fast, out_dtype, scatter = side
    return _mlp_block_cuda(x, *form, fast, out_dtype, scatter)


def _mlp_block_plain(side, x, *params):
    form, fast, out_dtype, scatter = side
    if params and torch.is_grad_enabled():
        form = _mlp_reference(params, form[2].dtype)
    return mlp_block_plain(x, *form, fast=fast, out_dtype=out_dtype,
                           scatter=scatter)


_mlp_block_function = kernel_function("mlp_block", _mlp_block_launch,
                                      _mlp_block_plain)


def mlp_block(x, ln_w, ln_b, w1, b1, w2, b2, *, fast=False, out_dtype=None,
              scatter=None, params=None):
    """LN -> fc1 -> GELU -> fc2 -> +residual over (T, C) tokens.

    ``w1`` (C, hidden) and ``w2`` (hidden, C) are in their kernel form
    (:func:`kernel_matrix`) for the compute dtype; the LN parameters and
    biases float32. ``fast`` takes tanh-GELU (else erf).
    With ``scatter = (B, H, W, ws, ...)`` the rows are in window order and
    the result is written as the (B, H, W, C) canvas. Two K1 launches on a
    CUDA tensor; :func:`mlp_block_plain` on a CPU tensor.

    ``params``: the reference tensors the form was made from (LN scale and
    shift, fc1 and fc2 weights as ``nn.Linear`` (out, in) and biases:
    :attr:`SwinBlockRef.mlp`); gradients reach them and ``x`` through
    :func:`mlp_block_plain`'s VJP (``ops/autograd.py``), the block
    recomputed in the backward. Without, the form is constant."""
    return _mlp_block_function(((ln_w, ln_b, w1, b1, w2, b2), fast,
                                out_dtype, scatter), x, *(params or ()))


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
                         nwy=h // ws, nwx=w // ws, fast=fast,
                         table=p.rpb_table)
    x1 = token_linear(a, p.wproj, p.bproj, res=xt, geom=geom, r_map=GATHER,
                      out_dtype=torch.float32 if paired else x.dtype)
    return mlp_block(x1, *p.mlp, fast=fast, out_dtype=x.dtype, scatter=geom)


def _swin_block_launch(side, x, *ref):
    p, num_heads, ws, dc, mask_bank, fast = side
    out = swin_block_composed(x, p, num_heads=num_heads, ws=ws, dc=dc,
                              mask_bank=mask_bank, fast=fast)
    swin_block.launches += 1
    return out


def _swin_block_plain(side, x, *ref):
    p, num_heads, ws, dc, mask_bank, fast = side
    return swin_block_plain(x, _block_params(p, ref, num_heads, ws),
                            num_heads=num_heads, ws=ws, dc=dc,
                            mask_bank=mask_bank, fast=fast)


_swin_block_function = kernel_function("swin_block", _swin_block_launch,
                                       _swin_block_plain)


def swin_block(x, p: SwinBlockParams, *, num_heads: int, ws: int,
               dc: int = 0, mask_bank=None, fast: bool = False,
               ref: SwinBlockRef | None = None):
    """One Swin block over ``x`` (B, H, W, C) read through
    ``roll(x, (dc, dc))``; the output stays in that rolled frame.

    Args:
        x: (B, H, W, C), H and W multiples of ``ws``.
        p: :class:`SwinBlockParams` (see :func:`prepare_swin_params`).
        num_heads, ws: heads and window size (N = ws^2 <= 64 on the card).
        dc: the folded roll, |dc| <= ws.
        mask_bank: None, or the (2, 2, N, N) float32 shift-mask bank.
        fast: the bf16 serving numerics (see the module docstring).
        ref: the :class:`SwinBlockRef` ``p`` was made from; gradients reach
            it. Without, ``p`` is constant.

    A CUDA tensor runs the kernels (:func:`swin_block_composed`) or raises;
    a CPU tensor runs :func:`swin_block_plain`. Under autograd the backward
    is :func:`swin_block_plain`'s VJP on :func:`reference_params`
    (``ops/autograd.py``): the block is recomputed from its input, which is
    all it keeps.
    """
    return _swin_block_function((p, num_heads, ws, dc, mask_bank, fast), x,
                                *(ref or ()))


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


def _swin_attn_block_launch(side, x, *ref):
    p, num_heads, ws, dc, mask_bank, fast = side
    _check_block(x, ws, dc)
    b, h, w, c = x.shape
    fast = fast and _paired(w, ws, num_heads)
    geom = (b, h, w, ws, dc)
    xt = x.contiguous().reshape(-1, c)
    qkv = token_linear(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b), geom=geom,
                       a_map=GATHER)
    a = window_attention(qkv, p.rpb, mask_bank, num_heads=num_heads,
                         nwy=h // ws, nwx=w // ws, fast=fast,
                         table=p.rpb_table)
    out = token_linear(a, p.wproj, p.bproj, res=xt, geom=geom, r_map=GATHER,
                       o_map=SCATTER, out_dtype=x.dtype)
    swin_attn_block.launches += 1
    return out.reshape(b, h, w, c)


def _swin_attn_block_plain(side, x, *ref):
    p, num_heads, ws, dc, mask_bank, fast = side
    return swin_attn_block_plain(x, _block_params(p, ref, num_heads, ws),
                                 num_heads=num_heads, ws=ws, dc=dc,
                                 mask_bank=mask_bank, fast=fast)


_swin_attn_block_function = kernel_function(
    "swin_attn_block", _swin_attn_block_launch, _swin_attn_block_plain)


def swin_attn_block(x, p: SwinBlockParams, *, num_heads: int, ws: int,
                    dc: int = 0, mask_bank=None, fast: bool = False,
                    ref: SwinBlockRef | None = None):
    """The attention half of a Swin block over ``x`` (B, H, W, C) read
    through ``roll(x, (dc, dc))``: ``xr + proj(attn(LN1(xr)))`` in the
    rolled frame, in ``x``'s dtype. The TPU's ``swin_strip_pallas`` with
    ``mlp=None``, HAT's call: numerics as :func:`swin_block`'s (``fast``
    where the windows per row and the heads are even), ``p``'s MLP
    weights unused; ``ref`` as :func:`swin_block`'s.

    A CUDA tensor runs three launches (K1 LN1 + gather -> qkv, K2, K1 proj
    + gathered residual scattered to the rolled frame) or raises; a CPU
    tensor runs :func:`swin_attn_block_plain`, which is also the backward's
    recompute under autograd.
    """
    return _swin_attn_block_function((p, num_heads, ws, dc, mask_bank, fast),
                                     x, *(ref or ()))


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


def _wmsa_block_launch(side, xw, *ref):
    p, num_heads, mask = side
    nwb, n, c = xw.shape
    xt = xw.contiguous().reshape(-1, c)
    qkv = token_linear(xt, p.wqkv, p.bqkv, ln=(p.ln1_w, p.ln1_b))
    a = window_attention(qkv, p.rpb, None, num_heads=num_heads, nwy=1,
                         nwx=1, fast=False, mask=mask, table=p.rpb_table)
    out = token_linear(a, p.wproj, p.bproj, res=xt, out_dtype=xw.dtype)
    wmsa_block.launches += 1
    return out.reshape(nwb, n, c)


def _wmsa_block_plain(side, xw, *ref):
    p, num_heads, mask = side
    ws = round(p.rpb.shape[-1] ** 0.5)
    return wmsa_block_plain(xw, _block_params(p, ref, num_heads, ws),
                            num_heads=num_heads, mask=mask)


_wmsa_block_function = kernel_function("wmsa_block", _wmsa_block_launch,
                                       _wmsa_block_plain)


def wmsa_block(xw, p: SwinBlockParams, *, num_heads: int, mask=None,
               ref: SwinBlockRef | None = None):
    """``xw + proj(attn(LN1(xw)))`` over partitioned windows: the TPU's
    ``wmsa_block_pallas``.

    Args:
        xw: (nWB, N, C) windows (N <= 256 on the card), in the dtype ``p``
            was prepared for.
        p: :class:`SwinBlockParams` (its MLP weights unused).
        mask: None or the (nW, N, N) float32 shift mask; window ``w`` adds
            ``mask[w % nW]``.
        ref: as :func:`swin_block`'s.

    Exact softmax in both dtypes. Cast points are the TPU kernel's: the LN
    output, qkv and the attention output in ``xw``'s dtype, proj +
    residual in float32 and one cast (the attention scale is folded into
    the q weights). A CUDA tensor runs three launches (K1 LN1 -> qkv, K2
    in full-mask mode, K1 proj + residual) or raises; a CPU tensor runs
    :func:`wmsa_block_plain`, which is also the backward's recompute under
    autograd.
    """
    return _wmsa_block_function((p, num_heads, mask), xw, *(ref or ()))


wmsa_block.launches = 0


# ---------------------------------------------------------------------------
# wmsa (the window-MHSA core; DehazeFormer's call)


def _wmsa(attention, qkv, rpb, mask, num_heads):
    """``attention`` (K2 or its plain version) in full-mask mode over the
    windows' rows, with the logit scale head_dim**-0.5."""
    nwb, n, c3 = qkv.shape
    out = attention(qkv.reshape(-1, c3), rpb, None, num_heads=num_heads,
                    nwy=1, nwx=1, fast=False, mask=mask,
                    scale=(c3 // 3 // num_heads) ** -0.5)
    return out.reshape(nwb, n, c3 // 3)


def wmsa_plain(qkv, rpb, mask=None, *, num_heads: int):
    """Plain PyTorch version of :func:`wmsa`."""
    return _wmsa(window_attention_plain, qkv, rpb, mask, num_heads)


def wmsa(qkv, rpb, mask=None, *, num_heads: int):
    """Window MHSA from packed projections: the TPU's ``wmsa_pallas``.

    Args:
        qkv: (nWB, N, 3C) packed [q | k | v], q unscaled, float32 or
            bfloat16 (N <= 256 and head width <= 64 on the card).
        rpb: (heads, N, N) float32 relative-position bias.
        mask: None or the (nW, N, N) float32 additive mask; window ``w``
            adds ``mask[w % nW]``.

    Returns (nWB, N, C) in ``qkv``'s dtype. Per (window, head) the logits
    are ``(q.k) * head_dim**-0.5`` in float32 plus the bias, the softmax is
    exact, ``p`` is cast to the qkv dtype before ``p.v`` (float32 sums).
    A CUDA tensor launches K2 with that logit scale (one launch) or raises;
    a CPU tensor runs :func:`wmsa_plain`. Gradients reach ``qkv`` and
    ``rpb`` (DehazeFormer's comes out of its bias MLP) through
    :func:`window_attention`'s backward.
    """
    out = _wmsa(window_attention, qkv, rpb, mask, num_heads)
    if qkv.is_cuda:
        wmsa.launches += 1
    return out


wmsa.launches = 0


# ---------------------------------------------------------------------------
# swin_pair_block (an RSTB's unshifted + shifted pair in one launch; K8)


def _check_pair(x, num_heads, ws, dc1):
    _, h, w, c = x.shape
    if h % ws or w % ws:
        raise ValueError(f"canvas {h}x{w} is not a multiple of window {ws}")
    if (w // ws) % 2 or num_heads % 2:
        raise ValueError(f"swin_pair_block needs an even window count per "
                         f"row and an even head count (got {w // ws} "
                         f"windows, {num_heads} heads)")
    if dc1 not in (0, ws // 2):
        raise ValueError(f"dc1 must be 0 or +ws//2 = {ws // 2}, not {dc1}")


def swin_pair_block_plain(x, pa: SwinBlockParams, pb: SwinBlockParams,
                          mask_bank, *, num_heads: int, ws: int, dc1: int):
    """Plain PyTorch version of :func:`swin_pair_block`: the two
    :func:`swin_block_plain` calls."""
    _check_pair(x, num_heads, ws, dc1)
    y = swin_block_plain(x, pa, num_heads=num_heads, ws=ws, dc=dc1,
                         fast=True)
    return swin_block_plain(y, pb, num_heads=num_heads, ws=ws, dc=-ws // 2,
                            mask_bank=mask_bank, fast=True)


def _pair_form(p: SwinBlockParams, num_heads: int):
    """K8's float32 pointers for one block, and its widths: the qkv weight
    and bias head-major (per head [q | k | v] columns) and proj's rows to
    match; the MLP weights row-major."""
    c = p.ln1_w.shape[0]
    hd = c // num_heads
    wq = _dense(p.wqkv, c, 3 * c).reshape(c, 3, num_heads, hd)
    hid = p.b1.shape[0]
    tensors = (p.ln1_w, p.ln1_b,
               wq.permute(0, 2, 1, 3).reshape(c, -1).contiguous(),
               p.bqkv.reshape(3, num_heads, hd).permute(1, 0, 2)
               .reshape(-1).contiguous(),
               _dense(p.wproj, c, c).contiguous(), p.bproj, p.rpb, p.ln2_w,
               p.ln2_b, _dense(p.w1, c, hid).contiguous(), p.b1,
               _dense(p.w2, hid, c).contiguous(), p.b2)
    dims = dict(hdp=hd, kp=c, hid=hid, hidp=hid, ldqkv=3 * c, ldproj=c,
                ldw1=hid, ldw2=c, cn=c)
    return tensors, dims


# The bf16 kernel's instantiations (csrc/swin_pair.cu: IRK_PAIR_SHAPES):
# (NQW, NCW, NHW, KD), one warpgroup's width of the q, k and v passes, of
# proj and fc2, of each half of fc1, and the padded head width / 16. They
# hold C 180 with 6 heads (SwinIR-M, HAT), C 48 with 2 heads, C 60 with 6
# heads.
PAIR_SHAPES = ((96, 96, 96, 2), (32, 24, 32, 2), (48, 32, 32, 1))
# the hidden width nh is 2 w for the first w here with 2 w >= hid: nh / 4
# (a warpgroup's slice of one fc1 half) is then an instantiated width, and
# nh a multiple of 64 (fc2's K, read in stages of at most 64 k rows)
_PAIR_HIDDEN_WIDTHS = (32, 64, 96, 128, 192)


def pair_dims(c: int, num_heads: int, hid: int) -> dict:
    """The padded widths of K8's bf16 form: the head width ``hdp`` (to 16),
    ``kp`` (C to 64: the LN rows), ``nq`` (heads x hdp: q; k and v are
    2 nq) and ``kq`` (nq to 64: the attention output, proj's K), ``nc``
    (proj and fc2's columns, twice an instantiated width >= C / 2), ``nh``
    (fc1's columns and fc2's K, twice a width of
    ``_PAIR_HIDDEN_WIDTHS`` >= hid / 2)."""
    hdp = -(-(c // num_heads) // 16) * 16
    nq = num_heads * hdp
    nhw = next((w for w in _PAIR_HIDDEN_WIDTHS if 2 * w >= hid), None)
    if nhw is None:
        raise ValueError(f"swin_pair_block: hidden width {hid} is wider "
                         f"than bf16 K8 takes (384)")
    return dict(hdp=hdp, kp=-(-c // 64) * 64, nq=nq, kq=-(-nq // 64) * 64,
                nc=2 * kernels.gemm_width(-(-c // 2)), nh=2 * nhw)


class SwinPairForm(NamedTuple):
    """K8's bf16 form of one block (:func:`swin_pair_weights`), made once
    per weight. Five product passes, each a (K, N) weight zero-padded to
    the widths of :func:`pair_dims` and packed as K1's core matrices
    (:func:`_core_matrices`): ``wq`` (kp, nq) head-major (per head ``hdp``
    columns), ``wkv`` (kp, 2 nq) as two slices, k of every head then v,
    ``wproj`` (kq, nc) with its rows head-major to match, ``w1`` (kp, nh)
    as two slices of nh / 2 columns, ``w2`` (nh, nc). A slice is one pass
    of the kernel. The biases float32 padded to the passes'
    columns, ``ln1`` and ``ln2`` the (2, C) LayerNorm scale and shift, and
    the (heads, N, N) relative-position bias ``rpb``. The q columns carry
    the attention scale, as in :class:`SwinBlockParams`."""

    wq: torch.Tensor
    wkv: torch.Tensor
    wproj: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor
    bq: torch.Tensor
    bkv: torch.Tensor
    bproj: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    ln1: torch.Tensor
    ln2: torch.Tensor
    rpb: torch.Tensor
    c: int
    heads: int
    hid: int

    @property
    def dims(self) -> dict:
        return pair_dims(self.c, self.heads, self.hid)

    def unpack(self) -> dict:
        """The block's (K, N) float32 matrices and biases this form holds
        (``wqkv`` (C, 3C) with [q | k | v] columns, ``bqkv``, ``wproj``,
        ``bproj``, ``w1``, ``b1``, ``w2``, ``b2``), and ``pads``: every
        padded entry of the form, which must be zero."""
        d = self.dims
        c, h, hdp = self.c, self.heads, d["hdp"]
        hd, hid = c // h, self.hid
        wq = _dense(self.wq, d["kp"], d["nq"]).reshape(-1, h, hdp)
        wkv = _dense(self.wkv, d["kp"], 2 * d["nq"]).reshape(-1, 2, h, hdp)
        wkv = wkv.transpose(1, 2)
        wp = _dense(self.wproj, d["kq"], d["nc"])
        w1 = _dense(self.w1, d["kp"], d["nh"])
        w2 = _dense(self.w2, d["nh"], d["nc"])
        bkv = self.bkv.reshape(2, h, hdp).transpose(0, 1)
        qkv = torch.cat([wq[:c, :, None, :hd], wkv[:c, :, :, :hd]], dim=2)
        bqkv = torch.cat([self.bq.reshape(h, 1, hdp), bkv], dim=1)[..., :hd]
        wpr = wp[:h * hdp].reshape(h, hdp, -1)
        pads = torch.cat([
            wq[c:].flatten(), wq[..., hd:].flatten(), wkv[c:].flatten(),
            wkv[..., hd:].flatten(), wpr[:, hd:].flatten(),
            wp[h * hdp:].flatten(), wp[:, c:].flatten(), w1[c:].flatten(),
            w1[:, hid:].flatten(), w2[hid:].flatten(), w2[:, c:].flatten(),
            self.bq.reshape(h, hdp)[:, hd:].flatten(),
            bkv[..., hd:].flatten(), self.bproj[c:], self.b1[hid:],
            self.b2[c:]])
        return dict(
            wqkv=qkv.permute(0, 2, 1, 3).reshape(c, 3 * c),
            bqkv=bqkv.permute(1, 0, 2).reshape(3 * c),
            wproj=wpr[:, :hd, :c].reshape(c, c), bproj=self.bproj[:c],
            w1=w1[:c, :hid], b1=self.b1[:hid], w2=w2[:hid, :c],
            b2=self.b2[:c], pads=pads)


def swin_pair_weights(p: SwinBlockParams, num_heads: int) -> SwinPairForm:
    """K8's bf16 form of one block's weights (:class:`SwinPairForm`), from
    its :class:`SwinBlockParams` in bfloat16 (exact: the same values,
    moved and zero-padded)."""
    c = p.ln1_w.shape[0]
    hid = p.b1.shape[0]
    h, hd = num_heads, c // num_heads
    d = pair_dims(c, h, hid)
    hdp = d["hdp"]
    dt = torch.bfloat16

    def pack(w, k, n, slices=1):
        w = F.pad(w, (0, n - w.shape[1], 0, k - w.shape[0]))
        return _core_matrices(w.to(dt), slices, n // slices).contiguous()

    wqkv = _dense(p.wqkv, c, 3 * c).reshape(c, 3, h, hd)
    wqkv = F.pad(wqkv, (0, hdp - hd)).permute(0, 2, 1, 3)  # (c, h, 3, hdp)
    bqkv = F.pad(p.bqkv.float().reshape(3, h, hd), (0, hdp - hd))
    bqkv = bqkv.permute(1, 0, 2)  # (h, 3, hdp)
    wproj = F.pad(_dense(p.wproj, c, c).reshape(h, hd, c),
                  (0, 0, 0, hdp - hd)).reshape(h * hdp, c)

    def vec(v, n):
        return F.pad(v.float(), (0, n - v.shape[0])).contiguous()

    return SwinPairForm(
        wq=pack(wqkv[:, :, 0].reshape(c, -1), d["kp"], d["nq"]),
        wkv=pack(wqkv[:, :, 1:].transpose(1, 2).reshape(c, -1), d["kp"],
                 2 * d["nq"], 2),
        wproj=pack(wproj, d["kq"], d["nc"]),
        w1=pack(_dense(p.w1, c, hid), d["kp"], d["nh"], 2),
        w2=pack(_dense(p.w2, hid, c), d["nh"], d["nc"]),
        bq=bqkv[:, 0].reshape(-1).contiguous(),
        bkv=bqkv[:, 1:].transpose(0, 1).reshape(-1).contiguous(),
        bproj=vec(p.bproj, d["nc"]), b1=vec(p.b1, d["nh"]),
        b2=vec(p.b2, d["nc"]),
        ln1=torch.stack([p.ln1_w, p.ln1_b]).float().contiguous(),
        ln2=torch.stack([p.ln2_w, p.ln2_b]).float().contiguous(),
        rpb=p.rpb.float().contiguous(), c=c, heads=h, hid=hid)


def _pair_cached(p: SwinBlockParams, num_heads: int, make):
    """``make(p, num_heads)``, made once per block and kept on its qkv
    weight, keyed by every tensor of the block and its version (an
    in-place edit remakes it)."""
    key = (num_heads, make.__name__) + tuple(
        (t.data_ptr(), t._version) for t in p[:13])
    hit = getattr(p.wqkv, "_irk_pair", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    val = make(p, num_heads)
    p.wqkv._irk_pair = (key, val)
    return val


def _swin_pair_cuda(x, pa, pb, mask_bank, num_heads, ws, dc1):
    b, h, w, c = x.shape
    if ws % 2 or ws * ws > 64:
        raise ValueError(f"swin_pair_block on the card takes an even window "
                         f"of at most 64 tokens (ws {ws})")
    if x.dtype not in _DT or any(p.wqkv.dtype != x.dtype for p in (pa, pb)):
        raise ValueError("swin_pair_block takes float32 or bfloat16 x with "
                         "weights prepared for its dtype")
    if c % num_heads:
        raise ValueError(f"C {c} is not a multiple of the heads")
    _check_f32(mask_bank, (2, 2, ws * ws, ws * ws), "mask_bank")
    x = x.contiguous()
    out = torch.empty_like(x)
    lib = kernels.load("swin_pair")
    ptrs = ctypes.c_void_p * 13
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        fa, fb = (_pair_cached(p, num_heads, swin_pair_weights)
                  for p in (pa, pb))
        d = fa.dims
        shape = (d["nq"] // 2, d["nc"] // 2, d["nh"] // 4, d["hdp"] // 16)
        if fb.dims != d or c > 256 or shape not in PAIR_SHAPES:
            raise ValueError(
                f"bf16 swin_pair_block is built for (C, heads) (180, 6), "
                f"(48, 2), (60, 6) (csrc/swin_pair.cu: IRK_PAIR_SHAPES), "
                f"not ({c}, {num_heads}) with hidden {fa.hid}, {fb.hid}")
        ta, tb = fa[:13], fb[:13]
    else:
        (ta, da), (tb, db) = (_pair_cached(p, num_heads, _pair_form)
                              for p in (pa, pb))
        if da != db:
            raise ValueError("the pair's blocks differ in their widths")
    for t in ta + tb:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("swin_pair_block operands on different devices")
    if x.dtype == torch.bfloat16:
        nwin = b * (h // ws) * (w // ws)
        fn = lib.swin_pair_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ptrs, ptrs,
                       ctypes.c_void_p] + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        err = fn(x.data_ptr(), out.data_ptr(),
                 ptrs(*(t.data_ptr() for t in ta)),
                 ptrs(*(t.data_ptr() for t in tb)), _ptr(mask_bank),
                 bank_zero_flags(mask_bank) if mask_bank is not None else 0,
                 b, h, w, c, num_heads, d["hdp"], ws, dc1, d["kp"], d["kq"],
                 d["nq"], d["nc"], d["nh"],
                 min(nwin, kernels.sm_count(x.device)), stream)
    else:
        fn = lib.swin_pair
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ptrs, ptrs,
                       ctypes.c_void_p] + [ctypes.c_int] * 16 \
            + [ctypes.c_void_p]
        err = fn(x.data_ptr(), out.data_ptr(),
                 ptrs(*(t.data_ptr() for t in ta)),
                 ptrs(*(t.data_ptr() for t in tb)), _ptr(mask_bank), b, h, w,
                 c, num_heads, da["hdp"], da["kp"], da["hid"], da["hidp"],
                 da["ldqkv"], da["ldproj"], da["ldw1"], da["ldw2"], da["cn"],
                 ws, dc1, stream)
    kernels.check(err, "swin_pair_block")
    swin_pair_block.launches += 1
    return out


def pair_gemm_tile_plain(a: torch.Tensor, w: torch.Tensor, n0: int,
                         nw: int) -> torch.Tensor:
    """Plain version of :func:`pair_gemm_tile`."""
    return a.float() @ w.float()[:, n0:n0 + nw]


def pair_gemm_tile(a: torch.Tensor, w: torch.Tensor, n0: int,
                   nw: int) -> torch.Tensor:
    """One K8 product pass of one warpgroup, the pass form's own check:
    ``a`` (64, K) bf16, ``w`` a (K, N) bf16 weight packed here as a pass of
    :class:`SwinPairForm` (K a multiple of the stage's 64 k rows, 32 where
    N > 192, at most 256), streamed through K8's ring; returns the (64, nw)
    float32 product with columns [n0, n0 + nw) of ``w`` (nw one of the
    kernel's widths). A CPU tensor takes :func:`pair_gemm_tile_plain`."""
    if not a.is_cuda:
        return pair_gemm_tile_plain(a, w, n0, nw)
    k, n = w.shape
    a = a.contiguous()
    wp = _core_matrices(w.to(torch.bfloat16), 1, n).contiguous()
    out = torch.empty((64, nw), dtype=torch.float32, device=a.device)
    fn = kernels.load("swin_pair").pair_gemm_tile
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    err = fn(a.data_ptr(), wp.data_ptr(), out.data_ptr(), k, n, n0, nw,
             torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(err, "pair_gemm_tile")
    return out


def swin_pair_block(x, pa: SwinBlockParams, pb: SwinBlockParams, mask_bank,
                    *, num_heads: int, ws: int, dc1: int):
    """An RSTB's pair of Swin blocks in one launch: the TPU's
    ``swin_pair_strip_pallas``.

    By definition ``swin_block(swin_block(x, pa, dc=dc1, fast=True), pb,
    dc=-ws//2, mask_bank=mask_bank, fast=True)``: block A unshifted, read
    through ``roll(x, dc1)`` (``dc1`` 0 for an RSTB's first pair, +ws//2
    for a pair whose input sits in frame -ws//2), block B shifted with the
    (2, 2, N, N) float32 ``mask_bank``; the output is in frame -ws//2.
    Fast numerics only, as on the TPU; float32 or bfloat16 (the serving
    form). ValueError for an odd window count per row, an odd head count,
    ``dc1`` not 0 or +ws//2, or H, W not multiples of ``ws``.

    A CUDA tensor runs one K8 launch (``csrc/swin_pair.cu``; N <= 64, ws
    even; in bf16 the (C, heads) of ``PAIR_SHAPES``) or raises; a CPU
    tensor runs :func:`swin_pair_block_plain`. The kernel's weight forms
    (:func:`swin_pair_weights` in bf16, :func:`_pair_form` in f32) are made
    at a block's first launch and kept on its qkv weight.
    """
    forbid_grad("swin_pair_block", x, pa, pb, mask_bank)
    _check_pair(x, num_heads, ws, dc1)
    if not x.is_cuda:
        return swin_pair_block_plain(x, pa, pb, mask_bank,
                                     num_heads=num_heads, ws=ws, dc1=dc1)
    return _swin_pair_cuda(x, pa, pb, mask_bank, num_heads, ws, dc1)


swin_pair_block.launches = 0

_COUNTED = (swin_block, swin_attn_block, wmsa_block, wmsa, mlp_block,
            token_linear, window_attention, swin_pair_block)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}

