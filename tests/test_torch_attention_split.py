"""The split-TF32 window attention of the float32 K2 kernel
(``csrc/window_attention.cu:window_attention_tf32_kernel``), emulated on
the CPU with bit masks, against the JAX package's float32 attention:
``wmsa_pallas`` in interpret mode (as its own tests run it).

The kernel splits q, k, p and v in registers into xh = rna(x) (TF32: 10
mantissa bits, nearest, ties away from zero; integer ops) and xl = x - xh
(read by the tensor cores as its top 19 bits: truncated to TF32), and sums
each product as xl yh + xh yl + xh yh in float32 on the tensor cores: S = q
k^T, then the logits ``(S * scale + bias) + mask`` and the softmax in
float32, then O = p v the same way. The emulation takes each TF32 x TF32
term exactly (a float64 product), adds the three terms in float32 in the
kernel's order, and must stay within the f32 rule the card is held to (max
error <= 1e-4 x max|ref|) with the bank and the bias table at N 64 and head
width 30, at N 49 (window 7), at N 256 with the full mask, and in
DehazeFormer's logit-scale mode at head width 12. Plain TF32 (the xh yh
term alone) is the control the split must beat."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.ops.pallas_attention import wmsa_pallas

tsb = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.swin_block")
twa = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.window_attention")

torch.set_num_threads(1)


def rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: add half a TF32 ulp to the magnitude, clear the
    low 13 bits."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(
        torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand as the tensor cores read TF32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor,
                 split: bool = True) -> torch.Tensor:
    """a @ b (batched) as K2 computes it: al bh + ah bl + ah bh, each term
    exact, added in float32 in that order (split=False: ah bh alone)."""
    ah, bh = rna(a), rna(b)
    if not split:
        return (ah.double() @ bh.double()).float()
    al, bl = trunc(a - ah), trunc(b - bh)
    acc = (al.double() @ bh.double()).float()
    acc = acc + (ah.double() @ bl.double()).float()
    return acc + (ah.double() @ bh.double()).float()


def attention_emulated(qkv, rpb, heads, scale, mask=None, split=True):
    """K2's exact mode on (nWB, N, 3C) windows: (q k^T) * scale + rpb (+
    mask[w % nW]), softmax in float32, p v; both products split TF32."""
    nwb, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(nwb, n, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4)
    s = split_matmul(q, k.transpose(-1, -2), split) * scale + rpb
    if mask is not None:
        s = (s.reshape(-1, mask.shape[0], heads, n, n)
             + mask[None, :, None]).reshape(nwb, heads, n, n)
    p = torch.softmax(s, dim=-1)
    return split_matmul(p, v, split).permute(0, 2, 1, 3).reshape(nwb, n, c)


def _bank_masks(ws: int, nwy: int, nwx: int) -> np.ndarray:
    """The (nwy * nwx, N, N) masks the K2 bank mode adds: the shift mask's
    (2, 2, N, N) edge bank picked per window by the port's rule."""
    n = ws * ws
    bank = torch.from_numpy(twa.shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n))
    return tsb._bank_per_window(bank, nwy, nwx).numpy()


# (ws, C, heads, canvas (h, w), batch, mask kind, bias from the table):
# SwinIR's N 64 with the bank and the table (head width 30), window 7 (N
# 49, keys padded to 64 in the kernel) with the full mask, HAT's N 256 with
# the full mask, DehazeFormer's head width 12 (logit scale, no mask)
_CASES = {
    "n64_bank_table_hd30": (8, 60, 2, (16, 24), 2, "bank", True),
    "n49_mask_hd30": (7, 60, 2, (14, 28), 2, "mask", True),
    "n256_mask_hd30": (16, 60, 2, (32, 32), 1, "mask", True),
    "dehazeformer_hd12": (8, 24, 2, (16, 32), 2, None, False),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_split_tf32_attention_matches_jax(name):
    ws, c, heads, (h, w), bsz, kind, table = _CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    n, hd = ws * ws, c // heads
    nwy, nwx = h // ws, w // ws
    nwb = bsz * nwy * nwx
    qkv = rng.standard_normal((nwb, n, 3 * c)).astype(np.float32)
    if table:
        tab = torch.from_numpy((0.5 * rng.standard_normal(
            ((2 * ws - 1) ** 2, heads))).astype(np.float32))
        rpb = twa.relative_position_bias(tab, ws).contiguous().numpy()
    else:
        rpb = (0.5 * rng.standard_normal((heads, n, n))).astype(np.float32)
    mask = (_bank_masks(ws, nwy, nwx) if kind == "bank"
            else twa.shift_attention_mask(h, w, ws, ws // 2) if kind
            else None)
    g = nwy * nwx if mask is not None else nwb
    want = np.asarray(wmsa_pallas(
        jnp.asarray(qkv), jnp.asarray(rpb),
        None if mask is None else jnp.asarray(mask), num_heads=heads, g=g,
        interpret=True))
    t = torch.from_numpy
    args = (t(qkv), t(rpb), heads, hd ** -0.5,
            None if mask is None else t(np.ascontiguousarray(mask)))
    got = attention_emulated(*args).numpy()
    ctrl = attention_emulated(*args, split=False).numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    err_tf32 = float(np.abs(ctrl - want).max())
    assert err <= 1e-4 * scale, (err, scale)
    assert err * 10 < err_tf32, (err, err_tf32)


def test_emulated_attention_matches_k2_plain_with_bank_and_table():
    """The bank and table forms K2 reads agree with the full-mask form the
    emulation takes: the port's plain K2 on the bank, with q pre-scaled
    (the Swin block's call), within float32 rounding of the full mask's."""
    rng = np.random.default_rng(3)
    ws, c, heads, nwy, nwx = 8, 60, 2, 2, 3
    n, hd = ws * ws, c // heads
    qkv = rng.standard_normal((2 * nwy * nwx * n, 3 * c)).astype(np.float32)
    tab = torch.from_numpy(rng.standard_normal(
        ((2 * ws - 1) ** 2, heads)).astype(np.float32))
    rpb = twa.relative_position_bias(tab, ws).contiguous()
    bank = torch.from_numpy(twa.shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n))
    q = qkv.copy()
    q[:, :c] *= hd ** -0.5
    got = tsb.window_attention(torch.from_numpy(q), rpb, bank,
                               num_heads=heads, nwy=nwy, nwx=nwx, fast=False,
                               table=tab)
    want = attention_emulated(
        torch.from_numpy(qkv).reshape(-1, n, 3 * c), rpb, heads, hd ** -0.5,
        torch.from_numpy(_bank_masks(ws, nwy, nwx)))
    scale = float(want.abs().max())
    assert float((got.reshape(want.shape) - want).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("k", [12, 30, 64])
def test_split_beats_plain_tf32(k):
    """Against a float64 product at a head width (q k^T) or a key count
    (p v), the split's error is far below plain TF32's and near float32's."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 64)).astype(np.float32))
    ref = a.double() @ b.double()
    e_split = float((split_matmul(a, b).double() - ref).abs().max())
    e_plain = float((split_matmul(a, b, split=False).double()
                     - ref).abs().max())
    e_f32 = float(((a @ b).double() - ref).abs().max())
    assert e_split * 100 < e_plain
    assert e_split <= 4 * e_f32 + 1e-6


@pytest.mark.parametrize("blocks,n,parts", [
    (32 * 6, 256, 4),     # HAT's training form: 32 windows x 6 heads
    (80 * 6, 256, 2),     # 480 pairs: two parts reach 4 blocks an SM
    (1280 * 6, 256, 1),   # HAT's 5x256x256 tile batch
    (16560 * 6, 64, 1),   # the SwinIR-M band
    (12, 49, 1),          # one 64-row chunk: nothing to split
    (12, 100, 2),         # two chunks
    (12, 160, 3),         # three chunks, split three ways
    (600, 160, 1),
])
def test_attention_parts(blocks, n, parts):
    """The float32 K2's split of a (window, head)'s query chunks across
    blocks: the fewest parts (a divisor of the chunks) that give 4 blocks
    an SM of the H100's 132, all chunks where even that falls short."""
    assert tsb.attention_parts(blocks, n, 132) == parts
