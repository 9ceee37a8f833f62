"""K2's (window_attention's) derived forms, on the CPU: the relative-
position bias the kernel rebuilds from the table by its index rule is the
dense bias, bit for bit, for the JAX package's and the port's index; the
bit form of a shift mask or bank decodes to the mask; all-zero bank
entries are flagged; and the plain path ignores the table (it is the same
bias)."""

import importlib

import numpy as np
import pytest
import torch

from image_restoration_agent_tpu.ops.window_attention import (
    relative_position_index as jax_relative_position_index)

tsb = importlib.import_module("image_restoration_agent_tpu_torch.ops.swin_block")
twa = importlib.import_module(
    "image_restoration_agent_tpu_torch.ops.window_attention")

torch.set_num_threads(1)


def _kernel_index(ws):
    """K2's table-mode rule (csrc/window_attention.cu bias_row,
    bias_cols): key j of query i reads table row rb(i) - cb(j), rb(i) = (yi + ws - 1)(2ws
    - 1) + xi + ws - 1, cb(j) = yj (2ws - 1) + xj, for tokens i = yi ws +
    xi; at window 16 the same index with cb(j) split into constants
    (BiasRow16)."""
    t = np.arange(ws * ws)
    y, x = t // ws, t % ws
    rb = (y + ws - 1) * (2 * ws - 1) + x + ws - 1
    cb = y * (2 * ws - 1) + x
    return rb[:, None] - cb[None, :]


@pytest.mark.parametrize("ws", [7, 8, 16])
@pytest.mark.parametrize("heads", [3, 6])
def test_table_rule_rebuilds_dense_bias(ws, heads):
    """table[rb(i) - cb(j)] (csrc/window_attention.cu bias_row /
    bias_cols) is the dense (heads, N, N) bias of SwinIR's and HAT's window attention
    (both gather by the JAX package's relative_position_index), and the
    port's relative_position_bias, bit for bit."""
    rng = np.random.default_rng(ws * 10 + heads)
    table = rng.standard_normal(((2 * ws - 1) ** 2, heads)).astype(
        np.float32)
    idx = _kernel_index(ws)
    assert idx.min() == 0 and idx.max() == (2 * ws - 1) ** 2 - 1
    rebuilt = table[idx].transpose(2, 0, 1)
    jidx = np.asarray(jax_relative_position_index(ws))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(rebuilt, table[jidx].transpose(2, 0, 1))
    dense = twa.relative_position_bias(torch.from_numpy(table), ws).numpy()
    assert rebuilt.tobytes() == dense.tobytes()


def _decode(bits, value, n):
    e, rows, mw = bits.shape
    b = (bits.long()[..., None] >> torch.arange(32)) & 1
    b = b.reshape(e, rows, mw * 32)
    assert not b[..., n:].any()  # the padding keys carry no bit
    return torch.where(b[..., :n].bool(), torch.tensor(value),
                       torch.tensor(0.0))


@pytest.mark.parametrize("ws,h,w", [(7, 21, 28), (8, 24, 40), (10, 20, 40),
                                    (16, 32, 64)])
def test_mask_bits_decode_to_the_shift_mask(ws, h, w):
    n = ws * ws
    mask = torch.from_numpy(twa.shift_attention_mask(h, w, ws, ws // 2))
    bits, value = tsb.mask_bits(mask)
    np_ = 64 if n <= 64 else 128 if n <= 128 else 256
    assert value == -100.0 and bits.dtype == torch.int32
    assert bits.shape == (mask.shape[0], n, np_ // 32)
    assert torch.equal(_decode(bits, value, n), mask)
    assert tsb.mask_bits(mask)[0] is bits  # made once per mask


@pytest.mark.parametrize("ws", [7, 8, 16])
def test_bank_bits_and_zero_flags(ws):
    n = ws * ws
    # a copy: the mask function's result is cached and read-only
    bank = torch.from_numpy(twa.shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n).copy())
    bits, value = tsb.mask_bits(bank)
    assert torch.equal(_decode(bits, value, n), bank.reshape(4, n, n))
    # only the interior entry (not last row, not last column) is all zero
    assert tsb.bank_zero_flags(bank) == 1
    bank[0, 0, 0, 1] = -100.0  # an in-place edit is seen
    assert tsb.bank_zero_flags(bank) == 0
    assert torch.equal(_decode(*tsb.mask_bits(bank), n),
                       bank.reshape(4, n, n))


def test_mask_bits_refuse_more_than_one_value():
    m = torch.zeros(2, 64, 64)
    m[0, 1, 2], m[1, 3, 4] = -100.0, -50.0
    assert tsb.mask_bits(m) is None
    assert tsb.mask_bits(torch.zeros(1, 49, 49))[1] == 0.0


@pytest.mark.parametrize("ws,heads", [(7, 3), (8, 2)])
def test_plain_path_ignores_the_table(ws, heads):
    """The table is the same bias: on a CPU tensor window_attention gives
    the same bits with and without it."""
    gen = torch.Generator().manual_seed(ws)
    n, c = ws * ws, 12 * heads
    qkv = torch.randn(2 * 4 * n, 3 * c, generator=gen)
    table = torch.randn((2 * ws - 1) ** 2, heads, generator=gen)
    rpb = twa.relative_position_bias(table, ws).contiguous()
    bank = torch.from_numpy(twa.shift_attention_mask(
        2 * ws, 2 * ws, ws, ws // 2).reshape(2, 2, n, n))
    kw = dict(num_heads=heads, nwy=2, nwx=2, fast=False)
    assert torch.equal(
        tsb.window_attention(qkv, rpb, bank, **kw, table=table),
        tsb.window_attention(qkv, rpb, bank, **kw))


def test_prepare_swin_params_keeps_the_table():
    gen = torch.Generator().manual_seed(3)
    c, heads, ws, hid = 24, 2, 8, 48
    p = tsb.prepare_swin_params(
        norm1_w=torch.ones(c), norm1_b=torch.zeros(c),
        qkv_w=torch.randn(3 * c, c, generator=gen), qkv_b=torch.zeros(3 * c),
        proj_w=torch.randn(c, c, generator=gen), proj_b=torch.zeros(c),
        rpb_table=torch.randn((2 * ws - 1) ** 2, heads, generator=gen),
        norm2_w=torch.ones(c), norm2_b=torch.zeros(c),
        fc1_w=torch.randn(hid, c, generator=gen), fc1_b=torch.zeros(hid),
        fc2_w=torch.randn(c, hid, generator=gen), fc2_b=torch.zeros(c),
        num_heads=heads, ws=ws, dtype=torch.float32)
    assert p.rpb_table.shape == ((2 * ws - 1) ** 2, heads)
    assert torch.equal(twa.relative_position_bias(p.rpb_table, ws), p.rpb)
