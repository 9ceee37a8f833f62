"""Windowed multi-head self-attention with relative position bias
(counterpart of ``image_restoration_agent_tpu/ops/window_attention.py``).

``window_attention`` here is the plain exact reference; the serving path
runs attention inside the Swin block kernels (``ops/swin_block.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """(B * nH * nW, ws, ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h // ws * w // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2*ws-1)^2 relative-position-bias
    table, the reference construction (network_swinir.py:87-99)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).astype(np.int32)


@functools.lru_cache(maxsize=256)
def shift_attention_mask(h: int, w: int, ws: int, shift: int
                         ) -> np.ndarray | None:
    """Additive (-100/0) mask for shifted windows, (nW, N, N), or None if
    shift == 0. Cached: treat the returned array as read-only."""
    if shift == 0:
        return None
    img_mask = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws)
    m = m.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _index_on(ws: int, device: torch.device) -> torch.Tensor:
    """:func:`relative_position_index` flattened, as int64 on ``device``:
    made once, so a forward that gathers its bias every call (training)
    copies no index to the card."""
    return torch.from_numpy(relative_position_index(ws).reshape(-1).astype(
        np.int64)).to(device)


def relative_position_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """Gather the ``((2ws-1)^2, heads)`` table into the ``(heads, N, N)``
    bias."""
    n = ws * ws
    return table[_index_on(ws, table.device)].reshape(n, n, -1).permute(
        2, 0, 1)


def window_attention(qkv: torch.Tensor, num_heads: int,
                     rpb_table: torch.Tensor, ws: int,
                     mask: torch.Tensor | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Exact multi-head attention within windows.

    Args:
        qkv: ``(nWB, N, 3*C)`` packed projections (q | k | v, torch order).
        num_heads: heads; ``C // num_heads`` is the head width.
        rpb_table: ``((2*ws-1)^2, num_heads)`` relative position bias table.
        ws: window size.
        mask: optional ``(nW, N, N)`` additive mask; the window batch is a
            multiple of nW.
        scale: logit scale; defaults to head_dim ** -0.5.

    Returns:
        ``(nWB, N, C)`` attention output (before the output projection),
        in ``qkv``'s dtype; logits and softmax in float32.
    """
    nwb, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    scale = hd ** -0.5 if scale is None else scale
    qkv = qkv.reshape(nwb, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0].float(), qkv[1].float(), qkv[2].float()
    attn = (q * scale) @ k.transpose(-1, -2)
    attn = attn + relative_position_bias(rpb_table, ws).float()[None]
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(nwb // nw, nw, num_heads, n, n) \
            + mask[None, :, None].float()
        attn = attn.reshape(nwb, num_heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    out = attn @ v
    return out.permute(0, 2, 1, 3).reshape(nwb, n, c).to(qkv.dtype)
