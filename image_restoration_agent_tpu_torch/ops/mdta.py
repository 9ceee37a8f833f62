"""MDTA: Restormer's transposed (channel) self-attention, unfused
(counterpart of ``image_restoration_agent_tpu/ops/mdta.py``).

q and k are L2-normalized over the pixels (``F.normalize``: a
``max(norm, 1e-12)`` floor), and a per-head ``(C_h, C_h)`` attention matrix
``softmax(q k^T * temperature)`` in float32 mixes the value channels.
"""

from __future__ import annotations

import torch


def mdta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   temperature: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Transposed channel attention.

    Args:
        q, k, v: (B, H, W, C), after the 1x1 and depthwise 3x3 convs.
        temperature: (num_heads,) or (num_heads, 1, 1).
        num_heads: C must divide evenly.

    Returns:
        (B, H, W, C) in ``q``'s dtype.
    """
    b, h, w, c = q.shape
    ch = c // num_heads
    hw = h * w

    def split(t):  # (B, HW, heads, C_h) -> (B, heads, C_h, HW)
        return t.reshape(b, hw, num_heads, ch).permute(0, 2, 3, 1)

    def l2norm(t):
        tf = t.float()
        n = tf.square().sum(dim=-1, keepdim=True).sqrt()
        return tf / n.clamp_min(1e-12)

    qn, kn = l2norm(split(q)), l2norm(split(k))
    temp = temperature.reshape(1, num_heads, 1, 1).float()
    attn = torch.softmax(qn @ kn.transpose(-1, -2) * temp, dim=-1)
    out = attn @ split(v).float()                  # (B, heads, C_h, HW)
    return out.permute(0, 3, 1, 2).reshape(b, h, w, c).to(q.dtype)
