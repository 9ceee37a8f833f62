"""Memory-bounded dense attention: a loop over query chunks (counterpart of
``image_restoration_agent_tpu/ops/chunked_attention.py``).

softmax(q k^T * scale) v without the whole (N, M) score matrix: each chunk
of queries sees all of K, so no online softmax is needed and a row's result
does not depend on the chunk it falls in. DiffBIR's VAE mid-block and UNet
self-attention take it above :data:`DENSE_SCORE_LIMIT` score entries: a 256
px request's 128x128 latent has 16384 tokens, and the UNet's dense scores
would be 5 heads x 16384^2 x 4 B = 5.4 GB a layer.

Plain PyTorch, as the JAX package's is plain XLA (no TPU kernel), with its
cast points: logits, softmax and ``p @ v`` in float32 (float32 operands, no
TF32 on the card), one cast back to q's dtype.
"""

from __future__ import annotations

import torch

from ..device import exact_f32

# Below this many score entries (heads * N * M) the callers keep their
# dense path; above it they take chunked_attention.
DENSE_SCORE_LIMIT = 32 * 1024 * 1024


def _largest_divisor_leq(n: int, cap: int) -> int:
    for c in range(min(n, cap), 0, -1):
        if n % c == 0:
            return c
    return n


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(q @ k^T [* scale]) @ v over the whole score matrix, float32
    logits, softmax and product (the callers' dense paths, the JAX
    package's ``preferred_element_type=f32`` einsums); float32 result.
    ``scale`` None leaves the logits as they are (a caller that scales q
    first)."""
    if q.is_cuda:
        exact_f32()
    lg = q.float() @ k.float().transpose(-1, -2)
    if scale is not None:
        lg = lg * scale
    return torch.softmax(lg, dim=-1) @ v.float()


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, chunk: int = 2048) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v over the second-to-last axis of q.

    Args:
        q: (..., N, D); k: (..., M, D); v: (..., M, Dv).
        scale: logit scale (e.g. D ** -0.5), applied to the float32 logits.
        chunk: target query-chunk size; rounded down to a divisor of N.

    Returns:
        (..., N, Dv) in q's dtype.
    """
    if q.is_cuda:
        exact_f32()
    n = q.shape[-2]
    c = _largest_divisor_leq(n, chunk)
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    out = torch.empty((*q.shape[:-1], v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    for s in range(0, n, c):
        lg = (q[..., s:s + c, :].float() @ kt) * scale
        p = torch.softmax(lg, dim=-1)
        out[..., s:s + c, :] = (p @ vf).to(q.dtype)
    return out
