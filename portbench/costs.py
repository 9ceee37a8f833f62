"""Operations and bytes of the layers the benchmark prices, from shapes.

FLOP are the algorithm's: 2 per multiply-add of a layer's products, its
attention products and its depthwise taps, counted once whatever the
implementation does (a split-TF32 kernel issues three products per
multiply-add; that is its cost, not the work). Normalisations, softmax,
activations and adds are not counted. Bytes: each input (activations and
weights) read once and each output written once, at float32 sizes.

The least time a layer can take on a card is the larger of FLOP over the
peak product rate and bytes over the memory bandwidth (:func:`least_s`).
"""

from __future__ import annotations

import math

F32 = 4

# Published peaks of one card, dense (NVIDIA's H100 SXM data sheet, at the
# full 700 W power limit). Float32 products are priced at the TF32 rate,
# the fastest at which the card multiplies float32 inputs, so no float32
# implementation can read above 100%.
PEAKS = {
    "H100": {"flops": 495e12, "bytes_per_s": 3.35e12,
             "what": "H100 SXM: 495 TFLOP/s dense TF32, 3.35 TB/s HBM3"},
}


def peaks(device_kind: str) -> dict | None:
    """The peaks of the card named ``device_kind`` (None if the table
    holds no such card: rooflines are then not reported)."""
    for key, p in PEAKS.items():
        if key in device_kind:
            return p
    return None


def least_s(flop: float, nbytes: float, peak: dict) -> float:
    return max(flop / peak["flops"], nbytes / peak["bytes_per_s"])


def swin_block_flop(tokens: int, c: int, hidden: int, ws: int) -> int:
    """One Swin transformer block over ``tokens`` tokens of width ``c``:
    qkv, the window attention's two products (each query against the
    ws*ws keys of its window, over all heads), proj, fc1, fc2."""
    n = ws * ws
    per_token = 2 * (c * 3 * c + c * c + 2 * c * hidden) + 2 * 2 * n * c
    return tokens * per_token


def restormer_block_flop(pixels: int, c: int, heads: int,
                         hidden: int) -> int:
    """One Restormer block over ``pixels`` pixels of width ``c``: MDTA (qkv
    1x1, its 3x3 depthwise taps, the transposed attention's two
    (c/heads)^2 products per head and pixel, project_out) and GDFN
    (project_in to 2*hidden, its depthwise taps, project_out)."""
    mdta = 2 * (c * 3 * c + 9 * 3 * c + 2 * c * c // heads + c * c)
    gdfn = 2 * (c * 2 * hidden + 9 * 2 * hidden + hidden * c)
    return pixels * (mdta + gdfn)


def conv3x3_flop(pixels: int, cin: int, cout: int) -> int:
    return 2 * 9 * cin * cout * pixels


def conv1x1_flop(pixels: int, cin: int, cout: int) -> int:
    return 2 * cin * cout * pixels


def activation_bytes(*shapes) -> int:
    """Float32 bytes of tensors of the given shapes, each once."""
    return F32 * sum(math.prod(s) for s in shapes)


def roofline_pct(run, label: str, cost) -> float | None:
    """A module's share of its roofline over a traced window: the least
    time of every call of modules ``label`` (``cost(call, run)`` gives a
    call's FLOP and bytes) over the device time launched inside those
    calls. None where the window holds no such call or no device time."""
    if run.trace is None or run.hooks is None or run.peak is None:
        return None
    calls = run.hooks.calls.get(label)
    device_s = run.trace.layer_s.get(label)
    if not calls or not device_s:
        return None
    least = sum(least_s(*cost(c, run), run.peak) for c in calls)
    return 100.0 * least / device_s


def params_bytes(run, qname: str) -> int:
    """Float32 bytes of the weights of module ``qname`` (by the
    reference's parameter names)."""
    prefix = qname + "."
    return F32 * sum(math.prod(s) for k, s in run.shapes.items()
                     if k.startswith(prefix))
