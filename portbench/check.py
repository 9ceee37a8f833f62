"""Whether what the timed path produced is correct: every answer of the
window against the plain reference's answer to the same request.

Outputs are uint8 images. Compared numbers (limits per cell, in
``portbench/checks/<workload>.json``, with the readings they were set
from):

- ``mismatch_pct``: the share of output values (pixel channels) whose uint8
  differs from the reference's, over all answers;
- ``worst_block_pct``: the largest such share in any 64 x 64 block of
  output pixels of any answer, which a fault confined to one tile, band or
  border shows though it leaves the total small;
- ``bad_answers``: answers that never came (the request raised) or came in
  the wrong shape; its limit is 0.

``max_level_diff`` (the largest difference in uint8 levels) and
``reference_unsaturated_pct`` (the reference's values strictly inside (0,
255): a saturated output would hide any error) are printed beside them and
not compared.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 64
COMPARED = ("mismatch_pct", "worst_block_pct", "bad_answers")


def compare(out: np.ndarray, ref: np.ndarray, device) -> dict:
    """Counts for one answer against the reference's."""
    a = torch.from_numpy(out).to(device).to(torch.int16)
    b = torch.from_numpy(ref).to(device).to(torch.int16)
    diff = (a - b).abs()
    miss = (diff > 0).float().sum(-1)                       # (H, W)
    h, w = miss.shape
    ph, pw = (-h) % BLOCK, (-w) % BLOCK
    blocks = torch.nn.functional.pad(miss, (0, pw, 0, ph)).view(
        (h + ph) // BLOCK, BLOCK, (w + pw) // BLOCK, BLOCK).sum((1, 3))
    area = torch.nn.functional.pad(torch.ones_like(miss), (0, pw, 0, ph)).view(
        (h + ph) // BLOCK, BLOCK, (w + pw) // BLOCK, BLOCK).sum((1, 3))
    return {"values": out.size, "mismatched": int(miss.sum()),
            "worst_block": float((blocks / (3 * area)).max()) * 100.0,
            "max_level_diff": int(diff.max()),
            "unsaturated": int(((b > 0) & (b < 255)).sum())}


def readings(pairs, bad: int, device) -> dict:
    """The compared numbers over (output, reference) pairs, plus the
    answers that never came or came in the wrong shape (``bad``)."""
    values = mism = unsat = 0
    worst, maxd = 0.0, 0
    for out, ref in pairs:
        if out.shape != ref.shape:
            bad += 1
            continue
        c = compare(out, ref, device)
        values += c["values"]
        mism += c["mismatched"]
        unsat += c["unsaturated"]
        worst = max(worst, c["worst_block"])
        maxd = max(maxd, c["max_level_diff"])
    return {"mismatch_pct": 100.0 * mism / max(values, 1),
            "worst_block_pct": worst,
            "bad_answers": bad,
            "max_level_diff": maxd,
            "reference_unsaturated_pct": 100.0 * unsat / max(values, 1),
            "values": values}


def verdict(read: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for the compared numbers."""
    shown = {}
    ok = True
    for k in COMPARED:
        limit = 0 if k == "bad_answers" else limits[k]["limit"]
        shown[k] = {"value": read[k], "limit": limit}
        ok = ok and read[k] <= limit
    return ok, shown
