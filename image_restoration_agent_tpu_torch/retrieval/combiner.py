"""Combiner: image/text feature fusion for experience retrieval
(counterpart of ``image_restoration_agent_tpu/retrieval/combiner.py``).

The reference CLIP4CIR combiner (``src/combiner.py``): image and text
features project to a shared space, concatenate through a hidden MLP, and a
learned dynamic scalar mixes a convex combination of the raw features with
the combined output; the result is L2-normalized. Parameter names are the
trained checkpoint's (``text_projection_layer``, ``image_projection_layer``,
``combiner_layer``, ``output_layer``, ``dynamic_scalar.0`` and ``.3``: its
Sequential's ReLU, Dropout and Sigmoid carry none). Reference dims for CLIP
RN50x4: feature 640, projection 2560, hidden 5120.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Combiner(nn.Module):
    def __init__(self, feature_dim: int = 640, projection_dim: int = 2560,
                 hidden_dim: int = 5120):
        super().__init__()
        self.text_projection_layer = nn.Linear(feature_dim, projection_dim)
        self.image_projection_layer = nn.Linear(feature_dim, projection_dim)
        self.combiner_layer = nn.Linear(2 * projection_dim, hidden_dim)
        self.output_layer = nn.Linear(hidden_dim, feature_dim)
        # Linear, ReLU, Dropout, Linear, Sigmoid: the linears at 0 and 3
        self.dynamic_scalar = nn.Sequential(
            nn.Linear(2 * projection_dim, hidden_dim), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(hidden_dim, 1), nn.Sigmoid())

    def forward(self, image_features: torch.Tensor,
                text_features: torch.Tensor) -> torch.Tensor:
        # concat order is (text, image): the reference's combiner.py:60
        txt_p = F.relu(self.text_projection_layer(text_features))
        img_p = F.relu(self.image_projection_layer(image_features))
        both = torch.cat([txt_p, img_p], dim=-1)
        combined = self.output_layer(F.relu(self.combiner_layer(both)))
        scalar = self.dynamic_scalar(both)
        out = (combined + scalar * text_features
               + (1 - scalar) * image_features)
        norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        return out / norm.clamp_min(1e-12)
