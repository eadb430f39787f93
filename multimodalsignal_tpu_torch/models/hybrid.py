"""Hybrid (raw + handcrafted feature) fusion model (counterpart of
multimodalsignal_tpu/models/hybrid.py).

The CnnGruAttention trunk (models/cnn_gru.py: channel gate, two conv+BN
stages, the BiGRU read at its last step) encodes the raw windows, a Dense
layer with a ReLU encodes the feature vector, and the head fuses both:

    z = cat(trunk(x_raw) [B, 2H], relu(feat1(x_feat)) [B, 32])
    logits = head2(dropout(relu(head1(z))))      head1: 2H + 32 -> 64

The input is the pair (x_raw [B, C, T], x_feat [B, F]), as the JAX model's
pytree input; the parameters are the trunk's plus `feat1`, and `head1`
takes 2H + 32 inputs.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalsignal_tpu_torch.models.cnn_gru import _CnnGruBase

FEAT_HIDDEN = 32  # the JAX model's feat_hidden


class HybridCnnGruModel(_CnnGruBase):
    """(x_raw [B, C, T], x_feat [B, F]) -> logits [B, classes], float32."""

    use_channel_attention = True

    def __init__(self, in_channels: int, num_features: int, **kwargs):
        super().__init__(in_channels, **kwargs)
        self.feat1 = nn.Linear(num_features, FEAT_HIDDEN)
        self.head1 = nn.Linear(2 * self.gru.hidden_size + FEAT_HIDDEN, 64)

    def forward(self, x: tuple[torch.Tensor, torch.Tensor],
                generator: torch.Generator | None = None) -> torch.Tensor:
        x_raw, x_feat = x
        h = self.trunk(x_raw, generator)
        f = torch.relu(self.dense(self.feat1, x_feat.to(self.dtype)))
        return self.head(torch.cat([h.to(self.dtype), f], dim=-1), generator)
