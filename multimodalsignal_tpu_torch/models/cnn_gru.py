"""Model family: ChannelAttention, CnnGru, CnnGruAttention (PyTorch); the
hybrid model (models/hybrid.py) shares their trunk.

Counterpart of multimodalsignal_tpu/models/cnn_gru.py. The public input is
[B, C, T], as in the JAX package; the encoder works in PyTorch's
channels-first layout, and the GRU takes [B, T, F].

Parameters and batch-norm statistics are float32. `dtype` is the compute
dtype: with bfloat16 the convolutions, dense layers and GRU run in bfloat16
(the parameters are cast on use), batch norm normalises in float32 and casts
back, and the logits come out float32, as in the JAX package.

Training mode (`model.train()`) follows flax's `train=True`: batch norm
normalises with the batch's mean and biased variance, computed in float32,
and moves the running statistics by flax's rule (momentum 0.9, biased
variance; torch's own BatchNorm would track the unbiased one); dropout after
`head1` and between GRU layers draws from the generator passed to
`forward`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsignal_tpu_torch.models.gru import BiGRU, dropout

BN_MOMENTUM = 0.9  # flax's BatchNorm(momentum=0.9) in the JAX model


class ChannelAttention(nn.Module):
    """Squeeze-and-excitation gate over signal channels: time mean ->
    Linear(C, C // r, no bias) -> ReLU -> Linear(C // r, C, no bias) ->
    sigmoid. With C < r the reference builds zero-width layers whose output
    is all zeros, so the gate is the constant sigmoid(0) = 0.5; that quirk is
    kept, without the empty parameters."""

    def __init__(self, channels: int, reduction_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        hidden = channels // reduction_ratio
        self.constant_gate = hidden == 0
        if not self.constant_gate:
            self.fc1 = nn.Linear(channels, hidden, bias=False)
            self.fc2 = nn.Linear(hidden, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, C, T]
        if self.constant_gate:
            return x * 0.5
        y = F.linear(x.mean(dim=2), self.fc1.weight.to(self.dtype))
        y = F.linear(torch.relu(y), self.fc2.weight.to(self.dtype))
        return x * torch.sigmoid(y)[:, :, None]


class ConvEncoder(nn.Module):
    """Conv1d(16, k7, s2, p3) + BN + ReLU + MaxPool(3, 2, p1) ->
    Conv1d(out, k5, s2, p2) + BN + ReLU + MaxPool(3, 2, p1): 16x fewer time
    steps (7680 -> 480) before the recurrence. Convolutions have no bias."""

    def __init__(self, in_channels: int, out_channels: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv1d(in_channels, 16, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm1d(16, eps=1e-5)
        self.conv2 = nn.Conv1d(16, out_channels, 5, stride=2, padding=2, bias=False)
        self.bn2 = nn.BatchNorm1d(out_channels, eps=1e-5)

    def _stage(self, x, conv, bn):
        x = F.conv1d(x, conv.weight.to(self.dtype), None, conv.stride, conv.padding)
        if self.training:
            x = batch_norm_train(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                 bn.eps).to(self.dtype)
        else:
            x = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, training=False, eps=bn.eps).to(self.dtype)
        return F.max_pool1d(torch.relu(x), 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, C, T] -> [B, out_channels, T / 16]
        x = self._stage(x, self.conv1, self.bn1)
        return self._stage(x, self.conv2, self.bn2)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                     update: torch.Tensor | None = None) -> torch.Tensor:
    """flax BatchNorm with train=True on x [B, C, L]: float32 batch mean and
    biased variance E[x^2] - E[x]^2 (clipped at 0), normalise as
    (x - mean) * (rsqrt(var + eps) * scale) + bias; then the running
    statistics [C] move by ra = 0.9 ra + 0.1 mean, rv = 0.9 rv + 0.1 var, in
    place and outside autograd, in the channels where the bool mask `update`
    [C] is true (all of them without one). Returns float32."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2))
    var = torch.clamp((xf * xf).mean(dim=(0, 2)) - mean * mean, min=0.0)
    with torch.no_grad():
        new_mean = BN_MOMENTUM * running_mean + (1 - BN_MOMENTUM) * mean
        new_var = BN_MOMENTUM * running_var + (1 - BN_MOMENTUM) * var
        if update is not None:
            new_mean = torch.where(update, new_mean, running_mean)
            new_var = torch.where(update, new_var, running_var)
        running_mean.copy_(new_mean)
        running_var.copy_(new_var)
    mul = torch.rsqrt(var + eps) * weight
    return (xf - mean[:, None]) * mul[:, None] + bias[:, None]


class _CnnGruBase(nn.Module):
    use_channel_attention = True

    def __init__(self, in_channels: int, num_classes: int = 2,
                 cnn_out_channels: int = 32, gru_hidden_size: int = 64,
                 gru_num_layers: int = 2, reduction_ratio: int = 4,
                 gru_impl: str = "auto", gru_last_prune: bool = True,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.gru_last_prune = gru_last_prune
        if self.use_channel_attention:
            self.channel_attention = ChannelAttention(in_channels,
                                                      reduction_ratio, dtype)
        self.cnn_encoder = ConvEncoder(in_channels, cnn_out_channels, dtype)
        self.gru = BiGRU(cnn_out_channels, gru_hidden_size, gru_num_layers,
                         impl=gru_impl, last_only=gru_last_prune, dtype=dtype,
                         dropout=dropout if gru_num_layers > 1 else 0.0)
        self.head1 = nn.Linear(2 * gru_hidden_size, 64)
        self.head2 = nn.Linear(64, num_classes)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        # x: [B, C, T]; `generator` feeds dropout in training mode
        return self.head(self.trunk(x, generator), generator)

    def trunk(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """[B, C, T] -> the GRU's last step [B, 2H] in the compute dtype."""
        x = x.to(self.dtype)
        if self.use_channel_attention:
            x = self.channel_attention(x)
        x = self.cnn_encoder(x)
        x = self.gru(x.transpose(1, 2), generator)
        return x if self.gru_last_prune else x[:, -1]  # last time step

    def dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))

    def head(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """head1 + ReLU + dropout + head2 -> float32 logits."""
        x = torch.relu(self.dense(self.head1, x))
        x = dropout(x, self.dropout, generator, self.training)
        return self.dense(self.head2, x).float()


class CnnGruAttentionModel(_CnnGruBase):
    """Channel-attention fusion model (the reference's headline model)."""

    use_channel_attention = True


class CnnGruModel(_CnnGruBase):
    """Early-fusion baseline (no channel gate)."""

    use_channel_attention = False


MODELS = {"cnn_gru_attention": CnnGruAttentionModel, "cnn_gru": CnnGruModel}
# ModelConfig.gru_impl (JAX names too) -> BiGRU impl of this package.
_GRU_IMPLS = {"auto": "auto", "scan": "torch", "torch": "torch", "cuda": "cuda",
              "cuda_fused": "cuda_fused", "pallas": "cuda", "pallas_db": "cuda",
              "pallas_fused": "cuda_fused", "aten": "aten"}
# The hybrid model's feature count when the caller names none: every
# feature the preprocessor writes (data/features.py FEATURE_NAMES).
NUM_FEATURES = 10


def build_model(model_cfg, num_classes: int, in_channels: int,
                num_features: int = NUM_FEATURES) -> _CnnGruBase:
    """Instantiate a model from a ModelConfig (config.py). The JAX package's
    flax modules infer the channel count (and the hybrid model's feature
    count) at init; here they are given. The JAX package's gru_impl names
    map onto this package's: "scan" to the plain loop, "pallas" and
    "pallas_db" to the CUDA kernels ("cuda"), and "pallas_fused" to the
    fused float32 BiGRU kernels ("cuda_fused"); "aten" (this package's
    only) is one torch.ops.aten.gru a layer, the exported artifact's."""
    impl = _GRU_IMPLS.get(model_cfg.gru_impl)
    if impl is None:
        raise ValueError(f"unknown gru_impl {model_cfg.gru_impl!r}; expected "
                         f"one of {sorted(_GRU_IMPLS)}")
    kwargs = dict(
        in_channels=in_channels,
        num_classes=num_classes,
        cnn_out_channels=model_cfg.cnn_out_channels,
        gru_hidden_size=model_cfg.gru_hidden_size,
        gru_num_layers=model_cfg.gru_num_layers,
        reduction_ratio=model_cfg.reduction_ratio,
        gru_impl=impl,
        gru_last_prune=model_cfg.gru_last_prune,
        dtype=getattr(torch, model_cfg.dtype),
        dropout=model_cfg.dropout,
    )
    if model_cfg.name == "hybrid_cnn_gru":
        from multimodalsignal_tpu_torch.models.hybrid import HybridCnnGruModel

        return HybridCnnGruModel(num_features=num_features, **kwargs)
    return MODELS[model_cfg.name](**kwargs)
