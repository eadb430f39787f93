"""Bidirectional multi-layer GRU (counterpart of multimodalsignal_tpu/models/gru.py).

Gate equations follow torch's convention (the reset gate scales
h @ W_hn^T + b_hn before the tanh):

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh   (x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

The input projection for all time steps is one matmul per direction; only
the recurrent [B, H] x [H, 3H] product runs per step. `impl` picks the
recurrence: "torch" is the plain loop below (the counterpart of the JAX
package's lax.scan path, differentiated by autograd), "cuda" the
hand-written kernels of ops/gru_cuda.py (their autograd Functions run the
adjoint kernels in the backward; both directions of a full layer run as two
lanes of one walk, the JAX package's "pallas_db"), "cuda_fused" the fused
bidirectional float32 kernels for every full layer (the JAX package's
"pallas_fused": gates, weights and h0 go to float32 whatever the compute
dtype, and the output is cast back to it), "aten" one `torch.ops.aten.gru`
per layer (nn.GRU's op on the same weights: what an exported artifact
holds, experiments/export.py, since torch.export keeps it as one node
where the plain loop unrolls to T steps, and the ctypes-bound kernels
cannot be serialised; inference only), and "auto" the kernels for CUDA
inputs and the plain loop otherwise (as the JAX package's "auto" picks
Pallas on a TPU only). Under last-step pruning the final layer's forward
walk is the single-direction kernel for "cuda" and "cuda_fused" alike, as
in the JAX package.

Dropout draws its masks from a `torch.Generator` the caller passes to
`forward` (the trainer seeds one on the model's device; without one, torch's
default generator for that device). Its bits cannot match JAX's masks from
the same seed; only their distribution does.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodalsignal_tpu_torch.ops import gru_cuda

IMPLS = ("auto", "torch", "cuda", "cuda_fused", "aten")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            active: bool) -> torch.Tensor:
    """Inverted dropout as flax's nn.Dropout: keep each element with
    probability 1 - rate and scale the kept ones by 1 / (1 - rate), in x's
    dtype. Identity unless `active` and rate > 0."""
    if not active or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def gru_cell(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One GRU step: precomputed input gates xg [B, 3H] + state h [B, H]
    (or F lanes at once: xg [F, B, 3H], w_hh [F, 3H, H], b_hh [F, 3H],
    h [F, B, H])."""
    hg = h @ w_hh.transpose(-1, -2) + b_hh[..., None, :]
    xr, xz, xn = xg.chunk(3, dim=-1)
    hr, hz, hn = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_sequence(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One GRU direction given precomputed input gates x_gates [B, T, 3H];
    returns [B, T, H] aligned to the original time order for both
    directions. Carry and math in the inputs' dtype. F lanes walk at once
    with time still on axis 1: x_gates [F, T, B, 3H] and gru_cell's lane
    shapes give ys [F, T, B, H]."""
    t_total = x_gates.shape[1]
    ys = [None] * t_total
    h = h0
    for t in (range(t_total - 1, -1, -1) if reverse else range(t_total)):
        h = gru_cell(x_gates[:, t], w_hh, b_hh, h)
        ys[t] = h
    return torch.stack(ys, dim=1)


def aten_gru(x: torch.Tensor, weights: tuple, hidden: int,
             batch_first: bool) -> torch.Tensor:
    """One GRU layer as one `torch.ops.aten.gru` node (nn.GRU's op): x [B,
    T, in] (batch_first) or [T, B, in]; `weights` the (w_ih, w_hh, b_ih,
    b_hh) of the forward direction, then those of the backward direction
    for a bidirectional layer. Returns the outputs, both directions
    concatenated on the last axis; h0 = 0."""
    dirs = len(weights) // 4
    b = x.shape[0 if batch_first else 1]
    h0 = torch.zeros((dirs, b, hidden), dtype=x.dtype, device=x.device)
    y, _ = torch.ops.aten.gru.input(x, h0, list(weights), True, 1, 0.0, False,
                                    dirs == 2, batch_first)
    return y


class BiGRU(nn.Module):
    """Multi-layer bidirectional GRU; input [B, T, F] -> [B, T, 2H], or
    [B, 2H] with last_only=True.

    last_only=True returns only the last time step and prunes the final
    layer's backward walk to one cell step: the backward output at the last
    position is the first step of the reversed walk (h0 -> cell(x[T-1], h0)).
    Earlier layers still run both directions in full.

    Parameters are float32 and named like the flax module's
    (`l{layer}_{fwd,bwd}_{w_ih,w_hh,b_ih,b_hh}`, torch layout); `dtype` is
    the compute dtype they are cast to. In training mode every layer's output
    but the last's goes through dropout at `dropout` (the flax module's
    inter-layer dropout).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 impl: str = "auto", last_only: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.dropout = dropout
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.impl = impl
        self.last_only = last_only
        self.dtype = dtype
        h = hidden_size
        bound = 1.0 / h**0.5  # torch GRU init: U(-1/sqrt(H), 1/sqrt(H))
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * h
            for direction in ("fwd", "bwd"):
                for name, shape in (("w_ih", (3 * h, in_dim)), ("w_hh", (3 * h, h)),
                                    ("b_ih", (3 * h,)), ("b_hh", (3 * h,))):
                    p = nn.Parameter(torch.empty(shape))
                    nn.init.uniform_(p, -bound, bound)
                    self.register_parameter(f"l{layer}_{direction}_{name}", p)

    def _weights(self, layer: int, direction: str):
        return tuple(getattr(self, f"l{layer}_{direction}_{n}").to(self.dtype)
                     for n in ("w_ih", "w_hh", "b_ih", "b_hh"))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        impl = self.impl
        if impl == "auto":
            impl = "cuda" if x.is_cuda else "torch"
        if impl == "aten":
            return self._forward_aten(x)
        out = x.to(self.dtype)
        h0 = torch.zeros((x.shape[0], self.hidden_size), dtype=self.dtype,
                         device=x.device)
        for layer in range(self.num_layers):
            wif, whf, bif, bhf = self._weights(layer, "fwd")
            wib, whb, bib, bhb = self._weights(layer, "bwd")
            xg_f = out @ wif.T + bif  # [B, T, 3H]
            xg_b = out @ wib.T + bib
            if self.last_only and layer == self.num_layers - 1:
                y_b_last = gru_cell(xg_b[:, -1], whb, bhb, h0)
                if impl in ("cuda", "cuda_fused"):
                    y_f = gru_cuda.gru_sequence_cuda(xg_f, whf, bhf, h0)
                else:
                    y_f = gru_sequence(xg_f, whf, bhf, h0)
                return torch.cat([y_f[:, -1].to(self.dtype),
                                  y_b_last.to(self.dtype)], dim=-1)  # [B, 2H]
            if impl == "cuda":
                y_f, y_b = gru_cuda.gru_bidirectional_dirbatch(
                    xg_f, xg_b, whf, whb, bhf, bhb, h0)
                y_f, y_b = y_f.to(self.dtype), y_b.to(self.dtype)
            elif impl == "cuda_fused":
                y_f, y_b = gru_cuda.gru_bidirectional_fused(
                    xg_f, xg_b, whf, whb, bhf, bhb, h0)
                y_f, y_b = y_f.to(self.dtype), y_b.to(self.dtype)
            else:
                y_f = gru_sequence(xg_f, whf, bhf, h0)
                y_b = gru_sequence(xg_b, whb, bhb, h0, reverse=True)
            out = torch.cat([y_f, y_b], dim=-1)  # [B, T, 2H]
            if layer < self.num_layers - 1:
                out = dropout(out, self.dropout, generator, self.training)
        return out

    def _forward_aten(self, x: torch.Tensor) -> torch.Tensor:
        """The layers as aten_gru nodes: [B, T, 2H]; under last-step pruning
        the final layer is a forward-only aten_gru and the backward
        direction's one cell step, [B, 2H]. Inference only."""
        if self.training:
            raise NotImplementedError("gru impl 'aten' is inference only")
        out = x.to(self.dtype)
        for layer in range(self.num_layers):
            fwd, bwd = self._weights(layer, "fwd"), self._weights(layer, "bwd")
            if self.last_only and layer == self.num_layers - 1:
                wib, whb, bib, bhb = bwd
                y_f = aten_gru(out, fwd, self.hidden_size, batch_first=True)
                h0 = torch.zeros_like(y_f[:, -1])
                y_b_last = gru_cell(out[:, -1] @ wib.T + bib, whb, bhb, h0)
                return torch.cat([y_f[:, -1], y_b_last], dim=-1)
            out = aten_gru(out, fwd + bwd, self.hidden_size, batch_first=True)
        return out
