"""Every LOSO fold's model as the lanes of one module: the counterpart of the
JAX package's `jax.vmap(model.apply)` over a fold axis, which its sharded
sweep (parallel/fold_sweep.py:242-283) and fold ensemble
(experiments/predict.py:431-439) run.

A FoldStackedModel holds the single-fold model's parameters and batch-norm
buffers with a leading fold axis [F, ...], under the single-fold module
tree's names, so models/convert.py maps it to and from the JAX package's
stacked trees. Its forward maps each layer onto one batched op over the
lanes:

  * input x [F, B, C, T], each fold its own windows (the ensemble expands
    one batch to every lane);
  * the channel gate: the constant 0.5 where C // r is 0, else bmm;
  * both convolutions: one conv1d with groups=F on [B, F*C, T];
  * batch norm: flax's train rule (cnn_gru.batch_norm_train) per (fold,
    channel) on [B, F*16, L], with the running statistics moved only in the
    folds of `update`;
  * the GRU's input projections: one baddbmm per direction straight into
    the time-major [F, T, B, 3H] that the kernels read;
  * the head: baddbmm; a hybrid model's feature branch (feat1) is one
    baddbmm more, concatenated with the GRU's last step before the head.

The GRU under the fold axis, by ModelConfig.gru_impl (as the JAX package's
build_model(fold_parallel=True) and the custom_vmap rules of
ops/gru_pallas.py route it):

  * "auto" on CUDA tensors, "pallas", "pallas_db" and "cuda": per
    direction, one walk of F lanes (gru_fwd_fb; its adjoint gru_bwd_fb),
    the backward direction with the kernel's own reverse; the last layer's
    pruned forward walk is F lanes too. Both directions as one walk of 2F
    lanes (the single-fold "pallas_db" mapping) is the same math but needs
    a flip and a concatenation of the gates and an un-flip of the outputs
    per layer, and measured slower on an H100 in float32 and bfloat16
    (PERF.md), so the fold axis does not take it;
  * "pallas_fused" and "cuda_fused": every layer but the pruned last one
    runs the fused float32 pair (gru_bifwd, its adjoint gru_bibwd) with all
    F folds' two directions as 2F lanes of one walk
    (gru_cuda.gru_bidirectional_folds), cast back to the compute dtype; the
    pruned last layer's forward walk is F lanes of gru_fwd_fb, as in "auto".
    The JAX package gives its fused pair no custom_vmap rule, so Pallas's
    batching rule walks each fold's two lanes on a grid axis of their own:
    the same per-lane math. On CPU tensors the pair's plain versions run;
  * fold grouping (MMS_GRU_FOLD_GROUP >= 2, gru_cuda.pick_group): the walks
    whose fold axis reaches the JAX package's per-direction custom_vmap rule
    (_FWD_CV / _BWD_CV, gru_pallas.py:756-819) walk G folds as one lane of
    width G·H (gru_cuda.gru_lanes_cuda): under "auto", "pallas" and "cuda"
    every layer's two directions, and under every kernel impl the pruned
    last layer's forward walk (gru_sequence_pallas in the JAX model). Never
    the fused pair, and never "pallas_db"'s other layers, whose JAX
    dirbatch walks reach the fold axis through the fb kernels' rule
    (_FWD_FB_CV), which does not group;
  * "scan", "torch", and "auto" on CPU tensors: the plain loop over all
    lanes in the compute dtype (models/gru.py), as the JAX package's
    fold-parallel "auto" resolves to scan off the TPU;
  * "aten": one `torch.ops.aten.gru` per fold and layer (models/gru.py
    aten_gru; an exported ensemble artifact's recurrence, inference only).

`forward_remat` is the train forward with its activations recomputed in
the backward (trainer.remat; the JAX sweep's jax.checkpoint of apply_train):
each kernel walk of the forward then runs twice a train step, its adjoint
once.
"""

from __future__ import annotations

import copy
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodalsignal_tpu_torch.models.cnn_gru import (
    NUM_FEATURES,
    batch_norm_train,
    build_model,
)
from multimodalsignal_tpu_torch.models.gru import aten_gru, gru_cell, gru_sequence
from multimodalsignal_tpu_torch.ops import gru_cuda

# ModelConfig.gru_impl -> how the fold-stacked GRU walks.
FOLD_IMPLS = {"auto": "auto", "pallas": "lanes", "pallas_db": "db",
              "cuda": "lanes", "pallas_fused": "fused", "cuda_fused": "fused",
              "scan": "torch", "torch": "torch", "aten": "aten"}


def _check_impl(gru_impl: str) -> str:
    impl = FOLD_IMPLS.get(gru_impl)
    if impl is None:
        raise ValueError(f"unknown gru_impl {gru_impl!r}; expected one of "
                         f"{sorted(FOLD_IMPLS)}")
    return impl


class FoldStackedModel(nn.Module):
    """The single-fold models `models` (same config) stacked into lanes, in
    list order. The submodules keep the single-fold tree and its names, but
    only hold the stacked tensors: the forward is this class's own."""

    def __init__(self, models: list[nn.Module], gru_impl: str = "auto"):
        super().__init__()
        self.impl = _check_impl(gru_impl)
        base = models[0]
        self.folds = len(models)
        self.dtype = base.dtype
        self.dropout = base.dropout
        self.gru_last_prune = base.gru_last_prune
        self.use_channel_attention = base.use_channel_attention
        # (first lane, the sweep's lanes) where this model holds a block of
        # a sweep split over processes (parallel/fold_sweep.py FoldSweep).
        self.lane_span: tuple[int, int] | None = None
        # Set while forward_remat recomputes: the batch-norm running
        # statistics then do not move a second time.
        self._replaying = False
        for name, child in base.named_children():
            self.add_module(name, copy.deepcopy(child))
        with torch.no_grad():
            for name, _ in base.named_parameters():
                self._put(name, nn.Parameter(torch.stack(
                    [m.get_parameter(name).detach() for m in models])))
            for name, _ in base.named_buffers():
                self._put(name, torch.stack([m.get_buffer(name) for m in models]))

    def _put(self, name: str, value: torch.Tensor) -> None:
        owner, _, leaf = name.rpartition(".")
        setattr(self.get_submodule(owner), leaf, value)

    def forward(self, x, generators: Sequence[torch.Generator] | None = None,
                update: torch.Tensor | None = None) -> torch.Tensor:
        """x [F, B, C, T] -> logits [F, B, K] float32; a hybrid model's lanes
        take the pair (x, feat [F, B, nF]). In training mode, `update` (bool
        [F]) names the folds whose batch-norm running statistics move (all
        of them without it); `generators` feed dropout: of G generators,
        generator g draws the masks of the g-th of G equal groups of lanes
        (one generator for a plain sweep; a seed-replicated sweep's seed
        groups, parallel/replicated_sweep.py)."""
        feat = None
        if hasattr(self, "feat1"):
            x, feat = x
        n_f, batch, chans, t = x.shape
        dt = self.dtype
        # The grouped convolutions' layout [B, F*C, T]: one copy, or none
        # where x is a fold-major view of batch-major memory (the sweep
        # gathers its batches so).
        h = x.transpose(0, 1).to(dt, memory_format=torch.contiguous_format)
        h = h.reshape(batch, n_f * chans, t)
        if self.use_channel_attention:
            h = self._gate(h, n_f, chans)
        enc = self.cnn_encoder
        h = self._stage(h, enc.conv1, enc.bn1, update)
        h = self._stage(h, enc.conv2, enc.bn2, update)       # [B, F*O, L]
        out_ch, steps = h.shape[1] // n_f, h.shape[2]
        # Time-major rows (t, b) per lane for the input projections: one copy.
        seq = h.view(batch, n_f, out_ch, steps).permute(1, 3, 0, 2)
        if self.impl == "aten":
            y = self._gru_aten(seq)
        else:
            y = self._gru(seq.reshape(n_f, steps * batch, out_ch), steps, batch, generators)
        if feat is not None:   # the hybrid model's feature branch
            f = torch.relu(self._dense(self.feat1, feat.to(dt)))
            y = torch.cat([y.to(dt), f], dim=-1)
        y = torch.relu(self._dense(self.head1, y))
        y = self._dropout(y, self.dropout, generators)
        return self._dense(self.head2, y).float()

    def forward_remat(self, x, generators: Sequence[torch.Generator] | None = None,
                      update: torch.Tensor | None = None) -> torch.Tensor:
        """forward in training mode with its activations recomputed in the
        backward instead of kept (trainer.remat; counterpart of the JAX
        sweep's jax.checkpoint(apply_train), parallel/fold_sweep.py:250-253:
        the model's forward only, not the loss), under non-reentrant
        torch.utils.checkpoint. The recompute draws the forward's dropout
        masks (every generator is put back to its state at the forward, and
        then to where the forward left it) and moves no batch-norm running
        statistic (they moved once, in the forward, as JAX's new batch_stats
        come out of the checkpointed function once), so a step equals one
        without remat (bit for bit on one CPU thread)."""
        gens = list(generators or ())
        start = [g.get_state() for g in gens]
        ran = []

        def run(inputs):
            if not ran:
                ran.append(True)
                return self(inputs, generators, update)
            after = [g.get_state() for g in gens]
            for g, state in zip(gens, start):
                g.set_state(state)
            self._replaying = True
            try:
                return self(inputs, generators, update)
            finally:
                self._replaying = False
                for g, state in zip(gens, after):
                    g.set_state(state)

        return checkpoint(run, x, use_reentrant=False)

    def _dropout(self, y: torch.Tensor, rate: float,
                 generators: Sequence[torch.Generator] | None) -> torch.Tensor:
        """Dropout of y [F, ...], each generator for its own equal group of
        the sweep's lanes (the masks of group g are those a sweep of that
        group alone would draw); torch's default generator without any.
        Under `lane_span` every generator draws its whole group's masks and
        the lanes this model holds keep theirs, so a sweep split over
        processes draws what one process does."""
        if not self.training or rate <= 0.0:
            return y
        generators = generators or [None]
        lo, total = self.lane_span or (0, y.shape[0])
        per_group, keep = total // len(generators), 1.0 - rate
        masks = []
        for g, gen in enumerate(generators):
            draw = torch.rand((per_group,) + y.shape[1:], generator=gen, device=y.device)
            a, b = max(lo - g * per_group, 0), min(lo + y.shape[0] - g * per_group, per_group)
            if a < b:
                masks.append(draw[a:b] < keep)
        mask = masks[0] if len(masks) == 1 else torch.cat(masks)
        return torch.where(mask, y / keep, torch.zeros((), dtype=y.dtype, device=y.device))

    def _dense(self, layer, y: torch.Tensor) -> torch.Tensor:
        """y [F, N, in] @ weight [F, out, in]^T + bias [F, out], in dtype."""
        dt = self.dtype
        return torch.baddbmm(layer.bias.to(dt)[:, None], y, layer.weight.to(dt).transpose(1, 2))

    def _gate(self, h: torch.Tensor, n_f: int, chans: int) -> torch.Tensor:
        ca = self.channel_attention
        if ca.constant_gate:
            return h * 0.5
        batch = h.shape[0]
        s = h.mean(dim=2).view(batch, n_f, chans).transpose(0, 1)     # [F, B, C]
        g = torch.relu(torch.bmm(s, ca.fc1.weight.to(self.dtype).transpose(1, 2)))
        g = torch.sigmoid(torch.bmm(g, ca.fc2.weight.to(self.dtype).transpose(1, 2)))
        return h * g.transpose(0, 1).reshape(batch, n_f * chans, 1)

    def _stage(self, h, conv, bn, update):
        w = conv.weight                                            # [F, O, I, K]
        h = F.conv1d(h, w.reshape(-1, *w.shape[2:]).to(self.dtype), None, conv.stride,
                     conv.padding, groups=self.folds)
        mean, var = bn.running_mean.view(-1), bn.running_var.view(-1)
        if self.training and self._replaying:   # forward_remat's recompute
            mean, var = mean.clone(), var.clone()
        if self.training:
            mask = None if update is None else update[:, None].expand(w.shape[:2]).reshape(-1)
            h = batch_norm_train(h, bn.weight.reshape(-1), bn.bias.reshape(-1), mean, var,
                                 bn.eps, mask)
        else:
            h = F.batch_norm(h.float(), mean, var, bn.weight.reshape(-1), bn.bias.reshape(-1),
                             training=False, eps=bn.eps)
        return F.max_pool1d(torch.relu(h.to(self.dtype)), 3, stride=2, padding=1)

    def _gru(self, seq: torch.Tensor, steps: int, batch: int,
             generators: Sequence[torch.Generator] | None) -> torch.Tensor:
        """seq [F, T*B, in], rows time-major -> the last step's [F, B, 2H]."""
        gru, dt = self.gru, self.dtype
        impl = self.impl
        if impl == "auto":
            impl = "lanes" if seq.is_cuda else "torch"
        n_f, hid = seq.shape[0], gru.hidden_size
        h0 = torch.zeros((n_f, batch, hid), dtype=dt, device=seq.device)
        last = gru.num_layers - 1
        for layer in range(gru.num_layers):
            (wif, whf, bif, bhf), (wib, whb, bib, bhb) = (
                tuple(getattr(gru, f"l{layer}_{d}_{n}").to(dt)
                      for n in ("w_ih", "w_hh", "b_ih", "b_hh")) for d in ("fwd", "bwd"))
            shape = (n_f, steps, batch, 3 * hid)
            xg_f = torch.baddbmm(bif[:, None], seq, wif.transpose(1, 2)).view(shape)
            xg_b = torch.baddbmm(bib[:, None], seq, wib.transpose(1, 2)).view(shape)
            if self.gru_last_prune and layer == last:
                y_b_last = gru_cell(xg_b[:, -1], whb, bhb, h0)
                if impl == "torch":
                    y_f = gru_sequence(xg_f, whf, bhf, h0)
                else:
                    y_f = gru_cuda.gru_lanes_cuda(xg_f, whf, bhf, h0)
                return torch.cat([y_f[:, -1].to(dt), y_b_last.to(dt)], dim=-1)
            if impl == "fused":
                y_f, y_b = gru_cuda.gru_bidirectional_folds(xg_f, xg_b, whf, whb, bhf, bhb, h0)
            elif impl in ("lanes", "db"):
                group = impl == "lanes"
                y_f = gru_cuda.gru_lanes_cuda(xg_f, whf, bhf, h0, group=group)
                y_b = gru_cuda.gru_lanes_cuda(xg_b, whb, bhb, h0, reverse=True, group=group)
            else:
                y_f = gru_sequence(xg_f, whf, bhf, h0)
                y_b = gru_sequence(xg_b, whb, bhb, h0, reverse=True)
            out = torch.cat([y_f.to(dt), y_b.to(dt)], dim=-1)      # [F, T, B, 2H]
            if layer < last:
                out = self._dropout(out, gru.dropout, generators)
            seq = out.view(n_f, steps * batch, 2 * hid)
        return out[:, -1]

    def _gru_aten(self, x: torch.Tensor) -> torch.Tensor:
        """x [F, T, B, in], time-major -> the last step's [F, B, 2H], one
        aten_gru per fold and layer (inference only); under pruning the last
        layer is a forward-only aten_gru and the backward direction's one
        cell step."""
        if self.training:
            raise NotImplementedError("gru impl 'aten' is inference only")
        gru, dt, n_f = self.gru, self.dtype, self.folds
        last = gru.num_layers - 1
        lane = lambda w, f: tuple(t[f] for t in w)  # noqa: E731
        for layer in range(gru.num_layers):
            fwd, bwd = (tuple(getattr(gru, f"l{layer}_{d}_{n}").to(dt)
                              for n in ("w_ih", "w_hh", "b_ih", "b_hh")) for d in ("fwd", "bwd"))
            if self.gru_last_prune and layer == last:
                y_f = torch.stack([aten_gru(x[f], lane(fwd, f), gru.hidden_size,
                                            batch_first=False)[-1] for f in range(n_f)])
                wib, whb, bib, bhb = bwd
                xg_b = torch.baddbmm(bib[:, None], x[:, -1], wib.transpose(1, 2))
                return torch.cat([y_f, gru_cell(xg_b, whb, bhb, torch.zeros_like(y_f))], dim=-1)
            x = torch.stack([aten_gru(x[f], lane(fwd, f) + lane(bwd, f), gru.hidden_size,
                                      batch_first=False) for f in range(n_f)])  # [F, T, B, 2H]
        return x[:, -1]


def build_fold_model(model_cfg, num_classes: int, in_channels: int, folds: int,
                     seeds: list[int] | None = None,
                     num_features: int = NUM_FEATURES) -> FoldStackedModel:
    """A FoldStackedModel of `folds` lanes from a ModelConfig (the hybrid
    model's with `num_features` features). With `seeds` (one per lane), lane
    f starts as build_model would under torch.manual_seed(seeds[f]);
    without, every lane holds the same initial weights, for a caller that
    loads its own."""
    _check_impl(model_cfg.gru_impl)
    if seeds is None:
        models = [build_model(model_cfg, num_classes, in_channels, num_features)] * folds
    else:
        if len(seeds) != folds:
            raise ValueError(f"{len(seeds)} seeds for {folds} folds")
        models = []
        for seed in seeds:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                models.append(build_model(model_cfg, num_classes, in_channels, num_features))
    return FoldStackedModel(models, model_cfg.gru_impl)
