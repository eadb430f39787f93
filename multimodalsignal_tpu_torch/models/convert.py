"""Weights between the JAX package's flax layout and this package's modules.

A flax checkpoint holds two pytrees of arrays: `params` and `batch_stats`.
Their leaves map onto the PyTorch modules as follows (the inverse of
multimodalsignal_tpu/experiments/import_torch.py):

  * Dense `kernel` [in, out]        -> Linear `weight` [out, in] (transpose):
    `head1`, `head2`, the channel gate's `fc1`, `fc2`, and the hybrid
    model's feature layer `feat1`
  * Conv `kernel` [K, in, out]      -> Conv1d `weight` [out, in, K]
  * BatchNorm `scale`, `bias`       -> `weight`, `bias`; batch_stats `mean`,
    `var`                           -> `running_mean`, `running_var`
  * GRU `l{L}_{fwd,bwd}_{w_ih,w_hh,b_ih,b_hh}` -> the BiGRU parameter of
    the same name, as it is (both packages keep torch's GRU layout)

Each transform is its own inverse, so the same table serves both ways.
The transforms act on the trailing axes, so a fold-stacked model
(models/fold_stack.py), whose every tensor has a leading fold axis, maps
onto the JAX package's stacked trees (leaves [F, ...], as its sweep and
fold ensemble hold them) through the same functions.
"""

from __future__ import annotations

import numpy as np
import torch


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -2)


def _conv(t: torch.Tensor) -> torch.Tensor:
    return t.transpose(-1, -3)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _layout(model):
    """(collection, flax path, module tensor, transform) for every leaf."""
    out = []
    ca = getattr(model, "channel_attention", None)
    if ca is not None and not ca.constant_gate:
        for fc in ("fc1", "fc2"):
            out.append(("params", ("channel_attention", fc, "kernel"),
                        getattr(ca, fc).weight, _dense))
    enc = model.cnn_encoder
    for conv in ("conv1", "conv2"):
        out.append(("params", ("cnn_encoder", conv, "kernel"),
                    getattr(enc, conv).weight, _conv))
    for bn_name in ("bn1", "bn2"):
        bn = getattr(enc, bn_name)
        out += [
            ("params", ("cnn_encoder", bn_name, "scale"), bn.weight, _same),
            ("params", ("cnn_encoder", bn_name, "bias"), bn.bias, _same),
            ("batch_stats", ("cnn_encoder", bn_name, "mean"), bn.running_mean, _same),
            ("batch_stats", ("cnn_encoder", bn_name, "var"), bn.running_var, _same),
        ]
    for name, p in model.gru.named_parameters():
        out.append(("params", ("gru", name), p, _same))
    # The hybrid model's feature branch (models/hybrid.py) beside the head.
    dense = ("feat1",) if hasattr(model, "feat1") else ()
    for head in dense + ("head1", "head2"):
        layer = getattr(model, head)
        out.append(("params", (head, "kernel"), layer.weight, _dense))
        out.append(("params", (head, "bias"), layer.bias, _same))
    return out


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def load_jax_variables(model, params: dict, batch_stats: dict) -> None:
    """Copy a flax `params` / `batch_stats` pair (nested dicts of numpy
    arrays, or of tensors) into `model` in place; a FoldStackedModel takes
    the stacked pair, every leaf with the leading fold axis. Raises if a
    leaf is missing, has the wrong shape, or is left over."""
    trees = {"params": params, "batch_stats": batch_stats}
    used = set()
    with torch.no_grad():
        for coll, path, target, transform in _layout(model):
            try:
                node = get_leaf(trees[coll], path)
            except KeyError as exc:
                raise ValueError(f"{coll}/{'/'.join(path)} missing from the "
                                 "checkpoint") from exc
            value = transform(_to_tensor(node))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{coll}/{'/'.join(path)} has shape {list(node.shape)}; "
                    f"the model needs {list(transform(target).shape)}")
            target.copy_(value)
            used.add((coll,) + path)
    extra = sorted("/".join(p) for coll, tree in trees.items()
                   for p in ((coll,) + q for q in _leaf_paths(tree))
                   if p not in used)
    if extra:
        raise ValueError(f"checkpoint leaves the model has no place for: {extra}")


def put_leaf(tree: dict, path: tuple, value) -> None:
    """tree[path[0]][path[1]]... = value, making the dicts on the way."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def get_leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def export_jax_variables(model) -> dict:
    """The model's weights as a flax {"params", "batch_stats"} pair of
    nested dicts of float32 numpy arrays (stacked over the fold axis for a
    FoldStackedModel)."""
    out = {"params": {}, "batch_stats": {}}
    for coll, path, tensor, transform in _layout(model):
        put_leaf(out[coll], path, transform(tensor.detach()).float().cpu().numpy().copy())
    return out


def _map_leaves(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_variables(variables: list[dict]) -> dict:
    """Per-fold flax {"params", "batch_stats"} pairs -> one pair whose every
    leaf is a tensor with a leading fold axis, in list order."""
    return _map_leaves(lambda *leaves: torch.stack([_to_tensor(a) for a in leaves]),
                       *variables)


def lane_variables(variables: dict, lane: int) -> dict:
    """Lane `lane` of a stacked flax pair (export_jax_variables of a
    FoldStackedModel, or the JAX package's stacked trees) as a single-fold
    pair, which load_jax_variables puts into a single-fold model."""
    return _map_leaves(lambda a: a[lane], variables)
