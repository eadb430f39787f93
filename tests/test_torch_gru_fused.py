"""The port's fused bidirectional GRU pair (gru_bifwd / gru_bibwd in
multimodalsignal_tpu_torch/ops/gru_cuda.py) vs the JAX package's
`_bigru_forward` / `_bigru_backward` (interpret mode on the CPU), the
autograd Function and the model-facing `gru_bidirectional_fused` vs
`jax.vjp` of `_bigru_tm` / `gru_bidirectional_pallas`, the pair at 2F lanes
(F folds, the fold axis) and `gru_bidirectional_folds` vs `jax.vmap` of
those two, and the model's
`gru_impl="pallas_fused"` in bfloat16 against the JAX BiGRU. Same
numpy-seeded inputs on both sides.

Tolerances. All float32: rtol = atol = 1e-5 on ys, dxg and dh0 (the two
sides sum each step's small products in other orders); dW and db are sums
over B*T = 120 such terms, so 1e-4. The bf16 model check holds every output
within one bf16 ulp of the JAX module's: the fused layer runs in float32 on
both sides and is rounded to bf16 once, and the last layer's walk runs the
single-direction kernels' bf16 mode on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.config import ModelConfig as JaxModelConfig
from multimodalsignal_tpu.models import build_model as build_jax_model
from multimodalsignal_tpu.models.gru import BiGRU as JaxBiGRU
from multimodalsignal_tpu.ops import gru_pallas
from multimodalsignal_tpu_torch.config import ModelConfig
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import load_jax_variables
from multimodalsignal_tpu_torch.ops import gru_cuda

T, B, H = 40, 3, 8


def _fused_inputs(seed, t=T, b=B, h=H):
    """xg2 [T, 2, B, 3H], whh2 [2, 3H, H], bhh2 [2, 3H], h02 [2, B, H],
    dy2 [T, 2, B, H], float32 numpy."""
    rng = np.random.default_rng(seed)
    xg2 = rng.standard_normal((t, 2, b, 3 * h)).astype(np.float32)
    whh2 = (rng.standard_normal((2, 3 * h, h)) * 0.3).astype(np.float32)
    bhh2 = (rng.standard_normal((2, 3 * h)) * 0.1).astype(np.float32)
    h02 = (rng.standard_normal((2, b, h)) * 0.5).astype(np.float32)
    dy2 = rng.standard_normal((t, 2, b, h)).astype(np.float32)
    return xg2, whh2, bhh2, h02, dy2


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def test_bifwd_plain_matches_bigru_forward():
    xg2, whh2, bhh2, h02, _ = _fused_inputs(0)
    want = gru_pallas._bigru_forward(*(jnp.asarray(a) for a in (xg2, whh2, bhh2, h02)))
    args = [torch.from_numpy(a) for a in (xg2, whh2, bhh2, h02)]
    got = gru_cuda.gru_bifwd_plain(*args)
    assert got.shape == (T, 2, B, H) and got.dtype == torch.float32
    _close(got, want, 1e-5, "ys2")
    torch.testing.assert_close(gru_cuda.gru_bifwd(*args), got, rtol=0, atol=0)


def test_bibwd_plain_matches_bigru_backward():
    xg2, whh2, bhh2, h02, dy2 = _fused_inputs(1)
    j = [jnp.asarray(a) for a in (xg2, whh2, bhh2, h02)]
    jys2 = gru_pallas._bigru_forward(*j)
    want = gru_pallas._bigru_backward(*j, jys2, jnp.asarray(dy2))
    args = [torch.from_numpy(a) for a in (xg2, whh2, bhh2, h02)]
    args += [torch.from_numpy(np.asarray(jys2)), torch.from_numpy(dy2)]
    got = gru_cuda.gru_bibwd_plain(*args)
    shapes = ((T, 2, B, 3 * H), (2, 3 * H, H), (2, 3 * H), (2, B, H))
    for g, w, shape, tol, what in zip(got, want, shapes, (1e-5, 1e-4, 1e-4, 1e-5),
                                      ("dxg2", "dW", "db", "dh0")):
        assert g.shape == shape and g.dtype == torch.float32, what
        _close(g, w, tol, what)
    for g, w in zip(gru_cuda.gru_bibwd(*args), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _torch_grads(fn, inputs, cots):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, ts, [torch.from_numpy(c) for c in cots])


def _jax_grads(fn, inputs, cots):
    outs, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    cot = tuple(jnp.asarray(c) for c in cots)
    return vjp(cot if isinstance(outs, tuple) else cot[0])


def test_bigru_walk_grads_match_bigru_tm():
    """torch.autograd.grad through _BiGruWalk (plain forward, plain
    adjoint) against jax.vjp of _bigru_tm, for xg2, whh2, bhh2 and h02."""
    xg2, whh2, bhh2, h02, dy2 = _fused_inputs(2)
    inputs = (xg2, whh2, bhh2, h02)
    got = _torch_grads(gru_cuda._BiGruWalk.apply, inputs, [dy2])
    want = _jax_grads(gru_pallas._bigru_tm, inputs, [dy2])
    for g, w, tol, what in zip(got, want, (1e-5, 1e-4, 1e-4, 1e-5),
                               ("dxg2", "dW", "db", "dh0")):
        _close(g, w, tol, what)


def test_bidirectional_fused_grads_match_pallas():
    """The model-facing entry point: outputs and gradients of both gate
    streams, both W_hh, both b_hh and the one h0 both directions share
    (its gradient sums the two directions' through the stack)."""
    rng = np.random.default_rng(3)
    gates = [rng.standard_normal((B, T, 3 * H)).astype(np.float32) for _ in range(2)]
    ws = [(rng.standard_normal((3 * H, H)) * 0.3).astype(np.float32) for _ in range(2)]
    bs = [(rng.standard_normal(3 * H) * 0.1).astype(np.float32) for _ in range(2)]
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    inputs = (*gates, *ws, *bs, h0)
    dys = [rng.standard_normal((B, T, H)).astype(np.float32) for _ in range(2)]
    jys = gru_pallas.gru_bidirectional_pallas(*(jnp.asarray(a) for a in inputs))
    tys = gru_cuda.gru_bidirectional_fused(*(torch.from_numpy(a) for a in inputs))
    for g, w, what in zip(tys, jys, ("ys_fwd", "ys_bwd")):
        assert g.shape == (B, T, H) and g.dtype == torch.float32
        _close(g, w, 1e-5, what)
    got = _torch_grads(gru_cuda.gru_bidirectional_fused, inputs, dys)
    want = _jax_grads(gru_pallas.gru_bidirectional_pallas, inputs, dys)
    names = ("dxg_f", "dxg_b", "dW_f", "dW_b", "db_f", "db_b", "dh0")
    tols = (1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4, 2e-5)  # dh0 sums both directions
    for g, w, tol, what in zip(got, want, tols, names):
        _close(g, w, tol, what)


def test_fused_wrappers_refuse_before_any_launch():
    """bf16 streams (the pair is float32 only), wrong shapes and
    non-contiguous tensors are refused on the CPU as on the card; so is a
    hidden size whose W^T does not fit in shared memory even split over a
    cluster of 8 CTAs."""
    xg2, whh2, bhh2, h02, dy2 = (torch.from_numpy(a) for a in _fused_inputs(4, t=4))
    ys2 = torch.zeros_like(dy2)
    gru_cuda.reset_launch_counts()
    with pytest.raises(TypeError, match="float32 only; xg2"):
        gru_cuda.gru_bifwd(xg2.bfloat16(), whh2, bhh2, h02)
    with pytest.raises(TypeError, match="float32 only; whh2"):
        gru_cuda.gru_bifwd(xg2, whh2.bfloat16(), bhh2, h02)
    with pytest.raises(TypeError, match="float32 only; dy2"):
        gru_cuda.gru_bibwd(xg2, whh2, bhh2, h02, ys2, dy2.bfloat16())
    with pytest.raises(ValueError, match=r"xg2 must be \[T, 2, B, 3H\]"):
        gru_cuda.gru_bifwd(xg2.transpose(0, 1).contiguous()[:1], whh2, bhh2, h02)
    with pytest.raises(ValueError, match="whh2 must have shape"):
        gru_cuda.gru_bifwd(xg2, whh2.transpose(1, 2).contiguous(), bhh2, h02)
    with pytest.raises(ValueError, match="h02 must have shape"):
        gru_cuda.gru_bifwd(xg2, whh2, bhh2, h02[:, :-1])
    with pytest.raises(ValueError, match="ys2 must have shape"):
        gru_cuda.gru_bibwd(xg2, whh2, bhh2, h02, ys2[:-1], dy2)
    with pytest.raises(ValueError, match="contiguous"):
        gru_cuda.gru_bibwd(xg2, whh2, bhh2, h02, ys2,
                           dy2.transpose(0, 2).contiguous().transpose(0, 2))
    # Past the streamed adjoint's limit its step buffers at one row exceed
    # 227 KB (the check reads shapes only: meta tensors).
    big = gru_cuda.adj_max_hidden(4) + 1
    z = functools.partial(torch.empty, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda.gru_bibwd(z(1, 2, 1, 3 * big), z(2, 3 * big, big), z(2, 3 * big),
                           z(2, 1, big), z(1, 2, 1, big), z(1, 2, 1, big))
    with pytest.raises(ValueError, match="CUDA tensors"):
        gru_cuda._require_cuda(xg2)
    assert gru_cuda.launch_counts() == dict.fromkeys(
        ("gru_fwd", "gru_fwd_fb", "gru_bwd", "gru_bwd_fb", "gru_bifwd", "gru_bibwd"), 0)


def _fold_inputs(folds, seed):
    """F folds of the fused pair in the JAX layout: xg2 [F, T, 2, B, 3H],
    whh2 [F, 2, 3H, H], bhh2 [F, 2, 3H], h02 [F, 2, B, H], dy2
    [F, T, 2, B, H], float32 numpy."""
    per_fold = [_fused_inputs(seed + f) for f in range(folds)]
    return tuple(np.stack(parts) for parts in zip(*per_fold))


def _lanes(a: np.ndarray, time_major: bool) -> np.ndarray:
    """[F, (T,) 2, ...] per fold -> the port's 2F lanes, [T, 2F, ...] (or
    [2F, ...]): lane 2f fold f's forward direction, 2f + 1 its backward."""
    if time_major:
        a = np.swapaxes(a, 0, 1)
        return np.ascontiguousarray(a.reshape(a.shape[0], -1, *a.shape[3:]))
    return np.ascontiguousarray(a.reshape(-1, *a.shape[2:]))


@pytest.mark.parametrize("folds", [1, 3])
def test_lane_pair_matches_vmapped_bigru_tm(folds):
    """The plain pair at L = 2F lanes (through _BiGruWalk: plain forward,
    plain adjoint) against jax.vmap of _bigru_tm over F folds, each fold
    its own two-lane walk (Pallas's batching rule, interpret mode): ys and
    the gradients of xg2, whh2, bhh2 and h02."""
    xg2, whh2, bhh2, h02, dy2 = _fold_inputs(folds, seed=10)
    inputs = (xg2, whh2, bhh2, h02)
    fn = jax.vmap(gru_pallas._bigru_tm)
    outs, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    want = vjp(jnp.asarray(dy2))
    tm = (True, False, False, False)
    lanes = [torch.from_numpy(_lanes(a, t)).requires_grad_() for a, t in zip(inputs, tm)]
    ys2 = gru_cuda._BiGruWalk.apply(*lanes)
    assert ys2.shape == (T, 2 * folds, B, H)
    _close(ys2.detach(), _lanes(np.asarray(outs), True), 1e-5, "ys2")
    got = torch.autograd.grad(ys2, lanes, torch.from_numpy(_lanes(dy2, True)))
    for g, w, t, tol, what in zip(got, want, tm, (1e-5, 1e-4, 1e-4, 1e-5),
                                  ("dxg2", "dW", "db", "dh0")):
        _close(g, _lanes(np.asarray(w), t), tol, what)


@pytest.mark.parametrize("folds", [1, 3])
def test_bidirectional_folds_matches_vmapped_pallas(folds):
    """gru_bidirectional_folds (F folds' per-direction gates, time-major,
    as the fold-stacked model projects them) against jax.vmap of
    gru_bidirectional_pallas over F folds (batch-major per fold): both
    outputs in original time order, and the gradients of both gate streams,
    both W_hh, both b_hh and h0 (which sums both directions')."""
    rng = np.random.default_rng(11)
    gates = [rng.standard_normal((folds, B, T, 3 * H)).astype(np.float32) for _ in range(2)]
    ws = [(rng.standard_normal((folds, 3 * H, H)) * 0.3).astype(np.float32) for _ in range(2)]
    bs = [(rng.standard_normal((folds, 3 * H)) * 0.1).astype(np.float32) for _ in range(2)]
    h0 = (rng.standard_normal((folds, B, H)) * 0.5).astype(np.float32)
    dys = [rng.standard_normal((folds, B, T, H)).astype(np.float32) for _ in range(2)]
    inputs = (*gates, *ws, *bs, h0)
    outs, vjp = jax.vjp(jax.vmap(gru_pallas.gru_bidirectional_pallas),
                        *(jnp.asarray(a) for a in inputs))
    want = vjp(tuple(jnp.asarray(d) for d in dys))
    tm = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))  # noqa: E731
    ts = [torch.from_numpy(tm(g)).requires_grad_() for g in gates]
    ts += [torch.from_numpy(a).requires_grad_() for a in (*ws, *bs, h0)]
    ys = gru_cuda.gru_bidirectional_folds(*ts)
    for g, w, what in zip(ys, outs, ("ys_fwd", "ys_bwd")):
        assert g.shape == (folds, T, B, H) and g.dtype == torch.float32
        _close(g.detach(), tm(np.asarray(w)), 1e-5, what)
    got = torch.autograd.grad(ys, ts, [torch.from_numpy(tm(d)) for d in dys])
    names = ("dxg_f", "dxg_b", "dW_f", "dW_b", "db_f", "db_b", "dh0")
    tols = (1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4, 2e-5)  # dh0 sums both directions
    for g, w, tol, what in zip(got, want, tols, names):
        w = np.asarray(w)
        _close(g, tm(w) if what.startswith("dxg") else w, tol, what)


def test_odd_lanes_are_refused_before_any_launch():
    """The fused pair walks each fold's two directions: an odd lane count
    (or none) is refused by both wrappers, on the CPU as on the card, and
    nothing is launched."""
    z = torch.zeros
    gru_cuda.reset_launch_counts()
    for lanes in (1, 3, 0):
        args = (z(4, lanes, 2, 3 * H), z(lanes, 3 * H, H), z(lanes, 3 * H), z(lanes, 2, H))
        with pytest.raises(ValueError, match="even number of lanes"):
            gru_cuda.gru_bifwd(*args)
        with pytest.raises(ValueError, match="even number of lanes"):
            gru_cuda.gru_bibwd(*args, z(4, lanes, 2, H), z(4, lanes, 2, H))
    args = (z(4, 4, 2, 3 * H), z(4, 3 * H, H), z(4, 3 * H), z(4, 2, H))
    assert gru_cuda.gru_bifwd(*args).shape == (4, 4, 2, H)
    assert gru_cuda.launch_counts() == dict.fromkeys(
        ("gru_fwd", "gru_fwd_fb", "gru_bwd", "gru_bwd_fb", "gru_bifwd", "gru_bibwd"), 0)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at |a| (8 significant bits), floored at the smallest
    normal's."""
    mag = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("layers,prune", [(1, False), (2, False), (2, True)],
                         ids=["one_full_layer", "two_full_layers", "two_layers_pruned"])
def test_pallas_fused_bf16_bigru_matches_jax(layers, prune):
    """The repair of `gru_impl="pallas_fused"`: the model's BiGRU built from
    ModelConfig(gru_impl="pallas_fused", dtype="bfloat16") against the JAX
    BiGRU(impl="pallas_fused", dtype=bfloat16), same weights (flax init,
    moved by models/convert.py), within one bf16 ulp. Mapped to the
    direction-batched kernels' bf16 mode, which rounds the carry before
    every product, the port differed by many ulps here.

    Under last-step pruning the output's second half is the final layer's
    backward direction, one bf16 gru_cell: plain elementwise bf16 ops that
    XLA fuses and rounds once and eager PyTorch rounds op by op, the same
    before and after the repair; that half is held within 2 ulps."""
    fields = dict(gru_impl="pallas_fused", dtype="bfloat16", gru_hidden_size=H,
                  cnn_out_channels=8, gru_num_layers=layers, gru_last_prune=prune)
    jm = build_jax_model(JaxModelConfig(**fields), 2)
    rng = np.random.default_rng(5)
    sample = jnp.asarray(rng.standard_normal((2, 3, 64)), jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jm.init(jax.random.PRNGKey(0), sample, train=False)))
    pm = build_model(ModelConfig(**fields), 2, in_channels=3)
    load_jax_variables(pm, variables["params"], variables["batch_stats"])

    x = rng.standard_normal((4, 120, 8)).astype(np.float32)  # [B, T, F]
    jgru = JaxBiGRU(hidden_size=H, num_layers=layers, impl="pallas_fused",
                    last_only=prune, dtype=jnp.bfloat16)
    want = np.asarray(jgru.apply({"params": variables["params"]["gru"]},
                                 jnp.asarray(x)).astype(jnp.float32))
    pm.eval()
    with torch.inference_mode():
        got = pm.gru(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    excess = np.abs(got - want) / ulp
    limit = np.ones_like(excess)
    if prune:
        limit[..., H:] = 2.0
    assert (excess <= limit).all(), (
        f"{(excess > limit).sum()} of {excess.size} outputs beyond their limit, "
        f"worst {excess[..., :H].max():.1f} ulp in the first half, "
        f"{excess[..., H:].max():.1f} in the second")


@pytest.mark.parametrize("hidden", [1, 8, 64, 65, 128, 135, 136, 137, 256, 380])
def test_bifwd_admits_every_earlier_hidden_size(hidden):
    """gru_bifwd's check follows the walk kernel's shared-memory formula: it
    takes every H up to 135 (the first template's limit), 136 (one block's)
    and 380 (a cluster of 8 CTAs), on the CPU as on the card, and 381 too
    (the streamed walk); it refuses the first H past the streamed walk's
    limit before any launch."""
    z = torch.zeros
    args = (z(1, 2, 1, 3 * hidden), z(2, 3 * hidden, hidden), z(2, 3 * hidden), z(2, 1, hidden))
    assert gru_cuda._check_bi_args(*args, gru_cuda.walk_shared_bytes) == (1, 1, hidden)
    assert gru_cuda.gru_bifwd(*args).shape == (1, 2, 1, hidden)
    past = 381
    assert gru_cuda.gru_bifwd(z(1, 2, 1, 3 * past), z(2, 3 * past, past), z(2, 3 * past),
                              z(2, 1, past)).shape == (1, 2, 1, past)
    limit = gru_cuda.walk_max_hidden(4)
    big, e = limit + 1, functools.partial(torch.empty, device="meta")   # shapes only
    with pytest.raises(ValueError, match=f"shared memory.*H up to {limit}"):
        gru_cuda.gru_bifwd(e(1, 2, 1, 3 * big), e(2, 3 * big, big), e(2, 3 * big),
                           e(2, 1, big))
