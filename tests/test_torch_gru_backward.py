"""The port's GRU adjoint (multimodalsignal_tpu_torch/ops/gru_cuda.py) vs the
JAX package's Pallas adjoint, on the CPU: the plain versions of the two
backward kernels against `_gru_backward` / `_gru_backward_fb` called directly
(interpret mode), and gradients through the autograd Functions around the
model-facing entry points against `jax.vjp` of the JAX ones. Same
numpy-seeded inputs on both sides.

Tolerances. float32: rtol = atol = 1e-5 on dxg and dh0 (the two sides sum
each step's small products in different orders); dW and db are sums over
B*T = 185 terms of such values, so atol 1e-4. bfloat16: dxg is stored bf16,
so atol 0.05 as the forward's bf16 tests; dW, db and dh0 are f32 sums of
bf16-operand products whose operands are rounded at the same points on both
sides (measured differences under 3e-5), but one f32 round-off in a
recomputed gate can flip a bf16 rounding of dg, so atol 1e-2 on dh0 and
5e-2 on dW/db (sums over 185 terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.ops import gru_pallas
from multimodalsignal_tpu_torch.ops import gru_cuda

B, T, H, F = 5, 37, 16, 3  # ragged T: not a multiple of the Pallas time chunk
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {  # (dxg, dh0, dW/db): atol; float32 also rtol = atol for dxg and dh0
    "float32": (1e-5, 1e-5, 1e-4),
    "bfloat16": (0.05, 1e-2, 5e-2),
}


def _arrays(seed, lead=(), t=T):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal(lead + (t, B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal(lead + (3 * H, H)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(lead + (3 * H,)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal(lead + (B, H)) * 0.5).astype(np.float32)
    dy = rng.standard_normal(lead + (t, B, H)).astype(np.float32)
    return xg, w, bias, h0, dy


def _close(got: torch.Tensor, want, atol, dtype, what):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    rtol = atol if dtype == "float32" and atol < 1e-4 else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol,
                               err_msg=what)


def _kernel_case(seed, dtype, reverse, fb):
    """Forward with the JAX kernel, then the adjoint on both sides from the
    same (xg, w, b, h0, ys, dy)."""
    lead = (F,) if fb else ()
    xg, w, bias, h0, dy = _arrays(seed, lead)
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    jx, jw, jb, jdy = (jnp.asarray(a, jdt) for a in (xg, w, bias, dy))
    jh0 = jnp.asarray(h0)
    fwd = gru_pallas._gru_forward_fb if fb else gru_pallas._gru_forward
    bwd = gru_pallas._gru_backward_fb if fb else gru_pallas._gru_backward
    jys = fwd(jx, jw, jb, jh0, reverse)
    want = bwd(jx, jw, jb, jh0, jys, jdy, reverse)
    ys = torch.from_numpy(np.array(jnp.asarray(jys, jnp.float32))).to(tdt)
    args = [torch.from_numpy(a).to(tdt) for a in (xg, w, bias)]
    args += [torch.from_numpy(h0), ys, torch.from_numpy(dy).to(tdt)]
    plain = gru_cuda.gru_backward_fb_plain if fb else gru_cuda.gru_backward_plain
    return plain(*args, reverse=reverse), want


@pytest.mark.parametrize("fb", [False, True], ids=["single", "fb"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_matches_pallas_backward(reverse, dtype, fb):
    (dxg, dw, db, dh0), want = _kernel_case(10 + fb, dtype, reverse, fb)
    tdt = getattr(torch, dtype)
    assert dxg.dtype == tdt
    assert dw.dtype == db.dtype == dh0.dtype == torch.float32
    lead = (F,) if fb else ()
    assert dw.shape == lead + (3 * H, H) and db.shape == lead + (3 * H,)
    assert dh0.shape == lead + (B, H) and dxg.shape == lead + (T, B, 3 * H)
    t_dxg, t_dh0, t_dw = TOL[dtype]
    _close(dxg, want[0], t_dxg, dtype, "dxg")
    _close(dw, want[1], t_dw, dtype, "dW")
    _close(db, want[2], t_dw, dtype, "db")
    _close(dh0, want[3], t_dh0, dtype, "dh0")


def test_plain_fb_backward_lanes_equal_single_lane():
    """Each lane of the lane-batched adjoint is the single-lane adjoint on
    that lane's inputs, in both walk directions (to f32 round-off: BLAS sums
    a batched product in another order)."""
    xg, w, b, h0, dy = (torch.from_numpy(a) for a in _arrays(12, lead=(2,)))
    for reverse in (False, True):
        ys = gru_cuda.gru_forward_fb_plain(xg, w, b, h0, reverse)
        fb = gru_cuda.gru_backward_fb_plain(xg, w, b, h0, ys, dy, reverse)
        for f in range(2):
            one = gru_cuda.gru_backward_plain(xg[f], w[f], b[f], h0[f], ys[f],
                                              dy[f], reverse)
            for got, want in zip(fb, one):
                torch.testing.assert_close(got[f], want, rtol=0, atol=1e-5)


def _torch_grads(fn, inputs, dy):
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cot = [torch.from_numpy(d).to(o.dtype) for o, d in zip(outs, dy)]
    return torch.autograd.grad(outs, ts, cot)


def _jax_grads(fn, inputs, dy):
    outs, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    outs = outs if isinstance(outs, tuple) else (outs,)
    cot = tuple(jnp.asarray(d, o.dtype) for o, d in zip(outs, dy))
    return vjp(cot if len(cot) > 1 else cot[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_sequence_cuda_grads_match_pallas(reverse, dtype):
    """torch.autograd.grad through gru_sequence_cuda on CPU tensors (the
    Function's plain forward and plain backward) against jax.vjp of
    gru_sequence_pallas, for gates, W_hh, b_hh and h0. The gates arrive in
    the compute dtype, as the model gives them; the cotangents of the f32
    inputs come back f32 on both sides."""
    xg, w, b, h0, dy = _arrays(13)
    xg = xg.transpose(1, 0, 2).copy()                      # [B, T, 3H]
    dy = dy.transpose(1, 0, 2).copy()
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    got = _torch_grads(lambda x, ww, bb, hh: gru_cuda.gru_sequence_cuda(
        x.to(tdt), ww.to(tdt), bb.to(tdt), hh, reverse=reverse), (xg, w, b, h0), [dy])
    want = _jax_grads(lambda x, ww, bb, hh: gru_pallas.gru_sequence_pallas(
        x.astype(jdt), ww.astype(jdt), bb.astype(jdt), hh, reverse=reverse),
        (xg, w, b, h0), [dy])
    t_dxg, t_dh0, t_dw = TOL[dtype]
    for g, wnt, tol, what in zip(got, want, (t_dxg, t_dw, t_dw, t_dh0),
                                 ("dxg", "dW", "db", "dh0")):
        assert g.dtype == torch.float32
        _close(g, wnt, tol, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dirbatch_grads_match_jax(dtype):
    """Both directions of a layer as two lanes of one walk: gradients of
    both gate streams, both W_hh, both b_hh and h0."""
    fwd, bwd = _arrays(14), _arrays(15)
    gates = [a.transpose(1, 0, 2).copy() for a in (fwd[0], bwd[0])]
    inputs = (gates[0], gates[1], fwd[1], bwd[1], fwd[2], bwd[2], fwd[3])
    dys = [a.transpose(1, 0, 2).copy() for a in (fwd[4], bwd[4])]
    jdt, tdt = JDT[dtype], getattr(torch, dtype)

    def port(xf, xb, wf, wb, bf, bb, h0):
        return gru_cuda.gru_bidirectional_dirbatch(
            xf.to(tdt), xb.to(tdt), wf.to(tdt), wb.to(tdt), bf.to(tdt), bb.to(tdt), h0)

    def ref(xf, xb, wf, wb, bf, bb, h0):
        return gru_pallas.gru_bidirectional_dirbatch(
            xf.astype(jdt), xb.astype(jdt), wf.astype(jdt), wb.astype(jdt),
            bf.astype(jdt), bb.astype(jdt), h0)

    got = _torch_grads(port, inputs, dys)
    want = _jax_grads(ref, inputs, dys)
    t_dxg, t_dh0, t_dw = TOL[dtype]
    names = ("dxg_f", "dxg_b", "dW_f", "dW_b", "db_f", "db_b", "dh0")
    tols = (t_dxg, t_dxg, t_dw, t_dw, t_dw, t_dw, 2 * t_dh0)  # dh0 sums both lanes
    for g, wnt, tol, what in zip(got, want, tols, names):
        _close(g, wnt, tol, dtype, what)


def test_launch_counts_cover_four_kernels_and_cpu_counts_nothing():
    """launch_counts() has one entry per C entry point; forward and backward
    on CPU tensors (the plain versions) count nothing."""
    gru_cuda.reset_launch_counts()
    xg, w, b, h0, dy = (torch.from_numpy(a) for a in _arrays(16, t=4))
    xg.requires_grad_()
    ys = gru_cuda.gru_sequence_cuda(xg.transpose(0, 1), w, b, h0)
    ys.sum().backward()
    yf, yb = gru_cuda.gru_bidirectional_dirbatch(
        xg.transpose(0, 1), xg.transpose(0, 1), w, w, b, b, h0)
    (yf.sum() + yb.sum()).backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    assert gru_cuda.launch_counts() == {"gru_fwd": 0, "gru_fwd_fb": 0,
                                        "gru_bwd": 0, "gru_bwd_fb": 0,
                                        "gru_bifwd": 0, "gru_bibwd": 0}


def test_backward_argument_checks():
    """What the adjoint kernel does not take is refused before any launch:
    ys/dy of the wrong shape or dtype, a non-contiguous dy, CPU tensors
    handed to the launcher, and a hidden size whose W^T and dW^T partial do
    not fit in shared memory."""
    xg, w, b, h0, dy = (torch.from_numpy(a) for a in _arrays(17, t=4))
    ys = torch.zeros_like(dy)
    check = gru_cuda._check_bwd_args
    assert check(xg, w, b, h0, ys, dy, fb=False) == (1, 4, B, H)
    assert check(xg[None], w[None], b[None], h0[None], ys[None], dy[None],
                 fb=True) == (1, 4, B, H)
    with pytest.raises(ValueError, match="ys must have shape"):
        check(xg, w, b, h0, ys[:-1], dy, fb=False)
    with pytest.raises(ValueError, match="dy must have shape"):
        check(xg, w, b, h0, ys, dy[..., :-1], fb=False)
    with pytest.raises(TypeError, match="dy must have xg's dtype"):
        check(xg, w, b, h0, ys, dy.bfloat16(), fb=False)
    with pytest.raises(ValueError, match="dy must be contiguous"):
        check(xg, w, b, h0, ys, dy.transpose(0, 1).contiguous().transpose(0, 1),
              fb=False)
    with pytest.raises(ValueError, match="xg must be"):
        check(xg, w, b, h0, ys, dy, fb=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gru_cuda._launch_bwd("gru_bwd", xg, w, b, h0, ys, dy, False, fb=False)
    # gru_bwd_fb keeps the first template: in f32 W^T (96 x 289) plus the
    # dW^T partial (96 x 288) exceed 227 KB.
    big = 96
    assert gru_cuda.bwd_shared_bytes(64, 4) <= gru_cuda.MAX_SHARED_BYTES
    z = torch.zeros
    with pytest.raises(ValueError, match="shared memory"):
        check(z(1, 2, 1, 3 * big), z(1, 3 * big, big), z(1, 3 * big), z(1, 1, big),
              z(1, 2, 1, big), z(1, 2, 1, big), fb=True)


# Largest hidden sizes gru_bwd's adjoint walk takes (its shared-memory
# formula), and the largest the first adjoint template took (bwd_shared_bytes
# within 232,448 bytes); gru_bwd still takes every H up to the old limit.
ADJ_MAX_HIDDEN = {"float32": 130, "bfloat16": 179}
FIRST_BWD_MAX_HIDDEN = {"float32": 95, "bfloat16": 109}


def _bwd_args(h, dtype, lanes=None):
    dt = getattr(torch, dtype)
    lead = () if lanes is None else (lanes,)
    z = torch.zeros
    return (z(lead + (2, 1, 3 * h), dtype=dt), z(lead + (3 * h, h), dtype=dt),
            z(lead + (3 * h,), dtype=dt), z(lead + (1, h)), z(lead + (2, 1, h), dtype=dt),
            z(lead + (2, 1, h), dtype=dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adjoint_walk_admits_every_earlier_hidden_size(dtype):
    """gru_bwd's argument check follows the adjoint walk's formula: it takes
    every H the first template took (95 f32, 109 bf16) and every H up to its
    own limit, and refuses the first H past it before any launch."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    assert gru_cuda.adj_shared_bytes(ADJ_MAX_HIDDEN[dtype], item) <= gru_cuda.MAX_SHARED_BYTES
    assert gru_cuda.adj_shared_bytes(ADJ_MAX_HIDDEN[dtype] + 1, item) > gru_cuda.MAX_SHARED_BYTES
    assert ADJ_MAX_HIDDEN[dtype] >= FIRST_BWD_MAX_HIDDEN[dtype]
    for h in range(1, ADJ_MAX_HIDDEN[dtype] + 1):
        assert gru_cuda._check_bwd_args(*_bwd_args(h, dtype), fb=False) == (1, 2, 1, h)
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda._check_bwd_args(*_bwd_args(ADJ_MAX_HIDDEN[dtype] + 1, dtype), fb=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_first_adjoint_template_keeps_its_limits(dtype):
    """gru_bwd_fb and gru_bibwd stay on the first template: they take every
    H up to its limit and refuse the next one (H=96 in f32)."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    first = FIRST_BWD_MAX_HIDDEN[dtype]
    assert gru_cuda.bwd_shared_bytes(first, item) <= gru_cuda.MAX_SHARED_BYTES
    assert gru_cuda.bwd_shared_bytes(first + 1, item) > gru_cuda.MAX_SHARED_BYTES
    assert gru_cuda._check_bwd_args(*_bwd_args(first, dtype, lanes=2), fb=True) == (2, 2, 1, first)
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda._check_bwd_args(*_bwd_args(first + 1, dtype, lanes=2), fb=True)
    if dtype == "float32":
        z = torch.zeros
        h = first + 1
        with pytest.raises(ValueError, match="shared memory"):
            gru_cuda.gru_bibwd(z(2, 2, 1, 3 * h), z(2, 3 * h, h), z(2, 3 * h), z(2, 1, h),
                               z(2, 2, 1, h), z(2, 2, 1, h))


@pytest.mark.parametrize("hidden", [16, 64, 95, 128])
@pytest.mark.parametrize("n_steps", [1, 37, 480])
@pytest.mark.parametrize("batch", [1, 5, 63, 64, 65, 256])
def test_adjoint_tile_and_workspace_cover_every_row_once(batch, n_steps, hidden):
    """gru_bwd's walk blocks (ceil(B / R) tiles of R rows) cover each batch
    row once, R a power of two of at most ADJ_MOST_ROWS that grows only
    while the blocks would outnumber the SMs; its weight-gradient chunks
    cover each of the T * B rows (t, b) once, in whole stages, at most
    ADJ_MAX_PARTIALS of them; the workspace holds the six factors and dht
    of every (t, b, unit), then one [3H, H] partial per chunk, and the db
    workspace one [3H] partial per chunk."""
    rows = gru_cuda.adj_row_tile(batch, 1, hidden)
    most = gru_cuda.ADJ_MOST_ROWS[gru_cuda.walk_in_registers(hidden)]
    assert rows & (rows - 1) == 0 and 1 <= rows <= most
    tiles = -(-batch // rows)
    covered = [t * rows + r for t in range(tiles) for r in range(rows) if t * rows + r < batch]
    assert covered == list(range(batch))
    assert tiles <= gru_cuda.NUM_SMS or rows == most
    chunk, parts = gru_cuda.adj_partials(n_steps, batch)
    assert chunk % gru_cuda.ADJ_GRAD_STAGE == 0 and 1 <= parts <= gru_cuda.ADJ_MAX_PARTIALS
    chunks = [range(p * chunk, min((p + 1) * chunk, n_steps * batch)) for p in range(parts)]
    assert [m for c in chunks for m in c] == list(range(n_steps * batch))
    assert all(len(c) > 0 for c in chunks)
    g = 3 * hidden
    dw_shape, db_shape = gru_cuda._adjoint_workspaces("gru_bwd", 1, n_steps, batch, hidden)
    assert dw_shape == (n_steps * batch * hidden * (gru_cuda.ADJ_FACTORS + 1)
                        + parts * g * hidden,)
    assert db_shape == (1, parts, g)
    assert gru_cuda._adjoint_workspaces("gru_bwd_fb", 2, n_steps, batch, hidden) == (
        (2, -(-batch // gru_cuda.BWD_ROWS_PER_BLOCK), hidden, g),
        (2, -(-batch // gru_cuda.BWD_ROWS_PER_BLOCK), g))
