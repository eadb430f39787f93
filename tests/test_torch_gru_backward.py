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

import functools

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
    handed to the launcher, and a hidden size whose adjoint walk does not
    fit in shared memory."""
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
    # Past the streamed walk's limit its dg buffers, factor chunks, dh and
    # copy rings at one row exceed 227 KB (the check reads shapes only:
    # meta tensors).
    big = ADJ_MAX_HIDDEN["float32"] + 1
    assert gru_cuda.adj_shared_bytes(64, 4) <= gru_cuda.MAX_SHARED_BYTES
    z = functools.partial(torch.empty, device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        check(z(1, 2, 1, 3 * big), z(1, 3 * big, big), z(1, 3 * big), z(1, 1, big),
              z(1, 2, 1, big), z(1, 2, 1, big), fb=True)


# Largest hidden sizes the adjoint walk takes (its shared-memory formula):
# the one-block and cluster design's (f32 a CTA's share of W^T split over a
# cluster of 8, bf16 the gate pre-pass's W slice and h_prev) and, past it,
# the streamed walk's (W^T streamed from device memory; its dg buffers,
# factor chunks, dh and copy rings at one row); and the largest the first
# adjoint template took; every adjoint entry still takes every H up to the
# old limits.
CLUSTER_ADJ_MAX_HIDDEN = {"float32": 376, "bfloat16": 450}
ADJ_MAX_HIDDEN = {"float32": 4453, "bfloat16": 4622}
FIRST_BWD_MAX_HIDDEN = {"float32": 95, "bfloat16": 109}
STREAMED_HS = (377, 451, 512, 768, 1024, 2048)


def _adj_hs(dtype):
    """Every H up to the cluster design's limit, some streamed ones, and
    the streamed walk's limit."""
    return [*range(1, CLUSTER_ADJ_MAX_HIDDEN[dtype] + 1), *STREAMED_HS, ADJ_MAX_HIDDEN[dtype]]


def _bwd_args(h, dtype, lanes=None):
    """Arguments of the adjoint's check at H, on the meta device (the check
    reads shapes, dtypes and layouts only)."""
    dt = getattr(torch, dtype)
    lead = () if lanes is None else (lanes,)
    z = functools.partial(torch.empty, device="meta")
    return (z(lead + (2, 1, 3 * h), dtype=dt), z(lead + (3 * h, h), dtype=dt),
            z(lead + (3 * h,), dtype=dt), z(lead + (1, h)), z(lead + (2, 1, h), dtype=dt),
            z(lead + (2, 1, h), dtype=dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adjoint_walk_admits_every_earlier_hidden_size(dtype):
    """gru_bwd's argument check follows the adjoint walk's formula: it takes
    every H the first template took (95 f32, 109 bf16), every H up to the
    cluster design's limit and the streamed walk's beyond, and refuses the
    first H past the streamed walk's limit before any launch, naming the
    limit."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    assert gru_cuda.adj_shared_bytes(ADJ_MAX_HIDDEN[dtype], item) <= gru_cuda.MAX_SHARED_BYTES
    assert gru_cuda.adj_shared_bytes(ADJ_MAX_HIDDEN[dtype] + 1, item) > gru_cuda.MAX_SHARED_BYTES
    assert ADJ_MAX_HIDDEN[dtype] >= FIRST_BWD_MAX_HIDDEN[dtype]
    assert gru_cuda.adj_max_hidden(item) == ADJ_MAX_HIDDEN[dtype]
    for h in _adj_hs(dtype):
        assert gru_cuda._check_bwd_args(*_bwd_args(h, dtype), fb=False) == (1, 2, 1, h)
    with pytest.raises(ValueError, match=f"shared memory.*H up to {ADJ_MAX_HIDDEN[dtype]}"):
        gru_cuda._check_bwd_args(*_bwd_args(ADJ_MAX_HIDDEN[dtype] + 1, dtype), fb=False)


@pytest.mark.parametrize("entry,dtype", [("gru_bwd_fb", "float32"), ("gru_bwd_fb", "bfloat16"),
                                         ("gru_bibwd", "float32")])
def test_fb_and_fused_adjoints_admit_every_walk_hidden_size(entry, dtype):
    """gru_bwd_fb (at 2 and at 15 lanes) and gru_bibwd run the adjoint walk
    and are checked by its formula: they take every H up to 376 (f32) / 450
    (bf16), so every H the first template took, and the streamed walk's
    beyond, and refuse the first H past its limit before any launch."""
    most = ADJ_MAX_HIDDEN[dtype]
    z = functools.partial(torch.empty, device="meta")
    if entry == "gru_bwd_fb":
        for lanes in (2, 15):
            for h in _adj_hs(dtype):
                assert gru_cuda._check_bwd_args(*_bwd_args(h, dtype, lanes), fb=True) == (
                    lanes, 2, 1, h)
            with pytest.raises(ValueError, match="shared memory"):
                gru_cuda._check_bwd_args(*_bwd_args(most + 1, dtype, lanes), fb=True)
        return

    def bi_args(h):
        return (z(2, 2, 1, 3 * h), z(2, 3 * h, h), z(2, 3 * h), z(2, 1, h), z(2, 2, 1, h),
                z(2, 2, 1, h))

    for h in _adj_hs(dtype):
        xg2, whh2, bhh2, h02, ys2, dy2 = bi_args(h)
        assert gru_cuda._check_bi_args(xg2, whh2, bhh2, h02, gru_cuda.adj_shared_bytes,
                                       ys2=ys2, dy2=dy2) == (2, 1, h)
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda.gru_bibwd(*bi_args(most + 1))


@pytest.mark.parametrize("lanes", [1, 2, 15])
@pytest.mark.parametrize("hidden", [16, 64, 95, 128])
@pytest.mark.parametrize("n_steps", [1, 37, 480])
@pytest.mark.parametrize("batch", [1, 5, 63, 64, 65, 256])
def test_adjoint_tile_and_workspace_cover_every_row_once(batch, n_steps, hidden, lanes):
    """The adjoint walk's blocks (ceil(B / R) tiles of R rows a lane) cover
    each batch row once, R a power of two of at most ADJ_MOST_ROWS that
    grows only while the blocks of all lanes would outnumber the SMs; its
    weight-gradient chunks cover each of a lane's T * B rows (t, b) once, in
    whole stages, one where the lanes' dW tiles fill the SMs and otherwise
    as many as the tiles take to fill them; the workspace holds the
    six factors and dht of every (lane, t, b, unit), then one [3H, H]
    partial per lane and chunk, and the db workspace one [3H] partial per
    lane and chunk."""
    rows = gru_cuda.adj_row_tile(batch, lanes, hidden)
    most = gru_cuda.ADJ_MOST_ROWS[gru_cuda.walk_in_registers(hidden)]
    assert rows & (rows - 1) == 0 and 1 <= rows <= most
    tiles = -(-batch // rows)
    covered = [t * rows + r for t in range(tiles) for r in range(rows) if t * rows + r < batch]
    assert covered == list(range(batch))
    assert tiles * lanes <= gru_cuda.NUM_SMS or rows == most
    assert rows == 1 or -(-batch // (rows // 2)) * lanes > gru_cuda.NUM_SMS
    chunk, parts = gru_cuda.adj_partials(lanes, n_steps, batch, hidden)
    tiles = lanes * -(-hidden // gru_cuda.ADJ_GRAD_TILE) * -(-3 * hidden // gru_cuda.ADJ_GRAD_TILE)
    assert chunk % gru_cuda.ADJ_GRAD_STAGE == 0 and parts >= 1
    assert parts == 1 if tiles >= gru_cuda.NUM_SMS else parts * tiles <= gru_cuda.NUM_SMS
    chunks = [range(p * chunk, min((p + 1) * chunk, n_steps * batch)) for p in range(parts)]
    assert [m for c in chunks for m in c] == list(range(n_steps * batch))
    assert all(len(c) > 0 for c in chunks)
    g = 3 * hidden
    dw_shape, db_shape = gru_cuda._adjoint_workspaces(lanes, n_steps, batch, hidden)
    assert dw_shape == (lanes * n_steps * batch * hidden * (gru_cuda.ADJ_FACTORS + 1)
                        + lanes * parts * g * hidden,)
    assert db_shape == (lanes, parts, g)


@pytest.mark.parametrize("entry,lanes", [("gru_bwd", 1), ("gru_bwd_fb", 3), ("gru_bibwd", 2)])
def test_every_adjoint_entry_gets_the_walk_workspaces(entry, lanes, monkeypatch):
    """The launcher hands each of the three C entries the same adjoint walk
    workspaces for its lane count (dw_part: the flat f32 workspace of
    adj_workspace_floats; db_part: [lanes, chunks, 3H]) and the ints of its
    C signature; nothing reaches a library on the CPU (the C call is
    replaced here)."""
    calls = []
    monkeypatch.setattr(gru_cuda, "_bwd_library", lambda: "lib")
    monkeypatch.setattr(gru_cuda, "_call", lambda lib, name, tensors, ints: calls.append(
        (lib, name, [tuple(t.shape) for t in tensors], [t.dtype for t in tensors], ints)))
    t, b, h = 37, 5, 8
    xg = torch.zeros(lanes, t, b, 3 * h)
    w, bias, h0 = torch.zeros(lanes, 3 * h, h), torch.zeros(lanes, 3 * h), torch.zeros(lanes, b, h)
    ys = dy = torch.zeros(lanes, t, b, h)
    ints = {"gru_bwd": [t, b, h, 0, 0], "gru_bwd_fb": [lanes, t, b, h, 0, 0],
            "gru_bibwd": [t, b, h]}[entry]
    grads, launched = gru_cuda._launch_adjoint(entry, xg, w, bias, h0, ys, dy, lanes, t, b, h,
                                               ints)
    assert launched and len(calls) == 1
    lib, name, shapes, dtypes, got_ints = calls[0]
    assert (lib, name, got_ints) == ("lib", entry, ints)
    parts = gru_cuda.adj_partials(lanes, t, b, h)[1]
    assert shapes[-2:] == [(gru_cuda.adj_workspace_floats(lanes, t, b, h),), (lanes, parts, 3 * h)]
    assert dtypes[-2:] == [torch.float32, torch.float32]
    assert [tuple(g.shape) for g in grads] == [tuple(xg.shape), tuple(w.shape),
                                               tuple(bias.shape), tuple(h0.shape)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_at_h256_matches_pallas(reverse, dtype):
    """At H=256 (the adjoint's cluster walk on the card) the plain adjoint
    matches `_gru_backward` in interpret mode, T=9, B=3, from the JAX
    forward's ys."""
    h, b, t = 256, 3, 9
    rng = np.random.default_rng(40 + reverse)
    xg = rng.standard_normal((t, b, 3 * h)).astype(np.float32)
    w = (rng.standard_normal((3 * h, h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((t, b, h)).astype(np.float32)
    jdt, tdt = JDT[dtype], getattr(torch, dtype)
    jx, jw, jb, jdy = (jnp.asarray(a, jdt) for a in (xg, w, bias, dy))
    jys = gru_pallas._gru_forward(jx, jw, jb, jnp.asarray(h0), reverse)
    want = gru_pallas._gru_backward(jx, jw, jb, jnp.asarray(h0), jys, jdy, reverse)
    ys = torch.from_numpy(np.array(jnp.asarray(jys, jnp.float32))).to(tdt)
    args = [torch.from_numpy(a).to(tdt) for a in (xg, w, bias)]
    args += [torch.from_numpy(h0), ys, torch.from_numpy(dy).to(tdt)]
    dxg, dw, db, dh0 = gru_cuda.gru_backward_plain(*args, reverse=reverse)
    t_dxg, t_dh0, t_dw = TOL[dtype]
    _close(dxg, want[0], t_dxg, dtype, "dxg")
    _close(dw, want[1], t_dw, dtype, "dW")
    _close(db, want[2], t_dw, dtype, "db")
    _close(dh0, want[3], t_dh0, dtype, "dh0")
