"""Port GRU wrappers (multimodalsignal_tpu_torch/ops/gru_cuda.py) vs the JAX
package's Pallas entry points, on the CPU: the port's wrappers run their
plain versions there, the Pallas kernels run in interpret mode. Same
numpy-seeded inputs on both sides.

Tolerances: float32 rtol = atol = 1e-5 (the two sides sum the step's
product in different orders); bfloat16 atol 0.05 with bf16 outputs, as in
tests/test_gru_pallas.py's bf16 tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.ops import gru_pallas
from multimodalsignal_tpu_torch.ops import gru_cuda

B, T, H = 5, 37, 16  # ragged T: not a multiple of the Pallas time chunk


def _inputs(seed, lead=(), b=B, t=T, h=H):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal(lead + (b, t, 3 * h)).astype(np.float32)
    w = (rng.standard_normal(lead + (3 * h, h)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(lead + (3 * h,)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal(lead + (b, h)) * 0.5).astype(np.float32)
    return xg, w, bias, h0


def _both(arrays, dtype):
    """(jax arrays, torch tensors) of the inputs; gates, weights and bias in
    `dtype`, h0 always float32."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    *streams, h0 = arrays
    j = [jnp.asarray(a, jdt) for a in streams] + [jnp.asarray(h0)]
    t = [torch.from_numpy(a).to(tdt) for a in streams] + [torch.from_numpy(h0)]
    return j, t


def _assert_close(got: torch.Tensor, want, dtype):
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=0.05)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_sequence_cuda_matches_pallas(reverse, dtype):
    (xg, w, b, h0), (txg, tw, tb, th0) = _both(_inputs(0), dtype)
    want = gru_pallas.gru_sequence_pallas(xg, w, b, h0, reverse=reverse)
    got = gru_cuda.gru_sequence_cuda(txg, tw, tb, th0, reverse=reverse)
    assert got.shape == (B, T, H)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_forward_fb_matches_vmapped_pallas(reverse, dtype):
    """F=3 lanes: jax.vmap over gru_sequence_pallas routes onto
    _fb_fwd_kernel through custom_vmap; the port's gru_forward_fb takes the
    same lanes time-major."""
    (xg, w, b, h0), (txg, tw, tb, th0) = _both(_inputs(1, lead=(3,)), dtype)
    want = jax.vmap(lambda a, ww, bb, hh: gru_pallas.gru_sequence_pallas(
        a, ww, bb, hh, reverse=reverse))(xg, w, b, h0)        # [F, B, T, H]
    got = gru_cuda.gru_forward_fb(txg.transpose(1, 2).contiguous(), tw, tb,
                                  th0, reverse=reverse)        # [F, T, B, H]
    _assert_close(got.transpose(1, 2), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_bidirectional_dirbatch_matches_jax(dtype):
    rng = np.random.default_rng(2)
    fwd, bwd = _inputs(3), _inputs(4)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    (xf, wf, bf, jh0), (txf, twf, tbf, th0) = _both(fwd[:3] + (h0,), dtype)
    (xb, wb, bb, _), (txb, twb, tbb, _) = _both(bwd[:3] + (h0,), dtype)
    want_f, want_b = gru_pallas.gru_bidirectional_dirbatch(
        xf, xb, wf, wb, bf, bb, jh0)
    got_f, got_b = gru_cuda.gru_bidirectional_dirbatch(
        txf, txb, twf, twb, tbf, tbb, th0)
    _assert_close(got_f, want_f, dtype)
    _assert_close(got_b, want_b, dtype)


def test_plain_fb_lanes_equal_single_direction_plain():
    """Each lane of the lane-batched plain version is the single-direction
    plain version on that lane's inputs, in both walk directions (to f32
    round-off: BLAS sums a batched product in another order)."""
    xg, w, b, h0 = (torch.from_numpy(a) for a in _inputs(5, lead=(2,)))
    xg = xg.transpose(1, 2).contiguous()
    for reverse in (False, True):
        fb = gru_cuda.gru_forward_fb_plain(xg, w, b, h0, reverse)
        for f in range(2):
            one = gru_cuda.gru_forward_plain(xg[f], w[f], b[f], h0[f], reverse)
            torch.testing.assert_close(fb[f], one, rtol=0, atol=1e-6)


def test_cpu_tensors_do_not_count_launches():
    """On the CPU the wrappers run their plain versions and count nothing."""
    gru_cuda.reset_launch_counts()
    xg, w, b, h0 = (torch.from_numpy(a) for a in _inputs(6, t=4))
    gru_cuda.gru_forward(xg.transpose(0, 1).contiguous(), w, b, h0)
    gru_cuda.gru_forward_fb(xg.transpose(0, 1).contiguous()[None], w[None],
                            b[None], h0[None])
    assert gru_cuda.launch_counts() == {"gru_fwd": 0, "gru_fwd_fb": 0,
                                        "gru_bwd": 0, "gru_bwd_fb": 0,
                                        "gru_bifwd": 0, "gru_bibwd": 0}


def test_cuda_argument_checks():
    """What the kernel does not take is refused before any launch: wrong
    shapes, dtypes, non-contiguous tensors, a hidden size whose W^T does not
    fit in shared memory even split over a cluster of 8 CTAs."""
    xg, w, b, h0 = (torch.from_numpy(a) for a in _inputs(7, t=4))
    xg = xg.transpose(0, 1).contiguous()
    check = gru_cuda._check_cuda_args
    assert check(xg, w, b, h0, fb=False) == (1, 4, B, H)
    assert check(xg[None], w[None], b[None], h0[None], fb=True) == (1, 4, B, H)
    with pytest.raises(ValueError, match="xg must be"):
        check(xg, w, b, h0, fb=True)
    with pytest.raises(ValueError, match="w_hh must have shape"):
        check(xg, w.T, b, h0, fb=False)
    with pytest.raises(TypeError, match="w_hh and b_hh"):
        check(xg, w.bfloat16(), b, h0, fb=False)
    with pytest.raises(TypeError, match="h0 must be float32"):
        check(xg, w, b, h0.double(), fb=False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check(xg.double(), w.double(), b.double(), h0, fb=False)
    with pytest.raises(ValueError, match="contiguous"):
        check(xg.transpose(0, 1).contiguous().transpose(0, 1), w, b, h0, fb=False)
    # Past the streamed walk's limit its h buffers, carry and copy rings at
    # one row exceed 227 KB (the check reads shapes only: meta tensors).
    big = WALK_MAX_HIDDEN["float32"] + 1
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        check(torch.empty(2, 1, 3 * big, **meta), torch.empty(3 * big, big, **meta),
              torch.empty(3 * big, **meta), torch.empty(1, big, **meta), fb=False)


# Largest hidden sizes the walk kernel (gru_fwd, gru_fwd_fb) takes, from its
# shared-memory formula: the cluster walk's (W split over a thread block
# cluster of up to 8 CTAs: each CTA's share of W and the whole h within
# 232,448 bytes) and, past it, the streamed walk's (W streamed from device
# memory; its h buffers, carry and copy rings at one row within 232,448
# bytes); and the largest the first forward template took (from its
# formula, W^T [H, 3H] plus 4 rows of carry, operand and hg); every H up to
# the old limits is still taken.
CLUSTER_MAX_HIDDEN = {"float32": 380, "bfloat16": 532}
WALK_MAX_HIDDEN = {"float32": 21564, "bfloat16": 24452}
FIRST_MAX_HIDDEN = {"float32": 135, "bfloat16": 190}
STREAMED_HS = (381, 451, 512, 533, 768, 1024, 2048)


def _walk_args(h, dtype, lanes=None):
    """Arguments of the walk's check at H, on the meta device (the check
    reads shapes, dtypes and layouts only)."""
    dt = dict(dtype=getattr(torch, dtype), device="meta")
    lead = () if lanes is None else (lanes,)
    return (torch.empty(lead + (1, 1, 3 * h), **dt), torch.empty(lead + (3 * h, h), **dt),
            torch.empty(lead + (3 * h,), **dt), torch.empty(lead + (1, h), device="meta"))


def _walk_hs(dtype):
    """Every H up to the cluster walk's limit, some streamed ones, and the
    streamed walk's limit."""
    return [*range(1, CLUSTER_MAX_HIDDEN[dtype] + 1), *STREAMED_HS, WALK_MAX_HIDDEN[dtype]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_kernel_admits_every_earlier_hidden_size(dtype):
    """gru_fwd's argument check follows the walk kernel's shared-memory
    formula: it takes every H the first template took, every H the cluster
    walk holds and the streamed walk's beyond, and refuses the first H past
    the streamed walk's limit before any launch, naming the limit."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    assert gru_cuda.walk_shared_bytes(WALK_MAX_HIDDEN[dtype], item) <= gru_cuda.MAX_SHARED_BYTES
    assert gru_cuda.walk_shared_bytes(WALK_MAX_HIDDEN[dtype] + 1, item) > gru_cuda.MAX_SHARED_BYTES
    for h in _walk_hs(dtype):
        assert gru_cuda._check_cuda_args(*_walk_args(h, dtype), fb=False) == (1, 1, 1, h)
    assert WALK_MAX_HIDDEN[dtype] >= FIRST_MAX_HIDDEN[dtype]
    assert gru_cuda.walk_max_hidden(item) == WALK_MAX_HIDDEN[dtype]
    with pytest.raises(ValueError, match=f"shared memory.*H up to {WALK_MAX_HIDDEN[dtype]}"):
        gru_cuda._check_cuda_args(*_walk_args(WALK_MAX_HIDDEN[dtype] + 1, dtype), fb=False)


@pytest.mark.parametrize("lanes", [1, 2, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fb_walk_admits_every_earlier_hidden_size(dtype, lanes):
    """gru_fwd_fb runs the walk kernel too: _check_cuda_args(fb=True) takes
    every H up to the first template's limit (135 f32, 190 bf16), the
    cluster walk's (380, 532) and the streamed walk's for any lane count,
    and refuses the first H past it before any launch."""
    for h in _walk_hs(dtype):
        assert gru_cuda._check_cuda_args(*_walk_args(h, dtype, lanes), fb=True) == (lanes, 1, 1, h)
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda._check_cuda_args(*_walk_args(WALK_MAX_HIDDEN[dtype] + 1, dtype, lanes),
                                  fb=True)


@pytest.mark.parametrize("hidden", [16, 64, 65, 128])
@pytest.mark.parametrize("lanes", [1, 2, 4, 15])
@pytest.mark.parametrize("batch", [1, 5, 63, 64, 65, 128, 256])
def test_walk_row_tile_covers_every_row_once(batch, lanes, hidden):
    """The walk kernel's blocks, ceil(B / R) tiles of R rows (rows past B
    masked), cover each batch row exactly once; R is a power of two of at
    most the threads per unit, and grows only while the blocks would
    outnumber the SMs."""
    rows = gru_cuda.walk_row_tile(batch, lanes, hidden)
    most = gru_cuda.WALK_SUBLANES[gru_cuda.walk_in_registers(hidden)]
    assert rows & (rows - 1) == 0 and 1 <= rows <= most
    tiles = -(-batch // rows)
    covered = [t * rows + r for t in range(tiles) for r in range(rows) if t * rows + r < batch]
    assert covered == list(range(batch))
    assert tiles * lanes <= gru_cuda.NUM_SMS or rows == most
    if rows > 1:
        assert -(-batch // (rows // 2)) * lanes > gru_cuda.NUM_SMS


@pytest.mark.parametrize("lanes, batch, rows", [(2, 64, 1), (4, 128, 4), (15, 64, 8)])
def test_fb_lanes_reach_row_tiles_four_and_eight(lanes, batch, rows):
    """The lane counts chip_smoke.py checks gru_fwd_fb at reach the row tiles
    the serving shape does not: F=4 at B=128 tiles 4 rows a block, the 15
    fold-parallel lanes at B=64 tile 8."""
    assert gru_cuda.walk_row_tile(batch, lanes, 64) == rows


# Past one block's shared memory the walks split W over a thread block
# cluster (f32 above H = 136 forward / 130 adjoint, bf16 above 192 / 179).
ONE_BLOCK_MAX_HIDDEN = {"float32": (136, 130), "bfloat16": (192, 179)}
BIG_H = 256


def _partitioned(hidden: int, cluster: int) -> bool:
    """Every unit of H in exactly one CTA's slice, none empty."""
    units = gru_cuda.cluster_units(hidden, cluster)
    slices = [range(r * units, min(hidden, (r + 1) * units)) for r in range(cluster)]
    return [j for s in slices for j in s] == list(range(hidden)) and all(slices)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_twins_cover_every_hidden_size_to_256(dtype):
    """For H = 1-256 the Python twins of the C formulas (walk_cluster_size,
    adj_cluster_size, walk_shared_bytes, adj_shared_bytes) pick the least
    cluster whose per-CTA share fits: one block up to the old limits, 2-8
    CTAs above, every unit in exactly one CTA's slice, the per-CTA bytes
    within the card's and the CTA's threads within the cluster walk's
    launch bound."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    walk_max, adj_max = ONE_BLOCK_MAX_HIDDEN[dtype]
    for h in range(1, BIG_H + 1):
        k = gru_cuda.walk_cluster_size(h, item)
        assert (k == 1) == (h <= walk_max) and 1 <= k <= gru_cuda.MAX_CLUSTER, (h, k)
        assert _partitioned(h, k)
        assert gru_cuda.walk_shared_bytes(h, item) <= gru_cuda.MAX_SHARED_BYTES
        if k > 1:
            most = gru_cuda.WALK_SUBLANES[False]
            assert gru_cuda._walk_threads(h, k) <= gru_cuda.CLUSTER_MAX_THREADS
            assert (gru_cuda._walk_bytes(h, item, most, k - 1) > gru_cuda.MAX_SHARED_BYTES
                    or gru_cuda._walk_threads(h, k - 1) > gru_cuda.CLUSTER_MAX_THREADS)
        a = gru_cuda.adj_cluster_size(h, item)
        assert (a == 1) == (h <= adj_max) and 1 <= a <= gru_cuda.MAX_CLUSTER, (h, a)
        assert _partitioned(h, a)
        assert gru_cuda.adj_shared_bytes(h, item) <= gru_cuda.MAX_SHARED_BYTES
        if a > 1:
            assert gru_cuda._adj_walk_bytes(h, item, 1, a - 1) > gru_cuda.MAX_SHARED_BYTES


def _entry_args(entry: str, h: int, dtype: str):
    """An entry's arguments at H, on the meta device (its check reads
    shapes, dtypes and layouts only)."""
    dt = getattr(torch, dtype)
    z = functools.partial(torch.empty, device="meta")
    if entry in ("gru_bifwd", "gru_bibwd"):
        args = (z(2, 2, 1, 3 * h), z(2, 3 * h, h), z(2, 3 * h), z(2, 1, h))
        return args + ((z(2, 2, 1, h), z(2, 2, 1, h)) if entry == "gru_bibwd" else ())
    lead = (2,) if entry.endswith("_fb") else ()
    args = (z(lead + (2, 1, 3 * h), dtype=dt), z(lead + (3 * h, h), dtype=dt),
            z(lead + (3 * h,), dtype=dt), z(lead + (1, h)))
    if entry.startswith("gru_bwd"):
        args += (z(lead + (2, 1, h), dtype=dt), z(lead + (2, 1, h), dtype=dt))
    return args


def _check_entry(entry: str, args):
    """The entry's own argument check, as its wrapper runs it before any
    launch."""
    if entry == "gru_bifwd":
        return gru_cuda._check_bi_args(*args, gru_cuda.walk_shared_bytes)
    if entry == "gru_bibwd":
        return gru_cuda._check_bi_args(*args[:4], gru_cuda.adj_shared_bytes, ys2=args[4],
                                       dy2=args[5])
    fb = entry.endswith("_fb")
    if entry.startswith("gru_bwd"):
        return gru_cuda._check_bwd_args(*args, fb=fb)
    return gru_cuda._check_cuda_args(*args, fb=fb)


@pytest.mark.parametrize("entry,dtype", [
    ("gru_fwd", "float32"), ("gru_fwd", "bfloat16"), ("gru_fwd_fb", "float32"),
    ("gru_fwd_fb", "bfloat16"), ("gru_bifwd", "float32"), ("gru_bwd", "float32"),
    ("gru_bwd", "bfloat16"), ("gru_bwd_fb", "float32"), ("gru_bwd_fb", "bfloat16"),
    ("gru_bibwd", "float32")])
def test_every_entry_admits_256_and_refuses_past_its_limit(entry, dtype):
    """Every entry's check admits H=256 (a cluster of 4 CTAs in f32, 2 in
    bf16) and refuses the first H past its limit (the streamed walks':
    forward 21564 / 24452, adjoint 4453 / 4622) with a ValueError that
    names the limit."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    adjoint = entry in ("gru_bwd", "gru_bwd_fb", "gru_bibwd")
    limit = gru_cuda.adj_max_hidden(item) if adjoint else gru_cuda.walk_max_hidden(item)
    assert _check_entry(entry, _entry_args(entry, BIG_H, dtype))[-1] == BIG_H
    assert _check_entry(entry, _entry_args(entry, limit, dtype))[-1] == limit
    with pytest.raises(ValueError, match=f"H up to {limit}$"):
        _check_entry(entry, _entry_args(entry, limit + 1, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_walk_at_h256_matches_pallas(reverse, dtype):
    """At H=256 (the cluster walk on the card) the plain version, which the
    wrapper runs on CPU tensors, matches gru_sequence_pallas in interpret
    mode, T=9, B=3, with W at torch's GRU scale (1/sqrt(H), as the models
    initialise it)."""
    xg, w, b, h0 = _inputs(20, b=3, t=9, h=BIG_H)
    w = (w / 0.3 / np.sqrt(BIG_H)).astype(np.float32)
    (xg, w, b, h0), (txg, tw, tb, th0) = _both((xg, w, b, h0), dtype)
    want = gru_pallas.gru_sequence_pallas(xg, w, b, h0, reverse=reverse)
    got = gru_cuda.gru_sequence_cuda(txg, tw, tb, th0, reverse=reverse)
    assert got.shape == (3, 9, BIG_H)
    _assert_close(got, want, dtype)
