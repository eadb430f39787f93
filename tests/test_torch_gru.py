"""Port GRU wrappers (multimodalsignal_tpu_torch/ops/gru_cuda.py) vs the JAX
package's Pallas entry points, on the CPU: the port's wrappers run their
plain versions there, the Pallas kernels run in interpret mode. Same
numpy-seeded inputs on both sides.

Tolerances: float32 rtol = atol = 1e-5 (the two sides sum the step's
product in different orders); bfloat16 atol 0.05 with bf16 outputs, as in
tests/test_gru_pallas.py's bf16 tests."""

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
    fit in shared memory."""
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
    big = 256  # W^T alone is 256 * 768 * 4 bytes > 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        check(torch.zeros(2, 1, 3 * big), torch.zeros(3 * big, big),
              torch.zeros(3 * big), torch.zeros(1, big), fb=False)


# Largest hidden sizes the walk kernel (gru_fwd) takes, from its shared-memory
# formula, and the largest the first template took; every H up to the old
# limit is still taken.
WALK_MAX_HIDDEN = {"float32": 136, "bfloat16": 192}
FIRST_MAX_HIDDEN = {"float32": 135, "bfloat16": 190}


def _walk_args(h, dtype):
    dt = getattr(torch, dtype)
    return (torch.zeros(1, 1, 3 * h, dtype=dt), torch.zeros(3 * h, h, dtype=dt),
            torch.zeros(3 * h, dtype=dt), torch.zeros(1, h))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_kernel_admits_every_earlier_hidden_size(dtype):
    """gru_fwd's argument check follows the walk kernel's shared-memory
    formula: it takes every H the first template took, and refuses the
    first H past the new limit before any launch."""
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    assert gru_cuda.walk_shared_bytes(WALK_MAX_HIDDEN[dtype], item) <= gru_cuda.MAX_SHARED_BYTES
    assert gru_cuda.walk_shared_bytes(WALK_MAX_HIDDEN[dtype] + 1, item) > gru_cuda.MAX_SHARED_BYTES
    for h in range(1, WALK_MAX_HIDDEN[dtype] + 1):
        assert gru_cuda._check_cuda_args(*_walk_args(h, dtype), fb=False) == (1, 1, 1, h)
    assert WALK_MAX_HIDDEN[dtype] >= FIRST_MAX_HIDDEN[dtype]
    assert gru_cuda.shared_bytes(FIRST_MAX_HIDDEN[dtype], item) <= gru_cuda.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        gru_cuda._check_cuda_args(*_walk_args(WALK_MAX_HIDDEN[dtype] + 1, dtype), fb=False)


@pytest.mark.parametrize("hidden", [16, 64, 65, 128])
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("batch", [1, 5, 63, 64, 65, 256])
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
