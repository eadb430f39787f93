"""On-GPU CUDA kernel tier of the PyTorch port (counterpart of
tests/test_tpu_kernels.py).

Every other test of the port runs the kernels' plain versions on the CPU
(the wrappers take them for CPU tensors); a fault in a hand-written kernel,
its launch or its autograd plumbing would pass them all. This tier holds
the wrappers on CUDA tensors against their plain versions on the same
tensors, on the card: at the flagship shape (B=64 windows, T=480 steps
after the encoder's 16x reduction, H=64) in both walk directions, gradients
through the autograd Functions against autograd through the plain loop,
the single-fold direction-batched layer, fold-batched lanes at a ragged
shape, the port's own instantiation seams (the walk kernels' one block /
cluster / grid boundaries, f32, at a short T), bf16 mode, and the adjoint's
two passes over all T under each adjoint entry (at the seams, ragged and
at H=1024, f32 and bf16; dW and db bitwise over two calls; the pre-pass's
factors read back against their plain version).

Run on a GPU host from the repository's root (tests/conftest.py sets up
JAX, which the GPU machine does not have, hence --noconftest):

    MMS_TEST_CUDA=1 python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_kernels.py -m cuda -q

or through `python -m multimodalsignal_tpu_torch.gpu_ci`. Without a CUDA
device and MMS_TEST_CUDA=1 every test skips. The file imports torch and the
port only.

Tolerances are PERF.md §2's (chip_smoke.py's TOL and BWD_TOL). Forward:
float32 rtol = atol = 1e-5, bfloat16 atol 0.05. Adjoint, (dxg and dh0, dW
and db): float32 1e-4 and rtol 1e-4 + atol 1e-3 (480 dependent steps in
another summation order; dW and db sums of B*T terms), bfloat16 atol 0.05
and rtol 2e-2 + atol 0.1 (one bf16 ulp of the stored dxg; a one-ulp flip of
a bf16-rounded dg moves a dW/db sum by up to ~1e-2).
"""

import os

import pytest
import torch

from multimodalsignal_tpu_torch.models.gru import gru_sequence
from multimodalsignal_tpu_torch.ops import gru_cuda

pytestmark = pytest.mark.cuda

B, T, H = 64, 480, 64
F32, BF16 = torch.float32, torch.bfloat16
FWD_TOL = {F32: dict(rtol=1e-5, atol=1e-5), BF16: dict(rtol=0.0, atol=0.05)}
BWD_TOL = {F32: (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-3)),
           BF16: (dict(rtol=0.0, atol=0.05), dict(rtol=2e-2, atol=0.1))}
ADJOINT_OUTPUTS = ("dxg", "dW", "db", "dh0")
# The walk kernels' seams at T=16, B=64, one lane, float32 (gru_cuda's plan
# twins): the forward walk is in one block to H=136, a cluster to 380, the
# grid walk past it; the adjoint walk in one block to 130, a cluster to 376.
SEAMS = {130: ("one block", "one block"), 131: ("one block", "cluster"),
         136: ("one block", "cluster"), 137: ("cluster", "cluster"),
         376: ("cluster", "cluster"), 377: ("cluster", "grid"),
         380: ("cluster", "grid"), 381: ("grid", "grid")}
SEAM_T = 16


@pytest.fixture(scope="module", autouse=True)
def on_the_card():
    if os.environ.get("MMS_TEST_CUDA") != "1" or not torch.cuda.is_available():
        pytest.skip("CUDA kernel tier: run MMS_TEST_CUDA=1 python -m pytest --noconftest "
                    "tests/test_torch_cuda_kernels.py -m cuda on a GPU host (or python -m "
                    "multimodalsignal_tpu_torch.gpu_ci)")


def _inputs(lanes, t, b, h, dtype=F32, seed=0):
    """Gates N(0, 1), W and b U(-1/sqrt(H), 1/sqrt(H)), h0 N(0, 0.5^2) float32,
    drawn on the card; `lanes` None for the one-lane entries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if lanes is None else (lanes,)
    bound = h ** -0.5

    def uniform(shape):
        return ((torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * bound).to(dtype)

    xg = torch.randn(lead + (t, b, 3 * h), generator=gen, device="cuda").to(dtype)
    h0 = torch.randn(lead + (b, h), generator=gen, device="cuda") * 0.5
    return xg, uniform(lead + (3 * h, h)), uniform(lead + (3 * h,)), h0


def _adjoint_inputs(lanes, t, b, h, dtype=F32, seed=0, reverse=False):
    """_inputs, ys from the plain forward, dy N(0, 1)."""
    xg, w, bias, h0 = _inputs(lanes, t, b, h, dtype, seed)
    fwd = gru_cuda.gru_forward_plain if lanes is None else gru_cuda.gru_forward_fb_plain
    ys = fwd(xg, w, bias, h0, reverse).contiguous()
    dy = _normal(ys.shape, seed + 1).to(dtype)
    return xg, w, bias, h0, ys, dy


def _normal(shape, seed):
    """N(0, 1) float32 on the card from its own seed (cotangents)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, device="cuda", generator=gen)


def _check_forward(got, want, dtype):
    assert got.is_cuda and got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **FWD_TOL[dtype])


def _check_adjoint(got, want, dtype, what=""):
    for name, g, w in zip(ADJOINT_OUTPUTS, got, want):
        assert g.is_cuda and g.shape == w.shape
        assert g.dtype == (dtype if name == "dxg" else F32), (name, g.dtype)
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype][name in ("dW", "db")],
                                   msg=lambda m, name=name: f"{what} {name}: {m}")


FORWARDS = {"gru_fwd": (None, gru_cuda.gru_forward, gru_cuda.gru_forward_plain),
            "gru_fwd_fb": (2, gru_cuda.gru_forward_fb, gru_cuda.gru_forward_fb_plain)}
ADJOINTS = {"gru_bwd": (None, gru_cuda.gru_backward, gru_cuda.gru_backward_plain),
            "gru_bwd_fb": (2, gru_cuda.gru_backward_fb, gru_cuda.gru_backward_fb_plain)}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("entry", sorted(FORWARDS))
def test_forward_flagship(entry, reverse):
    """The forward walk at the flagship shape (one lane, or both directions'
    two lanes) against its plain version, float32."""
    lanes, kernel, plain = FORWARDS[entry]
    args = _inputs(lanes, T, B, H, seed=1)
    _check_forward(kernel(*args, reverse=reverse), plain(*args, reverse=reverse), F32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("entry", sorted(ADJOINTS))
def test_adjoint_flagship(entry, reverse):
    """The adjoint walk at the flagship shape against its plain version:
    dxg, dW, db and dh0, float32."""
    lanes, kernel, plain = ADJOINTS[entry]
    args = _adjoint_inputs(lanes, T, B, H, seed=2, reverse=reverse)
    _check_adjoint(kernel(*args, reverse=reverse), plain(*args, reverse=reverse), F32, entry)


def _grads(fn, inputs, cotangent):
    leaves = [a.detach().clone().requires_grad_(True) for a in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * c).sum() for o, c in zip(outs, cotangent))
    return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)


def _check_grads(got, want, weights: set[int], what: str):
    """Forward outputs at FWD_TOL, gradients at BWD_TOL (f32): the inputs at
    the positions in `weights` (W and b) with dW's tolerance, the gates and
    h0 with dxg's."""
    (ys_got, g_got), (ys_want, g_want) = got, want
    for a, b in zip(ys_got, ys_want):
        _check_forward(a, b, F32)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert a.is_cuda and a.shape == b.shape
        torch.testing.assert_close(a, b, **BWD_TOL[F32][i in weights],
                                   msg=lambda m, i=i: f"{what} gradient {i}: {m}")


@pytest.mark.parametrize("reverse", [False, True])
def test_gradients_through_the_autograd_function(reverse):
    """gru_sequence_cuda (the _GruWalk Function: gru_fwd forward, gru_bwd
    backward) against autograd through the plain loop, batch-major, every
    input's gradient."""
    xg, w, bias, h0 = _inputs(None, T, B, H, seed=3)
    inputs = (xg.transpose(0, 1).contiguous(), w, bias, h0)
    cot = (_normal((B, T, H), 4),)
    got = _grads(lambda *a: gru_cuda.gru_sequence_cuda(*a, reverse=reverse), inputs, cot)
    want = _grads(lambda *a: gru_sequence(*a, reverse=reverse), inputs, cot)
    _check_grads(got, want, {1, 2}, "gru_sequence_cuda")


def test_single_fold_dirbatch():
    """The direction-batched BiGRU layer (gru_impl pallas_db, the flagship
    single-fold path: both directions as two lanes of gru_fwd_fb and
    gru_bwd_fb) against per-direction plain loops, forward and gradients."""
    xf, wf, bf, h0 = _inputs(None, T, B, H, seed=5)
    xb, wb, bb, _ = _inputs(None, T, B, H, seed=6)
    inputs = (xf.transpose(0, 1).contiguous(), xb.transpose(0, 1).contiguous(),
              wf, wb, bf, bb, h0)
    cot = (_normal((B, T, H), 7), _normal((B, T, H), 8))

    def ref(af, ab, wf_, wb_, cf, cb, h):
        return gru_sequence(af, wf_, cf, h), gru_sequence(ab, wb_, cb, h, reverse=True)

    got = _grads(gru_cuda.gru_bidirectional_dirbatch, inputs, cot)
    want = _grads(ref, inputs, cot)
    _check_grads(got, want, {2, 3, 4, 5}, "dirbatch")


def test_fold_lanes_ragged():
    """F=5 lanes at a ragged shape (B=13, T=301, H=16: no multiple of a row
    tile or of 8) through gru_lanes_cuda (_GruWalkFb) against the plain loop
    over the same lanes, time reversed, forward and gradients."""
    inputs = _inputs(5, 301, 13, 16, seed=8)
    cot = (_normal((5, 301, 13, 16), 9),)
    got = _grads(lambda *a: gru_cuda.gru_lanes_cuda(*a, reverse=True, group=False),
                 inputs, cot)
    want = _grads(lambda *a: gru_sequence(*a, reverse=True), inputs, cot)
    _check_grads(got, want, {1, 2}, "fold lanes")


@pytest.mark.parametrize("hidden", sorted(SEAMS))
def test_instantiation_seams(hidden):
    """Each side of the walk kernels' one block / cluster / grid seams,
    float32, T=16, B=64: the plan the wrappers take, then gru_fwd and
    gru_bwd against their plain versions."""
    fwd_kind, adj_kind = SEAMS[hidden]
    assert gru_cuda.walk_plan(B, 1, hidden, 4)["instantiation"] == fwd_kind
    assert gru_cuda.adj_plan(B, 1, SEAM_T, hidden, 4)["instantiation"] == adj_kind
    args = _inputs(None, SEAM_T, B, hidden, seed=hidden)
    _check_forward(gru_cuda.gru_forward(*args), gru_cuda.gru_forward_plain(*args), F32)
    args = _adjoint_inputs(None, SEAM_T, B, hidden, seed=hidden)
    _check_adjoint(gru_cuda.gru_backward(*args), gru_cuda.gru_backward_plain(*args), F32,
                   f"gru_bwd H={hidden}")


def test_bf16_mode_flagship():
    """bf16 streams and weights with an f32 carry: the forward against its
    bf16 plain version and within bf16 round-off of the f32 kernel, keeping
    the dtype; the two-lane adjoint against its bf16 plain version."""
    xg, w, bias, h0 = _inputs(None, T, B, H, seed=10)
    want32 = gru_cuda.gru_forward(xg, w, bias, h0)
    to16 = (xg.to(BF16), w.to(BF16), bias.to(BF16), h0)
    got = gru_cuda.gru_forward(*to16)
    _check_forward(got, gru_cuda.gru_forward_plain(*to16), BF16)
    torch.testing.assert_close(got.float(), want32, rtol=0.0, atol=0.05)
    args = _adjoint_inputs(2, T, B, H, BF16, seed=11)
    _check_adjoint(gru_cuda.gru_backward_fb(*args), gru_cuda.gru_backward_fb_plain(*args),
                   BF16, "gru_bwd_fb bf16")


def test_fused_pair_flagship():
    """gru_bifwd and gru_bibwd (gru_impl pallas_fused, float32) at the
    flagship shape, two lanes, against their plain versions."""
    xg, w, bias, h0 = _inputs(2, T, B, H, seed=12)
    xg2 = xg.transpose(0, 1).contiguous()                   # [T, 2, B, 3H]
    ys2 = gru_cuda.gru_bifwd(xg2, w, bias, h0)
    _check_forward(ys2, gru_cuda.gru_bifwd_plain(xg2, w, bias, h0), F32)
    dy2 = _normal(ys2.shape, 13)
    args = (xg2, w, bias, h0, gru_cuda.gru_bifwd_plain(xg2, w, bias, h0), dy2)
    _check_adjoint(gru_cuda.gru_bibwd(*args), gru_cuda.gru_bibwd_plain(*args), F32, "gru_bibwd")


# The adjoint's two passes over all T (the gate pre-pass and the
# weight-gradient pass, tensor cores: 3xTF32 in f32, bf16 mma in bf16) under
# each adjoint entry, as (T, B, H): the adjoint walk's seams (one block /
# cluster at 130 / 131, cluster / grid at 376 / 377 f32 and 450 / 451 bf16),
# ragged T * B with H not a multiple of 8 or 32, and H=1024 (the pre-pass's
# streamed W chunks, eight unit tiles of dW, one row chunk).
PASS_SHAPES = [(SEAM_T, B, 130), (SEAM_T, B, 131), (SEAM_T, B, 376), (SEAM_T, B, 377),
               (SEAM_T, B, 450), (SEAM_T, B, 451), (37, 5, 40), (37, 5, 63), (SEAM_T, B, 1024)]
PASS_ENTRIES = {"gru_bwd": (None, gru_cuda.gru_backward, gru_cuda.gru_backward_plain),
                "gru_bwd_fb": (2, gru_cuda.gru_backward_fb, gru_cuda.gru_backward_fb_plain),
                "gru_bibwd": (2, gru_cuda.gru_bibwd, gru_cuda.gru_bibwd_plain)}


def _entry_args(entry, t, b, h, dtype, seed):
    lanes = PASS_ENTRIES[entry][0]
    if entry != "gru_bibwd":
        return _adjoint_inputs(lanes, t, b, h, dtype, seed=seed)
    xg, w, bias, h0 = _inputs(2, t, b, h, seed=seed)
    xg2 = xg.transpose(0, 1).contiguous()                   # [T, 2, B, 3H]
    ys2 = gru_cuda.gru_bifwd_plain(xg2, w, bias, h0)
    return xg2, w, bias, h0, ys2, _normal(ys2.shape, seed + 1)


@pytest.mark.parametrize("shape", PASS_SHAPES, ids=lambda s: "T%d-B%d-H%d" % s)
@pytest.mark.parametrize("entry,dtype", [("gru_bwd", F32), ("gru_bwd", BF16),
                                         ("gru_bwd_fb", F32), ("gru_bwd_fb", BF16),
                                         ("gru_bibwd", F32)],
                         ids=["gru_bwd-f32", "gru_bwd-bf16", "gru_bwd_fb-f32", "gru_bwd_fb-bf16",
                              "gru_bibwd-f32"])
def test_adjoint_passes(entry, dtype, shape):
    """Each adjoint entry against its plain version at BWD_TOL at PASS_SHAPES
    (gru_bibwd float32 only), whatever walk its plan takes there."""
    _, kernel, plain = PASS_ENTRIES[entry]
    args = _entry_args(entry, *shape, dtype, seed=shape[2])
    _check_adjoint(kernel(*args), plain(*args), dtype, f"{entry} {shape}")


@pytest.mark.parametrize("hidden", [H, 1024])
@pytest.mark.parametrize("entry,dtype", [("gru_bwd", F32), ("gru_bwd", BF16),
                                         ("gru_bwd_fb", F32), ("gru_bwd_fb", BF16),
                                         ("gru_bibwd", F32)],
                         ids=["gru_bwd-f32", "gru_bwd-bf16", "gru_bwd_fb-f32", "gru_bwd_fb-bf16",
                              "gru_bibwd-f32"])
def test_adjoint_weight_gradients_bitwise_over_two_calls(entry, dtype, hidden):
    """dW and db are the same bits over two calls on the same inputs (no
    atomics; each chunk's partial and the chunks' sum in a fixed order)."""
    kernel = PASS_ENTRIES[entry][1]
    args = _entry_args(entry, SEAM_T, B, hidden, dtype, seed=20)
    first, second = kernel(*args), kernel(*args)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_prepass_factors(dtype, reverse):
    """The gate pre-pass's six factors, read back from gru_bwd_fb's
    workspace (15 lanes at the flagship shape, and 2 lanes at H=256),
    against its plain version: float32 rtol = atol = 1e-5 (3xTF32 products),
    bfloat16 at BWD_TOL's dxg tolerance."""
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == F32 else BWD_TOL[BF16][0]
    for lanes, hidden in ((15, H), (2, 256)):
        args = _adjoint_inputs(lanes, T, B, hidden, dtype, seed=30)
        got = gru_cuda.adj_factors_cuda(*args, reverse=reverse)
        torch.testing.assert_close(got, gru_cuda.adj_factors_plain(*args, reverse=reverse), **tol)


def test_tier_is_really_on_the_card():
    """Guard against running this tier where it proves nothing: the card is
    there, the tier was asked for, and every kernel entry was launched by
    the tests above (the wrappers count launches on CUDA tensors only; the
    plain versions count nothing)."""
    assert os.environ.get("MMS_TEST_CUDA") == "1"
    assert torch.cuda.is_available() and torch.zeros(1, device="cuda").is_cuda
    counts = gru_cuda.launch_counts()
    assert all(n > 0 for n in counts.values()), counts
