"""The walks at every hidden size the JAX kernels take (the streamed walk
past the cluster walk's limit), on the CPU: the plans of the six entries
(gru_cuda's Python twins of the C plans), their shared memory for H = 1-1100,
the argument checks at the new hidden sizes and past the new limit, the
plain versions of all six entries at H = 384 and 512 against the JAX
package's Pallas kernels in interpret mode, and fold grouping at G·H = 768.

Tolerances are those of tests/test_torch_gru.py (forward: float32 rtol =
atol = 1e-5; bfloat16 atol 0.05 on bf16 outputs), tests/test_torch_gru_backward.py
(adjoint (dxg, dh0, dW/db): float32 1e-5, 1e-5, 1e-4; bfloat16 0.05, 1e-2,
5e-2) and tests/test_torch_gru_fused.py (the fused pair: ys2, dxg2, dh0
1e-5; dW, db 1e-4), and tests/test_torch_fold_group.py for grouping (rtol
1e-4, atol 1e-5)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsignal_tpu.ops import gru_pallas
from multimodalsignal_tpu_torch.ops import gru_cuda

DTYPES = {"float32": (torch.float32, jnp.float32, 4), "bfloat16": (torch.bfloat16, jnp.bfloat16, 2)}
# The one-block limits (forward, adjoint) and the cluster limits, by dtype.
ONE_BLOCK = {"float32": (136, 130), "bfloat16": (192, 179)}
CLUSTER = {"float32": (380, 376), "bfloat16": (532, 450)}
NEW_HS = (381, 377, 451, 512, 768, 1024)
T, B = 4, 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twins_pick_one_block_then_cluster_then_streamed(dtype):
    """The forward walk: W in registers to H = 64, one block to 136 / 192,
    a cluster to 380 / 532, streamed above; the adjoint: one block to
    130 / 179, a cluster to 376 / 450, streamed above. Every plan's units
    are resident or streamed, and only the streamed plans stream any."""
    item = DTYPES[dtype][2]
    for adjoint, one, most in ((False, *(x[0] for x in (ONE_BLOCK[dtype], CLUSTER[dtype]))),
                               (True, *(x[1] for x in (ONE_BLOCK[dtype], CLUSTER[dtype])))):
        for h in range(1, 1101):
            plan = (gru_cuda.adj_plan(64, 2, 480, h, item) if adjoint
                    else gru_cuda.walk_plan(64, 2, h, item))
            want = ("registers" if h <= 64 else "one block" if h <= one
                    else "cluster" if h <= most else "streamed")
            assert plan["instantiation"] == want, (adjoint, h, plan)
            units = gru_cuda.cluster_units(h, plan["cluster"])
            if want == "streamed":
                assert plan["cluster"] == gru_cuda.MAX_CLUSTER
                assert plan["resident"] >= 0 and plan["resident"] + plan["streamed"] == units
            else:
                assert plan["resident"] == units and plan["streamed"] == 0
        assert (gru_cuda.adj_streamed if adjoint else gru_cuda.walk_streamed)(most + 1, item)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_bytes_fit_for_every_hidden_size_to_1100(dtype):
    """Per-CTA shared memory within the card's for H = 1-1100, at the most
    rows a tile takes and at the row tile of every (batch, lanes) the
    port's callers use; a streamed tile never takes more rows than fit."""
    item = DTYPES[dtype][2]
    for h in range(1, 1101):
        assert gru_cuda.walk_shared_bytes(h, item) <= gru_cuda.MAX_SHARED_BYTES, h
        assert gru_cuda.adj_shared_bytes(h, item) <= gru_cuda.MAX_SHARED_BYTES, h
        if h % 11 == 0 or h in NEW_HS:
            for batch, lanes in ((1, 1), (64, 1), (64, 2), (64, 15), (256, 2), (64, 60)):
                for plan in (gru_cuda.walk_plan(batch, lanes, h, item),
                             gru_cuda.adj_plan(batch, lanes, 480, h, item)):
                    assert plan["shared_bytes"] <= gru_cuda.MAX_SHARED_BYTES, (h, plan)
                    assert plan["rows"] & (plan["rows"] - 1) == 0


def test_streamed_workspaces():
    """The streamed forward's w_pad holds W padded [lanes, 3H, K padded to
    4]; the streamed adjoint's workspace adds W^T padded [lanes, H, 3H
    padded to 4] in the stream dtype from a 16-byte boundary; the other
    instantiations need none of either. At F=15, T=480, B=64 the adjoint's
    workspace is ~12 GB at H=512 and ~36 GB at H=1024."""
    assert gru_cuda.walk_workspace_elems(2, 380, 4) == 0
    assert gru_cuda.walk_workspace_elems(2, 381, 4) == 2 * 3 * 381 * 384
    assert gru_cuda.walk_workspace_elems(2, 512, 2) == 0
    base = gru_cuda.adj_workspace_floats(2, 5, 3, 376, 4)
    rows, parts = 2 * 5 * 3, gru_cuda.adj_partials(5, 3)[1]
    assert base == rows * 376 * 7 + 2 * parts * 3 * 376 * 376
    assert gru_cuda.adj_workspace_floats(2, 5, 3, 450, 2) == (
        rows * 450 * 7 + 2 * parts * 3 * 450 * 450)
    got = gru_cuda.adj_workspace_floats(2, 5, 3, 451, 2)
    plain = rows * 451 * 7 + 2 * parts * 3 * 451 * 451
    assert got == -(-plain // 4) * 4 + -(-2 * 451 * 1356 * 2 // 16) * 4
    assert 11e9 < gru_cuda.adj_workspace_floats(15, 480, 64, 512) * 4 < 13e9
    assert 35e9 < gru_cuda.adj_workspace_floats(15, 480, 64, 1024) * 4 < 37e9


def _meta_args(entry, h, dtype):
    """Arguments of an entry's check at H on the meta device (the checks
    read shapes, dtypes and layouts only)."""
    dt = DTYPES[dtype][0]
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


def _check(entry, args):
    if entry == "gru_bifwd":
        return gru_cuda._check_bi_args(*args, gru_cuda.walk_shared_bytes)
    if entry == "gru_bibwd":
        return gru_cuda._check_bi_args(*args[:4], gru_cuda.adj_shared_bytes, ys2=args[4],
                                       dy2=args[5])
    if entry.startswith("gru_bwd"):
        return gru_cuda._check_bwd_args(*args, fb=entry.endswith("_fb"))
    return gru_cuda._check_cuda_args(*args, fb=entry.endswith("_fb"))


ENTRIES = [("gru_fwd", "float32"), ("gru_fwd", "bfloat16"), ("gru_fwd_fb", "float32"),
           ("gru_fwd_fb", "bfloat16"), ("gru_bifwd", "float32"), ("gru_bwd", "float32"),
           ("gru_bwd", "bfloat16"), ("gru_bwd_fb", "float32"), ("gru_bwd_fb", "bfloat16"),
           ("gru_bibwd", "float32")]


@pytest.mark.parametrize("entry,dtype", ENTRIES)
def test_checks_take_the_new_hidden_sizes_and_refuse_past_the_limit(entry, dtype):
    """Every entry's check takes H = 381, 377, 451, 512, 768 and 1024 and
    refuses the first H past the streamed walk's limit before any launch,
    with a message that names the limit; the limit lies far past 1024."""
    item = DTYPES[dtype][2]
    adjoint = entry in ("gru_bwd", "gru_bwd_fb", "gru_bibwd")
    limit = gru_cuda.adj_max_hidden(item) if adjoint else gru_cuda.walk_max_hidden(item)
    assert limit > 4 * 1024 if adjoint else limit > 16 * 1024
    for h in NEW_HS + (limit,):
        assert _check(entry, _meta_args(entry, h, dtype))[-1] == h
    with pytest.raises(ValueError, match=f"step buffers at one row.*H up to {limit}$"):
        _check(entry, _meta_args(entry, limit + 1, dtype))


def _inputs(seed, lead, h, t=T, b=B):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal(lead + (t, b, 3 * h)).astype(np.float32)
    w = (rng.standard_normal(lead + (3 * h, h)) / np.sqrt(h)).astype(np.float32)
    bias = (rng.standard_normal(lead + (3 * h,)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal(lead + (b, h)) * 0.5).astype(np.float32)
    dy = rng.standard_normal(lead + (t, b, h)).astype(np.float32)
    return xg, w, bias, h0, dy


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("h", [384, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fb", [False, True], ids=["single", "fb"])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_walk_and_adjoint_match_pallas(h, dtype, fb, reverse):
    """gru_fwd / gru_fwd_fb and gru_bwd / gru_bwd_fb (F=2): the plain
    versions, which the wrappers run on CPU tensors, against _gru_forward
    (_fb) and _gru_backward (_fb) in interpret mode, T=4, B=2."""
    tdt, jdt, _ = DTYPES[dtype]
    lead = (2,) if fb else ()
    xg, w, bias, h0, dy = _inputs(h + 2 * fb + reverse, lead, h)
    jx, jw, jb, jdy = (jnp.asarray(a, jdt) for a in (xg, w, bias, dy))
    jh0 = jnp.asarray(h0)
    fwd = gru_pallas._gru_forward_fb if fb else gru_pallas._gru_forward
    bwd = gru_pallas._gru_backward_fb if fb else gru_pallas._gru_backward
    jys = fwd(jx, jw, jb, jh0, reverse)
    want = bwd(jx, jw, jb, jh0, jys, jdy, reverse)
    args = [torch.from_numpy(a).to(tdt) for a in (xg, w, bias)] + [torch.from_numpy(h0)]
    plain_fwd = gru_cuda.gru_forward_fb if fb else gru_cuda.gru_forward
    ys = plain_fwd(*args, reverse=reverse)
    assert ys.dtype == tdt
    fwd_tol = (0.05, 0.0) if dtype == "bfloat16" else (1e-5, 1e-5)
    _close(ys, jys, *fwd_tol, "ys")
    ys_j = torch.from_numpy(np.array(jnp.asarray(jys, jnp.float32))).to(tdt)
    plain_bwd = gru_cuda.gru_backward_fb if fb else gru_cuda.gru_backward
    got = plain_bwd(*args, ys_j, torch.from_numpy(dy).to(tdt), reverse=reverse)
    t_dxg, t_dh0, t_dw = {"float32": (1e-5, 1e-5, 1e-4), "bfloat16": (0.05, 1e-2, 5e-2)}[dtype]
    f32 = dtype == "float32"
    for g, w_, atol, what in zip(got, want, (t_dxg, t_dw, t_dw, t_dh0),
                                 ("dxg", "dW", "db", "dh0")):
        _close(g, w_, atol, atol if f32 and atol < 1e-4 else 0.0, what)


@pytest.mark.parametrize("h", [384, 512])
def test_plain_fused_pair_matches_pallas(h):
    """gru_bifwd and gru_bibwd (float32, both directions as two lanes)
    against _bigru_forward / _bigru_backward in interpret mode, T=4, B=2."""
    rng = np.random.default_rng(h)
    xg2 = rng.standard_normal((T, 2, B, 3 * h)).astype(np.float32)
    whh2 = (rng.standard_normal((2, 3 * h, h)) / np.sqrt(h)).astype(np.float32)
    bhh2 = (rng.standard_normal((2, 3 * h)) * 0.1).astype(np.float32)
    h02 = (rng.standard_normal((2, B, h)) * 0.5).astype(np.float32)
    dy2 = rng.standard_normal((T, 2, B, h)).astype(np.float32)
    j = [jnp.asarray(a) for a in (xg2, whh2, bhh2, h02)]
    jys2 = gru_pallas._bigru_forward(*j)
    want = gru_pallas._bigru_backward(*j, jys2, jnp.asarray(dy2))
    args = [torch.from_numpy(a) for a in (xg2, whh2, bhh2, h02)]
    _close(gru_cuda.gru_bifwd(*args), jys2, 1e-5, 1e-5, "ys2")
    got = gru_cuda.gru_bibwd(*args, torch.from_numpy(np.asarray(jys2)), torch.from_numpy(dy2))
    for g, w_, tol, what in zip(got, want, (1e-5, 1e-4, 1e-4, 1e-5),
                                ("dxg2", "dW", "db", "dh0")):
        _close(g, w_, tol, tol, what)


@pytest.mark.parametrize("reverse", [False, True])
def test_fold_grouping_at_768_equals_ungrouped(reverse, monkeypatch):
    """MMS_GRU_FOLD_GROUP=3 at H=256: three folds walk as one lane of
    G·H = 768 (past the cluster walk's limit: the streamed walk on the
    card), and ys and the gradients of xg, W_hh, b_hh and h0 equal the
    ungrouped walk's."""
    h, folds = 256, 3
    arrays = _inputs(7 + reverse, (folds,), h)[:4]
    seen = []
    real = gru_cuda.gru_forward_fb

    def walk(xg, *args, **kwargs):
        seen.append(tuple(xg.shape))
        return real(xg, *args, **kwargs)

    monkeypatch.setattr(gru_cuda, "gru_forward_fb", walk)
    runs = []
    for group in ("1", "3"):
        monkeypatch.setenv(gru_cuda.FOLD_GROUP_ENV, group)
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        ys = gru_cuda.gru_lanes_cuda(*ts, reverse=reverse)
        ys.square().sum().backward()
        runs.append([ys.detach()] + [t.grad for t in ts])
    assert seen == [(folds, T, B, 3 * h), (1, T, B, 3 * folds * h)]
    assert gru_cuda.walk_streamed(folds * h, 4)
    for name, g, w_ in zip(("ys", "dxg", "dW_hh", "db_hh", "dh0"), runs[1], runs[0]):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
