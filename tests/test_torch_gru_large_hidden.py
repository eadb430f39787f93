"""The walks at every hidden size the JAX kernels take (past the cluster
walk's limit the grid walk, W held across a group of CTAs spanning the
card, wherever one lane's W fits; the streamed walk past that), on the CPU:
the plans of the six entries (gru_cuda's Python twins of the C plans),
their shared memory for H = 1-1100, the grid plans' co-residency and
exchange workspaces, the argument checks at the new hidden sizes and past
the new limit, the plain versions of all six entries at H = 384 and 512
against the JAX package's Pallas kernels in interpret mode, and fold
grouping at G·H = 768.

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
# The grid walk's last H at B=64 (forward, adjoint), one lane: past it one
# lane's W no longer fits the card's shared memory and the walks stream.
GRID = {"float32": (1408, 1320), "bfloat16": (2112, 2112)}
NEW_HS = (381, 377, 451, 512, 768, 1024)
T, B = 4, 2


def _plan(adjoint, batch, lanes, h, item):
    return (gru_cuda.adj_plan(batch, lanes, 480, h, item) if adjoint
            else gru_cuda.walk_plan(batch, lanes, h, item))


def _check_units(plan, h):
    """Every unit of H in exactly one CTA's slice: the grid walk's G CTAs
    of `resident` units, the others' clusters of ceil(H / cluster)."""
    if plan["instantiation"] == "grid":
        assert plan["streamed"] == 0
        assert (plan["cluster"] - 1) * plan["resident"] < h <= plan["cluster"] * plan["resident"]
        return
    units = gru_cuda.cluster_units(h, plan["cluster"])
    if plan["instantiation"] == "streamed":
        assert plan["cluster"] == gru_cuda.MAX_CLUSTER
        assert plan["resident"] >= 0 and plan["resident"] + plan["streamed"] == units
    else:
        assert plan["resident"] == units and plan["streamed"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twins_pick_one_block_then_cluster_then_streamed(dtype):
    """The forward walk: W in registers to H = 64, one block to 136 / 192,
    a cluster to 380 / 532, then the grid walk (to H = 1100 at B=64 and two
    lanes); the adjoint: one block to 130 / 179, a cluster to 376 / 450,
    then the grid walk. Every plan's units are resident or streamed, and
    only the streamed plans stream any; past the cluster's limit is where
    both the grid and the streamed walk run (walk_streamed, adj_streamed)."""
    item = DTYPES[dtype][2]
    for adjoint, one, most in ((False, *(x[0] for x in (ONE_BLOCK[dtype], CLUSTER[dtype]))),
                               (True, *(x[1] for x in (ONE_BLOCK[dtype], CLUSTER[dtype])))):
        for h in range(1, 1101):
            plan = _plan(adjoint, 64, 2, h, item)
            want = ("registers" if h <= 64 else "one block" if h <= one
                    else "cluster" if h <= most else "grid")
            assert plan["instantiation"] == want, (adjoint, h, plan)
            _check_units(plan, h)
        assert (gru_cuda.adj_streamed if adjoint else gru_cuda.walk_streamed)(most + 1, item)


ORDER = ("registers", "one block", "cluster", "grid", "streamed")


@pytest.mark.parametrize("adjoint", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lanes", [1, 2, 15, 60])
def test_instantiation_order_registers_block_cluster_grid_streamed(lanes, dtype, adjoint):
    """For every H to past the grid walk's limit (every H at B=64, every
    7th at B = 1 and 256): the instantiation never goes back in the order
    registers, one block, cluster, grid, streamed; the grid walk takes over
    right after the cluster's limit, and at B=64 and one lane it holds to
    GRID's H, streamed one past it."""
    item = DTYPES[dtype][2]
    most = CLUSTER[dtype][adjoint]
    last = GRID[dtype][adjoint]
    for batch in (1, 64, 256):
        seen = 0
        for h in range(1, last + 40):
            if batch != 64 and h % 7 and h not in (most + 1, last, last + 1):
                continue
            plan = _plan(adjoint, batch, lanes, h, item)
            kind = ORDER.index(plan["instantiation"])
            assert kind >= seen, (batch, h, plan)
            seen = kind
            _check_units(plan, h)
            if h == most + 1:
                assert plan["instantiation"] == "grid", (batch, h, plan)
            if lanes == 1 and batch == 64 and h in (last, last + 1):
                assert plan["instantiation"] == ("grid" if h == last else "streamed"), (h, plan)


@pytest.mark.parametrize("adjoint", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 64, 256])
def test_grid_plans_fit_and_are_co_resident(batch, dtype, adjoint):
    """Every grid plan to past its limit, at 1, 2, 15 and 60 lanes: a CTA's
    shared bytes within the card's 232,448 (the adjoint's plan also covers
    its K-tiled pre-pass), its threads whole warps within GRID_THREADS,
    the groups' CTAs one an SM (G x groups <= 132), no more groups than
    work items, and passes of whole thread row groups covering the item's
    rows; where no group fits, the plan is the streamed walk's."""
    item = DTYPES[dtype][2]
    for lanes in (1, 2, 15, 60):
        for h in range(CLUSTER[dtype][adjoint] + 1, GRID[dtype][adjoint] + 40, 3):
            grid = gru_cuda.grid_plan(batch, lanes, h, item, adjoint)
            plan = _plan(adjoint, batch, lanes, h, item)
            if grid is None:
                assert plan["instantiation"] == "streamed", (lanes, h, plan)
                continue
            assert plan["instantiation"] == "grid"
            assert grid["smem"] <= gru_cuda.MAX_SHARED_BYTES
            assert plan["shared_bytes"] <= gru_cuda.MAX_SHARED_BYTES
            assert grid["threads"] % 32 == 0 and 0 < grid["threads"] <= gru_cuda.GRID_THREADS[adjoint]
            assert grid["ctas"] * grid["groups"] <= gru_cuda.NUM_SMS, (lanes, h, grid)
            items = lanes * -(-batch // grid["rows"])
            assert grid["groups"] <= items and grid["rows"] == min(batch, 64)
            assert grid["pass_rows"] % gru_cuda.GRID_ROWS == 0
            assert (plan["groups"], plan["threads"]) == (grid["groups"], grid["threads"])


@pytest.mark.parametrize("adjoint", [False, True], ids=["forward", "adjoint"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_exchange_workspace(dtype, adjoint):
    """The grid walk's workspace: the exchange buffers [groups, 2, rows, K
    padded to the plan's K tile] (K = H forward, 3H adjoint) in the stream
    dtype, then a 32-bit counter a group, each from a 16-byte boundary: the
    forward's w_pad elements, the adjoint's floats after its factors, dht
    and dW partials (from a 16-byte boundary)."""
    item = DTYPES[dtype][2]
    for h, batch, lanes in ((CLUSTER[dtype][adjoint] + 1, 64, 1), (1024, 64, 2),
                            (1024, 256, 15), (777, 5, 3)):
        grid = gru_cuda.grid_plan(batch, lanes, h, item, adjoint)
        assert grid["kt"] in gru_cuda.GRID_KTS
        k = -(-(3 * h if adjoint else h) // grid["kt"]) * grid["kt"]
        assert grid["exchange"] == grid["groups"] * 2 * grid["rows"] * k
        nbytes = -(-grid["exchange"] * item // 16) * 16 + -(-grid["groups"] * 4 // 16) * 16
        assert gru_cuda.grid_workspace_bytes(grid, item) == nbytes
        if adjoint:
            rows, parts = lanes * 5 * batch, gru_cuda.adj_partials(lanes, 5, batch, h)[1]
            base = rows * h * 7 + lanes * parts * 3 * h * h
            assert gru_cuda.adj_workspace_floats(lanes, 5, batch, h, item) == (
                -(-base // 4) * 4 + nbytes // 4)
        else:
            assert gru_cuda.walk_workspace_elems(batch, lanes, h, item) == nbytes // item


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
    padded to 4] in the stream dtype from a 16-byte boundary; the one-block
    and cluster instantiations need none of either (the grid walk's:
    test_grid_exchange_workspace). Both stream past the grid walk's limit.
    At F=15, T=480, B=64 the adjoint's workspace is ~6.7 GB at H=512 and
    ~13.4 GB at H=1024, under 20 GB (its factors and one dW partial a lane:
    the lanes' dW tiles fill the SMs without splitting the rows)."""
    assert gru_cuda.walk_workspace_elems(3, 2, 380, 4) == 0
    assert gru_cuda.walk_plan(3, 2, 1600, 4)["instantiation"] == "streamed"
    assert gru_cuda.walk_workspace_elems(3, 2, 1600, 4) == 2 * 3 * 1600 * 1600
    assert gru_cuda.walk_workspace_elems(3, 2, 512, 2) == 0
    base = gru_cuda.adj_workspace_floats(2, 5, 3, 376, 4)
    rows = 2 * 5 * 3
    parts = gru_cuda.adj_partials(2, 5, 3, 376)[1]
    assert base == rows * 376 * 7 + 2 * parts * 3 * 376 * 376
    parts = gru_cuda.adj_partials(2, 5, 3, 450)[1]
    assert gru_cuda.adj_workspace_floats(2, 5, 3, 450, 2) == (
        rows * 450 * 7 + 2 * parts * 3 * 450 * 450)
    h = 2600
    assert gru_cuda.adj_plan(3, 2, 5, h, 2)["instantiation"] == "streamed"
    got = gru_cuda.adj_workspace_floats(2, 5, 3, h, 2)
    plain = rows * h * 7 + 2 * gru_cuda.adj_partials(2, 5, 3, h)[1] * 3 * h * h
    assert got == -(-plain // 4) * 4 + -(-2 * h * (3 * h) * 2 // 16) * 4
    assert gru_cuda.adj_partials(15, 480, 64, 512) == gru_cuda.adj_partials(15, 480, 64, 1024) == (
        480 * 64, 1)
    assert 6e9 < gru_cuda.adj_workspace_floats(15, 480, 64, 512) * 4 < 7e9
    assert 13e9 < gru_cuda.adj_workspace_floats(15, 480, 64, 1024) * 4 < 14e9 < 20e9


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
    with a message that names the limit; the limit lies far past 1024 and
    is where it was before the grid walk (which moves no limit), and the H at the
    grid walk's ends are taken too."""
    item = DTYPES[dtype][2]
    adjoint = entry in ("gru_bwd", "gru_bwd_fb", "gru_bibwd")
    limit = gru_cuda.adj_max_hidden(item) if adjoint else gru_cuda.walk_max_hidden(item)
    assert limit == {(False, 4): 21564, (True, 4): 4453, (False, 2): 24452,
                     (True, 2): 4622}[(adjoint, item)]
    ends = tuple(h for d in GRID.values() for h in d) + tuple(h + 1 for d in GRID.values()
                                                              for h in d)
    for h in NEW_HS + ends + (limit,):
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
