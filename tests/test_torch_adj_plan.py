"""The adjoint walk's plan (gru_cuda's Python twins of csrc/gru_bwd.cu's
adj_choose), on the CPU: at every H of 1-1100, B = 1, 37, 64, 256 and 1, 2
and 15 lanes, in both dtypes, the choice is the candidate of the least
modelled time among those that fit the shape (every tile of the one-block
and cluster walks, the grid walk where its plan takes the shape; W in
registers up to H = 64, the streamed walk where neither fits); the chosen
walk's shared memory and threads fit the card; the workspace holds the
grid walk's exchange wherever the grid walk is chosen; a forced candidate's
plan (adj_candidate_plan) agrees with the choice's. No kernel runs: the
plans are arithmetic on shapes, and chip_smoke.py holds the C plan equal
to these twins on the card."""

import pytest

from multimodalsignal_tpu_torch.ops import gru_cuda

HS = range(1, 1101)
BATCHES = (1, 37, 64, 256)
LANES = (1, 2, 15)
ITEMS = {"float32": 4, "bfloat16": 2}


def _cheapest(batch, lanes, h, item):
    """The least modelled candidate by hand: the walk's tiles first (the
    smaller K, then R, on a tie), the grid walk only when strictly
    cheaper."""
    cands = gru_cuda.adj_candidates(batch, lanes, h, item)
    costs = [(gru_cuda.adj_candidate_cost(batch, lanes, h, item, *c), i, c)
             for i, c in enumerate(cands)]
    return min(costs)[2] if costs else None


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("dtype", sorted(ITEMS))
def test_choice_is_the_least_modelled_candidate(dtype, batch, lanes):
    """Above H = 64 the plan's instantiation and tile are those of the
    candidate with the least modelled picoseconds (a tie to the walk's
    smaller K, then R, before the grid walk); W in registers to H = 64; the
    streamed walk only where no candidate fits. The candidates are the
    walk's tiles while adj_walk_takes (to 376 f32, 522 bf16) and the grid
    walk wherever grid_plan takes the shape."""
    item = ITEMS[dtype]
    for h in HS:
        kind, tile, grid = gru_cuda.adj_choice(batch, lanes, h, item)
        if h <= gru_cuda.WALK_REG_MAX_HIDDEN:
            assert kind == "registers" and grid is None, (h, kind)
            assert gru_cuda.adj_candidates(batch, lanes, h, item) == []
            continue
        best = _cheapest(batch, lanes, h, item)
        if best is None:
            assert kind == "streamed", (h, kind)
            continue
        assert (kind, *tile) == best, (h, kind, tile, best)
        assert (grid is not None) == (kind == "grid")
        walk = [c for c in gru_cuda.adj_candidates(batch, lanes, h, item) if c[0] != "grid"]
        assert bool(walk) == gru_cuda.adj_walk_takes(h, item)
        if walk:
            k, r = gru_cuda.adj_walk_tile(batch, lanes, h, item)
            assert ("one block" if k == 1 else "cluster", k, r) in walk


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("dtype", sorted(ITEMS))
def test_chosen_walk_fits_the_card(dtype, batch, lanes):
    """The chosen walk's shared bytes (its kernels' most, the passes'
    included) within the card's 232,448; its CTA's threads within the
    launch bound of its instantiation (768 one block, 576 a cluster's CTA,
    the grid walk's 384); the grid walk's groups one CTA an SM; a cluster
    of at most 8 CTAs, a tile of 1, 2 or 4 rows."""
    item = ITEMS[dtype]
    for h in HS:
        plan = gru_cuda.adj_plan(batch, lanes, 480, h, item)
        kind, (cluster, rows), grid = gru_cuda.adj_choice(batch, lanes, h, item)
        assert plan["instantiation"] == kind and (plan["cluster"], plan["rows"]) == (cluster, rows)
        assert plan["shared_bytes"] <= gru_cuda.MAX_SHARED_BYTES, (h, plan)
        if kind == "grid":
            assert 0 < grid["threads"] <= gru_cuda.GRID_THREADS[True]
            assert grid["ctas"] * grid["groups"] <= gru_cuda.NUM_SMS
            assert plan["shared_bytes"] == max(grid["smem"], gru_cuda._adj_pass_bytes(item))
        elif kind in ("one block", "cluster"):
            assert rows in (1, 2, 4) and 1 <= cluster <= gru_cuda.MAX_CLUSTER
            bound = gru_cuda.MAX_THREADS if cluster == 1 else gru_cuda.CLUSTER_MAX_THREADS
            assert gru_cuda._adj_threads(h, cluster) <= bound
            assert gru_cuda._adj_walk_bytes(h, item, rows, cluster) <= gru_cuda.MAX_SHARED_BYTES
            assert (kind == "one block") == (gru_cuda.adj_cluster_size(h, item) == 1)
        elif kind == "registers":
            assert cluster == 1 and rows in (1, 2)
            assert gru_cuda._adj_threads(h, 1) <= gru_cuda.MAX_THREADS


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("dtype", sorted(ITEMS))
def test_workspace_holds_the_chosen_walks_buffers(dtype, batch, lanes):
    """The workspace (adj_workspace_floats, at T=7): the factors, dht and
    dW partials, then from a 16-byte boundary the grid walk's exchange
    buffers and counters wherever the grid walk is chosen, W^T padded where
    the streamed walk is, nothing more for the others; a forced
    candidate's workspace (adj_candidate_plan) is its instantiation's, and
    the chosen candidate's is the plan's."""
    item, t = ITEMS[dtype], 7
    for h in range(1, 1101, 3):
        rows_all = lanes * t * batch
        parts = gru_cuda.adj_partials(lanes, t, batch, h)[1]
        base = rows_all * h * 7 + lanes * parts * 3 * h * h
        kind, tile, grid = gru_cuda.adj_choice(batch, lanes, h, item)
        got = gru_cuda.adj_workspace_floats(lanes, t, batch, h, item)
        if kind == "grid":
            assert got == -(-base // 4) * 4 + gru_cuda.grid_workspace_bytes(grid, item) // 4
            assert got * 4 - -(-base // 4) * 16 >= grid["exchange"] * item + grid["groups"] * 4
        elif kind == "streamed":
            assert got == -(-base // 4) * 4 + -(-lanes * h * (-(-3 * h // 4) * 4) * item // 16) * 4
        else:
            assert got == base
        for cand in gru_cuda.adj_candidates(batch, lanes, h, item):
            plan = gru_cuda.adj_candidate_plan(batch, lanes, t, h, item, *cand)
            assert plan["fits"]
            assert plan["workspace"] == gru_cuda.adj_workspace_floats(lanes, t, batch, h, item,
                                                                      cand[0])
            if (cand[0], *cand[1:]) == (kind, *tile):
                assert plan["workspace"] == got
                assert plan["cost"] == gru_cuda.adj_candidate_cost(batch, lanes, h, item, *cand)


@pytest.mark.parametrize("dtype", sorted(ITEMS))
def test_candidate_plans_refuse_what_does_not_fit(dtype):
    """A forced tile outside adj_candidates (more rows than 4, a cluster
    below the least or past 8, a one-block tile where W^T does not fit one
    block, the walk past its limit, the grid walk past its own) is refused
    (fits False, zeros), as the C entry refuses it before any launch."""
    item = ITEMS[dtype]
    least = gru_cuda.adj_cluster_size(256, item)
    for kind, k, r in (("cluster", least, 8), ("cluster", least - 1, 1), ("cluster", 9, 1),
                       ("one block", 1, 1), ("cluster", 8, 1)):
        h = 256 if (kind, k) != ("cluster", 8) else gru_cuda.adj_max_hidden(item)
        plan = gru_cuda.adj_candidate_plan(64, 2, 480, h, item, kind, k, r)
        assert not plan["fits"] and plan["cost"] == plan["workspace"] == 0, (kind, k, r, plan)
    assert not gru_cuda.adj_candidate_plan(64, 1, 480, 3000, item, "grid", 0, 0)["fits"]
    assert gru_cuda.adj_candidate_plan(64, 1, 480, 512, item, "grid", 0, 0)["fits"]


def test_the_plan_reads_nothing_but_the_shape():
    """The choice is a function of (B, lanes, H, dtype) alone: the same at
    every call and for every T (a step's cost times T orders the
    candidates as a step's cost does), so a shape runs the same kernels
    and sums dW in the same order in every run."""
    for h in (100, 256, 376, 450, 512, 1024):
        for item in (4, 2):
            first = gru_cuda.adj_choice(64, 15, h, item)
            assert all(gru_cuda.adj_choice(64, 15, h, item) == first for _ in range(3))
            plans = {t: gru_cuda.adj_plan(64, 15, t, h, item) for t in (1, 16, 480)}
            assert len({(p["instantiation"], p["cluster"], p["rows"]) for p in plans.values()}) == 1
