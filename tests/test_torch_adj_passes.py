"""The adjoint's two passes over all T (csrc/gru_bwd.cu: the gate pre-pass
gru_adj_gates_kernel and the weight-gradient pass gru_adj_wgrad_kernel),
on the CPU: their launch plans (gru_cuda's Python twins of the C plans)
cover every (row, unit) of the factors, every (gate column, unit) of dW and
every row of a lane's chunks exactly once; their shared memory does not
grow with H, and the pre-pass's lets two blocks share an SM; the 3xTF32
products that the
f32 passes take on the tensor cores, emulated here with a mantissa mask,
hold the adjoint's f32 tolerance where one TF32 product would not; and
the six factors of the pre-pass's plain version, walked as the adjoint walk
walks them, give the plain adjoint back.

Tolerances: BWD_TOL of tests/test_torch_cuda_kernels.py, float32 (dxg and
dh0 rtol = atol = 1e-4; dW and db rtol 1e-4, atol 1e-3) for the 3xTF32
products against float64; the factor walk against gru_backward_fb_plain
within 1e-5 in float32 (the same products in another order), and in
bfloat16 within one bf16 rounding of dxg (0.05, as BWD_TOL's bf16 dxg)
and 1e-2 for dW/db/dh0 (a reordered f32 sum can move one rounded dg_lo)."""

import numpy as np
import pytest
import torch

from multimodalsignal_tpu_torch.ops import gru_cuda

HIDDEN = (1, 40, 63, 64, 95, 130, 256, 381, 1024)
SHAPES = ((37, 5), (1, 3), (3, 50), (9, 31))   # ragged T * B: 185, 3, 150, 279 rows
CAPACITIES = (2 * gru_cuda.NUM_SMS, gru_cuda.NUM_SMS, 7)
BWD_TOL = (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-3))
# An H100 SM's shared memory (228 KB) and what the runtime keeps of it a block.
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1024


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("lanes", [1, 2, 15, 60])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_pass_plans_cover_each_row_unit_and_weight_once(itemsize, lanes, hidden):
    """The pre-pass's blocks (row group x, unit tile y, lane z; row tiles
    x, x + groups, ...) write the factors of every (lane, row, unit) once,
    at every capacity; the weight-gradient pass's blocks (chunk, column
    tile, unit tile x lanes) write every (lane, chunk, gate column, unit) of
    the dW partials once, the chunks cover a lane's rows once, and the unit
    tile 0 blocks write dxg and db of every (lane, row, gate column) and
    (lane, chunk, gate column) once."""
    g = 3 * hidden
    for n_steps, batch in SHAPES:
        rows = n_steps * batch
        for capacity in CAPACITIES:
            plan = gru_cuda.adj_pass_plan(lanes, n_steps, batch, hidden, itemsize, capacity)
            groups, unit_tiles, z = plan["gates_grid"]
            assert z == lanes and 1 <= groups <= max(-(-rows // gru_cuda.ADJ_GATE_ROWS), 1)
            assert groups * unit_tiles * lanes <= max(capacity, unit_tiles * lanes)
            seen = np.zeros((rows, hidden), np.int32)   # the same for every lane
            for x in range(groups):
                for tile in range(x, -(-rows // gru_cuda.ADJ_GATE_ROWS), groups):
                    m0 = tile * gru_cuda.ADJ_GATE_ROWS
                    for y in range(unit_tiles):
                        j0 = y * gru_cuda.ADJ_GATE_UNITS
                        seen[m0:m0 + gru_cuda.ADJ_GATE_ROWS, j0:j0 + gru_cuda.ADJ_GATE_UNITS] += 1
            assert (seen == 1).all(), (n_steps, batch, capacity)

        plan = gru_cuda.adj_pass_plan(lanes, n_steps, batch, hidden, itemsize)
        parts, col_tiles, zk = plan["grad_grid"]
        chunk = plan["chunk_rows"]
        assert (chunk, parts) == gru_cuda.adj_partials(lanes, n_steps, batch, hidden)
        assert chunk % gru_cuda.ADJ_GRAD_STAGE == 0
        k_tiles = -(-hidden // gru_cuda.ADJ_GRAD_TILE)
        assert zk == k_tiles * lanes and col_tiles == -(-g // gru_cuda.ADJ_GRAD_TILE)
        tiles = lanes * k_tiles * col_tiles
        assert parts == 1 if tiles >= gru_cuda.NUM_SMS else parts * tiles <= gru_cuda.NUM_SMS
        covered = np.zeros(rows, np.int32)
        for part in range(parts):
            covered[part * chunk:(part + 1) * chunk] += 1
            assert part * chunk < rows   # no empty chunk
        assert (covered == 1).all()
        dw = np.zeros((g, hidden), np.int32)   # a lane's chunk's partial
        dxg_cols = np.zeros(g, np.int32)
        for y in range(col_tiles):
            c0 = y * gru_cuda.ADJ_GRAD_TILE
            for kt in range(k_tiles):
                k0 = kt * gru_cuda.ADJ_GRAD_TILE
                dw[c0:c0 + gru_cuda.ADJ_GRAD_TILE, k0:k0 + gru_cuda.ADJ_GRAD_TILE] += 1
                if kt == 0:
                    dxg_cols[c0:c0 + gru_cuda.ADJ_GRAD_TILE] += 1
        assert (dw == 1).all() and (dxg_cols == 1).all()
        want = lanes * rows * hidden * (gru_cuda.ADJ_FACTORS + 1) + lanes * parts * g * hidden
        assert gru_cuda.adj_workspace_floats(lanes, n_steps, batch, hidden, itemsize) >= want


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_pass_shared_memory_is_fixed_and_two_blocks_share_an_sm(itemsize):
    """Each pass's shared memory is the same for every H and fits a block;
    the pre-pass's is small enough for two blocks an SM (the runtime's
    reserve counted), and the adjoint's shared-memory formula covers both
    passes at every H."""
    plans = [gru_cuda.adj_pass_plan(2, 37, 5, h, itemsize) for h in (1, 64, 256, 1024, 4000)]
    for key in ("gates_shared_bytes", "grad_shared_bytes"):
        assert len({p[key] for p in plans}) == 1
        assert plans[0][key] <= gru_cuda.MAX_SHARED_BYTES
    assert 2 * (plans[0]["gates_shared_bytes"] + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    for h in range(1, 1101, 7):
        assert gru_cuda.adj_shared_bytes(h, itemsize) >= max(plans[0]["gates_shared_bytes"],
                                                              plans[0]["grad_shared_bytes"])


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with TF32's 10-bit mantissa: the low 13 bits masked off."""
    return (x.view(torch.int32) & -(1 << 13)).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the passes' f32 mode takes it: each operand split into a
    TF32 head and a TF32 residual, a_lo b_hi + a_hi b_lo + a_hi b_hi in f32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


@pytest.mark.parametrize("hidden", [64, 256, 1024])
@pytest.mark.parametrize("what", ["hg", "dW"])
def test_3xtf32_products_hold_the_adjoint_tolerance(what, hidden):
    """The pre-pass's hg = h_prev @ W^T and the weight-gradient pass's dW^T =
    h_prev^T @ dg over 300 rows, in 3xTF32, within BWD_TOL of the same
    product in float64 (h_prev in (-1, 1) as a GRU state, W U(-1/sqrt(H),
    1/sqrt(H)), dg N(0, 1)); one TF32 product is at least 100x as far."""
    rng = np.random.default_rng(hidden)
    rows = 300
    h = np.tanh(rng.standard_normal((rows, hidden))).astype(np.float32)
    if what == "hg":
        bound = hidden ** -0.5
        other = rng.uniform(-bound, bound, (hidden, 3 * hidden)).astype(np.float32)
        a, b, tol = torch.from_numpy(h), torch.from_numpy(other), BWD_TOL[0]
    else:
        dg = rng.standard_normal((rows, 3 * hidden)).astype(np.float32)
        a, b, tol = torch.from_numpy(h.T.copy()), torch.from_numpy(dg), BWD_TOL[1]
    want = a.double() @ b.double()
    got = _mm_3xtf32(a, b)
    torch.testing.assert_close(got.double(), want, **tol)
    err = (got.double() - want).abs().max().item()
    one = (_tf32(a) @ _tf32(b)).double()
    assert (one - want).abs().max().item() > 100 * err


def _walk_factors(fac, w, dxg_dtype):
    """The adjoint walk and weight-gradient pass over the pre-pass's factors
    [F, T, B, 6, H] (reverse=False order: t from T - 1 down), as
    csrc/gru_bwd.cu takes them: dht = dh + dy; dg = dht (a_r | cz | a_n),
    dg_lo rounded to the stream dtype, dxg = dht (a_r | cz | cn), dh' =
    dht z + dg_lo @ W. Returns (dxg, dht of every step)."""
    lanes, n_steps, batch, _, hidden = fac.shape
    dh = torch.zeros(lanes, batch, hidden)
    dxg = torch.empty(lanes, n_steps, batch, 3 * hidden, dtype=dxg_dtype)
    dht = torch.empty(lanes, n_steps, batch, hidden)
    for t in range(n_steps - 1, -1, -1):
        a_r, cz, a_n, z, dy, cn = fac[:, t].unbind(-2)
        d = dh + dy
        dg = torch.cat([d * a_r, d * cz, d * a_n], dim=-1)
        dg_lo = dg.to(dxg_dtype).float()
        dxg[:, t] = torch.cat([d * a_r, d * cz, d * cn], dim=-1).to(dxg_dtype)
        dht[:, t] = d
        dh = d * z + torch.matmul(dg_lo, w)
    return dxg, dht, dh


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factors_walked_give_the_plain_adjoint(dtype, reverse):
    """The contract of the pre-pass (the header of csrc/gru_bwd.cu): its
    plain version's six factors, walked and summed as the adjoint walk and
    the weight-gradient pass do (dW^T = h_prev^T @ dg_lo, db = sum of the
    f32 dg), give gru_backward_fb_plain's dxg, dW, db and dh0 (3 lanes,
    T=7, B=5, H=24)."""
    lanes, n_steps, batch, hidden = 3, 7, 5, 24
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5 + reverse)
    bound = hidden ** -0.5
    xg = torch.from_numpy(rng.standard_normal((lanes, n_steps, batch, 3 * hidden))
                          .astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.uniform(-bound, bound, (lanes, 3 * hidden, hidden))
                         .astype(np.float32)).to(dt)
    b = torch.from_numpy(rng.uniform(-bound, bound, (lanes, 3 * hidden)).astype(np.float32)).to(dt)
    h0 = torch.from_numpy((rng.standard_normal((lanes, batch, hidden)) * 0.5).astype(np.float32))
    ys = gru_cuda.gru_forward_fb_plain(xg, w, b, h0, reverse)
    dy = torch.from_numpy(rng.standard_normal((lanes, n_steps, batch, hidden))
                          .astype(np.float32)).to(dt)
    want = gru_cuda.gru_backward_fb_plain(xg, w, b, h0, ys, dy, reverse)

    fac = gru_cuda.adj_factors_plain(xg, w, b, h0, ys, dy, reverse)
    assert fac.shape == (lanes, n_steps, batch, gru_cuda.ADJ_FACTORS, hidden)
    assert fac.dtype == torch.float32
    torch.testing.assert_close(fac[..., 4, :], dy.float(), rtol=0, atol=0)
    flip = (lambda x: x.flip(1)) if reverse else (lambda x: x)
    dxg, dht, dh0 = _walk_factors(flip(fac), w.float(), dt)
    dxg, dht = flip(dxg), flip(dht)
    h0_lo = h0.to(dt)[:, None]
    h_prev = (torch.cat([ys[:, 1:], h0_lo], 1) if reverse
              else torch.cat([h0_lo, ys[:, :-1]], 1)).float()
    dg = torch.cat([dht[..., None, :] * fac[..., k:k + 1, :] for k in range(3)], dim=-2)
    dg = dg.flatten(-2)                                        # [F, T, B, 3H]: r | z | n
    dw = torch.einsum("ftbc,ftbk->fck", dg.to(dt).float(), h_prev)
    db = dg.sum(dim=(1, 2))
    if dtype == "float32":
        tol = dict(rtol=1e-5, atol=1e-5)
        tols = (tol, tol, tol, tol)
    else:
        tols = (dict(rtol=0, atol=0.05), *(dict(rtol=1e-2, atol=1e-2),) * 3)
    for name, got, ref, t in zip(("dxg", "dW", "db", "dh0"), (dxg, dw, db, dh0), want, tols):
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        torch.testing.assert_close(got.float(), ref.float(), **t, msg=lambda m, n=name: f"{n}: {m}")
