"""GRU recurrence: hand-written CUDA kernels and their plain versions.

Counterpart of multimodalsignal_tpu/ops/gru_pallas.py's single-direction,
fold-batched and fused bidirectional kernels. Two sources, their kernels
templates with a lane axis and a stream layout, and three C entry points
each, every entry behind its own wrapper here:

  csrc/gru_fwd.cu
  * `gru_forward`     -> C `gru_fwd`     (replaces `_fwd_kernel` / `_gru_forward`)
  * `gru_forward_fb`  -> C `gru_fwd_fb`  (replaces `_fb_fwd_kernel` / `_gru_forward_fb`)
  * `gru_bifwd`       -> C `gru_bifwd`   (replaces `_bifwd_kernel` / `_bigru_forward`)
  csrc/gru_bwd.cu
  * `gru_backward`    -> C `gru_bwd`     (replaces `_bwd_kernel` / `_gru_backward`)
  * `gru_backward_fb` -> C `gru_bwd_fb`  (replaces `_fb_bwd_kernel` / `_gru_backward_fb`)
  * `gru_bibwd`       -> C `gru_bibwd`   (replaces `_bibwd_kernel` / `_bigru_backward`)

Three `torch.autograd.Function`s pair them as `_gru_tm`'s and `_bigru_tm`'s
custom VJPs do (forward saves xg, w_hh, b_hh, h0 and ys; backward runs the
adjoint kernel), and the model-facing entry points go through those:

  * `gru_sequence_cuda`          (counterpart of `gru_sequence_pallas`)
  * `gru_bidirectional_dirbatch` (counterpart of the JAX function of that name)
  * `gru_bidirectional_fused`    (counterpart of `gru_bidirectional_pallas`)
  * `gru_bidirectional_folds` (the fold-stacked model's fused pair: F folds
    of one layer as 2F lanes of one walk; the counterpart of
    gru_bidirectional_pallas under the fold vmap, whose Pallas batching
    rule gives each fold its own two-lane walk)
  * `gru_lanes_cuda` (the fold-stacked model's walk: F lanes of one
    direction; the counterpart of the custom_vmap rules that route a fold
    vmap onto the fb kernels, fold grouping included: with
    MMS_GRU_FOLD_GROUP >= 2, G folds as one block-diagonal lane of width
    G·H, as gru_pallas.py:602-691 and :756-819 do)

The three forward entries run the walk kernel (`gru_walk_kernel`): one
block per (lane, tile of rows), W^T in registers up to H = 64 and in shared
memory above, h double-buffered with one barrier a step, xg prefetched;
where W does not fit one block (f32 above H = 136, bf16 above 192) a thread
block cluster of K <= 8 CTAs shares each (lane, row tile), each CTA holding
W's rows of its own ceil(H/K) units and sending its slice of h' to every
CTA over distributed shared memory, one cluster barrier a step; past the
cluster's limit (f32 above H = 380, bf16 above 532) the grid walk
(`gru_walk_grid_kernel`, `grid_plan`): a group of CTAs spanning the card,
one an SM, each holding W's rows of its units for a whole work item (a
lane and up to 64 rows), the state exchanged each step through buffers in
device memory (`w_pad`, which the wrapper allocates) with a group barrier,
launched cooperatively, the groups taking the lanes in turn, the bf16
products on the tensor cores (mma.sync), the f32 ones on CUDA cores; and where
not even the card's shared memory holds one lane's W (f32 above H = 1408,
bf16 above 2112 at B = 64) the streamed walk (`gru_walk_stream_kernel`): a
cluster of 8 as before, each CTA keeping as many of its units' W rows in
shared memory as fit and streaming the rest every step from a padded copy
of W (`w_pad`) through a per-thread cp.async ring, up to 8 rows a tile.
The three adjoint
entries run the adjoint walk, with their own lane count and stream layout
(`gru_bwd` one lane, `gru_bwd_fb` F lanes, `gru_bibwd` the fused pair's 2
or 2F): a gate pre-pass over all T, a walk that keeps only the dh chain
(W's columns in registers up to H = 64, in shared memory above, split over
a cluster above H = 130 f32 / 179 bf16, the step's dg exchanged over
distributed shared memory; a producer warp moves its factors and dht
between device and shared memory a chunk of steps at a time; past H = 376
f32 / 450 bf16 the grid walk, dg exchanged through the workspace as the
forward's h, up to H = 1320 f32 / 2112 bf16 at B = 64, then the streamed
walk, W^T streamed from a padded transpose in the workspace, up to 4 rows a
tile), and a weight-gradient pass over all T, summed in a fixed order; both
passes over all T take their products on the tensor cores (bf16 mma, 3xTF32
in f32; `adj_pass_plan`). `walk_plan`, `adj_plan` and
`grid_plan` (with `walk_cluster_size`, `walk_row_tile`,
`walk_shared_bytes`, `walk_workspace_elems`, `adj_cluster_size`,
`adj_row_tile`, `adj_shared_bytes`, `adj_partials` and
`adj_workspace_floats`) mirror how the C side picks the instantiation, the
cluster or group and the tile, and sizes shared memory and workspaces
(`c_plan` reads the C plans on the card); they size
every entry's checks and allocations. An H past the streamed walk's limit
(`walk_max_hidden`, `adj_max_hidden`: 21564 / 4453 in float32, 24452 /
4622 in bfloat16, where its step buffers at one row fill a CTA's shared
memory) is refused before any launch.

The wrappers take the TPU kernels' time-major layout. A wrapper given CPU
tensors runs its plain PyTorch version (`*_plain`: a Python loop over time
with the kernel's gate math and dtypes); given CUDA tensors it launches the
kernel on the current stream or raises. Each launch adds one to the
wrapper's `launches` count (see `launch_counts`).

Dtypes follow the TPU kernels: float32 streams run all in float32; bfloat16
streams (gates, weights, bias, outputs) use bfloat16 product operands with
float32 sums, and the carry is float32 in both modes. The backward
recomputes the gates from the bf16 states, rounds the gate cotangents to
bf16 before its products and keeps dW, db and dh0 in float32, as the TPU
kernels do: in bf16 it is not the exact adjoint of the bf16 forward.
The fused bidirectional pair (`gru_bifwd`, `gru_bibwd`) is float32 only, as
`_bifwd_kernel` and `_bibwd_kernel` are: its streams are [T, L, B, .], the
lane inside time, with an even L (each fold's forward direction, then its
backward one: L = 2 for one layer, 2F for F folds of it), and its wrappers
refuse anything but float32 streams on either device (the caller casts
first, as `gru_bidirectional_folds` does).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os

import torch

# Dynamic shared memory one block may use on sm_90 (232,448 bytes).
MAX_SHARED_BYTES = 232_448
# The walk kernel (gru_fwd, gru_fwd_fb, gru_bifwd), as csrc/gru_fwd.cu lays
# it out: W^T in registers up to WALK_REG_MAX_HIDDEN, with WALK_SUBLANES
# threads per hidden unit (K split across them), which is also the most
# rows a block takes; the row tile fills NUM_SMS. The adjoint walk (gru_bwd,
# gru_bwd_fb, gru_bibwd; csrc/gru_bwd.cu) takes the same threshold.
NUM_SMS = 132
WALK_REG_MAX_HIDDEN = 64
WALK_SUBLANES = {True: 8, False: 4}   # by "W in registers"
WALK_REG_KPAD = 64                     # K padded to 8 sub-lanes x 2 chunks of 4
# Threads a block or CTA of either walk takes at most, the portable thread
# block cluster size (the most CTAs that split one walk's W), and what the C
# entries return when no cluster of that size fits the card.
MAX_THREADS = 768
MAX_CLUSTER = 8
NO_CLUSTER = -1
# ... and the most a CTA of either cluster walk takes (its launch bound).
CLUSTER_MAX_THREADS = 576
# The adjoint walk's layout (csrc/gru_bwd.cu): K = 3H padded to 8 sub-lanes
# x 6 chunks of 4 with W in registers; at most 2 rows a block with W in
# registers, 1 with W in shared memory; the steps its producer warp moves at
# a time, and the factors it reads; six f32 factors (dy among them) and
# dht per (step, row, unit) in the workspace; the weight-gradient pass's
# tile of dW (gate columns x units), its stage of rows and ring stages.
ADJ_REG_KPAD = 192
ADJ_MOST_ROWS = {True: 2, False: 1}   # by "W in registers"
ADJ_SMEM_SUBLANES = 4                  # dot threads per unit, W in shared memory
ADJ_PRODUCER = 32                      # the producer warp
ADJ_CHUNK = {True: 16, False: 4}
ADJ_WALK_FACTORS = 5
ADJ_FACTORS = 6
ADJ_GRAD_TILE = 128
ADJ_GRAD_STAGE, ADJ_GRAD_STAGES = 32, 3
# The gate pre-pass's tile (rows x units, all three gates' columns of W),
# its K chunk and ring stages, and the largest H whose W slice stays in
# shared memory.
ADJ_GATE_ROWS, ADJ_GATE_UNITS = 128, 32
ADJ_GATE_K, ADJ_GATE_STAGES = 32, 3
ADJ_GATE_RESIDENT_K = 128
# The streamed walks, past the cluster walks' limits (csrc/*.cu): the most
# threads (dot threads, for the adjoint) of a CTA, the most rows of a tile
# (forward: two a gate lane; adjoint: a (row, unit) pair a sub-lane), the
# slots of each thread's cp.async ring. An instantiation is one of
# INSTANTIATIONS, in the order of the C plans' first number.
STREAM_THREADS = 512
STREAM_MOST_ROWS = {False: 8, True: 4}   # by "adjoint"
STREAM_STAGES = 2
# Clusters of MAX_CLUSTER CTAs of one CTA an SM that an H100 runs at once
# (cudaOccupancyMaxActiveClusters: 15, not NUM_SMS / 8).
STREAM_CLUSTERS = 15
# The grid walks (csrc/gru_grid.cuh), between the cluster walks and the
# streamed ones: the K tiles of the exchanged state a plan may take (the
# first preferred), elements past every shared row, the least and the most
# tiles in the cp.async ring, sub-lanes splitting K, batch rows a thread,
# hidden units a thread, the most threads of a CTA and the most batch rows
# of a work item; and what the entries return when the card cannot hold a
# plan's groups at once.
GRID_KTS = (128, 64)
GRID_PAD = 16
GRID_MIN_STAGES, GRID_MAX_STAGES = 3, 8
GRID_SUB = 8
GRID_ROWS = 8
GRID_UNITS = {False: 1, True: 2}   # by "adjoint"
GRID_THREADS = {False: 512, True: 384}   # by "adjoint": the kernels' launch bounds
GRID_ITEM_ROWS = 64
NO_GROUP = -2
INSTANTIATIONS = ("registers", "one block", "cluster", "grid", "streamed")

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def walk_in_registers(hidden: int) -> bool:
    """Which instantiation of the walk kernel takes this H: W^T in
    registers, or in shared memory."""
    return hidden <= WALK_REG_MAX_HIDDEN


def _row_tile(batch: int, lanes: int, most: int) -> int:
    """The least power of two R that brings ceil(B / R) * lanes blocks down
    to NUM_SMS, at most `most`."""
    want = -(-batch * lanes // NUM_SMS)
    rows = 1
    while rows < want and rows < most:
        rows *= 2
    return rows


def cluster_units(hidden: int, cluster: int) -> int:
    """Hidden units one CTA of a cluster of `cluster` owns (as walk_units
    and adj_units in C): CTA r owns r * units .. (r + 1) * units - 1, those
    inside H."""
    return -(-hidden // cluster)


def _walk_bytes(hidden: int, itemsize: int, rows: int, cluster: int) -> int:
    regs = walk_in_registers(hidden)
    kpad = WALK_REG_KPAD if regs else -(-hidden // 4) * 4
    w = 0 if regs else (3 * cluster_units(hidden, cluster) * kpad * itemsize + 15) // 16 * 16
    return w + 2 * rows * kpad * 4


def _walk_threads(hidden: int, cluster: int) -> int:
    return -(-cluster_units(hidden, cluster) * WALK_SUBLANES[walk_in_registers(hidden)] // 32) * 32


def walk_cluster_size(hidden: int, itemsize: int) -> int:
    """CTAs of the walk kernel per (lane, row tile) (as gru_walk_cluster_size
    in C): 1 while W fits one block at the most rows a block takes, else the
    least cluster up to MAX_CLUSTER whose per-CTA share of W and threads
    fit; 0 past the cluster design's limit, where the streamed walk runs."""
    if walk_in_registers(hidden):
        return 1
    for k in range(1, MAX_CLUSTER + 1):
        if (_walk_threads(hidden, k) <= (MAX_THREADS if k == 1 else CLUSTER_MAX_THREADS)
                and _walk_bytes(hidden, itemsize, WALK_SUBLANES[False], k) <= MAX_SHARED_BYTES):
            return k
    return 0


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def _stream_threads(hidden: int) -> int:
    """Threads (the adjoint: dot threads) of a streamed CTA: 4 a unit of
    its ceil(H / MAX_CLUSTER), whole warps, at most STREAM_THREADS."""
    units = cluster_units(hidden, MAX_CLUSTER)
    return min(-(-units * ADJ_SMEM_SUBLANES // 32) * 32, STREAM_THREADS)


def _stream_fixed(hidden: int, itemsize: int, rows: int, adjoint: bool) -> int:
    """Shared bytes of a streamed CTA beside its resident W rows (as
    stream_fixed_bytes / adj_stream_fixed_bytes in C). Forward: the two h
    buffers [2, rows, K padded to 4] f32, the units' f32 carry [rows,
    units] padded to 16 bytes, every thread's ring of 3 gates x 4 values a
    slot. Adjoint: the two dg_lo buffers [2, rows, 3H padded to 4], for two
    chunks of steps the units' five factors and dht, the pairs' dh, all f32
    and padded to 16 bytes, then every dot thread's ring of 4 values a
    slot."""
    units = cluster_units(hidden, MAX_CLUSTER)
    rings = _stream_threads(hidden) * STREAM_STAGES * itemsize
    if adjoint:
        kpad = -(-3 * hidden // 4) * 4
        per_row = 2 * ADJ_CHUNK[False] * (ADJ_WALK_FACTORS + 1) + 1
        return _a16((2 * rows * kpad + per_row * rows * units) * 4) + rings * 4
    kpad = -(-hidden // 4) * 4
    return 2 * rows * kpad * 4 + _a16(rows * units * 4) + rings * 12


def _stream_unit_bytes(hidden: int, itemsize: int, adjoint: bool) -> int:
    """One unit's resident W in the stream dtype: its three rows [3, K
    padded to 4] forward, its W^T row [3H padded to 4] adjoint."""
    return (-(-3 * hidden // 4) * 4 if adjoint else 3 * (-(-hidden // 4) * 4)) * itemsize


def stream_resident(hidden: int, itemsize: int, rows: int, adjoint: bool = False) -> int:
    """Units of a streamed CTA whose W rows stay in shared memory at this
    row tile (as stream_resident / adj_stream_resident in C): as many as fit
    beside the fixed part, all of its units at most; -1 where not even the
    fixed part fits."""
    fixed = _stream_fixed(hidden, itemsize, rows, adjoint)
    if fixed > MAX_SHARED_BYTES:
        return -1
    unit = _stream_unit_bytes(hidden, itemsize, adjoint)
    res = min(cluster_units(hidden, MAX_CLUSTER), (MAX_SHARED_BYTES - fixed) // unit)
    while res > 0 and _a16(res * unit) + fixed > MAX_SHARED_BYTES:
        res -= 1
    return res


def _stream_bytes(hidden: int, itemsize: int, rows: int, adjoint: bool) -> int:
    res = stream_resident(hidden, itemsize, rows, adjoint)
    unit = _stream_unit_bytes(hidden, itemsize, adjoint)
    return (_a16(res * unit) if res > 0 else 0) + _stream_fixed(hidden, itemsize, rows, adjoint)


def _stream_row_tile(batch: int, lanes: int, hidden: int, itemsize: int, adjoint: bool) -> int:
    """Rows per (lane, tile) of a streamed walk (as stream_row_tile /
    adj_stream_row_tile in C): the least power of two that brings
    ceil(B / R) * lanes clusters down to STREAM_CLUSTERS (one wave), at most
    stream_most_rows."""
    want, most = -(-batch * lanes // STREAM_CLUSTERS), stream_most_rows(hidden, itemsize, adjoint)
    rows = 1
    while rows < want and rows < most:
        rows *= 2
    return rows


def stream_most_rows(hidden: int, itemsize: int, adjoint: bool = False) -> int:
    """The most rows a streamed tile takes at this H: the largest power of
    two up to STREAM_MOST_ROWS whose fixed part fits; 1 where none does."""
    rows = STREAM_MOST_ROWS[adjoint]
    while rows > 1 and _stream_fixed(hidden, itemsize, rows, adjoint) > MAX_SHARED_BYTES:
        rows //= 2
    return rows


def walk_streamed(hidden: int, itemsize: int) -> bool:
    """Whether gru_fwd, gru_fwd_fb and gru_bifwd are past the cluster walk's
    limit at this H (380 f32, 532 bf16): the grid walk runs there where
    grid_plan takes the shape, the streamed walk elsewhere."""
    return walk_cluster_size(hidden, itemsize) == 0


def _grid_cta(hidden: int, itemsize: int, rows: int, units: int, adjoint: bool,
              kt: int) -> tuple[int, int, int, int]:
    """A grid CTA owning `units` units for work items of `rows` rows (as
    grid_cta in C): (threads, rows a pass, tiles in the ring, shared bytes).
    Threads: GRID_SUB a (group of GRID_UNITS units, group of GRID_ROWS
    rows), whole warps, at most GRID_THREADS; 0 where not even one row
    group fits. Shared: W's rows of its units ([3, units, K padded to kt +
    GRID_PAD] forward; W^T [unit pairs x 2, 3H padded to kt + GRID_PAD]
    adjoint) in the stream dtype and f32 [rows, units] (the carry, or the
    adjoint's dht z), each padded to 16 bytes, then as many tiles [pass rows,
    kt + GRID_PAD] as fit, at most GRID_MAX_STAGES (the bytes count
    GRID_MIN_STAGES where fewer fit)."""
    groups_u = -(-units // GRID_UNITS[adjoint])
    per_group = GRID_SUB * groups_u
    row_groups = min(-(-rows // GRID_ROWS), GRID_THREADS[adjoint] // per_group)
    if row_groups < 1:
        return 0, 0, 0, 0
    pass_rows = GRID_ROWS * row_groups
    if adjoint:
        w = groups_u * 2 * (_grid_kx(3 * hidden, kt) + GRID_PAD) * itemsize
    else:
        w = 3 * units * (_grid_kx(hidden, kt) + GRID_PAD) * itemsize
    fixed = _a16(w) + _a16(rows * units * 4)
    stage = pass_rows * (kt + GRID_PAD) * itemsize
    stages = min((MAX_SHARED_BYTES - fixed) // stage if fixed < MAX_SHARED_BYTES else 0,
                 GRID_MAX_STAGES)
    threads = -(-per_group * row_groups // 32) * 32
    return threads, pass_rows, stages, fixed + max(stages, GRID_MIN_STAGES) * stage


def _grid_kx(k: int, kt: int) -> int:
    return -(-k // kt) * kt


def grid_plan(batch: int, lanes: int, hidden: int, itemsize: int = 4,
              adjoint: bool = False) -> dict | None:
    """The grid walk's plan (as grid_plan in C), or None where one lane's W
    does not fit the card's shared memory: the plan with the wider K tile
    of GRID_KTS (fewer tiles, so fewer barriers a step) unless the narrower
    one takes the shape in fewer rounds of work items or the wider one does
    not take it at all (_grid_plan_kt)."""
    if batch < 1 or lanes < 1:
        return None
    wide, narrow = (_grid_plan_kt(batch, lanes, hidden, itemsize, adjoint, kt)
                    for kt in GRID_KTS)
    if wide is None or narrow is None:
        return wide or narrow
    items = lanes * -(-batch // wide["rows"])
    return wide if -(-items // wide["groups"]) <= -(-items // narrow["groups"]) else narrow


def _grid_plan_kt(batch: int, lanes: int, hidden: int, itemsize: int, adjoint: bool,
                  kt: int) -> dict | None:
    """The grid plan with K tiles of kt (as grid_plan_kt in C): the least
    group whose CTAs' share of W fits (one CTA an SM) gives the most groups
    the card holds at once, at most the work items (lanes x row groups of
    at most GRID_ITEM_ROWS rows); the groups then spread over the NUM_SMS,
    each CTA owning as few units as that leaves. Returns CTAs a group,
    groups at once, units a CTA, rows of a work item and of a pass, the K
    tile, tiles in the ring, threads and shared bytes of a CTA, and the
    exchange buffers' elements [groups, 2, rows, K padded to kt]."""
    rows = min(batch, GRID_ITEM_ROWS)
    items = lanes * -(-batch // rows)

    def fits(cta):
        return cta[0] > 0 and cta[2] >= GRID_MIN_STAGES and cta[3] <= MAX_SHARED_BYTES

    least = next((g for g in range(1, NUM_SMS + 1)
                  if fits(_grid_cta(hidden, itemsize, rows, -(-hidden // g), adjoint, kt))), 0)
    if not least:
        return None
    groups = min(items, NUM_SMS // least)
    units = -(-hidden // (NUM_SMS // groups))
    cta = _grid_cta(hidden, itemsize, rows, units, adjoint, kt)
    if not fits(cta):
        units = -(-hidden // least)
        cta = _grid_cta(hidden, itemsize, rows, units, adjoint, kt)
    return dict(ctas=-(-hidden // units), groups=groups, units=units, rows=rows,
                pass_rows=cta[1], kt=kt, stages=cta[2], threads=cta[0], smem=cta[3],
                exchange=groups * 2 * rows * _grid_kx(3 * hidden if adjoint else hidden, kt))


def grid_workspace_bytes(plan: dict, itemsize: int) -> int:
    """Bytes of a grid walk's workspace: the exchange buffers, then a
    counter a group, each from a 16-byte boundary."""
    return _a16(plan["exchange"] * itemsize) + _a16(plan["groups"] * 4)


def walk_row_tile(batch: int, lanes: int, hidden: int, itemsize: int = 4) -> int:
    """Rows per (lane, tile) of the walk kernel (as gru_walk_row_tile in C),
    at most the threads per hidden unit; a cluster's K CTAs count as K
    blocks toward the SMs (the streamed walk: _stream_row_tile)."""
    if walk_streamed(hidden, itemsize):
        return _stream_row_tile(batch, lanes, hidden, itemsize, adjoint=False)
    cluster = walk_cluster_size(hidden, itemsize)
    return _row_tile(batch, lanes * cluster, WALK_SUBLANES[walk_in_registers(hidden)])


def walk_shared_bytes(hidden: int, itemsize: int, rows: int | None = None) -> int:
    """Shared memory per block or CTA of the walk kernel (as
    gru_walk_shared_bytes in C): W's rows of the CTA's units [3, units, K
    padded to 4] in the stream dtype, padded to 16 bytes (all H in one
    block; none with W in registers), then two f32 buffers of the tile's
    whole h operand, [rows, K padded], at this H's cluster size; past the
    cluster's limit the streamed walk's resident rows and fixed part
    (_stream_fixed). `rows` defaults to the most a block takes, so the limit
    on H holds for every batch."""
    if walk_streamed(hidden, itemsize):
        rows = stream_most_rows(hidden, itemsize) if rows is None else rows
        return _stream_bytes(hidden, itemsize, rows, adjoint=False)
    rows = WALK_SUBLANES[walk_in_registers(hidden)] if rows is None else rows
    return _walk_bytes(hidden, itemsize, rows, walk_cluster_size(hidden, itemsize))


def walk_workspace_elems(batch: int, lanes: int, hidden: int, itemsize: int) -> int:
    """Elements, in the stream dtype, of the workspace the forward entries
    take as w_pad (as walk_workspace_elems in C): the grid walk's exchange
    buffers and counters (grid_workspace_bytes), or the padded copy of W
    [lanes, 3H, K padded to 4] the streamed walk reads its streamed rows
    from; 0 for the other instantiations."""
    if not walk_streamed(hidden, itemsize):
        return 0
    grid = grid_plan(batch, lanes, hidden, itemsize)
    if grid is not None:
        return grid_workspace_bytes(grid, itemsize) // itemsize
    return lanes * 3 * hidden * (-(-hidden // 4) * 4)


def _grid_fields(grid: dict, shared_bytes: int) -> dict:
    return dict(instantiation="grid", cluster=grid["ctas"], rows=grid["rows"],
                resident=grid["units"], streamed=0, shared_bytes=shared_bytes,
                groups=grid["groups"], threads=grid["threads"])


def walk_plan(batch: int, lanes: int, hidden: int, itemsize: int = 4) -> dict:
    """The forward walk's plan for this shape (as gru_walk_plan in C): the
    instantiation, CTAs per (lane, row tile) (the grid walk: of a group),
    the row tile (the grid walk: rows of a work item), a CTA's units whose W
    rows are resident in shared memory and those streamed, its shared bytes,
    the w_pad workspace's elements, and the grid walk's groups at once and
    threads a CTA (0 for the others)."""
    grid = grid_plan(batch, lanes, hidden, itemsize) if walk_streamed(hidden, itemsize) else None
    workspace = walk_workspace_elems(batch, lanes, hidden, itemsize)
    if grid is not None:
        return dict(_grid_fields(grid, grid["smem"]), workspace=workspace)
    rows = walk_row_tile(batch, lanes, hidden, itemsize)
    if walk_streamed(hidden, itemsize):
        res = stream_resident(hidden, itemsize, rows)
        kind, cluster, streamed = 4, MAX_CLUSTER, cluster_units(hidden, MAX_CLUSTER) - max(res, 0)
    else:
        cluster = walk_cluster_size(hidden, itemsize)
        kind = 0 if walk_in_registers(hidden) else 1 if cluster == 1 else 2
        res, streamed = cluster_units(hidden, cluster), 0
    return dict(instantiation=INSTANTIATIONS[kind], cluster=cluster, rows=rows,
                resident=res, streamed=streamed,
                shared_bytes=walk_shared_bytes(hidden, itemsize, rows), groups=0, threads=0,
                workspace=workspace)


def adj_row_tile(batch: int, lanes: int, hidden: int, itemsize: int = 4) -> int:
    """Rows per block of gru_bwd's walk (as gru_adj_row_tile in C), at most
    ADJ_MOST_ROWS (1 with W in shared memory, in one block or a cluster);
    the streamed walk's: _stream_row_tile."""
    if adj_streamed(hidden, itemsize):
        return _stream_row_tile(batch, lanes, hidden, itemsize, adjoint=True)
    return _row_tile(batch, lanes, ADJ_MOST_ROWS[walk_in_registers(hidden)])


def _adj_walk_bytes(hidden: int, itemsize: int, rows: int, cluster: int) -> int:
    regs = walk_in_registers(hidden)
    units = cluster_units(hidden, cluster)
    kpad = ADJ_REG_KPAD if regs else -(-3 * hidden // 4) * 4
    w = 0 if regs else (units * kpad * itemsize + 15) // 16 * 16
    per_row = 2 * ADJ_CHUNK[regs] * (ADJ_WALK_FACTORS + 1) * units
    return w + (2 * rows * kpad + rows * per_row) * 4


def adj_cluster_size(hidden: int, itemsize: int) -> int:
    """CTAs of the adjoint walk per (lane, batch row) (as
    gru_adj_cluster_size in C): 1 while W^T fits one block, else the least
    cluster up to MAX_CLUSTER whose per-CTA share and threads (its units'
    dot threads and the producer warp) fit; 0 past the walk's limit."""
    if walk_in_registers(hidden):
        return 1
    for k in range(1, MAX_CLUSTER + 1):
        threads = -(-cluster_units(hidden, k) * ADJ_SMEM_SUBLANES // 32) * 32 + ADJ_PRODUCER
        if (threads <= (MAX_THREADS if k == 1 else CLUSTER_MAX_THREADS)
                and _adj_walk_bytes(hidden, itemsize, 1, k) <= MAX_SHARED_BYTES):
            return k
    return 0


def _adj_gates_bytes(itemsize: int) -> int:
    """Shared bytes of the adjoint's gate pre-pass (as adj_gates_shared_bytes
    in C), which do not grow with H: W's slice [3 x ADJ_GATE_UNITS,
    ADJ_GATE_RESIDENT_K + 16 bytes] in the stream dtype (resident up to H =
    ADJ_GATE_RESIDENT_K; past it the ring's W chunks) and the ring's h_prev
    chunks [ADJ_GATE_STAGES, ADJ_GATE_ROWS, ADJ_GATE_K + 16 bytes]."""
    pad = 16 // itemsize
    return (3 * ADJ_GATE_UNITS * (ADJ_GATE_RESIDENT_K + pad)
            + ADJ_GATE_STAGES * ADJ_GATE_ROWS * (ADJ_GATE_K + pad)) * itemsize


def _adj_grad_bytes(itemsize: int) -> int:
    """Shared bytes of the adjoint's weight-gradient pass (as
    adj_grad_shared_bytes in C): ADJ_GRAD_STAGES stages of ADJ_GRAD_STAGE
    rows, each h_prev [rows, ADJ_GRAD_TILE + 8] in the stream dtype, the
    factors [rows, ADJ_GRAD_TILE + 8], dht and cn [rows, ADJ_GRAD_TILE] in
    f32; in bf16 a dg_lo tile [rows, ADJ_GRAD_TILE + 8]; ADJ_GRAD_TILE f32
    for db; each stage's rows' places in the streams, [ADJ_GRAD_STAGES,
    rows] int."""
    row = (ADJ_GRAD_TILE + 8) * itemsize
    stage = ADJ_GRAD_STAGE * (row + (3 * ADJ_GRAD_TILE + 8) * 4)
    return (ADJ_GRAD_STAGES * stage + (0 if itemsize == 4 else ADJ_GRAD_STAGE * row)
            + ADJ_GRAD_TILE * 4 + ADJ_GRAD_STAGES * ADJ_GRAD_STAGE * 4)


def _adj_pass_bytes(itemsize: int) -> int:
    """The larger of the two passes' shared bytes (adj_pass_shared_bytes)."""
    return max(_adj_gates_bytes(itemsize), _adj_grad_bytes(itemsize))


def adj_pass_plan(lanes: int, n_steps: int, batch: int, hidden: int, itemsize: int = 4,
                  capacity: int = 2 * NUM_SMS) -> dict:
    """The two passes' launches (as gru_adj_pass_plan in C) at a pre-pass
    capacity of `capacity` blocks at once (the card's, from CUDA's occupancy
    calculator, in C): the pre-pass's grid (row groups, unit tiles, lanes),
    each block one lane's unit tile of ADJ_GATE_UNITS units walking row
    tiles x, x + row groups, ... of ADJ_GATE_ROWS rows (as many blocks as
    the capacity, split over the lanes' unit tiles, at least one and at most
    one a row tile); the weight-gradient pass's grid (chunks, column tiles
    of 3H, unit tiles of H x lanes), a block one chunk's rows of an
    ADJ_GRAD_TILE x ADJ_GRAD_TILE tile of dW; rows a chunk; shared bytes."""
    row_tiles = -(-n_steps * batch // ADJ_GATE_ROWS)
    unit_tiles = -(-hidden // ADJ_GATE_UNITS)
    groups = max(min(capacity // (lanes * unit_tiles), row_tiles), 1)
    chunk, parts = adj_partials(lanes, n_steps, batch, hidden)
    return dict(capacity=capacity, gates_grid=(groups, unit_tiles, lanes),
                gates_shared_bytes=_adj_gates_bytes(itemsize),
                grad_grid=(parts, -(-3 * hidden // ADJ_GRAD_TILE),
                           -(-hidden // ADJ_GRAD_TILE) * lanes),
                chunk_rows=chunk, grad_shared_bytes=_adj_grad_bytes(itemsize))


def _adj_cluster_bytes(hidden: int, itemsize: int, rows: int) -> int:
    """adj_shared_bytes of the one-block and cluster design (as
    adj_cluster_shared_bytes in C)."""
    cluster = adj_cluster_size(hidden, itemsize) or MAX_CLUSTER
    return max(_adj_walk_bytes(hidden, itemsize, rows, cluster), _adj_pass_bytes(itemsize))


# The bf16 adjoint leaves the cluster walk past this H, where the gate
# pre-pass's shared memory ended it before the passes were redesigned (the
# cluster walk beyond it has not been timed against the grid walk).
ADJ_CLUSTER_MOST_BF16 = 450


def adj_streamed(hidden: int, itemsize: int) -> bool:
    """Whether gru_bwd, gru_bwd_fb and gru_bibwd are past the one-block and
    cluster design's limit at this H (as adj_streamed in C): its walk's (376
    f32) or ADJ_CLUSTER_MOST_BF16: the grid walk runs there where grid_plan
    takes the shape, the streamed walk elsewhere."""
    return (adj_cluster_size(hidden, itemsize) == 0
            or (itemsize != 4 and hidden > ADJ_CLUSTER_MOST_BF16)
            or _adj_cluster_bytes(hidden, itemsize,
                                  ADJ_MOST_ROWS[walk_in_registers(hidden)]) > MAX_SHARED_BYTES)


def adj_shared_bytes(hidden: int, itemsize: int, rows: int | None = None) -> int:
    """Shared memory of the most demanding kernel of gru_bwd, per block or
    CTA (as gru_adj_shared_bytes in C): the walk's W^T rows of the CTA's
    units [units, 3H padded to 4] in the stream dtype, padded to 16 bytes
    (all H in one block; none with W in registers), then two f32 buffers of
    the tile's whole dg, [rows, K padded], and for two chunks of steps its
    units' f32 factors [2 chunk, rows, 5, units] and dht [2 chunk, rows,
    units], at this H's cluster size; or the two passes' (_adj_pass_bytes),
    whichever is larger. Past that design's limit the streamed walk's
    resident rows and fixed part (_stream_fixed), or the passes', whichever
    is larger. `rows` defaults to the most a block takes."""
    if adj_streamed(hidden, itemsize):
        rows = stream_most_rows(hidden, itemsize, adjoint=True) if rows is None else rows
        return max(_stream_bytes(hidden, itemsize, rows, adjoint=True), _adj_pass_bytes(itemsize))
    rows = ADJ_MOST_ROWS[walk_in_registers(hidden)] if rows is None else rows
    return _adj_cluster_bytes(hidden, itemsize, rows)


@functools.cache
def max_hidden(smem, itemsize: int) -> int:
    """The largest H whose every smaller H a kernel's shared-memory formula
    (walk_shared_bytes or adj_shared_bytes) admits in this dtype."""
    hidden = 1
    while smem(hidden + 1, itemsize) <= MAX_SHARED_BYTES:
        hidden += 1
    return hidden


def walk_max_hidden(itemsize: int) -> int:
    """The largest H of gru_fwd, gru_fwd_fb and gru_bifwd: the streamed
    walk's, set by its h buffers, carry and copy rings at one row."""
    return max_hidden(walk_shared_bytes, itemsize)


def adj_max_hidden(itemsize: int) -> int:
    """The largest H of gru_bwd, gru_bwd_fb and gru_bibwd: the streamed
    walk's, set by its dg buffers, factor and dht chunks, dh and copy rings
    at one row."""
    return max_hidden(adj_shared_bytes, itemsize)


def adj_partials(lanes: int, n_steps: int, batch: int, hidden: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of the adjoint's weight-gradient pass (as
    gru_adj_chunk_rows and gru_adj_partials in C): the T * B rows (t, b) of
    a lane in as many chunks as the lanes' dW tiles (ADJ_GRAD_TILE x
    ADJ_GRAD_TILE of [3H, H]) take to fill NUM_SMS without passing it, one
    where the tiles alone fill it, in whole stages of ADJ_GRAD_STAGE rows;
    each chunk gives one dW / db partial."""
    rows = n_steps * batch
    tiles = lanes * -(-hidden // ADJ_GRAD_TILE) * -(-3 * hidden // ADJ_GRAD_TILE)
    want = 1 if tiles >= NUM_SMS else NUM_SMS // tiles
    chunk = max(-(-(-(-rows // want)) // ADJ_GRAD_STAGE) * ADJ_GRAD_STAGE, ADJ_GRAD_STAGE)
    return chunk, -(-rows // chunk)


def adj_workspace_floats(lanes: int, n_steps: int, batch: int, hidden: int,
                         itemsize: int = 4) -> int:
    """Floats of the workspace gru_bwd takes as dw_part (as
    gru_adj_workspace_floats in C): the six factors and dht of every
    (lane, t, b, unit), then the dW partials [lanes, chunks, 3H, H]; for the
    streamed walk then, from a 16-byte boundary, W^T padded [lanes, H, 3H
    padded to 4] in the stream dtype."""
    rows = lanes * n_steps * batch
    parts = adj_partials(lanes, n_steps, batch, hidden)[1]
    base = rows * hidden * (ADJ_FACTORS + 1) + lanes * parts * 3 * hidden * hidden
    if not adj_streamed(hidden, itemsize):
        return base
    grid = grid_plan(batch, lanes, hidden, itemsize, adjoint=True)
    if grid is not None:
        return -(-base // 4) * 4 + grid_workspace_bytes(grid, itemsize) // 4
    wt = lanes * hidden * (-(-3 * hidden // 4) * 4) * itemsize
    return -(-base // 4) * 4 + -(-wt // 16) * 4


def adj_plan(batch: int, lanes: int, n_steps: int, hidden: int, itemsize: int = 4) -> dict:
    """The adjoint walk's plan for this shape (as gru_adj_plan in C): the
    instantiation, CTAs per (lane, row tile) (the grid walk: of a group),
    the row tile (the grid walk: rows of a work item), a CTA's units whose
    W^T rows are resident in shared memory and those streamed, the most
    shared bytes of its kernels, the workspace floats, and the grid walk's
    groups at once and threads a CTA (0 for the others)."""
    workspace = adj_workspace_floats(lanes, n_steps, batch, hidden, itemsize)
    grid = (grid_plan(batch, lanes, hidden, itemsize, adjoint=True)
            if adj_streamed(hidden, itemsize) else None)
    if grid is not None:
        return dict(_grid_fields(grid, max(grid["smem"], _adj_pass_bytes(itemsize))),
                    workspace=workspace)
    rows = adj_row_tile(batch, lanes, hidden, itemsize)
    if adj_streamed(hidden, itemsize):
        res = stream_resident(hidden, itemsize, rows, adjoint=True)
        kind, cluster, streamed = 4, MAX_CLUSTER, cluster_units(hidden, MAX_CLUSTER) - max(res, 0)
    else:
        cluster = adj_cluster_size(hidden, itemsize)
        kind = 0 if walk_in_registers(hidden) else 1 if cluster == 1 else 2
        res, streamed = cluster_units(hidden, cluster), 0
    return dict(instantiation=INSTANTIATIONS[kind], cluster=cluster, rows=rows,
                resident=res, streamed=streamed,
                shared_bytes=adj_shared_bytes(hidden, itemsize, rows), groups=0, threads=0,
                workspace=workspace)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def gru_forward_fb_plain(xg: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor, h0: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """xg [F, T, B, 3H], w_hh [F, 3H, H], b_hh [F, 3H], h0 [F, B, H] f32
    -> ys [F, T, B, H] in xg's dtype. Same arithmetic as the kernel: operands
    rounded to the stream dtype, products summed in float32, f32 carry."""
    dt = xg.dtype
    hidden = h0.shape[-1]
    w_t = w_hh.to(dt).float().transpose(1, 2)   # [F, H, 3H]
    b = b_hh.to(dt).float()[:, None, :]          # [F, 1, 3H]
    h = h0.float()
    ys = torch.empty(xg.shape[:-1] + (hidden,), dtype=dt, device=xg.device)
    steps = range(xg.shape[1] - 1, -1, -1) if reverse else range(xg.shape[1])
    for t in steps:
        hg = torch.matmul(h.to(dt).float(), w_t) + b
        xr, xz, xn = xg[:, t].float().split(hidden, dim=-1)
        hr, hz, hn = hg.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys[:, t] = h.to(dt)
    return ys


def gru_forward_plain(xg: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, h0: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """xg [T, B, 3H], w_hh [3H, H], b_hh [3H], h0 [B, H] f32 -> ys [T, B, H]."""
    return gru_forward_fb_plain(xg[None], w_hh[None], b_hh[None], h0[None],
                                reverse)[0]


def gru_backward_fb_plain(xg: torch.Tensor, w_hh: torch.Tensor,
                          b_hh: torch.Tensor, h0: torch.Tensor,
                          ys: torch.Tensor, dy: torch.Tensor,
                          reverse: bool = False):
    """Adjoint of gru_forward_fb_plain's walk, an explicit loop with the
    kernel's arithmetic (not autograd through the forward, which in bf16
    would differentiate another function): xg [F, T, B, 3H], w_hh [F, 3H, H],
    b_hh [F, 3H] in the stream dtype, h0 [F, B, H] f32, ys and dy
    [F, T, B, H] in the stream dtype -> (dxg [F, T, B, 3H] in the stream
    dtype, dw_hh [F, 3H, H], db_hh [F, 3H], dh0 [F, B, H], all f32)."""
    dt = xg.dtype
    hidden = h0.shape[-1]
    w = w_hh.to(dt).float()                      # [F, 3H, H]
    w_t = w.transpose(1, 2)                      # [F, H, 3H]
    b = b_hh.to(dt).float()[:, None, :]
    h0_lo = h0.to(dt)[:, None]
    # State entering each forward step (gru_pallas.py:277-283).
    if reverse:
        h_prev = torch.cat([ys[:, 1:], h0_lo], dim=1)
    else:
        h_prev = torch.cat([h0_lo, ys[:, :-1]], dim=1)
    dh = torch.zeros(h0.shape, dtype=torch.float32, device=xg.device)
    dw_t = torch.zeros(w_t.shape, dtype=torch.float32, device=xg.device)
    db = torch.zeros(b_hh.shape, dtype=torch.float32, device=xg.device)
    dxg = torch.empty_like(xg)
    steps = range(xg.shape[1]) if reverse else range(xg.shape[1] - 1, -1, -1)
    for t in steps:
        hp = h_prev[:, t].float()
        hg = torch.matmul(hp, w_t) + b
        xr, xz, xn = xg[:, t].float().split(hidden, dim=-1)
        hr, hz, hn = hg.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dht = dh + dy[:, t].float()
        dz = dht * (hp - n)
        dn = dht * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxg[:, t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1).to(dt)
        dg = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)   # [F, B, 3H]
        dg_lo = dg.to(dt).float()
        dw_t += torch.matmul(hp.transpose(1, 2), dg_lo)
        db += dg.sum(dim=1)
        dh = dht * z + torch.matmul(dg_lo, w)
    return dxg, dw_t.transpose(1, 2).contiguous(), db, dh


def adj_factors_plain(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                      h0: torch.Tensor, ys: torch.Tensor, dy: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """The plain version of the adjoint's gate pre-pass (csrc/gru_bwd.cu,
    gru_adj_gates_kernel) for [F, T, B, .] streams as gru_backward_fb_plain
    takes them: hg = h_prev @ W^T + bh for every (lane, t, b) at once, then
    r, z, n and the six f32 factors the walk and the weight-gradient pass
    read, in the workspace's layout [F, T, B, 6, H]: a_r = cn cr, cz, a_n =
    cn r, z, dy and cn, where cz = (h_prev - n) z (1 - z), cn = (1 - z)(1 -
    n^2), cr = hn r (1 - r)."""
    dt = xg.dtype
    hidden = h0.shape[-1]
    w_t = w_hh.to(dt).float().transpose(1, 2)               # [F, H, 3H]
    h0_lo = h0.to(dt)[:, None]
    h_prev = (torch.cat([ys[:, 1:], h0_lo], dim=1) if reverse
              else torch.cat([h0_lo, ys[:, :-1]], dim=1)).float()
    hg = torch.matmul(h_prev.flatten(1, 2), w_t).view(*xg.shape)
    hg = hg + b_hh.to(dt).float()[:, None, None]
    xr, xz, xn = xg.float().split(hidden, dim=-1)
    hr, hz, hn = hg.split(hidden, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    cn = (1.0 - z) * (1.0 - n * n)
    return torch.stack([cn * (hn * r * (1.0 - r)), (h_prev - n) * z * (1.0 - z), cn * r, z,
                        dy.float(), cn], dim=-2)


def gru_backward_plain(xg: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor, h0: torch.Tensor, ys: torch.Tensor,
                       dy: torch.Tensor, reverse: bool = False):
    """xg [T, B, 3H], w_hh [3H, H], b_hh [3H], h0 [B, H], ys, dy [T, B, H]
    -> (dxg [T, B, 3H], dw_hh [3H, H], db_hh [3H], dh0 [B, H])."""
    grads = gru_backward_fb_plain(xg[None], w_hh[None], b_hh[None], h0[None],
                                  ys[None], dy[None], reverse)
    return tuple(g[0] for g in grads)


def gru_bifwd_plain(xg2: torch.Tensor, whh2: torch.Tensor, bhh2: torch.Tensor,
                    h02: torch.Tensor) -> torch.Tensor:
    """L lanes of the fused walk (a BiGRU layer's two directions, or F
    folds' as 2F lanes), all walking forward, float32: xg2 [T, L, B, 3H]
    (the backward directions already flipped in time), whh2 [L, 3H, H],
    bhh2 [L, 3H], h02 [L, B, H] -> ys2 [T, L, B, H]."""
    hidden = h02.shape[-1]
    w_t = whh2.transpose(1, 2)                   # [L, H, 3H]
    b = bhh2[:, None, :]                         # [L, 1, 3H]
    h = h02
    ys = torch.empty(xg2.shape[:-1] + (hidden,), dtype=torch.float32,
                     device=xg2.device)
    for t in range(xg2.shape[0]):
        hg = torch.matmul(h, w_t) + b
        xr, xz, xn = xg2[t].split(hidden, dim=-1)
        hr, hz, hn = hg.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return ys


def gru_bibwd_plain(xg2, whh2, bhh2, h02, ys2, dy2):
    """Adjoint of gru_bifwd_plain's walk, an explicit float32 loop walking
    time backward, h_prev = [h0, ys[:-1]] read in place: xg2 [T, L, B, 3H],
    whh2 [L, 3H, H], bhh2 [L, 3H], h02 [L, B, H], ys2 and dy2 [T, L, B, H]
    -> (dxg2 [T, L, B, 3H], dw_hh [L, 3H, H], db_hh [L, 3H], dh0 [L, B, H])."""
    hidden = h02.shape[-1]
    w_t = whh2.transpose(1, 2)                   # [L, H, 3H]
    b = bhh2[:, None, :]
    dh = torch.zeros_like(h02)
    dw_t = torch.zeros_like(w_t)
    db = torch.zeros_like(bhh2)
    dxg = torch.empty_like(xg2)
    for t in range(xg2.shape[0] - 1, -1, -1):
        hp = ys2[t - 1] if t > 0 else h02
        hg = torch.matmul(hp, w_t) + b
        xr, xz, xn = xg2[t].split(hidden, dim=-1)
        hr, hz, hn = hg.split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dht = dh + dy2[t]
        dz = dht * (hp - n)
        dn_pre = dht * (1.0 - z) * (1.0 - n * n)
        dr_pre = dn_pre * hn * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dxg[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        dg = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)   # [L, B, 3H]
        dw_t += torch.matmul(hp.transpose(1, 2), dg)
        db += dg.sum(dim=1)
        dh = dht * z + torch.matmul(dg, whh2)
    return dxg, dw_t.transpose(1, 2).contiguous(), db, dh


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/gru_fwd.cu, built at first use, with its C signatures declared."""
    from multimodalsignal_tpu_torch.ops import _build

    lib = _build.library("gru_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gru_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.gru_fwd.restype = i32
    lib.gru_fwd_fb.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.gru_fwd_fb.restype = i32
    lib.gru_bifwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.gru_bifwd.restype = i32
    lib.gru_walk_plan.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_walk_plan.restype = None
    lib.gru_walk_shared_bytes.argtypes = [i32, i32, i32]
    lib.gru_walk_shared_bytes.restype = ctypes.c_longlong
    lib.gru_walk_row_tile.argtypes = [i32] * 4
    lib.gru_walk_row_tile.restype = i32
    lib.gru_walk_cluster_size.argtypes = [i32, i32]
    lib.gru_walk_cluster_size.restype = i32
    lib.gru_walk_blocks_per_sm.argtypes = [i32] * 4
    lib.gru_walk_blocks_per_sm.restype = i32
    lib.gru_walk_active_clusters.argtypes = [i32] * 4
    lib.gru_walk_active_clusters.restype = i32
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """csrc/gru_bwd.cu, built at first use, with its C signatures declared."""
    from multimodalsignal_tpu_torch.ops import _build

    lib = _build.library("gru_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gru_bwd.argtypes = [ptr] * 12 + [i32] * 5 + [ptr]
    lib.gru_bwd.restype = i32
    lib.gru_bwd_fb.argtypes = [ptr] * 12 + [i32] * 6 + [ptr]
    lib.gru_bwd_fb.restype = i32
    lib.gru_bibwd.argtypes = [ptr] * 12 + [i32] * 4 + [ptr]
    lib.gru_bibwd.restype = i32
    lib.gru_adj_shared_bytes.argtypes = [i32, i32, i32]
    lib.gru_adj_shared_bytes.restype = ctypes.c_longlong
    lib.gru_adj_row_tile.argtypes = [i32] * 4
    lib.gru_adj_row_tile.restype = i32
    lib.gru_adj_walk_blocks_per_sm.argtypes = [i32] * 4
    lib.gru_adj_walk_blocks_per_sm.restype = i32
    lib.gru_adj_cluster_size.argtypes = [i32, i32]
    lib.gru_adj_cluster_size.restype = i32
    lib.gru_adj_walk_active_clusters.argtypes = [i32] * 4
    lib.gru_adj_walk_active_clusters.restype = i32
    lib.gru_adj_chunk_rows.argtypes = [i32] * 4
    lib.gru_adj_chunk_rows.restype = ctypes.c_longlong
    lib.gru_adj_partials.argtypes = [i32] * 4
    lib.gru_adj_partials.restype = i32
    lib.gru_adj_workspace_floats.argtypes = [i32] * 5
    lib.gru_adj_workspace_floats.restype = ctypes.c_longlong
    lib.gru_adj_plan.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_adj_plan.restype = None
    lib.gru_adj_pass_plan.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.gru_adj_pass_plan.restype = None
    return lib


PLAN_FIELDS = ("instantiation", "cluster", "rows", "resident", "streamed", "shared_bytes",
               "workspace", "groups", "threads")


def c_plan(adjoint: bool, batch: int, lanes: int, hidden: int, itemsize: int,
           n_steps: int = 1) -> dict:
    """gru_walk_plan or gru_adj_plan from the built library, in the form of
    walk_plan / adj_plan."""
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    bf16 = int(itemsize == 2)
    if adjoint:
        _bwd_library().gru_adj_plan(batch, lanes, n_steps, hidden, bf16, out)
    else:
        _library().gru_walk_plan(batch, lanes, hidden, bf16, out)
    plan = dict(zip(PLAN_FIELDS, out))
    plan["instantiation"] = INSTANTIATIONS[plan["instantiation"]]
    return plan


def c_pass_plan(lanes: int, n_steps: int, batch: int, hidden: int, itemsize: int) -> dict:
    """gru_adj_pass_plan from the built library (the card's pre-pass
    capacity), in the form of adj_pass_plan."""
    out = (ctypes.c_longlong * 10)()
    _bwd_library().gru_adj_pass_plan(lanes, n_steps, batch, hidden, int(itemsize == 2), out)
    v = list(out)
    return dict(capacity=v[0], gates_grid=tuple(v[1:4]), gates_shared_bytes=v[4],
                grad_grid=tuple(v[5:8]), chunk_rows=v[8], grad_shared_bytes=v[9])


def _check_cuda_args(xg, w_hh, b_hh, h0, fb: bool, smem=None):
    """Validate what the kernel takes; returns (lanes, T, B, H). `smem` is
    the kernel's shared-memory formula (default: the walk kernel's)."""
    if xg.dim() != (4 if fb else 3):
        raise ValueError(f"xg must be [{'F, ' if fb else ''}T, B, 3H], "
                         f"got {list(xg.shape)}")
    lead = tuple(xg.shape[:1]) if fb else ()
    n_steps, batch, three_h = xg.shape[-3:]
    if three_h % 3:
        raise ValueError(f"xg's last axis must be 3H, got {three_h}")
    hidden = three_h // 3
    want = {"w_hh": lead + (three_h, hidden), "b_hh": lead + (three_h,),
            "h0": lead + (batch, hidden)}
    for name, t in (("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {list(want[name])}, "
                             f"got {list(t.shape)}")
    dev = xg.device
    for name, t in (("xg", xg), ("w_hh", w_hh), ("b_hh", b_hh), ("h0", h0)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xg on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xg.dtype not in _STREAM_DTYPES:
        raise TypeError(f"xg must be float32 or bfloat16, got {xg.dtype}")
    if w_hh.dtype != xg.dtype or b_hh.dtype != xg.dtype:
        raise TypeError("w_hh and b_hh must have xg's dtype "
                        f"({xg.dtype}), got {w_hh.dtype} and {b_hh.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32 (the carry), got {h0.dtype}")
    _check_hidden(smem or walk_shared_bytes, hidden, xg.element_size(), xg.dtype)
    if max(*lead, n_steps, batch) * three_h >= 2**31:
        raise ValueError("a dimension is too large for the kernel's int arguments")
    return (lead or (1,))[0], n_steps, batch, hidden


def _check_hidden(smem, hidden: int, itemsize: int, dtype) -> None:
    """Refuse, before any launch, an H whose per-CTA shared memory exceeds
    the card's even in the streamed walk at one row a tile (its h or dg
    buffers, its chunks and its copy rings, with no W resident)."""
    need = smem(hidden, itemsize)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"hidden size {hidden} needs {need} bytes of shared memory per block "
            f"(the streamed walk's step buffers at one row, W streamed) in {dtype}; "
            f"the kernel takes at most {MAX_SHARED_BYTES}, so H up to "
            f"{max_hidden(smem, itemsize)}")


def _require_cuda(xg) -> None:
    if xg.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {xg.device}")


def _mode_args(xg, reverse: bool) -> list[int]:
    """The trailing (reverse, bf16) ints of the dtype-generic entry points."""
    return [int(bool(reverse)), int(xg.dtype == torch.bfloat16)]


def _launch(entry: str, xg, w_hh, b_hh, h0, reverse: bool, fb: bool):
    """Allocate ys and launch `entry` on the current stream. Returns
    (ys, whether a kernel was launched); nothing is launched for empty ys."""
    _require_cuda(xg)
    f, n_steps, batch, hidden = _check_cuda_args(xg, w_hh, b_hh, h0, fb)
    ys = torch.empty(xg.shape[:-1] + (hidden,), dtype=xg.dtype, device=xg.device)
    if ys.numel() == 0:
        return ys, False
    _call(_library(), entry, (xg, w_hh, b_hh, h0, ys, _walk_workspace(xg, batch, f, hidden)),
          ([f] if fb else []) + [n_steps, batch, hidden] + _mode_args(xg, reverse))
    return ys, True


def _walk_workspace(xg, batch: int, lanes: int, hidden: int) -> torch.Tensor:
    """The forward entries' w_pad: the grid walk's exchange buffers and
    counters or the streamed walk's padded copy of W, in xg's dtype
    (walk_workspace_elems; empty for the other instantiations)."""
    return torch.empty(walk_workspace_elems(batch, lanes, hidden, xg.element_size()),
                       dtype=xg.dtype, device=xg.device)


def _call(lib: ctypes.CDLL, entry: str, tensors, ints: list[int]) -> None:
    """Call C `entry` with the tensors' pointers, the ints and the current
    stream; raise if it returns a CUDA error. Under a running torch.profiler
    the launch is a range named `entry` (record_function), so a trace names
    the entry beside its kernels; otherwise nothing is recorded."""
    named = (torch.profiler.record_function(entry) if torch.autograd._profiler_enabled()
             else contextlib.nullcontext())
    with torch.cuda.device(tensors[0].device), named:
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *ints, stream)
    if err == NO_CLUSTER:
        raise RuntimeError(f"{entry} launch refused: no thread block cluster of the walk's "
                           "size fits the card (cudaOccupancyMaxActiveClusters is 0)")
    if err == NO_GROUP:
        raise RuntimeError(f"{entry} launch refused: the card cannot hold every CTA of the "
                           "grid walk's groups at once (its plan counts one CTA on each of "
                           f"{NUM_SMS} SMs)")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def gru_forward(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One GRU direction over time-major gates (counterpart of _gru_forward):
    xg [T, B, 3H], w_hh [3H, H], b_hh [3H] in xg's dtype, h0 [B, H] float32
    -> ys [T, B, H] in xg's dtype."""
    if xg.device.type == "cpu":
        return gru_forward_plain(xg, w_hh, b_hh, h0, reverse)
    ys, launched = _launch("gru_fwd", xg, w_hh, b_hh, h0, reverse, fb=False)
    if launched:
        gru_forward.launches += 1
    return ys


def gru_forward_fb(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   h0: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """F independent GRU lanes in one walk (counterpart of _gru_forward_fb):
    xg [F, T, B, 3H], w_hh [F, 3H, H], b_hh [F, 3H] in xg's dtype,
    h0 [F, B, H] float32 -> ys [F, T, B, H] in xg's dtype."""
    if xg.device.type == "cpu":
        return gru_forward_fb_plain(xg, w_hh, b_hh, h0, reverse)
    ys, launched = _launch("gru_fwd_fb", xg, w_hh, b_hh, h0, reverse, fb=True)
    if launched:
        gru_forward_fb.launches += 1
    return ys


def _check_bwd_args(xg, w_hh, b_hh, h0, ys, dy, fb: bool):
    """Validate what the adjoint walk takes; returns (lanes, T, B, H). Both
    entries (gru_bwd, one lane; gru_bwd_fb, F lanes) are sized by
    adj_shared_bytes."""
    dims = _check_cuda_args(xg, w_hh, b_hh, h0, fb, smem=adj_shared_bytes)
    want = tuple(xg.shape[:-1]) + (dims[-1],)
    for name, t in (("ys", ys), ("dy", dy)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {list(want)}, got {list(t.shape)}")
        if t.dtype != xg.dtype:
            raise TypeError(f"{name} must have xg's dtype ({xg.dtype}), got {t.dtype}")
        if t.device != xg.device:
            raise ValueError(f"{name} is on {t.device}, xg on {xg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dims


def _adjoint_workspaces(lanes: int, n_steps: int, batch: int, hidden: int,
                        itemsize: int = 4) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of the two f32 workspaces an adjoint entry with `lanes` lanes
    takes (dw_part, db_part): the adjoint walk's flat workspace (factors,
    dht, dW partials and, streamed, W^T) and its db partials per lane and
    chunk of rows."""
    return ((adj_workspace_floats(lanes, n_steps, batch, hidden, itemsize),),
            (lanes, adj_partials(lanes, n_steps, batch, hidden)[1], 3 * hidden))


def _launch_adjoint(entry: str, xg, w_hh, b_hh, h0, ys, dy, lanes: int, n_steps: int,
                    batch: int, hidden: int, ints: list[int]):
    """Allocate the gradients and the workspaces and launch `entry` on the
    current stream with `ints` after the pointers. Returns ((dxg, dw_hh,
    db_hh, dh0), whether a kernel was launched); nothing is launched for an
    empty walk."""
    f32 = dict(dtype=torch.float32, device=xg.device)
    dxg = torch.empty_like(xg)
    dw = torch.empty(w_hh.shape, **f32)
    db = torch.empty(b_hh.shape, **f32)
    dh0 = torch.empty(h0.shape, **f32)
    if xg.numel() == 0:
        for g in (dw, db, dh0):
            g.zero_()
        return (dxg, dw, db, dh0), False
    dw_shape, db_shape = _adjoint_workspaces(lanes, n_steps, batch, hidden, xg.element_size())
    dw_part = torch.empty(dw_shape, **f32)
    db_part = torch.empty(db_shape, **f32)
    _call(_bwd_library(), entry,
          (xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part), ints)
    return (dxg, dw, db, dh0), True


def adj_factors_cuda(xg, w_hh, b_hh, h0, ys, dy, reverse: bool = False) -> torch.Tensor:
    """The gate pre-pass's six factors [F, T, B, 6, H] (f32) as gru_bwd_fb
    leaves them in its workspace, for CUDA streams as gru_backward_fb takes
    them: what adj_factors_plain computes, read back to check the kernel.
    The call is not counted as a launch."""
    _require_cuda(xg)
    lanes, n_steps, batch, hidden = _check_bwd_args(xg, w_hh, b_hh, h0, ys, dy, fb=True)
    dw_shape, db_shape = _adjoint_workspaces(lanes, n_steps, batch, hidden, xg.element_size())
    f32 = dict(dtype=torch.float32, device=xg.device)
    dw_part = torch.full(dw_shape, float("nan"), **f32)
    outs = (torch.empty_like(xg), torch.empty(w_hh.shape, **f32), torch.empty(b_hh.shape, **f32),
            torch.empty(h0.shape, **f32))
    _call(_bwd_library(), "gru_bwd_fb", (xg, w_hh, b_hh, h0, ys, dy, *outs, dw_part,
                                         torch.empty(db_shape, **f32)),
          [lanes, n_steps, batch, hidden, *_mode_args(xg, reverse)])
    rows = lanes * n_steps * batch
    return dw_part[:rows * ADJ_FACTORS * hidden].view(lanes, n_steps, batch, ADJ_FACTORS, hidden)


def _launch_bwd(entry: str, xg, w_hh, b_hh, h0, ys, dy, reverse: bool, fb: bool):
    """_launch_adjoint for gru_bwd / gru_bwd_fb ([F, T, B, .] streams)."""
    _require_cuda(xg)
    f, n_steps, batch, hidden = _check_bwd_args(xg, w_hh, b_hh, h0, ys, dy, fb)
    ints = ([f] if fb else []) + [n_steps, batch, hidden] + _mode_args(xg, reverse)
    return _launch_adjoint(entry, xg, w_hh, b_hh, h0, ys, dy, f, n_steps, batch, hidden,
                           ints)


def gru_backward(xg, w_hh, b_hh, h0, ys, dy, reverse: bool = False):
    """Adjoint of gru_forward (counterpart of _gru_backward): xg [T, B, 3H],
    w_hh [3H, H], b_hh [3H] in the stream dtype, h0 [B, H] f32, ys and dy
    [T, B, H] in the stream dtype -> (dxg [T, B, 3H] in the stream dtype,
    dw_hh [3H, H], db_hh [3H], dh0 [B, H] float32)."""
    if xg.device.type == "cpu":
        return gru_backward_plain(xg, w_hh, b_hh, h0, ys, dy, reverse)
    grads, launched = _launch_bwd("gru_bwd", xg, w_hh, b_hh, h0, ys, dy,
                                  reverse, fb=False)
    if launched:
        gru_backward.launches += 1
    return grads


def gru_backward_fb(xg, w_hh, b_hh, h0, ys, dy, reverse: bool = False):
    """Adjoint of gru_forward_fb (counterpart of _gru_backward_fb), per lane:
    xg [F, T, B, 3H], w_hh [F, 3H, H], b_hh [F, 3H], h0 [F, B, H] f32, ys and
    dy [F, T, B, H] -> (dxg [F, T, B, 3H], dw_hh [F, 3H, H], db_hh [F, 3H],
    dh0 [F, B, H])."""
    if xg.device.type == "cpu":
        return gru_backward_fb_plain(xg, w_hh, b_hh, h0, ys, dy, reverse)
    grads, launched = _launch_bwd("gru_bwd_fb", xg, w_hh, b_hh, h0, ys, dy,
                                  reverse, fb=True)
    if launched:
        gru_backward_fb.launches += 1
    return grads


def _check_bi_args(xg2, whh2, bhh2, h02, smem, **streams):
    """Validate what the fused BiGRU pair takes (both devices: the pair is
    float32 only, as the TPU kernels are): whh2 [L, 3H, H] names the lanes,
    an even L of at least 2 (a forward and a backward direction for each
    fold); xg2 [T, L, B, 3H], bhh2 [L, 3H], h02 [L, B, H] and `streams`
    (ys2, dy2) [T, L, B, H], all float32, contiguous, on one device. Returns
    (T, B, H)."""
    if whh2.dim() != 3:
        raise ValueError(f"whh2 must be [L, 3H, H], got {list(whh2.shape)}")
    lanes = whh2.shape[0]
    if lanes < 2 or lanes % 2:
        raise ValueError(f"the fused pair walks an even number of lanes (each fold's two "
                         f"directions), at least 2; whh2 holds {lanes}")
    if xg2.dim() != 4 or xg2.shape[1] != lanes:
        raise ValueError(f"xg2 must be [T, {lanes}, B, 3H], got {list(xg2.shape)}")
    n_steps, _, batch, three_h = xg2.shape
    if three_h % 3:
        raise ValueError(f"xg2's last axis must be 3H, got {three_h}")
    hidden = three_h // 3
    want = {"whh2": (lanes, three_h, hidden), "bhh2": (lanes, three_h),
            "h02": (lanes, batch, hidden)}
    want.update({name: (n_steps, lanes, batch, hidden) for name in streams})
    tensors = dict(xg2=xg2, whh2=whh2, bhh2=bhh2, h02=h02, **streams)
    for name, t in tensors.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {list(want[name])}, "
                             f"got {list(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the fused BiGRU kernels take float32 only; {name} "
                            f"is {t.dtype} (cast first, as gru_bidirectional_folds does)")
        if t.device != xg2.device:
            raise ValueError(f"{name} is on {t.device}, xg2 on {xg2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_hidden(smem, hidden, 4, torch.float32)
    if max(n_steps, batch) * lanes * three_h >= 2**31:
        raise ValueError("a dimension is too large for the kernel's int arguments")
    return n_steps, batch, hidden


def gru_bifwd(xg2: torch.Tensor, whh2: torch.Tensor, bhh2: torch.Tensor,
              h02: torch.Tensor) -> torch.Tensor:
    """L lanes of the fused forward walk (counterpart of _bigru_forward; L = 2
    for one BiGRU layer's directions, 2F for F folds of it), float32:
    xg2 [T, L, B, 3H] with every odd lane already flipped in time, whh2
    [L, 3H, H], bhh2 [L, 3H], h02 [L, B, H] -> ys2 [T, L, B, H]."""
    n_steps, batch, hidden = _check_bi_args(xg2, whh2, bhh2, h02, walk_shared_bytes)
    if xg2.device.type == "cpu":
        return gru_bifwd_plain(xg2, whh2, bhh2, h02)
    _require_cuda(xg2)
    ys2 = torch.empty(xg2.shape[:-1] + (hidden,), dtype=torch.float32,
                      device=xg2.device)
    if ys2.numel() == 0:
        return ys2
    _call(_library(), "gru_bifwd",
          (xg2, whh2, bhh2, h02, ys2, _walk_workspace(xg2, batch, xg2.shape[1], hidden)),
          [xg2.shape[1], n_steps, batch, hidden])
    gru_bifwd.launches += 1
    return ys2


def gru_bibwd(xg2, whh2, bhh2, h02, ys2, dy2):
    """Adjoint of gru_bifwd (counterpart of _bigru_backward), float32,
    walking time backward: xg2 [T, L, B, 3H], whh2 [L, 3H, H], bhh2 [L, 3H],
    h02 [L, B, H], ys2 and dy2 [T, L, B, H] -> (dxg2 [T, L, B, 3H],
    dw_hh [L, 3H, H], db_hh [L, 3H], dh0 [L, B, H]), per lane."""
    n_steps, batch, hidden = _check_bi_args(xg2, whh2, bhh2, h02, adj_shared_bytes,
                                            ys2=ys2, dy2=dy2)
    if xg2.device.type == "cpu":
        return gru_bibwd_plain(xg2, whh2, bhh2, h02, ys2, dy2)
    _require_cuda(xg2)
    lanes = xg2.shape[1]
    grads, launched = _launch_adjoint("gru_bibwd", xg2, whh2, bhh2, h02, ys2, dy2, lanes,
                                      n_steps, batch, hidden, [lanes, n_steps, batch, hidden])
    if launched:
        gru_bibwd.launches += 1
    return grads


_WRAPPERS = {"gru_fwd": gru_forward, "gru_fwd_fb": gru_forward_fb,
             "gru_bwd": gru_backward, "gru_bwd_fb": gru_backward_fb,
             "gru_bifwd": gru_bifwd, "gru_bibwd": gru_bibwd}
for _w in _WRAPPERS.values():
    _w.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by C entry point."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0


# ---------------------------------------------------------------------------
# Autograd (counterpart of _gru_tm's custom VJP, gru_pallas.py:826-846)
# ---------------------------------------------------------------------------

def _walk_backward(backward_fn, ctx, dy):
    """Cotangents of (xg, w_hh, b_hh, h0, reverse), cast to the primal
    dtypes as _gru_tm_bwd does: dW and db in bf16 when the weights are bf16
    (the f32 master parameters take them back to f32 through the casts
    outside), dh0 f32."""
    xg, w_hh, b_hh, h0, ys = ctx.saved_tensors
    dxg, dw, db, dh0 = backward_fn(xg, w_hh, b_hh, h0, ys,
                                   dy.to(ys.dtype).contiguous(), ctx.reverse)
    return (dxg.to(xg.dtype), dw.to(w_hh.dtype), db.to(b_hh.dtype),
            dh0.to(h0.dtype), None)


class _GruWalk(torch.autograd.Function):
    """ys = gru_forward(xg, w_hh, b_hh, h0); its backward runs gru_backward."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, h0, reverse: bool):
        ys = gru_forward(xg, w_hh, b_hh, h0, reverse)
        ctx.save_for_backward(xg, w_hh, b_hh, h0, ys)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dy):
        return _walk_backward(gru_backward, ctx, dy)


class _GruWalkFb(torch.autograd.Function):
    """F lanes: ys = gru_forward_fb(...); its backward runs gru_backward_fb."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, h0, reverse: bool):
        ys = gru_forward_fb(xg, w_hh, b_hh, h0, reverse)
        ctx.save_for_backward(xg, w_hh, b_hh, h0, ys)
        ctx.reverse = reverse
        return ys

    @staticmethod
    def backward(ctx, dy):
        return _walk_backward(gru_backward_fb, ctx, dy)


class _BiGruWalk(torch.autograd.Function):
    """ys2 = gru_bifwd(xg2, whh2, bhh2, h02); its backward runs gru_bibwd
    (counterpart of _bigru_tm's custom VJP, gru_pallas.py:1065-1080). All
    float32, so the cotangents need no cast."""

    @staticmethod
    def forward(ctx, xg2, whh2, bhh2, h02):
        ys2 = gru_bifwd(xg2, whh2, bhh2, h02)
        ctx.save_for_backward(xg2, whh2, bhh2, h02, ys2)
        return ys2

    @staticmethod
    def backward(ctx, dy2):
        xg2, whh2, bhh2, h02, ys2 = ctx.saved_tensors
        return gru_bibwd(xg2, whh2, bhh2, h02, ys2, dy2.float().contiguous())


# ---------------------------------------------------------------------------
# Model-facing entry points (batch-major, like the JAX package's)
# ---------------------------------------------------------------------------

def _stream_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def gru_sequence_cuda(x_gates: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor, h0: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """Drop-in for models.gru.gru_sequence (counterpart of
    gru_sequence_pallas): x_gates [B, T, 3H] -> ys [B, T, H]. bf16 gates
    select the kernel's bf16 mode; anything else runs in float32."""
    dt = _stream_dtype(x_gates)
    x_tm = x_gates.transpose(0, 1).to(dt).contiguous()
    ys = _GruWalk.apply(x_tm, w_hh.to(dt).contiguous(), b_hh.to(dt).contiguous(),
                        h0.float().contiguous(), bool(reverse))
    return ys.transpose(0, 1)


# ---------------------------------------------------------------------------
# Fold grouping (counterpart of gru_pallas.py:602-691): G folds as one lane
# of width G·H, the hidden states fold-major along the features, the gate
# columns gate-major, W block-diagonal (the zero blocks cancel the cross-fold
# terms exactly). Off by default, as in the JAX package, where it measured
# slower on a TPU; MMS_GRU_FOLD_GROUP >= 2 turns it on with that preferred
# group size.
# ---------------------------------------------------------------------------

FOLD_GROUP_ENV = "MMS_GRU_FOLD_GROUP"


def pick_group(lanes: int) -> int:
    """Folds a group holds (counterpart of _pick_group): 1 unless
    MMS_GRU_FOLD_GROUP >= 2; then the first of (that size, 4, 3, 2) no
    larger than it that divides the lane count, else 1."""
    top = int(os.environ.get(FOLD_GROUP_ENV, 1))
    if top <= 1:
        return 1
    for g in (top, 4, 3, 2):
        if g <= top and lanes % g == 0:
            return g
    return 1


def _group_cols(x: torch.Tensor, fg: int, g: int) -> torch.Tensor:
    """[F, *lead, 3H] -> [Fg, *lead, 3GH] with gate-major columns."""
    lead, h, n = x.shape[1:-1], x.shape[-1] // 3, x.dim() - 2
    y = x.reshape((fg, g) + lead + (3, h))
    perm = (0,) + tuple(range(2, 2 + n)) + (2 + n, 1, 3 + n)
    return y.permute(perm).reshape((fg,) + lead + (3 * g * h,))


def _ungroup_cols(y: torch.Tensor, fg: int, g: int) -> torch.Tensor:
    """Inverse of _group_cols."""
    lead, h, n = y.shape[1:-1], y.shape[-1] // (3 * g), y.dim() - 2
    z = y.reshape((fg,) + lead + (3, g, h))
    perm = (0, 2 + n) + tuple(range(1, 1 + n)) + (1 + n, 3 + n)
    return z.permute(perm).reshape((fg * g,) + lead + (3 * h,))


def _group_h(x: torch.Tensor, fg: int, g: int) -> torch.Tensor:
    """[F, *lead, H] -> [Fg, *lead, GH] (fold-major columns)."""
    lead, h, n = x.shape[1:-1], x.shape[-1], x.dim() - 2
    y = x.reshape((fg, g) + lead + (h,))
    perm = (0,) + tuple(range(2, 2 + n)) + (1, 2 + n)
    return y.permute(perm).reshape((fg,) + lead + (g * h,))


def _ungroup_h(y: torch.Tensor, fg: int, g: int) -> torch.Tensor:
    """Inverse of _group_h."""
    lead, h, n = y.shape[1:-1], y.shape[-1] // g, y.dim() - 2
    z = y.reshape((fg,) + lead + (g, h))
    perm = (0, 1 + n) + tuple(range(1, 1 + n)) + (2 + n,)
    return z.permute(perm).reshape((fg * g,) + lead + (h,))


def _blockdiag_w(w_hh: torch.Tensor, fg: int, g: int) -> torch.Tensor:
    """Per-fold [F, 3H, H] recurrent weights -> block-diagonal [Fg, 3GH, GH]:
    rows (gate, fold, H_out) gate-major, columns (fold, H_in) fold-major.
    Its gradient through autograd is the diagonal blocks of the grouped dW,
    what the JAX rule's _diag_dw extracts."""
    h = w_hh.shape[-1]
    w = w_hh.reshape(fg, g, 3, h, h)
    eye = torch.eye(g, dtype=w_hh.dtype, device=w_hh.device)
    return torch.einsum("fgtoi,gk->ftgoki", w, eye).reshape(fg, 3 * g * h, g * h)


def gru_lanes_cuda(x_gates: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                   h0: torch.Tensor, reverse: bool = False,
                   group: bool = True) -> torch.Tensor:
    """F lanes of one GRU direction in one kernel walk (the fold-stacked
    model's walk; counterpart of gru_sequence_pallas under the fold vmap):
    time-major x_gates [F, T, B, 3H], w_hh [F, 3H, H], b_hh [F, 3H],
    h0 [F, B, H] -> ys [F, T, B, H] in the stream dtype (bf16 gates select
    the kernel's bf16 mode). With `group` and pick_group(F) = G >= 2 (the
    JAX rule's grouped branch, gru_pallas.py:756-819), float32 throughout:
    the F folds walk as F/G lanes of width G·H, and ys is cast back to the
    stream dtype; autograd through the regrouping gives the per-fold
    gradients."""
    dt = _stream_dtype(x_gates)
    g = pick_group(x_gates.shape[0]) if group else 1
    if g == 1:
        return _GruWalkFb.apply(x_gates.to(dt).contiguous(), w_hh.to(dt).contiguous(),
                                b_hh.to(dt).contiguous(), h0.float().contiguous(),
                                bool(reverse))
    f32, fg = torch.float32, x_gates.shape[0] // g
    ys = _GruWalkFb.apply(_group_cols(x_gates.to(f32), fg, g).contiguous(),
                          _blockdiag_w(w_hh.to(f32), fg, g).contiguous(),
                          _group_cols(b_hh.to(f32), fg, g).contiguous(),
                          _group_h(h0.float(), fg, g).contiguous(), bool(reverse))
    return _ungroup_h(ys, fg, g).to(dt)


def gru_bidirectional_dirbatch(x_gates_f, x_gates_b, w_hh_f, w_hh_b,
                               b_hh_f, b_hh_b, h0):
    """Both directions of one BiGRU layer as F=2 lanes of one kernel walk;
    the backward direction's gates are flipped in time first so both lanes
    walk forward. x_gates_* [B, T, 3H] -> (ys_fwd, ys_bwd), each [B, T, H] in
    original time order."""
    dt = _stream_dtype(x_gates_f)
    xf = x_gates_f.transpose(0, 1)
    xb = x_gates_b.transpose(0, 1).flip(0)
    xg = torch.stack([xf, xb]).to(dt).contiguous()        # [2, T, B, 3H]
    whh = torch.stack([w_hh_f, w_hh_b]).to(dt).contiguous()
    bhh = torch.stack([b_hh_f, b_hh_b]).to(dt).contiguous()
    h02 = torch.stack([h0, h0]).float().contiguous()
    ys = _GruWalkFb.apply(xg, whh, bhh, h02, False)       # [2, T, B, H]
    return ys[0].transpose(0, 1), ys[1].flip(0).transpose(0, 1)


def gru_bidirectional_folds(x_gates_f, x_gates_b, w_hh_f, w_hh_b, b_hh_f, b_hh_b, h0):
    """F folds of one BiGRU layer in one fused float32 walk of 2F lanes (the
    fold-stacked model's fused pair; counterpart of gru_bidirectional_pallas
    under the fold vmap, whose Pallas batching rule runs each fold's own
    two-lane walk): gates, weights, bias and h0 are cast to float32 whatever
    the compute dtype, each backward direction's gates are flipped in time,
    and the kernels read [T, F, 2, B, .] as [T, 2F, B, .] (lane 2f fold f's
    forward direction, lane 2f + 1 its backward one). Time-major x_gates_*
    [F, T, B, 3H], w_hh_* [F, 3H, H], b_hh_* [F, 3H], h0 [F, B, H] ->
    (ys_fwd, ys_bwd), each [F, T, B, H] float32 in original time order; h0's
    gradient sums both directions' through the stack."""
    f32 = torch.float32
    n_f, n_steps, batch, three_h = x_gates_f.shape
    lanes = 2 * n_f
    xf = x_gates_f.to(f32).transpose(0, 1)                 # [T, F, B, 3H]
    xb = x_gates_b.to(f32).flip(1).transpose(0, 1)         # time-reversed
    xg2 = torch.stack([xf, xb], dim=2).reshape(n_steps, lanes, batch, three_h)
    whh2 = torch.stack([w_hh_f, w_hh_b], dim=1).to(f32).reshape(lanes, three_h, -1)
    bhh2 = torch.stack([b_hh_f, b_hh_b], dim=1).to(f32).reshape(lanes, three_h)
    h02 = torch.stack([h0, h0], dim=1).to(f32).reshape(lanes, batch, -1)
    ys2 = _BiGruWalk.apply(xg2, whh2, bhh2, h02)           # [T, 2F, B, H]
    ys2 = ys2.view(n_steps, n_f, 2, batch, -1)            # [T, F, 2, B, H]
    return ys2[:, :, 0].transpose(0, 1), ys2[:, :, 1].flip(0).transpose(0, 1)


def gru_bidirectional_fused(x_gates_f, x_gates_b, w_hh_f, w_hh_b,
                            b_hh_f, b_hh_b, h0):
    """Both directions of one BiGRU layer in the fused float32 walk
    (counterpart of gru_bidirectional_pallas): gru_bidirectional_folds of
    one fold, batch-major. x_gates_* [B, T, 3H], w_hh_* [3H, H], b_hh_*
    [3H], h0 [B, H] -> (ys_fwd, ys_bwd), each [B, T, H] float32 in original
    time order."""
    ys_f, ys_b = gru_bidirectional_folds(
        x_gates_f.transpose(0, 1)[None], x_gates_b.transpose(0, 1)[None], w_hh_f[None],
        w_hh_b[None], b_hh_f[None], b_hh_b[None], h0[None])
    return ys_f[0].transpose(0, 1), ys_b[0].transpose(0, 1)
