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

The three forward entries run the walk kernel (`gru_walk_kernel`): one
block per (lane, tile of rows), W^T in registers up to H = 64 and in shared
memory above, h double-buffered with one barrier a step, xg prefetched;
`walk_row_tile` and `walk_shared_bytes` mirror how its C side picks the
tile and sizes shared memory. `gru_bwd` runs the adjoint walk: a gate
pre-pass over all T, a walk that keeps only the dh chain (W's columns in
registers up to H = 64, in shared memory above; a producer warp moves its
factors and dht between device and shared memory a chunk of steps at a
time), and a weight-gradient pass over all T, summed in a fixed order;
`adj_row_tile`, `adj_shared_bytes`, `adj_partials` and
`adj_workspace_floats` mirror its C side. `gru_bwd_fb` and `gru_bibwd` run
the first adjoint template (`gru_bwd_kernel`, sized by `bwd_shared_bytes`
and BWD_ROWS_PER_BLOCK).

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
`_bifwd_kernel` and `_bibwd_kernel` are: its streams are [T, 2, B, .], the
direction inside time, and its wrappers refuse anything but float32 streams
on either device (the caller casts first, as `gru_bidirectional_fused` does).
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Batch rows per block of gru_bwd_kernel; must equal kRows in csrc/gru_bwd.cu.
BWD_ROWS_PER_BLOCK = 4
# Dynamic shared memory one block may use on sm_90 (232,448 bytes).
MAX_SHARED_BYTES = 232_448
# The walk kernel (gru_fwd, gru_fwd_fb, gru_bifwd), as csrc/gru_fwd.cu lays
# it out: W^T in registers up to WALK_REG_MAX_HIDDEN, with WALK_SUBLANES
# threads per hidden unit (K split across them), which is also the most
# rows a block takes; the row tile fills NUM_SMS. The adjoint walk (gru_bwd,
# csrc/gru_bwd.cu) takes the same threshold and sub-lanes.
NUM_SMS = 132
WALK_REG_MAX_HIDDEN = 64
WALK_SUBLANES = {True: 8, False: 4}   # by "W in registers"
WALK_REG_KPAD = 64                     # K padded to 8 sub-lanes x 2 chunks of 4
# The adjoint walk's layout (csrc/gru_bwd.cu): K = 3H padded to 8 sub-lanes
# x 6 chunks of 4 with W in registers; at most 2 rows a block with W in
# registers, 1 with W in shared memory; the steps its producer warp moves at
# a time, and the factors it reads; the gate pre-pass's block of rows x
# units; six f32 factors (dy among them) and dht per (step, row, unit) in
# the workspace; the weight-gradient pass's stage of rows and most
# partials.
ADJ_REG_KPAD = 192
ADJ_MOST_ROWS = {True: 2, False: 1}   # by "W in registers"
ADJ_CHUNK = {True: 16, False: 4}
ADJ_WALK_FACTORS = 5
ADJ_GATE_ROWS = ADJ_GATE_UNITS = 32
ADJ_FACTORS = 6
ADJ_GRAD_STAGE = 32
ADJ_MAX_PARTIALS = 128

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


def walk_row_tile(batch: int, lanes: int, hidden: int) -> int:
    """Rows per block of the walk kernel (as gru_walk_row_tile in C), at
    most the threads per hidden unit."""
    return _row_tile(batch, lanes, WALK_SUBLANES[walk_in_registers(hidden)])


def walk_shared_bytes(hidden: int, itemsize: int, rows: int | None = None) -> int:
    """Shared memory per block of the walk kernel (as gru_walk_shared_bytes
    in C): W [3H, K padded to 4] in the stream dtype, padded to 16 bytes,
    for the shared-memory instantiation, then two f32 buffers of the tile's
    h operand, [rows, K padded]. `rows` defaults to the most a block takes,
    so the limit on H holds for every batch."""
    regs = walk_in_registers(hidden)
    rows = WALK_SUBLANES[regs] if rows is None else rows
    kpad = WALK_REG_KPAD if regs else -(-hidden // 4) * 4
    w = 0 if regs else (3 * hidden * kpad * itemsize + 15) // 16 * 16
    return w + 2 * rows * kpad * 4


def adj_row_tile(batch: int, lanes: int, hidden: int) -> int:
    """Rows per block of gru_bwd's walk (as gru_adj_row_tile in C), at most
    ADJ_MOST_ROWS (1 with W in shared memory)."""
    return _row_tile(batch, lanes, ADJ_MOST_ROWS[walk_in_registers(hidden)])


def adj_shared_bytes(hidden: int, itemsize: int, rows: int | None = None) -> int:
    """Shared memory of the most demanding kernel of gru_bwd (as
    gru_adj_shared_bytes in C): the walk's W^T [H, 3H padded to 4] in the
    stream dtype, padded to 16 bytes, for the shared-memory instantiation,
    then two f32 buffers of the tile's dg, [rows, K padded], and for two
    chunks of steps the f32 factors [2 chunk, rows, 5, H] and dht
    [2 chunk, rows, H]; or the gate pre-pass's f32 W slice [H, 3 * 32 + 1],
    padded to 16 bytes, and h_prev [H, 32], whichever is larger. `rows`
    defaults to the most a block takes."""
    regs = walk_in_registers(hidden)
    rows = ADJ_MOST_ROWS[regs] if rows is None else rows
    kpad = ADJ_REG_KPAD if regs else -(-3 * hidden // 4) * 4
    w = 0 if regs else (hidden * kpad * itemsize + 15) // 16 * 16
    per_row = 2 * ADJ_CHUNK[regs] * (ADJ_WALK_FACTORS + 1) * hidden
    walk = w + (2 * rows * kpad + rows * per_row) * 4
    gates = (-(-hidden * (3 * ADJ_GATE_UNITS + 1) // 4) * 4 + hidden * ADJ_GATE_ROWS) * 4
    return max(walk, gates)


def adj_partials(n_steps: int, batch: int) -> tuple[int, int]:
    """(rows per chunk, chunks) of gru_bwd's weight-gradient pass (as
    gru_adj_chunk_rows and gru_adj_partials in C): the T * B rows (t, b) in
    chunks of a whole number of ADJ_GRAD_STAGE rows, at most
    ADJ_MAX_PARTIALS chunks; each chunk gives one dW / db partial."""
    rows = n_steps * batch
    per = -(-rows // ADJ_MAX_PARTIALS) if rows > ADJ_MAX_PARTIALS else 1
    chunk = -(-per // ADJ_GRAD_STAGE) * ADJ_GRAD_STAGE
    return chunk, -(-rows // chunk)


def adj_workspace_floats(lanes: int, n_steps: int, batch: int, hidden: int) -> int:
    """Floats of the workspace gru_bwd takes as dw_part (as
    gru_adj_workspace_floats in C): the six factors and dht of every
    (lane, t, b, unit), then the dW partials [lanes, chunks, 3H, H]."""
    rows = lanes * n_steps * batch
    parts = adj_partials(n_steps, batch)[1]
    return rows * hidden * (ADJ_FACTORS + 1) + lanes * parts * 3 * hidden * hidden


def bwd_shared_bytes(hidden: int, itemsize: int) -> int:
    """Shared memory per block of gru_bwd_kernel (gru_bwd_fb, gru_bibwd; as
    gru_bwd_shared_bytes in C): W^T [H, 3H + 1] in the stream dtype, padded
    to 16 bytes, then the f32 dW^T partial [H, 3H], h_prev, dh and dht*z for
    BWD_ROWS_PER_BLOCK rows, and the step's hg and dg."""
    w = (hidden * (3 * hidden + 1) * itemsize + 15) // 16 * 16
    rows = BWD_ROWS_PER_BLOCK
    return w + (3 * hidden * hidden + 3 * rows * hidden + 2 * rows * 3 * hidden) * 4


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
    """Both directions of one BiGRU layer as one forward walk, float32:
    xg2 [T, 2, B, 3H] (direction 1 already flipped in time), whh2 [2, 3H, H],
    bhh2 [2, 3H], h02 [2, B, H] -> ys2 [T, 2, B, H]."""
    hidden = h02.shape[-1]
    w_t = whh2.transpose(1, 2)                   # [2, H, 3H]
    b = bhh2[:, None, :]                         # [2, 1, 3H]
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
    time backward, h_prev = [h0, ys[:-1]] read in place: xg2 [T, 2, B, 3H],
    whh2 [2, 3H, H], bhh2 [2, 3H], h02 [2, B, H], ys2 and dy2 [T, 2, B, H]
    -> (dxg2 [T, 2, B, 3H], dw_hh [2, 3H, H], db_hh [2, 3H], dh0 [2, B, H])."""
    hidden = h02.shape[-1]
    w_t = whh2.transpose(1, 2)                   # [2, H, 3H]
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
        dg = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)   # [2, B, 3H]
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
    lib.gru_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.gru_fwd.restype = i32
    lib.gru_fwd_fb.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.gru_fwd_fb.restype = i32
    lib.gru_bifwd.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    lib.gru_bifwd.restype = i32
    lib.gru_walk_shared_bytes.argtypes = [i32, i32, i32]
    lib.gru_walk_shared_bytes.restype = ctypes.c_longlong
    lib.gru_walk_row_tile.argtypes = [i32, i32, i32]
    lib.gru_walk_row_tile.restype = i32
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
    lib.gru_bibwd.argtypes = [ptr] * 12 + [i32] * 3 + [ptr]
    lib.gru_bibwd.restype = i32
    lib.gru_bwd_shared_bytes.argtypes = [i32, i32]
    lib.gru_bwd_shared_bytes.restype = ctypes.c_longlong
    lib.gru_adj_shared_bytes.argtypes = [i32, i32, i32]
    lib.gru_adj_shared_bytes.restype = ctypes.c_longlong
    lib.gru_adj_row_tile.argtypes = [i32, i32, i32]
    lib.gru_adj_row_tile.restype = i32
    lib.gru_adj_chunk_rows.argtypes = [i32, i32]
    lib.gru_adj_chunk_rows.restype = ctypes.c_longlong
    lib.gru_adj_partials.argtypes = [i32, i32]
    lib.gru_adj_partials.restype = i32
    lib.gru_adj_workspace_floats.argtypes = [i32, i32, i32, i32]
    lib.gru_adj_workspace_floats.restype = ctypes.c_longlong
    return lib


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
    need = (smem or walk_shared_bytes)(hidden, xg.element_size())
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"hidden size {hidden} needs {need} bytes of shared memory per "
            f"block in {xg.dtype}; the kernel takes at most {MAX_SHARED_BYTES}")
    if max(*lead, n_steps, batch) * three_h >= 2**31:
        raise ValueError("a dimension is too large for the kernel's int arguments")
    return (lead or (1,))[0], n_steps, batch, hidden


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
    _call(_library(), entry, (xg, w_hh, b_hh, h0, ys),
          ([f] if fb else []) + [n_steps, batch, hidden] + _mode_args(xg, reverse))
    return ys, True


def _call(lib: ctypes.CDLL, entry: str, tensors, ints: list[int]) -> None:
    """Call C `entry` with the tensors' pointers, the ints and the current
    stream; raise if it returns a CUDA error."""
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *ints, stream)
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
    """Validate what the adjoint kernel takes; returns (lanes, T, B, H).
    gru_bwd (one lane) runs the adjoint walk, sized by adj_shared_bytes;
    the F-lane entry runs gru_bwd_kernel, sized by bwd_shared_bytes."""
    dims = _check_cuda_args(xg, w_hh, b_hh, h0, fb,
                            smem=bwd_shared_bytes if fb else adj_shared_bytes)
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


def _adjoint_workspaces(entry: str, lanes: int, n_steps: int, batch: int,
                        hidden: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of the two f32 workspaces `entry` takes (dw_part, db_part):
    gru_bwd's flat workspace and its db partials per chunk of rows, or
    gru_bwd_kernel's dW^T and db partials per tile of BWD_ROWS_PER_BLOCK
    rows."""
    g = 3 * hidden
    if entry == "gru_bwd":
        return ((adj_workspace_floats(lanes, n_steps, batch, hidden),),
                (lanes, adj_partials(n_steps, batch)[1], g))
    tiles = -(-batch // BWD_ROWS_PER_BLOCK)
    return (lanes, tiles, hidden, g), (lanes, tiles, g)


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
    dw_shape, db_shape = _adjoint_workspaces(entry, lanes, n_steps, batch, hidden)
    dw_part = torch.empty(dw_shape, **f32)
    db_part = torch.empty(db_shape, **f32)
    _call(_bwd_library(), entry,
          (xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part), ints)
    return (dxg, dw, db, dh0), True


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
    float32 only, as the TPU kernels are): xg2 [T, 2, B, 3H], whh2
    [2, 3H, H], bhh2 [2, 3H], h02 [2, B, H] and `streams` (ys2, dy2)
    [T, 2, B, H], all float32, contiguous, on one device. Returns (T, B, H)."""
    if xg2.dim() != 4 or xg2.shape[1] != 2:
        raise ValueError(f"xg2 must be [T, 2, B, 3H], got {list(xg2.shape)}")
    n_steps, _, batch, three_h = xg2.shape
    if three_h % 3:
        raise ValueError(f"xg2's last axis must be 3H, got {three_h}")
    hidden = three_h // 3
    want = {"whh2": (2, three_h, hidden), "bhh2": (2, three_h),
            "h02": (2, batch, hidden)}
    want.update({name: (n_steps, 2, batch, hidden) for name in streams})
    tensors = dict(xg2=xg2, whh2=whh2, bhh2=bhh2, h02=h02, **streams)
    for name, t in tensors.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {list(want[name])}, "
                             f"got {list(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the fused BiGRU kernels take float32 only; {name} "
                            f"is {t.dtype} (cast first, as gru_bidirectional_fused does)")
        if t.device != xg2.device:
            raise ValueError(f"{name} is on {t.device}, xg2 on {xg2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    need = smem(hidden, 4)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"hidden size {hidden} needs {need} bytes of shared memory per "
            f"block; the kernel takes at most {MAX_SHARED_BYTES}")
    if max(n_steps, batch) * 2 * three_h >= 2**31:
        raise ValueError("a dimension is too large for the kernel's int arguments")
    return n_steps, batch, hidden


def gru_bifwd(xg2: torch.Tensor, whh2: torch.Tensor, bhh2: torch.Tensor,
              h02: torch.Tensor) -> torch.Tensor:
    """Both directions of one BiGRU layer as one forward walk (counterpart
    of _bigru_forward), float32: xg2 [T, 2, B, 3H] with direction 1 already
    flipped in time, whh2 [2, 3H, H], bhh2 [2, 3H], h02 [2, B, H]
    -> ys2 [T, 2, B, H]."""
    n_steps, batch, hidden = _check_bi_args(xg2, whh2, bhh2, h02, walk_shared_bytes)
    if xg2.device.type == "cpu":
        return gru_bifwd_plain(xg2, whh2, bhh2, h02)
    _require_cuda(xg2)
    ys2 = torch.empty(xg2.shape[:-1] + (hidden,), dtype=torch.float32,
                      device=xg2.device)
    if ys2.numel() == 0:
        return ys2
    _call(_library(), "gru_bifwd", (xg2, whh2, bhh2, h02, ys2),
          [n_steps, batch, hidden])
    gru_bifwd.launches += 1
    return ys2


def gru_bibwd(xg2, whh2, bhh2, h02, ys2, dy2):
    """Adjoint of gru_bifwd (counterpart of _bigru_backward), float32,
    walking time backward: xg2 [T, 2, B, 3H], whh2 [2, 3H, H], bhh2 [2, 3H],
    h02 [2, B, H], ys2 and dy2 [T, 2, B, H] -> (dxg2 [T, 2, B, 3H],
    dw_hh [2, 3H, H], db_hh [2, 3H], dh0 [2, B, H]), per direction."""
    n_steps, batch, hidden = _check_bi_args(xg2, whh2, bhh2, h02, bwd_shared_bytes,
                                            ys2=ys2, dy2=dy2)
    if xg2.device.type == "cpu":
        return gru_bibwd_plain(xg2, whh2, bhh2, h02, ys2, dy2)
    _require_cuda(xg2)
    grads, launched = _launch_adjoint("gru_bibwd", xg2, whh2, bhh2, h02, ys2, dy2,
                                      2, n_steps, batch, hidden, [n_steps, batch, hidden])
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


def gru_bidirectional_fused(x_gates_f, x_gates_b, w_hh_f, w_hh_b,
                            b_hh_f, b_hh_b, h0):
    """Both directions of one BiGRU layer in the fused float32 walk
    (counterpart of gru_bidirectional_pallas): gates, weights, bias and h0
    are cast to float32 whatever the compute dtype, the backward direction's
    gates are flipped in time, and the kernels read the time-major
    [T, 2, B, .] layout. x_gates_* [B, T, 3H] -> (ys_fwd, ys_bwd), each
    [B, T, H] float32 in original time order; h0's gradient sums both
    directions' through the stack."""
    f32 = torch.float32
    xf = x_gates_f.transpose(0, 1)                        # [T, B, 3H]
    xb = x_gates_b.transpose(0, 1).flip(0)                # time-reversed
    xg2 = torch.stack([xf, xb], dim=1).to(f32).contiguous()   # [T, 2, B, 3H]
    whh2 = torch.stack([w_hh_f, w_hh_b]).to(f32).contiguous()
    bhh2 = torch.stack([b_hh_f, b_hh_b]).to(f32).contiguous()
    h02 = torch.stack([h0, h0]).to(f32).contiguous()
    ys2 = _BiGruWalk.apply(xg2, whh2, bhh2, h02)          # [T, 2, B, H]
    return ys2[:, 0].transpose(0, 1), ys2[:, 1].flip(0).transpose(0, 1)
