"""GRU recurrence: hand-written CUDA kernels and their plain versions.

Counterpart of multimodalsignal_tpu/ops/gru_pallas.py's single-direction and
fold-batched kernels. Two sources, each one template with a lane axis and
two C entry points, each entry behind its own wrapper here:

  csrc/gru_fwd.cu
  * `gru_forward`     -> C `gru_fwd`     (replaces `_fwd_kernel` / `_gru_forward`)
  * `gru_forward_fb`  -> C `gru_fwd_fb`  (replaces `_fb_fwd_kernel` / `_gru_forward_fb`)
  csrc/gru_bwd.cu
  * `gru_backward`    -> C `gru_bwd`     (replaces `_bwd_kernel` / `_gru_backward`)
  * `gru_backward_fb` -> C `gru_bwd_fb`  (replaces `_fb_bwd_kernel` / `_gru_backward_fb`)

Two `torch.autograd.Function`s pair them as `_gru_tm`'s custom VJP does
(forward saves xg, w_hh, b_hh, h0 and ys; backward runs the adjoint kernel),
and the model-facing entry points go through those:

  * `gru_sequence_cuda`          (counterpart of `gru_sequence_pallas`)
  * `gru_bidirectional_dirbatch` (counterpart of the JAX function of that name)

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
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Batch rows per block; must equal kRows in csrc/gru_fwd.cu and csrc/gru_bwd.cu.
ROWS_PER_BLOCK = 4
BWD_ROWS_PER_BLOCK = 4
# Dynamic shared memory one block may use on sm_90 (232,448 bytes).
MAX_SHARED_BYTES = 232_448

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def shared_bytes(hidden: int, itemsize: int) -> int:
    """Shared memory per block of the kernel (as gru_fwd_shared_bytes in C):
    W^T [H, 3H] in the stream dtype, padded to 16 bytes, then the f32 carry,
    its operand copy and the step's hg for ROWS_PER_BLOCK rows."""
    w = (hidden * 3 * hidden * itemsize + 15) // 16 * 16
    return w + (2 * ROWS_PER_BLOCK * hidden + ROWS_PER_BLOCK * 3 * hidden) * 4


def bwd_shared_bytes(hidden: int, itemsize: int) -> int:
    """Shared memory per block of the adjoint kernel (as gru_bwd_shared_bytes
    in C): W^T [H, 3H + 1] in the stream dtype, padded to 16 bytes, then the
    f32 dW^T partial [H, 3H], h_prev, dh and dht*z for BWD_ROWS_PER_BLOCK
    rows, and the step's hg and dg."""
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
    lib.gru_fwd_shared_bytes.argtypes = [i32, i32]
    lib.gru_fwd_shared_bytes.restype = ctypes.c_longlong
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
    lib.gru_bwd_shared_bytes.argtypes = [i32, i32]
    lib.gru_bwd_shared_bytes.restype = ctypes.c_longlong
    return lib


def _check_cuda_args(xg, w_hh, b_hh, h0, fb: bool, smem=shared_bytes):
    """Validate what the kernel takes; returns (lanes, T, B, H). `smem` is
    the kernel's shared-memory formula."""
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
    need = smem(hidden, xg.element_size())
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"hidden size {hidden} needs {need} bytes of shared memory per "
            f"block in {xg.dtype}; the kernel takes at most {MAX_SHARED_BYTES}")
    if max(*lead, n_steps, batch) * three_h >= 2**31:
        raise ValueError("a dimension is too large for the kernel's int arguments")
    return (lead or (1,))[0], n_steps, batch, hidden


def _launch(entry: str, xg, w_hh, b_hh, h0, reverse: bool, fb: bool):
    """Allocate ys and launch `entry` on the current stream. Returns
    (ys, whether a kernel was launched); nothing is launched for empty ys."""
    if xg.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {xg.device}")
    f, n_steps, batch, hidden = _check_cuda_args(xg, w_hh, b_hh, h0, fb)
    ys = torch.empty(xg.shape[:-1] + (hidden,), dtype=xg.dtype, device=xg.device)
    if ys.numel() == 0:
        return ys, False
    _call(_library(), entry, (xg, w_hh, b_hh, h0, ys),
          ([f] if fb else []) + [n_steps, batch, hidden], reverse)
    return ys, True


def _call(lib: ctypes.CDLL, entry: str, tensors, dims: list[int], reverse: bool) -> None:
    """Call C `entry` with the tensors' pointers, the dims, reverse, the bf16
    flag (from the first tensor) and the current stream; raise if it returns
    a CUDA error."""
    dev = tensors[0].device
    bf16 = int(tensors[0].dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *dims,
                                  int(bool(reverse)), bf16, stream)
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
    """Validate what the adjoint kernel takes; returns (lanes, T, B, H)."""
    dims = _check_cuda_args(xg, w_hh, b_hh, h0, fb, smem=bwd_shared_bytes)
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


def _launch_bwd(entry: str, xg, w_hh, b_hh, h0, ys, dy, reverse: bool, fb: bool):
    """Allocate the gradients and the per-tile workspaces and launch `entry`
    on the current stream. Returns ((dxg, dw_hh, db_hh, dh0), whether a
    kernel was launched); nothing is launched for an empty walk."""
    if xg.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {xg.device}")
    f, n_steps, batch, hidden = _check_bwd_args(xg, w_hh, b_hh, h0, ys, dy, fb)
    dev = xg.device
    f32 = dict(dtype=torch.float32, device=dev)
    dxg = torch.empty_like(xg)
    dw = torch.empty(w_hh.shape, **f32)
    db = torch.empty(b_hh.shape, **f32)
    dh0 = torch.empty(h0.shape, **f32)
    if xg.numel() == 0:
        for g in (dw, db, dh0):
            g.zero_()
        return (dxg, dw, db, dh0), False
    tiles = -(-batch // BWD_ROWS_PER_BLOCK)
    dw_part = torch.empty((f, tiles, hidden, 3 * hidden), **f32)
    db_part = torch.empty((f, tiles, 3 * hidden), **f32)
    _call(_bwd_library(), entry,
          (xg, w_hh, b_hh, h0, ys, dy, dxg, dw, db, dh0, dw_part, db_part),
          ([f] if fb else []) + [n_steps, batch, hidden], reverse)
    return (dxg, dw, db, dh0), True


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


_WRAPPERS = {"gru_fwd": gru_forward, "gru_fwd_fb": gru_forward_fb,
             "gru_bwd": gru_backward, "gru_bwd_fb": gru_backward_fb}
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
