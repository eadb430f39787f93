"""GRU forward recurrence: hand-written CUDA kernels and their plain versions.

Counterpart of multimodalsignal_tpu/ops/gru_pallas.py's forward path. Two
kernels live in csrc/gru_fwd.cu (one template with a lane axis, two C entry
points), each behind its own wrapper here:

  * `gru_forward`    -> C `gru_fwd`    (replaces `_fwd_kernel` / `_gru_forward`)
  * `gru_forward_fb` -> C `gru_fwd_fb` (replaces `_fb_fwd_kernel` / `_gru_forward_fb`)

and the model-facing entry points built on them:

  * `gru_sequence_cuda`          (counterpart of `gru_sequence_pallas`)
  * `gru_bidirectional_dirbatch` (counterpart of the JAX function of that name)

The wrappers take the TPU kernels' time-major layout. A wrapper given CPU
tensors runs its plain PyTorch version (`*_plain`: a Python loop over time
with the kernel's gate math and dtypes); given CUDA tensors it launches the
kernel on the current stream or raises. Each launch adds one to the
wrapper's `launches` count (see `launch_counts`).

Dtypes follow the TPU kernels: float32 streams run all in float32; bfloat16
streams (gates, weights, bias, outputs) use bfloat16 product operands with
float32 sums, and the carry is float32 in both modes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Batch rows per block; must equal kRows in csrc/gru_fwd.cu.
ROWS_PER_BLOCK = 4
# Dynamic shared memory one block may use on sm_90 (232,448 bytes).
MAX_SHARED_BYTES = 232_448

_STREAM_DTYPES = (torch.float32, torch.bfloat16)


def shared_bytes(hidden: int, itemsize: int) -> int:
    """Shared memory per block of the kernel (as gru_fwd_shared_bytes in C):
    W^T [H, 3H] in the stream dtype, padded to 16 bytes, then the f32 carry,
    its operand copy and the step's hg for ROWS_PER_BLOCK rows."""
    w = (hidden * 3 * hidden * itemsize + 15) // 16 * 16
    return w + (2 * ROWS_PER_BLOCK * hidden + ROWS_PER_BLOCK * 3 * hidden) * 4


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


def _check_cuda_args(xg, w_hh, b_hh, h0, fb: bool):
    """Validate what the kernel takes; returns (lanes, T, B, H)."""
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
    need = shared_bytes(hidden, xg.element_size())
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
    lib = _library()
    with torch.cuda.device(xg.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                ys.data_ptr()]
        dims = [n_steps, batch, hidden, int(bool(reverse)),
                int(xg.dtype == torch.bfloat16)]
        if fb:
            dims = [f] + dims
        err = getattr(lib, entry)(*args, *dims, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return ys, True


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


gru_forward.launches = 0
gru_forward_fb.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by C entry point."""
    return {"gru_fwd": gru_forward.launches, "gru_fwd_fb": gru_forward_fb.launches}


def reset_launch_counts() -> None:
    gru_forward.launches = 0
    gru_forward_fb.launches = 0


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
    ys = gru_forward(x_tm, w_hh.to(dt).contiguous(), b_hh.to(dt).contiguous(),
                     h0.float().contiguous(), reverse)
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
    ys = gru_forward_fb(xg, whh, bhh, h02, reverse=False)  # [2, T, B, H]
    return ys[0].transpose(0, 1), ys[1].flip(0).transpose(0, 1)
