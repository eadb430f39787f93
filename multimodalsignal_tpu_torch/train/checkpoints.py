"""Read and write the JAX package's flax checkpoints (`best_model.msgpack`).

The JAX package writes a whole train state with flax's msgpack codec
(multimodalsignal_tpu/train/checkpoints.py): a map with `params`,
`batch_stats` and `opt_state`, whose array leaves are msgpack ext type 1,
the packed triple (shape, dtype name, C-order bytes); numpy scalars are ext
type 3 in the same encoding. This module decodes that format with a small
pure-Python msgpack reader and encodes it with a small writer that makes the
bytes flax's codec makes, so the port needs neither flax nor the `msgpack`
package. `write_train_state` writes a port model and its Adam optimizer in
the JAX package's TrainState layout, which the JAX package's
`restore_state` reads into a TrainState template.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# flax splits arrays above this many bytes into chunks; the writer does not.
_MAX_CHUNK_BYTES = 2**30


def read_flax_checkpoint(path: Path | str) -> dict:
    """best_model.msgpack -> {"params": ..., "batch_stats": ...}: nested
    dicts of numpy arrays. A bfloat16 leaf (numpy has no such dtype) comes
    back as a torch.bfloat16 tensor with the same bits. opt_state is
    dropped."""
    state = unpackb(Path(path).read_bytes())
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError(f"{path} is not a flax train-state checkpoint")
    return {"params": state["params"],
            "batch_stats": state.get("batch_stats") or {}}


def unpackb(data: bytes):
    """Decode one msgpack object that fills `data`, with flax's ext types."""
    obj, pos = _Reader(data).read(0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the msgpack object")
    return obj


def _ndarray(payload: bytes):
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"unknown msgpack ext type {code}")


class _Reader:
    """Recursive msgpack decoder over one buffer: read(pos) -> (obj, next pos)."""

    # Fixed-width scalars: code -> struct format (big-endian).
    _SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    # Length-prefixed: code -> (kind, struct format of the length).
    _SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
              0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
              0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
              0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
              0xde: ("map", ">H"), 0xdf: ("map", ">I")}
    _FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}

    def __init__(self, data: bytes):
        self.data = memoryview(data)

    def _take(self, pos: int, n: int):
        end = pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        return self.data[pos:end], end

    def read(self, pos: int):
        if pos >= len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[pos]
        pos += 1
        if b <= 0x7f:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if 0x80 <= b <= 0x8f:
            return self._map(pos, b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(pos, b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            raw, pos = self._take(pos, b & 0x1f)
            return str(raw, "utf-8"), pos
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        if b in self._SCALARS:
            fmt = self._SCALARS[b]
            raw, pos = self._take(pos, struct.calcsize(fmt))
            return struct.unpack(fmt, raw)[0], pos
        if b in self._FIXEXT:
            code = struct.unpack(">b", self._take(pos, 1)[0])[0]
            raw, pos = self._take(pos + 1, self._FIXEXT[b])
            return _ext(code, bytes(raw)), pos
        if b in self._SIZED:
            kind, fmt = self._SIZED[b]
            raw, pos = self._take(pos, struct.calcsize(fmt))
            n = struct.unpack(fmt, raw)[0]
            if kind == "map":
                return self._map(pos, n)
            if kind == "array":
                return self._array(pos, n)
            if kind == "ext":
                code = struct.unpack(">b", self._take(pos, 1)[0])[0]
                raw, pos = self._take(pos + 1, n)
                return _ext(code, bytes(raw)), pos
            raw, pos = self._take(pos, n)
            return (str(raw, "utf-8") if kind == "str" else bytes(raw)), pos
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at offset {pos - 1}")

    def _array(self, pos: int, n: int):
        out = []
        for _ in range(n):
            item, pos = self.read(pos)
            out.append(item)
        return out, pos

    def _map(self, pos: int, n: int):
        out = {}
        for _ in range(n):
            key, pos = self.read(pos)
            out[key], pos = self.read(pos)
        return out, pos


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write_train_state(path: Path | str, model, optimizer=None) -> None:
    """Write `model` (and the Adam `optimizer` over its parameters, if
    given) as the JAX package's TrainState: params and batch_stats in the
    flax layout (models/convert.py), opt_state in optax's layout for
    make_optimizer's inject_hyperparams(add_decayed_weights -> scale_by_adam
    -> scale) chain, with torch Adam's exp_avg / exp_avg_sq as mu / nu (the
    same transposes as the weights) and its step as both counts."""
    from multimodalsignal_tpu_torch.models.convert import _layout

    state = {"params": {}, "batch_stats": {}}
    mu, nu = {}, {}
    opt = optimizer.state if optimizer is not None else {}
    step = 0
    for coll, path_, tensor, transform in _layout(model):
        _put(state[coll], path_, _as_array(transform(tensor.detach())))
        if coll != "params":
            continue
        moments = opt.get(tensor, {})
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            m = moments.get(key)
            value = (np.zeros(_as_array(transform(tensor.detach())).shape, np.float32)
                     if m is None else _as_array(transform(m.detach())))
            _put(tree, path_, value)
        if "step" in moments:
            step = int(moments["step"])
    lr = optimizer.param_groups[0]["lr"] if optimizer is not None else 0.0
    count = np.asarray(step, np.int32)
    state["opt_state"] = {
        "count": count,
        "hyperparams": {"learning_rate": np.asarray(lr, np.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {}, "1": {"count": count, "mu": mu, "nu": nu}, "2": {}},
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(packb(state))
    tmp.replace(path)


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _as_array(t: torch.Tensor) -> np.ndarray:
    """A CPU float32 numpy copy (parameters and statistics are float32)."""
    return t.float().cpu().numpy().copy()


def packb(obj) -> bytes:
    """Encode `obj` to the bytes flax's msgpack codec makes of it (msgpack
    with bin types, map keys sorted, numpy arrays as ext type 1): dicts with
    str keys, lists, str, bytes, int and numpy arrays, which is what a train
    state holds."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.nbytes > _MAX_CHUNK_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it; "
                         "the writer does not")
    return packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])


def _pack_header(out: bytearray, n: int, fix_base: int | None, fix_max: int,
                 codes: tuple[int, int, int]) -> None:
    """Length header: fix form (base | n) up to fix_max, else the 8/16/32-bit
    form of `codes` (a code of 0 means the width does not exist)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b", v) if v < 0 else bytes([v])
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} is too large for msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                                 (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"integer {v} is too small for msgpack")


def _pack(obj, out: bytearray) -> None:
    if type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif type(obj) is bytes:
        _pack_header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) is list:
        _pack_header(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif type(obj) is dict:
        # Sorted keys: flax's codec rebuilds the tree with jax's tree_map,
        # which sorts them.
        _pack_header(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} as msgpack")
