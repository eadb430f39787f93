"""Read the JAX package's flax checkpoints (`best_model.msgpack`).

The JAX package writes a whole train state with flax's msgpack codec
(multimodalsignal_tpu/train/checkpoints.py): a map with `params`,
`batch_stats` and `opt_state`, whose array leaves are msgpack ext type 1,
the packed triple (shape, dtype name, C-order bytes); numpy scalars are ext
type 3 in the same encoding. This module decodes that format with a small
pure-Python msgpack reader, so the port needs neither flax nor the `msgpack`
package.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


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
