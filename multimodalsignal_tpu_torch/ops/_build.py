"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own into
`build/lib<name>-<hash>.so` beside this file (the directory is git-ignored).
The hash covers the source, the headers of csrc/ and the compiler flags, so
an edited source or header is rebuilt and an unchanged one is loaded as it
is. nvcc's output, including
`-Xptxas -v`'s registers and shared memory per kernel, is kept beside the
library as `lib<name>-<hash>.log`.

Nothing is compiled when this module is imported: `library()` builds on the
first call, and `build()` compiles several sources at once, one nvcc process
each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every CUDA source the port ships."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH); the port's CUDA kernels are built from source")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers of
    csrc/ (any of them may be included) and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | None = None) -> dict[str, float]:
    """Compile each named source (default: all) that has no library yet, all
    nvcc processes at once. Returns the seconds each build took (0.0 where the
    library was already there). Raises with nvcc's output if one fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    seconds = {n: 0.0 for n in names}
    running = []
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output for the current build of `name` ('' if none kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
