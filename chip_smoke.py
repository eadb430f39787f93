#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodalsignal_tpu_torch) on one GPU.

    python chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. The card: name and power limit from nvidia-smi, torch's device name.
2. Build every CUDA source of the port with nvcc (one process each, all at
   once) into multimodalsignal_tpu_torch/ops/build/; print ptxas's
   registers and spills per kernel instantiation and fail on any spill;
   check each kernel's shared-memory size in C against its wrapper's
   formula, the walk kernel's row tile (gru_fwd, gru_fwd_fb, gru_bifwd), and
   the adjoint walk's (gru_bwd) row tile, chunks of rows and workspace.
3. One phase per kernel: the wrapper on CUDA tensors against its plain
   PyTorch version on the same inputs, float32 and bfloat16, both walk
   directions, at the serving/training shape (T=480, B=64, H=64; F=2 lanes
   for the _fb kernels) and a ragged one; the walk kernel also at
   WALK_CASES (gru_fwd, and gru_bifwd in float32: H=128, the largest H each
   dtype admits, B=1, B=256 and T=1) and FB_CASES (gru_fwd_fb: the same at
   two lanes, and F=4 at B=128, F=15 at B=64 for row tiles 4 and 8), each
   line with its row tile and instantiation (W^T in registers or in shared
   memory); the adjoint walk (gru_bwd) also at ADJ_CASES (H=95 f32, 109
   bf16, 128, B=1, B=256, T=1, and a dy that is zero but at the forward's
   last step), each line with its row tile, instantiation and chunks, and
   twice on the same inputs with dW and db bitwise equal; then the walks'
   float32 time as B grows (walk_sweep). TF32 is off for matmul and cuDNN.
   Forward kernels (gru_fwd, gru_fwd_fb): ys, float32 rtol = atol = 1e-5,
   bfloat16 atol 0.05. Adjoint kernels (gru_bwd, gru_bwd_fb): all four
   outputs, tolerances in BWD_TOL. Then the times at the main shape: the
   kernel, the plain version, the least time the card could take, and
   cuDNN's GRU (nn.GRU: the forward, or for an adjoint kernel the backward
   as forward+backward minus forward; it also does the input projection),
   and us per dependent step (ms / T); for gru_bwd also a profiler trace of
   its four kernels (gate pre-pass, walk, weight-gradient pass, reduction).
4. The serving path: the default-config CnnGruAttention model (C=3,
   T=7680, H=64, 2 layers) with weights from a numpy seed, in float32 and
   bfloat16, behind the port's HTTP server: GET /healthz, POST /v1/predict
   with 1, 7, 64 and 100 windows, POST /v1/predict_recording on a
   WESAD-format pickle written here. Probabilities must be finite rows
   summing to 1 and equal to the same model's on the CPU (float32 atol
   1e-4, bfloat16 atol 3e-2); each forward kernel must have been launched
   once per padded batch and each adjoint kernel never. Then the padded-64
   forward's time, and a profiler trace of it: device time by kernel and
   the device's idle share.
5. The training path, float32 and bfloat16, same model and seed weights,
   on synthetic windows [3, 7680] made with numpy (200 train, 64 val):
   a. with dropout 0, the first steps on the card (two full batches and the
      padded last one) against the same steps of the port on the CPU (impl
      "cuda" on CPU tensors: the kernels' plain versions): per-step losses
      and the parameters afterwards, tolerances in TRAIN_TOL; after the
      first step every parameter has a finite, nonzero gradient (but
      gru.l1_bwd_w_hh, zero by construction, see check_gradients);
   b. Trainer.train for 2 epochs at the config's dropout 0.5: finite
      losses, a best_model.msgpack the port reads back, and each kernel
      launched once per real train step (the forward kernels also once per
      eval batch);
   c. the ms per train step and windows/s at B=64, and a profiler trace of
      back-to-back train steps: device time by kernel and the idle share.
6. The serial LOSO experiment CLI with gru_impl="pallas_fused", float32 and
   bfloat16, on a synthetic preprocessed data directory written here with
   numpy (4 subjects x 48 windows [7680, 8], raw labels 1-4, the chest
   channel names):
   a. the first 3 train steps of the first fold, dropout 0, on the card
      against the port on the CPU (the plain versions), as in 5a;
   b. `python -m multimodalsignal_tpu_torch.main --execution serial --set
      model.gru_impl=pallas_fused --set trainer.epochs=2` (in process): a
      run directory with config.json, cv_summary.txt of 4 folds with finite
      numbers and a best_model.msgpack per fold that the port reads back;
      gru_bifwd and gru_fwd launched once per train step and eval batch,
      gru_bibwd and gru_bwd once per train step, the fb kernels never;
   c. each fold's wall time, the ms per pallas_fused train step at B=64 and
      a profiler trace of back-to-back train steps.
The fused pair (gru_bifwd, gru_bibwd) has kernel phases as in 3, float32
only: ys at TOL, the adjoint's outputs at BWD_TOL; its library time is
cuDNN's bidirectional nn.GRU.

Prints a JSON line of the kernels (launches: the forward kernels' from the
float32 serving run, the adjoint kernels' from the float32 training run,
the fused pair's from the float32 LOSO run), then, as the last line,
{"ok": true, "device": {...}}. Needs one CUDA device and the repository.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import math
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch import main as cli
from multimodalsignal_tpu_torch.config import (
    ALL_CHANNEL_NAMES,
    ExperimentConfig,
    ModelConfig,
    TrainerConfig,
)
from multimodalsignal_tpu_torch.data.dataset import build_dataset, read_channel_names
from multimodalsignal_tpu_torch.experiments.predict import Predictor
from multimodalsignal_tpu_torch.experiments.splits import loso_folds
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.ops import _build, gru_cuda
from multimodalsignal_tpu_torch.serving import PredictionService, make_server
from multimodalsignal_tpu_torch.train.checkpoints import read_flax_checkpoint
from multimodalsignal_tpu_torch.train.trainer import Trainer, batch_indices

# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s, and
# FLOP/s by the type of the recurrent product's operands (float32 outside
# the tensor cores; bfloat16 on them).
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Gate math per hidden unit and step: 3 bias adds of hg, 3 pre-activation
# adds, r * hn, two sigmoids and a tanh (4 each), (1 - z) * n + z * h (3).
GATE_FLOPS_PER_UNIT = 22
# The adjoint recomputes that gate math and adds its own per unit and step:
# dht, dz, dn, dn_pre, dr_pre, dz_pre, dhn, dht * z and the dh and db sums.
BWD_GATE_FLOPS_PER_UNIT = GATE_FLOPS_PER_UNIT + 21

SERVE_T, SERVE_B, SERVE_H = 480, 64, 64
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=0.0, atol=0.05)}
# Adjoint kernels vs their plain versions, (dxg and dh0, dW and db) per dtype.
# float32: dxg and dh0 carry f32 round-off through 480 dependent steps in
# another summation order, so 1e-4; dW and db are sums over B*T = 30,720
# terms of magnitude up to ~1, so rtol 1e-4 with atol 1e-3. bfloat16: dxg is
# stored bf16 (one ulp of values up to ~4 is 0.03), and a one-ulp flip of a
# bf16-rounded dg moves a dW/db sum by up to ~1e-2, so atol 0.05 on dxg and
# dh0 and 0.1 with rtol 2e-2 on dW and db.
BWD_TOL = {torch.float32: (dict(rtol=1e-4, atol=1e-4), dict(rtol=1e-4, atol=1e-3)),
           torch.bfloat16: (dict(rtol=0.0, atol=0.05), dict(rtol=2e-2, atol=0.1))}
PROB_ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
WINDOW_T = 60 * 128   # a 60 s window at 128 Hz
TRAIN_N, VAL_N, BATCH, LR = 200, 64, 64, 1e-3
# Card vs CPU over the first train steps. Losses: float32 rtol 1e-4 (f32
# round-off of a 7680-sample forward), bfloat16 rtol 2e-2. Parameters: Adam's
# first steps move each element by about +-lr whatever its gradient's size,
# so an element whose gradient sits within round-off of zero can land up to
# 2 lr per step apart; hence every element within 2 lr per step, and all but
# a small share (0.1 % f32, 10 % bf16) within 1e-5 (f32) or 2e-4 (bf16).
TRAIN_TOL = {"float32": dict(loss=1e-4, elem=1e-5, share=1e-3),
             "bfloat16": dict(loss=2e-2, elem=2e-4, share=0.1)}


def card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    return smi


PTXAS_KERNEL = re.compile(r"Function properties for (\S+)\n\s+(.*?)\n"
                          r"ptxas info\s+: Used (\d+) registers")


def short_kernel_name(mangled: str) -> str:
    """`gru_walk_kernel<float, LaneMajor, 1, 0>` from a mangled kernel name
    (template arguments: the stream type, the layout, then the integers)."""
    m = re.search(r"(gru_[a-z_]*?kernel|gru_[a-z]+_reduce)(?:I(\w*?)EEv|E)", mangled)
    if not m:
        return mangled
    rest = m.group(2) or ""
    args = {"f": ["float"], "1": ["bf16"]}.get(rest[:1], [])
    args += [rest[n.end():n.end() + int(n.group(1))] for n in re.finditer(r"NS_(\d+)", rest)]
    args += re.findall(r"L[ib](\d+)E", rest)
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def build_phase() -> None:
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"in {time.perf_counter() - t0:.2f} s")
    for name in seconds:
        for kernel, props, regs in PTXAS_KERNEL.findall(_build.build_log(name)):
            print(f"  ptxas {name}: {short_kernel_name(kernel)}: {regs} registers, {props}")
            if not props.endswith("0 bytes spill stores, 0 bytes spill loads"):
                raise AssertionError(f"ptxas {name}: {kernel} spills: {props}")
    bwd = gru_cuda._bwd_library()
    for bf16, size in ((0, 4), (1, 2)):
        c_bytes = bwd.gru_bwd_shared_bytes(SERVE_H, bf16)
        if c_bytes != gru_cuda.bwd_shared_bytes(SERVE_H, size):
            raise AssertionError(f"gru_bwd_shared_bytes: C says {c_bytes}, wrapper "
                                 f"{gru_cuda.bwd_shared_bytes(SERVE_H, size)}")
        print(f"  gru_bwd_shared_bytes(H={SERVE_H}, bf16={bf16}) = {c_bytes} bytes")
    check_adjoint_formulas(bwd)
    lib = gru_cuda._library()
    for h in (SERVE_H, 128, 136, 192):
        for bf16, size in ((0, 4), (1, 2)):
            for rows in (1, 2, 4) + ((8,) if gru_cuda.walk_in_registers(h) else ()):
                c_bytes = lib.gru_walk_shared_bytes(h, bf16, rows)
                if c_bytes != gru_cuda.walk_shared_bytes(h, size, rows):
                    raise AssertionError(
                        f"gru_walk_shared_bytes(H={h}, bf16={bf16}, rows={rows}): C says "
                        f"{c_bytes}, wrapper {gru_cuda.walk_shared_bytes(h, size, rows)}")
    for batch in (1, 5, 64, 65, 256, 1024):
        for lanes in (1, 2):
            for h in (SERVE_H, 128):
                if lib.gru_walk_row_tile(batch, lanes, h) != gru_cuda.walk_row_tile(batch, lanes, h):
                    raise AssertionError(f"gru_walk_row_tile({batch}, {lanes}, {h}): C says "
                                         f"{lib.gru_walk_row_tile(batch, lanes, h)}")
    print(f"  gru_walk_shared_bytes(H={SERVE_H}, bf16=0, rows=1) = "
          f"{lib.gru_walk_shared_bytes(SERVE_H, 0, 1)} bytes; C and wrapper agree on the "
          "walk kernel's shared memory and row tile")


def check_adjoint_formulas(bwd) -> None:
    """The adjoint walk's (gru_bwd) shared memory, row tile, chunks of rows
    and workspace, C against gru_cuda's Python twins."""
    def same(what, c_val, py_val):
        if c_val != py_val:
            raise AssertionError(f"{what}: C says {c_val}, wrapper {py_val}")

    for h in (40, SERVE_H, 65, 95, 109, 128, 130, 179):
        for bf16, size in ((0, 4), (1, 2)):
            for rows in (1,) + ((2,) if gru_cuda.walk_in_registers(h) else ()):
                same(f"gru_adj_shared_bytes(H={h}, bf16={bf16}, rows={rows})",
                     bwd.gru_adj_shared_bytes(h, bf16, rows),
                     gru_cuda.adj_shared_bytes(h, size, rows))
    for batch in (1, 5, 64, 65, 256, 1024):
        for lanes in (1, 2, 15):
            for h in (SERVE_H, 128):
                same(f"gru_adj_row_tile({batch}, {lanes}, {h})",
                     bwd.gru_adj_row_tile(batch, lanes, h), gru_cuda.adj_row_tile(batch, lanes, h))
        for t in (1, 37, SERVE_T):
            same(f"gru_adj_chunk_rows/partials({t}, {batch})",
                 (bwd.gru_adj_chunk_rows(t, batch), bwd.gru_adj_partials(t, batch)),
                 gru_cuda.adj_partials(t, batch))
            for lanes in (1, 2):
                same(f"gru_adj_workspace_floats({lanes}, {t}, {batch}, {SERVE_H})",
                     bwd.gru_adj_workspace_floats(lanes, t, batch, SERVE_H),
                     gru_cuda.adj_workspace_floats(lanes, t, batch, SERVE_H))
    chunk, parts = gru_cuda.adj_partials(SERVE_T, SERVE_B)
    print(f"  gru_adj_shared_bytes(H={SERVE_H}, bf16=0, rows=1) = "
          f"{bwd.gru_adj_shared_bytes(SERVE_H, 0, 1)} bytes; at T={SERVE_T} B={SERVE_B}: "
          f"{parts} chunks of {chunk} rows, workspace "
          f"{gru_cuda.adj_workspace_floats(1, SERVE_T, SERVE_B, SERVE_H) * 4 / 2**20:.1f} MiB; "
          "C and wrapper agree on the adjoint walk's shared memory, row tile, chunks "
          "and workspace")


def median_ms(fn, per_block: int, blocks: int = 5, warmup: int = 2) -> float:
    """ms per call: CUDA events around blocks of `per_block` back-to-back
    calls, the median over `blocks` blocks."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_block):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_block)
    return statistics.median(times)


def kernel_inputs(lanes, t, b, h, dtype, seed):
    """Gates N(0, 1), weights and bias U(-1/sqrt(H), 1/sqrt(H)) (torch's GRU
    init), h0 N(0, 0.5^2); made with numpy, moved to the card."""
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    bound = 1 / math.sqrt(h)
    xg = rng.standard_normal(lead + (t, b, 3 * h))
    w = rng.uniform(-bound, bound, lead + (3 * h, h))
    bias = rng.uniform(-bound, bound, lead + (3 * h,))
    h0 = rng.standard_normal(lead + (b, h)) * 0.5
    dev = lambda a, dt: torch.from_numpy(a).to("cuda", dt).contiguous()  # noqa: E731
    return dev(xg, dtype), dev(w, dtype), dev(bias, dtype), dev(h0, torch.float32)


def bound_ms(lanes, t, b, h, dtype) -> tuple[float, str]:
    """Least time on an H100 for one call: each input read once and ys
    written once over the memory rate, or the product and gate FLOPs over
    the peak rate for the operands' type, whichever is larger."""
    f = lanes or 1
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (f * t * b * 3 * h * item + f * 3 * h * h * item + f * 3 * h * item
              + f * b * h * 4 + f * t * b * h * item)
    flops = f * t * b * (2 * h * 3 * h + GATE_FLOPS_PER_UNIT * h)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_ms(lanes, t, b, h, dtype) -> float:
    """nn.GRU (cuDNN) over the same T, B and H: one direction, or both for
    two lanes. It also does the input projection (input size H)."""
    gru = torch.nn.GRU(h, h, bidirectional=lanes == 2).to("cuda", dtype)
    gru.flatten_parameters()  # one weight buffer, as cuDNN wants it
    x = torch.randn(t, b, h, device="cuda", dtype=dtype)
    with torch.inference_mode():
        return median_ms(lambda: gru(x), per_block=20)


# Shapes of the walk kernel (gru_fwd, gru_bifwd) beyond the main and the
# ragged one, as (T, B, H, dtypes): H=128 and the largest H each dtype
# admits (the first template's 135 / 190 and the formula's 136 / 192, W^T in
# shared memory), one batch row, a batch that tiles 2 or 4 rows a block,
# one step.
F32, BF16 = (torch.float32,), (torch.bfloat16,)
WALK_CASES = [(SERVE_T, SERVE_B, 128, F32 + BF16), (SERVE_T, SERVE_B, 135, F32),
              (SERVE_T, SERVE_B, 136, F32), (SERVE_T, SERVE_B, 190, BF16),
              (SERVE_T, SERVE_B, 192, BF16), (SERVE_T, 1, SERVE_H, F32 + BF16),
              (SERVE_T, 256, SERVE_H, F32 + BF16), (1, SERVE_B, SERVE_H, F32 + BF16)]


# Shapes of gru_fwd_fb (F lanes of the walk kernel) beyond the main and the
# ragged one, as (F, T, B, H, dtypes): WALK_CASES at two lanes, then 4 lanes
# at B=128 (row tile 4) and 15 at B=64 (row tile 8, the fold-parallel
# lanes).
FB_CASES = [(2, *case) for case in WALK_CASES] + [
    (4, SERVE_T, 128, SERVE_H, F32 + BF16), (15, SERVE_T, SERVE_B, SERVE_H, F32 + BF16)]


def walk_plan(lanes: int, batch: int, hidden: int) -> str:
    """The walk kernel's row tile and instantiation for a shape."""
    where = "registers" if gru_cuda.walk_in_registers(hidden) else "shared memory"
    return f"row tile {gru_cuda.walk_row_tile(batch, lanes, hidden)}, W^T in {where}"


def kernel_phase(name, wrapper, plain, fb: bool, source_line: str) -> dict:
    lanes = 2 if fb else None
    both = (torch.float32, torch.bfloat16)
    cases = [(lanes, SERVE_T, SERVE_B, SERVE_H, both), (3 if fb else None, 37, 5, 40, both)]
    cases += FB_CASES if fb else [(None, *case) for case in WALK_CASES]
    serve_err = 0.0
    for *shape, dtypes in cases:
        for dtype in dtypes:
            for reverse in (False, True):
                args = kernel_inputs(*shape, dtype, seed=len(name) + shape[1])
                got = wrapper(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = plain(*args, reverse=reverse)
                err = (got.float() - want.float()).abs().max().item()
                plan = f" ({walk_plan(shape[0] or 1, shape[2], shape[3])})"
                print(f"{name}: shape F={shape[0]} T={shape[1]} B={shape[2]} "
                      f"H={shape[3]} {str(dtype)[6:]} reverse={reverse}: "
                      f"max|d|={err:.3e}{plan}")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"{name}: got {got.dtype} {list(got.shape)}")
                torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
                if shape[1:] == [SERVE_T, SERVE_B, SERVE_H] and dtype == torch.float32:
                    serve_err = max(serve_err, err)
    entry = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = kernel_inputs(lanes, SERVE_T, SERVE_B, SERVE_H, dtype, seed=7)
        ms = median_ms(lambda: wrapper(*args), per_block=50)
        plain_ms = median_ms(lambda: plain(*args), per_block=1, warmup=1)
        lib_ms = cudnn_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        b_ms, b_by = bound_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        plan = f", {walk_plan(lanes or 1, SERVE_B, SERVE_H)}"
        print(f"{name} {str(dtype)[6:]} at F={lanes or 1} T={SERVE_T} "
              f"B={SERVE_B} H={SERVE_H}: kernel {ms:.4f} ms "
              f"({ms / SERVE_T * 1e3:.3f} us per dependent step{plan}), plain "
              f"{plain_ms:.3f} ms, cuDNN GRU {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
        if dtype == torch.float32:
            entry = {"name": name, "route": "cuda",
                     "source": "multimodalsignal_tpu_torch/ops/csrc/gru_fwd.cu",
                     "replaces": source_line, "launches": 0,
                     "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


def walk_sweep() -> None:
    """The walk kernels' float32 time at T=480, H=64 as the batch, and so
    the block count, grows: one lane (gru_fwd), two (gru_bifwd), and the
    adjoint walk (gru_bwd, all four of its kernels). Shows whether the
    per-step cost depends on the layout or on the blocks."""
    for name, lanes, batches in (("gru_fwd", 1, (16, 64, 128, 256)),
                                 ("gru_bifwd", 2, (32, 64, 128)),
                                 ("gru_bwd", 1, (16, 64, 128, 256))):
        for b in batches:
            if name == "gru_fwd":
                args = kernel_inputs(None, SERVE_T, b, SERVE_H, torch.float32, seed=7)
                ms = median_ms(lambda: gru_cuda.gru_forward(*args), per_block=50)
            elif name == "gru_bifwd":
                args = fused_inputs(SERVE_T, b, SERVE_H, seed=7, adjoint=False)
                ms = median_ms(lambda: gru_cuda.gru_bifwd(*args), per_block=50)
            else:
                args = bwd_inputs(None, SERVE_T, b, SERVE_H, torch.float32, seed=7)
                ms = median_ms(lambda: gru_cuda.gru_backward(*args), per_block=50)
            tile = gru_cuda.adj_row_tile if name == "gru_bwd" else gru_cuda.walk_row_tile
            rows = tile(b, lanes, SERVE_H)
            print(f"walk sweep: {name} float32 "
                  f"T={SERVE_T} B={b} H={SERVE_H}: {ms:.4f} ms ({ms / SERVE_T * 1e3:.3f} us "
                  f"per dependent step), {-(-b // rows) * lanes} blocks of row tile {rows}")


def bwd_bound_ms(lanes, t, b, h, dtype) -> tuple[float, str]:
    """Least time on an H100 for one adjoint call: dy, h_prev, xg read once
    and dxg written once in the stream dtype, W read once, dW, db, dh0
    written once in f32; or the three products per step (h_prev @ W^T,
    h_prev^T @ dg, dg @ W) and the gate math at the operands' peak rate."""
    f = lanes or 1
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (f * t * b * (2 * h + 2 * 3 * h) * item + f * 3 * h * h * item
              + f * (3 * h * h + 3 * h + b * h) * 4)
    flops = f * t * b * (3 * 2 * h * 3 * h + BWD_GATE_FLOPS_PER_UNIT * h)
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_bwd_ms(lanes, t, b, h, dtype) -> float:
    """Backward of nn.GRU (cuDNN) over the same T, B and H, one direction or
    both for two lanes: forward+backward minus forward, both with autograd
    on. It also computes the input projection's gradients."""
    bi = lanes == 2
    gru = torch.nn.GRU(h, h, bidirectional=bi).to("cuda", dtype)
    gru.flatten_parameters()
    x = torch.randn(t, b, h, device="cuda", dtype=dtype, requires_grad=True)
    g = torch.randn(t, b, h * (2 if bi else 1), device="cuda", dtype=dtype)

    def fwd_bwd():
        gru(x)[0].backward(g)

    with torch.enable_grad():
        both = median_ms(fwd_bwd, per_block=20)
        fwd = median_ms(lambda: gru(x), per_block=20)
    return both - fwd


def bwd_inputs(lanes, t, b, h, dtype, seed, reverse=False, last_only=False):
    """kernel_inputs, then ys from the plain forward in the walk direction
    and dy N(0, 1); with `last_only` dy is zero but at the forward's last
    step (what the last-step-pruned layer sends back)."""
    xg, w, bias, h0 = kernel_inputs(lanes, t, b, h, dtype, seed)
    lead = () if lanes is None else (lanes,)
    fwd = gru_cuda.gru_forward_fb_plain if lanes else gru_cuda.gru_forward_plain
    ys = fwd(xg, w, bias, h0, reverse)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        lead + (t, b, h))).to("cuda", dtype)
    if last_only:
        keep = torch.arange(t, device="cuda") == (0 if reverse else t - 1)
        dy = torch.where(keep[:, None, None], dy, torch.zeros_like(dy)).contiguous()
    return xg, w, bias, h0, ys.contiguous(), dy


# Shapes of gru_bwd (the adjoint walk) beyond the main and the ragged one,
# as (T, B, H, dtypes, last_only): the largest H of the first template (95
# f32, 109 bf16), H=128 (W in shared memory), one batch row, B=256 (row
# tile 2), one step, and a dy that is zero but at the forward's last step.
ADJ_CASES = [(SERVE_T, SERVE_B, 95, F32, False), (SERVE_T, SERVE_B, 109, BF16, False),
             (SERVE_T, SERVE_B, 128, F32 + BF16, False), (SERVE_T, 1, SERVE_H, F32 + BF16, False),
             (SERVE_T, 256, SERVE_H, F32 + BF16, False), (1, SERVE_B, SERVE_H, F32 + BF16, False),
             (SERVE_T, SERVE_B, SERVE_H, F32 + BF16, True)]


def adj_plan(t: int, batch: int, hidden: int) -> str:
    """The adjoint walk's row tile, instantiation and chunks of rows."""
    where = "registers" if gru_cuda.walk_in_registers(hidden) else "shared memory"
    chunk, parts = gru_cuda.adj_partials(t, batch)
    return (f"row tile {gru_cuda.adj_row_tile(batch, 1, hidden)}, W in {where}, "
            f"{parts} chunks of {chunk} rows")


def check_deterministic(name, wrapper, dtype) -> None:
    """Two calls on the same inputs give the same bits of dW and db."""
    args = bwd_inputs(None, SERVE_T, SERVE_B, SERVE_H, dtype, seed=11)
    first = wrapper(*args)
    second = wrapper(*args)
    torch.cuda.synchronize()
    for o, a, b in (("dW", first[1], second[1]), ("db", first[2], second[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {str(dtype)[6:]}: {o} differs between two runs "
                                 f"(max |d| {(a - b).abs().max().item():.3e})")
    print(f"{name} {str(dtype)[6:]}: dW and db bitwise equal over two runs")


def bwd_kernel_phase(name, wrapper, plain, fb: bool, source_line: str) -> dict:
    lanes = 2 if fb else None
    both = (torch.float32, torch.bfloat16)
    cases = [(lanes, SERVE_T, SERVE_B, SERVE_H, both, False),
             (3 if fb else None, 37, 5, 40, both, False)]
    if name == "gru_bwd":
        cases += [(None, *case) for case in ADJ_CASES]
    serve_err = 0.0
    outputs = ("dxg", "dW", "db", "dh0")
    for *shape, dtypes, last_only in cases:
        for dtype in dtypes:
            for reverse in (False, True):
                args = bwd_inputs(*shape, dtype, seed=len(name) + shape[1], reverse=reverse,
                                  last_only=last_only)
                got = wrapper(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = plain(*args, reverse=reverse)
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(got, want)]
                plan = f" ({adj_plan(*shape[1:])})" if name == "gru_bwd" else ""
                print(f"{name}: shape F={shape[0]} T={shape[1]} B={shape[2]} "
                      f"H={shape[3]} {str(dtype)[6:]} reverse={reverse}"
                      f"{' dy at the last step only' if last_only else ''}: max|d| "
                      + ", ".join(f"{o} {e:.3e}" for o, e in zip(outputs, errs)) + plan)
                for o, g, w in zip(outputs, got, want):
                    want_dt = dtype if o == "dxg" else torch.float32
                    if g.dtype != want_dt or g.shape != w.shape:
                        raise AssertionError(f"{name} {o}: got {g.dtype} {list(g.shape)}")
                    tol = BWD_TOL[dtype][o in ("dW", "db")]
                    torch.testing.assert_close(g.float(), w.float(), **tol,
                                               msg=lambda m, o=o: f"{name} {o}: {m}")
                if shape[1:] == [SERVE_T, SERVE_B, SERVE_H] and dtype == torch.float32:
                    serve_err = max(serve_err, *errs)
    entry = {}
    for dtype in (torch.float32, torch.bfloat16):
        if name == "gru_bwd":
            check_deterministic(name, wrapper, dtype)
        args = bwd_inputs(lanes, SERVE_T, SERVE_B, SERVE_H, dtype, seed=7)
        ms = median_ms(lambda: wrapper(*args), per_block=50)
        plain_ms = median_ms(lambda: plain(*args), per_block=1, warmup=1)
        lib_ms = cudnn_bwd_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        b_ms, b_by = bwd_bound_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        print(f"{name} {str(dtype)[6:]} at F={lanes or 1} T={SERVE_T} "
              f"B={SERVE_B} H={SERVE_H}: kernel {ms:.4f} ms "
              f"({ms / SERVE_T * 1e3:.3f} us per dependent step), plain "
              f"{plain_ms:.3f} ms, cuDNN GRU backward {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
        if name == "gru_bwd":
            trace(lambda: wrapper(*args), f"{str(dtype)[6:]} gru_bwd call")
        if dtype == torch.float32:
            entry = {"name": name, "route": "cuda",
                     "source": "multimodalsignal_tpu_torch/ops/csrc/gru_bwd.cu",
                     "replaces": source_line, "launches": 0,
                     "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


def fused_inputs(t, b, h, seed, adjoint: bool):
    """kernel_inputs of two float32 lanes in the fused pair's layout: xg2
    [T, 2, B, 3H], whh2, bhh2, h02; for the adjoint also ys2 from the plain
    forward and dy2 N(0, 1) [T, 2, B, H]."""
    xg, w, bias, h0 = kernel_inputs(2, t, b, h, torch.float32, seed)
    args = (xg.transpose(0, 1).contiguous(), w, bias, h0)
    if not adjoint:
        return args
    dy2 = np.random.default_rng(seed + 1).standard_normal((t, 2, b, h))
    return args + (gru_cuda.gru_bifwd_plain(*args).contiguous(),
                   torch.from_numpy(dy2).to("cuda", torch.float32))


def fused_kernel_phase(name, wrapper, plain, adjoint: bool, source_line: str) -> dict:
    """The fused BiGRU pair, float32 only: the kernel against its plain
    version at the main shape and a ragged one, then the times (library:
    cuDNN's bidirectional GRU, forward or backward)."""
    outputs = ("dxg2", "dW", "db", "dh0") if adjoint else ("ys2",)
    serve_err = 0.0
    cases = [(SERVE_T, SERVE_B, SERVE_H), (37, 5, 40)]
    if not adjoint:
        cases += [(t, b, h) for t, b, h, dtypes in WALK_CASES
                  if torch.float32 in dtypes]
    for t, b, h in cases:
        args = fused_inputs(t, b, h, seed=len(name) + t, adjoint=adjoint)
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        got, want = (got, want) if adjoint else ((got,), (want,))
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        plan = "" if adjoint else f" ({walk_plan(2, b, h)})"
        print(f"{name}: shape T={t} B={b} H={h} float32: max|d| "
              + ", ".join(f"{o} {e:.3e}" for o, e in zip(outputs, errs)) + plan)
        for o, g, w in zip(outputs, got, want):
            if g.dtype != torch.float32 or g.shape != w.shape:
                raise AssertionError(f"{name} {o}: got {g.dtype} {list(g.shape)}")
            tol = (BWD_TOL[torch.float32][o in ("dW", "db")] if adjoint
                   else TOL[torch.float32])
            torch.testing.assert_close(g, w, **tol, msg=lambda m, o=o: f"{name} {o}: {m}")
        if (t, b, h) == (SERVE_T, SERVE_B, SERVE_H):
            serve_err = max(errs)
    args = fused_inputs(SERVE_T, SERVE_B, SERVE_H, seed=7, adjoint=adjoint)
    ms = median_ms(lambda: wrapper(*args), per_block=50)
    plain_ms = median_ms(lambda: plain(*args), per_block=1, warmup=1)
    shape = (2, SERVE_T, SERVE_B, SERVE_H, torch.float32)
    lib_ms = cudnn_bwd_ms(*shape) if adjoint else cudnn_ms(*shape)
    b_ms, b_by = bwd_bound_ms(*shape) if adjoint else bound_ms(*shape)
    plan = "" if adjoint else f", {walk_plan(2, SERVE_B, SERVE_H)}"
    print(f"{name} float32 at T={SERVE_T} 2 directions B={SERVE_B} H={SERVE_H}: "
          f"kernel {ms:.4f} ms ({ms / SERVE_T * 1e3:.3f} us per dependent step{plan}), "
          f"plain {plain_ms:.3f} ms, cuDNN bidirectional GRU "
          f"{'backward ' if adjoint else ''}{lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}), {b_ms / ms:.2%} of bound")
    return {"name": name, "route": "cuda",
            "source": f"multimodalsignal_tpu_torch/ops/csrc/gru_{'bwd' if adjoint else 'fwd'}.cu",
            "replaces": source_line, "launches": 0, "max_abs_err": serve_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def random_variables(cfg: ExperimentConfig, seed: int) -> dict:
    """flax-layout weights from a numpy seed: kernels and GRU weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), BN affine terms near 1 and 0,
    running means N(0, 0.1^2), running variances U(0.5, 2)."""
    model = build_model(cfg.model, cfg.num_classes, len(cfg.channels_to_use))
    rng = np.random.default_rng(seed)
    h = cfg.model.gru_hidden_size

    def fill(tree, path=()):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf, path + (key,))
                continue
            shape = leaf.shape
            if key == "var":
                value = rng.uniform(0.5, 2.0, shape)
            elif key == "mean":
                value = rng.normal(0.0, 0.1, shape)
            elif key == "scale":
                value = rng.uniform(0.5, 1.5, shape)
            elif key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                value = rng.uniform(-1, 1, shape) / math.sqrt(fan_in)
            elif path and path[0] == "gru":
                value = rng.uniform(-1, 1, shape) / math.sqrt(h)
            else:  # dense and BN biases
                value = rng.uniform(-0.1, 0.1, shape)
            tree[key] = value.astype(np.float32)

    variables = export_jax_variables(model)
    fill(variables)
    return variables


def write_recording(path: Path, seconds: int, seed: int) -> None:
    """A WESAD-format chest recording at 700 Hz: ACC [N, 3], and ECG, EDA,
    EMG, Resp, Temp [N, 1], byte-keyed as the original pickles are."""
    rng = np.random.default_rng(seed)
    n = seconds * 700
    t = np.arange(n) / 700.0
    chan = lambda x: x[:, None].astype(np.float64)  # noqa: E731
    chest = {
        b"ACC": np.stack([np.sin(2 * np.pi * f * t) * 0.1 + rng.normal(0, 0.02, n)
                          for f in (0.3, 0.5, 0.7)], axis=1),
        b"ECG": chan(np.sin(2 * np.pi * 1.2 * t) ** 15 + rng.normal(0, 0.05, n)),
        b"EDA": chan(2.0 + 0.5 * np.sin(2 * np.pi * 0.01 * t) + rng.normal(0, 0.01, n)),
        b"EMG": chan(rng.normal(0, 0.1, n)),
        b"Resp": chan(np.sin(2 * np.pi * 0.25 * t) * 3 + rng.normal(0, 0.2, n)),
        b"Temp": chan(33.0 + rng.normal(0, 0.01, n)),
    }
    with open(path, "wb") as f:
        pickle.dump({b"signal": {b"chest": chest}}, f)


def _post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url}: HTTP {resp.status}")
        return json.loads(resp.read())


def _check_probs(probs, want, n: int, atol: float, what: str) -> float:
    probs = np.asarray(probs, np.float64)
    if probs.shape != (n, want.shape[1]):
        raise AssertionError(f"{what}: probs shape {probs.shape}, want {(n, want.shape[1])}")
    if not np.isfinite(probs).all() or not np.allclose(probs.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"{what}: probs not finite rows summing to 1")
    np.testing.assert_allclose(probs, want, rtol=0, atol=atol, err_msg=what)
    return float(np.abs(probs - want).max())


def trace(fn, what: str, n: int = 5) -> None:
    """torch.profiler over n back-to-back calls of fn: device time per call
    by kernel name, and the idle share (the part of the traced span from the
    first kernel's start to the last one's end with no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print("  trace: the profiler saw no device activity; not measured")
        return
    busy, (cur_start, cur_end) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = spans[-1][1] - spans[0][0]
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    print(f"  trace of {n} {what}s: device busy {total / n / 1e3:.3f} ms per "
          f"{what}, span {span / n / 1e3:.3f} ms, idle share {1 - busy / span:.2%}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / n / 1e3:8.3f} ms {us / total:6.1%}  {name[:90]}")


def serving_phase(dtype: str, pkl: Path) -> dict[str, int]:
    """Drive the port's server over HTTP; returns the kernel launches of
    the run."""
    cfg = ExperimentConfig(model=ModelConfig(dtype=dtype))
    variables = random_variables(cfg, seed=0)
    predictor = Predictor(cfg, variables, device="cuda")
    # The reference runs the kernels' plain versions (gru_impl "cuda" on CPU
    # tensors), so both sides do the same arithmetic in bfloat16 too.
    ref_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, gru_impl="cuda"))
    reference = Predictor(ref_cfg, variables, device="cpu")
    c, t = len(cfg.channels_to_use), 60 * 128
    rng = np.random.default_rng(1)
    requests = {n: rng.standard_normal((n, c, t)).astype(np.float32)
                for n in (1, 7, 64, 100)}
    service = PredictionService(predictor, batch_size=64)
    server = make_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        gru_cuda.reset_launch_counts()
        # --- the main path: everything between reset and read is counted ---
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            card_info = json.loads(resp.read())
        replies = {}
        for n, x in requests.items():
            if n == 1:
                payload = {"windows": x.tolist()}
            else:
                buf = io.BytesIO()
                np.save(buf, x)
                payload = {"windows_b64": base64.b64encode(buf.getvalue()).decode()}
            replies[n] = _post(url + "/v1/predict", payload)
        rec = _post(url + "/v1/predict_recording", {"pkl_path": str(pkl)})
        launches = gru_cuda.launch_counts()
        # --------------------------------------------------------------------
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    if card_info["platform"] != "cuda" or card_info["window_shape"] != [c, t]:
        raise AssertionError(f"/healthz: {card_info}")
    atol = PROB_ATOL[dtype]
    errs = []
    for n, x in requests.items():
        if replies[n]["num_windows"] != n:
            raise AssertionError(f"/v1/predict {n}: num_windows {replies[n]['num_windows']}")
        errs.append(_check_probs(replies[n]["probs"], reference.predict_windows(x),
                                 n, atol, f"{dtype} /v1/predict {n} windows"))
    want_rec = reference.predict_recording(pkl)
    n_rec = len(want_rec.probs)
    errs.append(_check_probs([w["probs"] for w in rec["windows"]], want_rec.probs,
                             n_rec, atol, f"{dtype} /v1/predict_recording"))
    batches = sum(-(-n // 64) for n in requests) + -(-n_rec // 64)
    print(f"serving {dtype}: /healthz ok; /v1/predict 1, 7, 64, 100 windows and "
          f"/v1/predict_recording {n_rec} windows; max|probs - CPU| = "
          f"{max(errs):.3e} (atol {atol}); padded batches {batches}; "
          f"launches {launches}")
    expected = {"gru_fwd": batches, "gru_fwd_fb": batches, "gru_bwd": 0, "gru_bwd_fb": 0,
                "gru_bifwd": 0, "gru_bibwd": 0}
    if launches != expected:
        raise AssertionError(f"serving launched {launches}; expected {expected} "
                             f"for {batches} padded batches and no backward")

    x64 = requests[64]
    xt = torch.from_numpy(x64).cuda()
    with torch.inference_mode():
        fwd_ms = median_ms(lambda: predictor.model(xt), per_block=10)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        predictor.predict_windows(x64)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    print(f"serving {dtype}: padded-64 forward {fwd_ms:.3f} ms on the device "
          f"({64 / fwd_ms * 1e3:.0f} windows/s); predict_windows(64) "
          f"{host_ms:.3f} ms host clock with copies ({64 / host_ms * 1e3:.0f} windows/s)")
    with torch.inference_mode():
        trace(lambda: predictor.model(xt), "forward")
    return launches


def check_gradients(model) -> None:
    """After one step every parameter has a finite gradient, nonzero but for
    gru.l1_bwd_w_hh: with last-step pruning the final layer's backward
    direction is one cell step from h0 = 0, so dL/dW_hh = h0^T dg = 0
    exactly (the same in the JAX model)."""
    zero_by_construction = {"gru.l1_bwd_w_hh"}
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            raise AssertionError(f"{name}: gradient missing or not finite")
        nonzero = bool(p.grad.abs().sum() > 0)
        if nonzero == (name in zero_by_construction):
            raise AssertionError(f"{name}: gradient {'nonzero' if nonzero else 'zero'}")
    print(f"  gradients: all {len(list(model.parameters()))} parameters finite, "
          f"nonzero but {sorted(zero_by_construction)} (zero by construction)")


def compare_parameters(a, b, n_steps: int, tol: dict) -> tuple[float, float]:
    """(max |a - b|, share of elements beyond tol['elem']) over all
    parameters; raises beyond TRAIN_TOL's limits."""
    worst, far, total = 0.0, 0, 0
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        d = (pa.detach().cpu() - pb.detach()).abs()
        worst = max(worst, d.max().item())
        far += int((d > tol["elem"]).sum())
        total += d.numel()
    share = far / total
    if worst > 2 * LR * n_steps + 1e-6 or share > tol["share"]:
        raise AssertionError(f"parameters card vs CPU: max|d| {worst:.3e}, "
                             f"{share:.3%} of elements beyond {tol['elem']}")
    return worst, share


def first_steps_parity(model_cfg, variables, x, y, batches, tcfg, root: Path,
                       tol: dict, what: str) -> None:
    """Train steps on the card and on the CPU from the same weights, with
    dropout 0, over `batches` ((rows, weights) pairs): every loss within
    tol['loss'] relative, the gradients after the first step checked, and
    the parameters afterwards within TRAIN_TOL (compare_parameters). The CPU
    side runs the kernels' plain versions (gru_impl "auto" would take the
    plain loop there, so it becomes "cuda")."""
    no_drop = dataclasses.replace(model_cfg, dropout=0.0)
    cpu_cfg = (dataclasses.replace(no_drop, gru_impl="cuda")
               if no_drop.gru_impl == "auto" else no_drop)
    c = x.shape[1]
    card = Trainer(build_model(no_drop, 2, c), root / "card", tcfg, 2,
                   device="cuda", variables=variables)
    cpu = Trainer(build_model(cpu_cfg, 2, c), root / "cpu", tcfg, 2, device="cpu",
                  variables=variables)
    x_cpu, y_cpu = torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    x_gpu, y_gpu = x_cpu.cuda(), y_cpu.cuda()
    losses = []
    for k, (rows_np, w_np) in enumerate(batches):
        rows, wb = torch.from_numpy(rows_np), torch.from_numpy(w_np)
        got, _ = card.train_step(x_gpu[rows.cuda()], y_gpu[rows.cuda()], wb.cuda())
        if k == 0:
            check_gradients(card.model)
        want, _ = cpu.train_step(x_cpu[rows], y_cpu[rows], wb)
        losses.append((got.item(), want.item()))
        if not math.isfinite(got.item()) or abs(got.item() - want.item()) > tol["loss"] * abs(want.item()):
            raise AssertionError(f"{what} step {k}: loss card {got.item()} vs CPU {want.item()}")
    worst, share = compare_parameters(card.model, cpu.model, len(batches), tol)
    print(f"{what}: first {len(batches)} steps card vs CPU, losses "
          + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
          + f"; parameters max|d| {worst:.3e}, {share:.4%} beyond {tol['elem']}")


def training_phase(dtype: str, root: Path) -> dict[str, int]:
    """Parity of the first steps, the Trainer run (the main path, counted),
    then timings; returns the kernel launches of the Trainer run."""
    cfg = ExperimentConfig(model=ModelConfig(dtype=dtype))
    variables = random_variables(cfg, seed=0)
    c, t = len(cfg.channels_to_use), WINDOW_T
    rng = np.random.default_rng(3)
    x_tr = rng.standard_normal((TRAIN_N, c, t)).astype(np.float32)
    y_tr = rng.integers(0, 2, TRAIN_N)
    x_va = rng.standard_normal((VAL_N, c, t)).astype(np.float32)
    y_va = rng.integers(0, 2, VAL_N)
    tcfg = TrainerConfig(epochs=2, batch_size=BATCH, learning_rate=LR)
    tol = TRAIN_TOL[dtype]

    # a. The first steps, card vs CPU, dropout 0.
    idx, w = batch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0))
    steps = [0, 1, idx.shape[0] - 1]  # two full batches and the padded last
    first_steps_parity(cfg.model, variables, x_tr, y_tr, [(idx[s], w[s]) for s in steps],
                       tcfg, root / f"parity_{dtype}", tol, f"training {dtype}")

    # b. The main path: Trainer.train at the config's dropout (0.5).
    trainer = Trainer(build_model(cfg.model, 2, c), root / f"train_{dtype}", tcfg, 2,
                      device="cuda", variables=variables)
    gru_cuda.reset_launch_counts()
    # --- the main path: everything between reset and read is counted ---
    trainer.train((x_tr, y_tr), (x_va, y_va))
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    train_steps = tcfg.epochs * -(-TRAIN_N // BATCH)
    eval_batches = tcfg.epochs * -(-VAL_N // BATCH)
    expected = {"gru_fwd": train_steps + eval_batches,
                "gru_fwd_fb": train_steps + eval_batches,
                "gru_bwd": train_steps, "gru_bwd_fb": train_steps,
                "gru_bifwd": 0, "gru_bibwd": 0}
    hist = trainer.history
    if not all(math.isfinite(v) for h in hist for v in (h.train_loss, h.val_loss)):
        raise AssertionError(f"training {dtype}: losses not finite: {hist}")
    if launches != expected:
        raise AssertionError(f"training {dtype}: launches {launches}, expected "
                             f"{expected} ({train_steps} train steps, "
                             f"{eval_batches} eval batches)")
    ckpt = read_flax_checkpoint(root / f"train_{dtype}" / "best_model.msgpack")
    if set(ckpt) != {"params", "batch_stats"} or not ckpt["params"]:
        raise AssertionError("best_model.msgpack did not read back")
    print(f"training {dtype}: Trainer.train {tcfg.epochs} epochs, losses "
          + ", ".join(f"{h.train_loss:.4f}/{h.val_loss:.4f}" for h in hist)
          + f" (train/val); launches {launches}")

    # c. Timings at the config's dropout: back-to-back train steps at B=64.
    xb = torch.from_numpy(x_tr[:BATCH]).cuda()
    yb = torch.from_numpy(y_tr[:BATCH]).cuda()
    wb = torch.ones(BATCH, device="cuda")
    step_ms = median_ms(lambda: trainer.train_step(xb, yb, wb), per_block=5)
    print(f"training {dtype}: train step {step_ms:.3f} ms at B={BATCH} "
          f"({BATCH / step_ms * 1e3:.0f} windows/s), dropout {cfg.model.dropout}")
    trace(lambda: trainer.train_step(xb, yb, wb), "train step")
    return launches


LOSO_SUBJECTS = ("S2", "S3", "S4", "S5")
LOSO_WINDOWS = 48  # per subject
FOLD_LINE = re.compile(
    r"  - test (S\d+): Accuracy = (\S+), F1-score = (\S+) \(epochs: (\d+), "
    r"best: (\d+), test loss: (\S+), (\S+)s\)")


def write_loso_data(root: Path, seed: int) -> Path:
    """A preprocessed data directory as the preprocessor lays it out: per
    subject S*_X.npy [48, 7680, 8] float32 (the chest channels of
    ALL_CHANNEL_NAMES, N(0, 1), chest_EDA around 2) and S*_y.npy raw labels
    1-4, and _channel_names.txt."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    (root / "_channel_names.txt").write_text("\n".join(ALL_CHANNEL_NAMES) + "\n")
    eda = ALL_CHANNEL_NAMES.index("chest_EDA")
    for sid in LOSO_SUBJECTS:
        x = rng.standard_normal((LOSO_WINDOWS, WINDOW_T, len(ALL_CHANNEL_NAMES)),
                                dtype=np.float32)
        x[..., eda] = 2.0 + 0.5 * x[..., eda]
        np.save(root / f"{sid}_X.npy", x)
        np.save(root / f"{sid}_y.npy", rng.integers(1, 5, LOSO_WINDOWS))
    return root


def loso_expected_launches(cfg: ExperimentConfig) -> dict[str, int]:
    """Launches a serial LOSO run over LOSO_SUBJECTS implies with the fused
    BiGRU: per fold and epoch one train step per batch of the train
    subjects and one eval batch per batch of the validation subjects, then
    the test subject's eval batches (stress_binary keeps every window; the
    early-stopping patience exceeds the epochs)."""
    batches = lambda n: -(-n // cfg.trainer.batch_size)  # noqa: E731
    train_steps = eval_batches = 0
    for fold in loso_folds(cfg.subjects, cfg.val_fraction, cfg.seed):
        train_steps += cfg.trainer.epochs * batches(LOSO_WINDOWS * len(fold.train_subjects))
        eval_batches += (cfg.trainer.epochs * batches(LOSO_WINDOWS * len(fold.val_subjects))
                         + batches(LOSO_WINDOWS))
    return {"gru_fwd": train_steps + eval_batches, "gru_fwd_fb": 0,
            "gru_bwd": train_steps, "gru_bwd_fb": 0,
            "gru_bifwd": train_steps + eval_batches, "gru_bibwd": train_steps}


def loso_phase(dtype: str, data: Path, root: Path) -> dict[str, int]:
    """First-steps parity, then the experiment CLI (the main path,
    counted), its run directory's checks and the timings; returns the
    kernel launches of the CLI run."""
    out = root / f"loso_{dtype}"
    argv = ["--execution", "serial", "--output-dir", str(out),
            "--set", "model.gru_impl=pallas_fused", "--set", "trainer.epochs=2",
            "--set", f"model.dtype={dtype}", "--set", f"data_path={data}",
            "--set", "subjects=" + ",".join(LOSO_SUBJECTS)]
    cfg = cli.load_config(cli.build_parser().parse_args(argv))
    variables = random_variables(cfg, seed=0)
    fold = loso_folds(cfg.subjects, cfg.val_fraction, cfg.seed)[0]
    train = build_dataset(data, list(fold.train_subjects), list(cfg.channels_to_use),
                          read_channel_names(data), cfg.classification_mode,
                          cfg.normalization)
    bs = cfg.trainer.batch_size

    # a. The first 3 train steps of the first fold (its 2 batches, then the
    # first of the next epoch's order), card vs CPU, dropout 0.
    grids = [batch_indices(len(train), bs, rng=np.random.default_rng(e)) for e in (0, 1)]
    batches = [(idx[i], w[i]) for idx, w in grids for i in range(idx.shape[0])][:3]
    first_steps_parity(cfg.model, variables, train.x, train.y, batches, cfg.trainer,
                       root / f"loso_parity_{dtype}", TRAIN_TOL[dtype],
                       f"loso {dtype} fold test={fold.test_subject}")

    # b. The main path: the experiment CLI.
    gru_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    # --- the main path: everything between reset and read is counted ---
    cli.main(argv)
    launches = gru_cuda.launch_counts()
    # --------------------------------------------------------------------
    wall = time.perf_counter() - t0
    expected = loso_expected_launches(cfg)
    if launches != expected:
        raise AssertionError(f"loso {dtype}: launches {launches}, expected {expected}")
    (run_dir,) = (out / cfg.run_name).iterdir()
    saved = json.loads((run_dir / "config.json").read_text())
    if saved["model"]["gru_impl"] != "pallas_fused" or saved["model"]["dtype"] != dtype:
        raise AssertionError(f"loso {dtype}: config.json says {saved['model']}")
    summary = (run_dir / "cv_summary.txt").read_text()
    folds = FOLD_LINE.findall(summary)
    means = re.findall(r"Mean (?:accuracy|weighted F1): (\S+) ± (\S+)", summary)
    numbers = [float(v) for f in folds for v in f[1:]] + [float(v) for m in means for v in m]
    if (sorted(f[0] for f in folds) != sorted(LOSO_SUBJECTS) or len(means) != 2
            or not all(math.isfinite(v) for v in numbers)):
        raise AssertionError(f"loso {dtype}: cv_summary.txt is not 4 finite folds:\n{summary}")
    for sid in LOSO_SUBJECTS:
        ckpt = read_flax_checkpoint(run_dir / f"fold_test_on_{sid}" / "best_model.msgpack")
        if set(ckpt) != {"params", "batch_stats"} or not ckpt["params"]:
            raise AssertionError(f"loso {dtype}: fold {sid}'s best_model.msgpack did not read back")
    print(f"loso {dtype}: main --execution serial, {len(folds)} folds in {wall:.2f} s; "
          "fold wall s " + ", ".join(f"{f[0]} {f[6]}" for f in folds)
          + "; " + "; ".join(f"mean {a} ± {b}" for a, b in means)
          + f" (accuracy, F1); launches {launches}")

    # c. Timings: back-to-back pallas_fused train steps at B=64, config dropout.
    trainer = Trainer(build_model(cfg.model, 2, len(cfg.channels_to_use)),
                      root / f"loso_step_{dtype}", cfg.trainer, 2, device="cuda",
                      variables=variables)
    xb = torch.from_numpy(train.x[:bs]).cuda()
    yb = torch.from_numpy(train.y[:bs].astype(np.int64)).cuda()
    wb = torch.ones(bs, device="cuda")
    step_ms = median_ms(lambda: trainer.train_step(xb, yb, wb), per_block=5)
    print(f"loso {dtype}: pallas_fused train step {step_ms:.3f} ms at B={bs} "
          f"({bs / step_ms * 1e3:.0f} windows/s), dropout {cfg.model.dropout}")
    trace(lambda: trainer.train_step(xb, yb, wb), "pallas_fused train step")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card()
    build_phase()
    kernels = [
        kernel_phase("gru_fwd", gru_cuda.gru_forward, gru_cuda.gru_forward_plain,
                     fb=False, source_line="multimodalsignal_tpu/ops/gru_pallas.py:77"),
        kernel_phase("gru_fwd_fb", gru_cuda.gru_forward_fb,
                     gru_cuda.gru_forward_fb_plain, fb=True,
                     source_line="multimodalsignal_tpu/ops/gru_pallas.py:371"),
        bwd_kernel_phase("gru_bwd", gru_cuda.gru_backward, gru_cuda.gru_backward_plain,
                         fb=False, source_line="multimodalsignal_tpu/ops/gru_pallas.py:174"),
        bwd_kernel_phase("gru_bwd_fb", gru_cuda.gru_backward_fb,
                         gru_cuda.gru_backward_fb_plain, fb=True,
                         source_line="multimodalsignal_tpu/ops/gru_pallas.py:460"),
        fused_kernel_phase("gru_bifwd", gru_cuda.gru_bifwd, gru_cuda.gru_bifwd_plain,
                           adjoint=False,
                           source_line="multimodalsignal_tpu/ops/gru_pallas.py:874"),
        fused_kernel_phase("gru_bibwd", gru_cuda.gru_bibwd, gru_cuda.gru_bibwd_plain,
                           adjoint=True,
                           source_line="multimodalsignal_tpu/ops/gru_pallas.py:945"),
    ]
    walk_sweep()
    with tempfile.TemporaryDirectory() as tmp:
        pkl = Path(tmp) / "S99.pkl"
        write_recording(pkl, seconds=300, seed=2)
        serve_launches = serving_phase("float32", pkl)
        serving_phase("bfloat16", pkl)
        train_launches = training_phase("float32", Path(tmp))
        training_phase("bfloat16", Path(tmp))
        data = write_loso_data(Path(tmp) / "loso_data", seed=4)
        loso_launches = loso_phase("float32", data, Path(tmp))
        loso_phase("bfloat16", data, Path(tmp))
    # launches: the forward kernels' on the float32 serving path, the
    # adjoint kernels' on the float32 training path, the fused pair's on the
    # float32 LOSO path (all checked above).
    for k in kernels:
        path = {"gru_fwd": serve_launches, "gru_fwd_fb": serve_launches,
                "gru_bwd": train_launches, "gru_bwd_fb": train_launches}.get(
                    k["name"], loso_launches)
        k["launches"] = path[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
