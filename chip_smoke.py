#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodalsignal_tpu_torch) on one GPU.

    python chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. The card: name and power limit from nvidia-smi, torch's device name.
2. Build every CUDA source of the port with nvcc (one process each, all at
   once) into multimodalsignal_tpu_torch/ops/build/, and check each
   kernel's shared-memory size in C against its wrapper's formula.
3. One phase per kernel: the wrapper on CUDA tensors against its plain
   PyTorch version on the same inputs, float32 and bfloat16, both walk
   directions, at the serving/training shape (T=480, B=64, H=64; F=2 lanes
   for the _fb kernels) and a ragged one. TF32 is off for matmul and cuDNN.
   Forward kernels (gru_fwd, gru_fwd_fb): ys, float32 rtol = atol = 1e-5,
   bfloat16 atol 0.05. Adjoint kernels (gru_bwd, gru_bwd_fb): all four
   outputs, tolerances in BWD_TOL. Then the times at the main shape: the
   kernel, the plain version, the least time the card could take, and
   cuDNN's GRU (nn.GRU: the forward, or for an adjoint kernel the backward
   as forward+backward minus forward; it also does the input projection).
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

Prints a JSON line of the kernels, then, as the last line,
{"ok": true, "device": {...}}. Needs one CUDA device and the repository.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import math
import pickle
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

from multimodalsignal_tpu_torch.config import ExperimentConfig, ModelConfig, TrainerConfig
from multimodalsignal_tpu_torch.experiments.predict import Predictor
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


def build_phase() -> None:
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"in {time.perf_counter() - t0:.2f} s")
    for name in seconds:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for lib, c_fn, py_fn in (
            (gru_cuda._library(), "gru_fwd_shared_bytes", gru_cuda.shared_bytes),
            (gru_cuda._bwd_library(), "gru_bwd_shared_bytes", gru_cuda.bwd_shared_bytes)):
        for bf16, size in ((0, 4), (1, 2)):
            c_bytes = getattr(lib, c_fn)(SERVE_H, bf16)
            if c_bytes != py_fn(SERVE_H, size):
                raise AssertionError(f"{c_fn}: C says {c_bytes}, wrapper "
                                     f"{py_fn(SERVE_H, size)}")
            print(f"  {c_fn}(H={SERVE_H}, bf16={bf16}) = {c_bytes} bytes")


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


def kernel_phase(name, wrapper, plain, fb: bool, source_line: str) -> dict:
    lanes = 2 if fb else None
    cases = [(lanes, SERVE_T, SERVE_B, SERVE_H), (3 if fb else None, 37, 5, 40)]
    serve_err = 0.0
    for shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for reverse in (False, True):
                args = kernel_inputs(*shape, dtype, seed=len(name) + shape[1])
                got = wrapper(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = plain(*args, reverse=reverse)
                err = (got.float() - want.float()).abs().max().item()
                print(f"{name}: shape F={shape[0]} T={shape[1]} B={shape[2]} "
                      f"H={shape[3]} {str(dtype)[6:]} reverse={reverse}: "
                      f"max|d|={err:.3e}")
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError(f"{name}: got {got.dtype} {list(got.shape)}")
                torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
                if shape[1] == SERVE_T and dtype == torch.float32:
                    serve_err = max(serve_err, err)
    entry = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = kernel_inputs(lanes, SERVE_T, SERVE_B, SERVE_H, dtype, seed=7)
        ms = median_ms(lambda: wrapper(*args), per_block=50)
        plain_ms = median_ms(lambda: plain(*args), per_block=1, warmup=1)
        lib_ms = cudnn_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        b_ms, b_by = bound_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        print(f"{name} {str(dtype)[6:]} at F={lanes or 1} T={SERVE_T} "
              f"B={SERVE_B} H={SERVE_H}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, cuDNN GRU {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
        if dtype == torch.float32:
            entry = {"name": name, "route": "cuda",
                     "source": "multimodalsignal_tpu_torch/ops/csrc/gru_fwd.cu",
                     "replaces": source_line, "launches": 0,
                     "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


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


def bwd_inputs(lanes, t, b, h, dtype, seed):
    """kernel_inputs, then ys from the plain forward and dy N(0, 1)."""
    xg, w, bias, h0 = kernel_inputs(lanes, t, b, h, dtype, seed)
    lead = () if lanes is None else (lanes,)
    fwd = gru_cuda.gru_forward_fb_plain if lanes else gru_cuda.gru_forward_plain
    ys = fwd(xg, w, bias, h0)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        lead + (t, b, h))).to("cuda", dtype)
    return xg, w, bias, h0, ys.contiguous(), dy


def bwd_kernel_phase(name, wrapper, plain, fb: bool, source_line: str) -> dict:
    lanes = 2 if fb else None
    cases = [(lanes, SERVE_T, SERVE_B, SERVE_H), (3 if fb else None, 37, 5, 40)]
    serve_err = 0.0
    outputs = ("dxg", "dW", "db", "dh0")
    for shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for reverse in (False, True):
                args = bwd_inputs(*shape, dtype, seed=len(name) + shape[1])
                got = wrapper(*args, reverse=reverse)
                torch.cuda.synchronize()
                want = plain(*args, reverse=reverse)
                errs = [(g.float() - w.float()).abs().max().item()
                        for g, w in zip(got, want)]
                print(f"{name}: shape F={shape[0]} T={shape[1]} B={shape[2]} "
                      f"H={shape[3]} {str(dtype)[6:]} reverse={reverse}: max|d| "
                      + ", ".join(f"{o} {e:.3e}" for o, e in zip(outputs, errs)))
                for o, g, w in zip(outputs, got, want):
                    want_dt = dtype if o == "dxg" else torch.float32
                    if g.dtype != want_dt or g.shape != w.shape:
                        raise AssertionError(f"{name} {o}: got {g.dtype} {list(g.shape)}")
                    tol = BWD_TOL[dtype][o in ("dW", "db")]
                    torch.testing.assert_close(g.float(), w.float(), **tol,
                                               msg=lambda m, o=o: f"{name} {o}: {m}")
                if shape[1] == SERVE_T and dtype == torch.float32:
                    serve_err = max(serve_err, *errs)
    entry = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = bwd_inputs(lanes, SERVE_T, SERVE_B, SERVE_H, dtype, seed=7)
        ms = median_ms(lambda: wrapper(*args), per_block=50)
        plain_ms = median_ms(lambda: plain(*args), per_block=1, warmup=1)
        lib_ms = cudnn_bwd_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        b_ms, b_by = bwd_bound_ms(lanes, SERVE_T, SERVE_B, SERVE_H, dtype)
        print(f"{name} {str(dtype)[6:]} at F={lanes or 1} T={SERVE_T} "
              f"B={SERVE_B} H={SERVE_H}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, cuDNN GRU backward {lib_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms:.2%} of bound")
        if dtype == torch.float32:
            entry = {"name": name, "route": "cuda",
                     "source": "multimodalsignal_tpu_torch/ops/csrc/gru_bwd.cu",
                     "replaces": source_line, "launches": 0,
                     "max_abs_err": serve_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return entry


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
    expected = {"gru_fwd": batches, "gru_fwd_fb": batches, "gru_bwd": 0, "gru_bwd_fb": 0}
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
    no_drop = dataclasses.replace(cfg.model, dropout=0.0)
    card = Trainer(build_model(no_drop, 2, c), root / f"card_{dtype}", tcfg, 2,
                   device="cuda", variables=variables)
    cpu = Trainer(build_model(dataclasses.replace(no_drop, gru_impl="cuda"), 2, c),
                  root / f"cpu_{dtype}", tcfg, 2, device="cpu", variables=variables)
    idx, w = batch_indices(TRAIN_N, BATCH, rng=np.random.default_rng(0))
    steps = [0, 1, idx.shape[0] - 1]  # two full batches and the padded last
    x_gpu, y_gpu = torch.from_numpy(x_tr).cuda(), torch.from_numpy(y_tr).cuda()
    losses = []
    for k, s in enumerate(steps):
        rows, wb = torch.from_numpy(idx[s]), torch.from_numpy(w[s])
        got, _ = card.train_step(x_gpu[rows.cuda()], y_gpu[rows.cuda()], wb.cuda())
        if k == 0:
            check_gradients(card.model)
        want, _ = cpu.train_step(torch.from_numpy(x_tr)[rows], torch.from_numpy(y_tr)[rows], wb)
        losses.append((got.item(), want.item()))
        if not math.isfinite(got.item()) or abs(got.item() - want.item()) > tol["loss"] * abs(want.item()):
            raise AssertionError(f"train step {k}: loss card {got.item()} vs CPU {want.item()}")
    worst, share = compare_parameters(card.model, cpu.model, len(steps), tol)
    print(f"training {dtype}: first {len(steps)} steps card vs CPU, losses "
          + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
          + f"; parameters max|d| {worst:.3e}, {share:.4%} beyond {tol['elem']}")

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
                "gru_bwd": train_steps, "gru_bwd_fb": train_steps}
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
    xb, yb = x_gpu[:BATCH], y_gpu[:BATCH]
    wb = torch.ones(BATCH, device="cuda")
    step_ms = median_ms(lambda: trainer.train_step(xb, yb, wb), per_block=5)
    print(f"training {dtype}: train step {step_ms:.3f} ms at B={BATCH} "
          f"({BATCH / step_ms * 1e3:.0f} windows/s), dropout {cfg.model.dropout}")
    trace(lambda: trainer.train_step(xb, yb, wb), "train step")
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
    ]
    with tempfile.TemporaryDirectory() as tmp:
        pkl = Path(tmp) / "S99.pkl"
        write_recording(pkl, seconds=300, seed=2)
        serve_launches = serving_phase("float32", pkl)
        serving_phase("bfloat16", pkl)
        train_launches = training_phase("float32", Path(tmp))
        training_phase("bfloat16", Path(tmp))
    # launches: the forward kernels' on the float32 serving path, the
    # adjoint kernels' on the float32 training path (both checked above).
    for k in kernels:
        path = train_launches if k["name"].startswith("gru_bwd") else serve_launches
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
