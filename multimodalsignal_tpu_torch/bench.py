"""Benchmark: train steps/sec of the flagship CnnGruAttention model on one GPU.

Counterpart of the repository's bench.py. It times the port's training step
(forward, backward, Adam update and the batch-norm statistics' update, under
`train.trainer.deterministic_convolutions` as `Trainer.train_step` takes it)
at the reference's headline shape: batch 64, 3 input channels, 7680
timesteps, one fixed batch made from a seed. bench.py runs its steps as one
device program (`jax.jit(lax.scan(train_step))`) so that per-call dispatch
never enters the measurement; the counterpart here is a CUDA graph: one
train step is captured (`torch.cuda.CUDAGraph`, after `--warmup` eager steps
on a side stream) and replayed `--steps` times, 3 reps, with one
synchronize at the end of each rep. Adam is made capturable (its step count
on the device) and the dropout generator is registered with the graph, so
every replay draws new masks and takes Adam's next bias correction. The GRU
runs in the hand-written kernels; the graph holds their launches, and the
wrappers' launch counters count the capture, not the replays: the line
before the result gives the launches per captured step.

    python -m multimodalsignal_tpu_torch.bench              # on the GPU
    python -m multimodalsignal_tpu_torch.bench --dtype float32 --steps 100
    python -m multimodalsignal_tpu_torch.bench --device cpu --batch 2 --seq 256 --steps 2

`--device cpu` runs the same step eagerly, for tests only. `vs_baseline` is
the ratio to the reference architecture's float32 PyTorch training step on
nn.GRU (`bench_torch_baseline`, bench.py's own copy), timed on the same
device and cached in `.bench_baseline_torch.json` at the repository's root,
keyed by device name and shape. `--dropout-rng` is accepted and ignored, as
`dropout_rng` is everywhere in the port (one generator kind).

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "steps/sec/chip", "vs_baseline": N}
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import ModelConfig
from multimodalsignal_tpu_torch.experiments.predict import resolve_device
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.ops import gru_cuda
from multimodalsignal_tpu_torch.train.optim import make_optimizer
from multimodalsignal_tpu_torch.train.trainer import train_step

BASELINE_CACHE = Path(__file__).resolve().parent.parent / ".bench_baseline_torch.json"
GRU_IMPLS = ("scan", "pallas", "pallas_db", "pallas_fused")
REPS = 3
SEED = 0


def bench_model(channels: int, gru_impl: str = "pallas_db", dtype: str = "bfloat16",
                last_prune: bool = True, dropout: float = ModelConfig.dropout):
    """The benchmarked model: CnnGruAttention at the config's widths and
    dropout (the JAX bench's defaults), gru_impl mapped as build_model maps
    it."""
    cfg = ModelConfig(gru_impl=gru_impl, gru_last_prune=last_prune, dtype=dtype,
                      dropout=dropout)
    return build_model(cfg, 2, in_channels=channels)


def fixed_batch(batch: int, channels: int, seq: int, device):
    """One batch made from a numpy seed: windows N(0, 1) [B, C, T] float32,
    labels in {0, 1}, all-ones sample weights."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((batch, channels, seq), np.float32))
    y = torch.from_numpy(rng.integers(0, 2, batch))
    return x.to(device), y.to(device), torch.ones(batch, device=device)


def make_train_step(model, optimizer, x, y, w, generator):
    """The body of bench.py's train_step on the port: one Trainer-style step
    (train.trainer.train_step) on the fixed batch; returns a function that
    takes it and returns the loss, a device tensor."""
    def step() -> torch.Tensor:
        return train_step(model, optimizer, generator, x, y, w)[0]
    return step


def make_capturable(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Keep Adam's step count on the device (`capturable`), so that a
    captured step reads and advances it at every replay instead of freezing
    the bias correction at capture. Before the first step only: the state
    is created where this says."""
    if optimizer.state:
        raise ValueError("make the optimizer capturable before its first step")
    for group in optimizer.param_groups:
        group["capturable"] = True
    return optimizer


def capture(step, warmup: int, generator: torch.Generator):
    """Run `step` max(warmup, 1) times on a side stream (the optimizer's
    state, cuDNN's and cuBLAS's workspaces are made there, outside the
    graph), then capture one call in a CUDA graph with `generator`
    registered, so each replay draws from it anew. Returns (graph, the loss
    tensor every replay writes, the hand-written kernels' launches in the
    captured step: what every replay launches, as the wrappers' counters
    count the capture and never a replay; the counters themselves go on
    counting, the warm-up steps too). The step's tensors must stay where
    they are: the graph reads and writes them in place."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(max(warmup, 1)):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    before = gru_cuda.launch_counts()
    with torch.cuda.graph(graph):
        loss = step()
    return graph, loss, {k: n - before[k] for k, n in gru_cuda.launch_counts().items()}


def bench_torch(batch: int, channels: int, seq: int, steps: int, warmup: int,
                gru_impl: str = "pallas_db", dtype: str = "bfloat16",
                last_prune: bool = True, device: str | torch.device = "cuda") -> dict:
    """Train steps/s of the benchmarked step. On CUDA: `warmup` eager steps,
    one captured step, one warm replay, then REPS reps of `steps` replays,
    each rep ended by a synchronize; the launches of the hand-written
    kernels per captured step. On the CPU the same step eagerly. Returns
    {"steps_per_sec", "ms", "launches", "graph", "step"}: launches and
    graph None on the CPU; the graph is the one timed, replayable while the
    step it captured is held (the step keeps the model, the optimizer, the
    batch and the generator alive, whose memory the graph reads and
    writes)."""
    device = resolve_device(device)
    torch.manual_seed(SEED)
    model = bench_model(channels, gru_impl, dtype, last_prune).to(device)
    optimizer = make_optimizer(model.parameters(), 1e-3, 1e-4)
    x, y, w = fixed_batch(batch, channels, seq, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(SEED)
    step = make_train_step(model, optimizer, x, y, w, generator)
    launches = graph = None
    if device.type == "cuda":
        make_capturable(optimizer)
        graph, loss, launches = capture(step, warmup, generator)
        run = graph.replay
        run()
        torch.cuda.synchronize()
    else:
        loss = None

        def run():
            nonlocal loss
            loss = step()

        for _ in range(warmup):
            run()
    t0 = time.perf_counter()
    for _ in range(REPS):
        for _ in range(steps):
            run()
        if device.type == "cuda":
            torch.cuda.synchronize()
    rate = REPS * steps / (time.perf_counter() - t0)
    if not torch.isfinite(loss).item():
        raise RuntimeError(f"the benchmarked step's loss is not finite: {loss.item()}")
    return {"steps_per_sec": rate, "ms": 1e3 / rate, "launches": launches, "graph": graph,
            "step": step}


def bench_torch_baseline(batch: int, channels: int, seq: int, steps: int,
                         device: str | torch.device = "cuda") -> float:
    """Reference-architecture PyTorch training step (the reference is pure
    PyTorch, on nn.GRU) on `device`, float32, timed eagerly after 2 warm-up
    steps; bench.py's bench_torch_baseline with a synchronize before each
    clock read, which a CUDA device needs."""
    import torch.nn as nn

    class TorchChannelAttention(nn.Module):
        def __init__(self, c, r=4):
            super().__init__()
            self.pool = nn.AdaptiveAvgPool1d(1)
            self.fc = nn.Sequential(
                nn.Linear(c, c // r, bias=False), nn.ReLU(),
                nn.Linear(c // r, c, bias=False), nn.Sigmoid(),
            )

        def forward(self, x):
            y = self.fc(self.pool(x).squeeze(-1))
            return x * y.unsqueeze(-1)

    class TorchCnnGruAttention(nn.Module):
        def __init__(self, c_in, num_classes=2, cnn_out=32, hidden=64, layers=2):
            super().__init__()
            self.att = TorchChannelAttention(c_in) if c_in >= 4 else None
            self.cnn = nn.Sequential(
                nn.Conv1d(c_in, 16, 7, stride=2, padding=3, bias=False),
                nn.BatchNorm1d(16), nn.ReLU(), nn.MaxPool1d(3, 2, padding=1),
                nn.Conv1d(16, cnn_out, 5, stride=2, padding=2, bias=False),
                nn.BatchNorm1d(cnn_out), nn.ReLU(), nn.MaxPool1d(3, 2, padding=1),
            )
            self.gru = nn.GRU(cnn_out, hidden, layers, batch_first=True,
                              bidirectional=True, dropout=0.5)
            self.head = nn.Sequential(
                nn.Linear(2 * hidden, 64), nn.ReLU(), nn.Dropout(0.5),
                nn.Linear(64, num_classes),
            )

        def forward(self, x):
            if self.att is not None:
                x = self.att(x)
            else:
                x = x * 0.5  # reference's degenerate C<4 gate (models.py:12-21)
            x = self.cnn(x).permute(0, 2, 1)
            out, _ = self.gru(x)
            return self.head(out[:, -1, :])

    device = resolve_device(device)
    model = TorchCnnGruAttention(channels).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-4)
    loss_fn = nn.CrossEntropyLoss()
    x = torch.randn(batch, channels, seq, device=device)
    y = torch.randint(0, 2, (batch,), device=device)
    model.train()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(2):  # warmup
        opt.zero_grad()
        loss_fn(model(x), y).backward()
        opt.step()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad()
        loss_fn(model(x), y).backward()
        opt.step()
    sync()
    return steps / (time.perf_counter() - t0)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def get_baseline(batch: int, channels: int, seq: int, device: str | torch.device = "cuda"
                 ) -> float:
    """The baseline's steps/s on this device at this shape, from the cache or
    measured once (10 steps) and cached; nan if it could not run."""
    device = resolve_device(device)
    key = f"{device_name(device)}|torch_b{batch}_c{channels}_t{seq}"
    cache = {}
    if BASELINE_CACHE.exists():
        try:
            cache = json.loads(BASELINE_CACHE.read_text())
        except json.JSONDecodeError:
            cache = {}
    if key not in cache:
        try:
            cache[key] = bench_torch_baseline(batch, channels, seq, steps=10, device=device)
        except RuntimeError as exc:  # out of memory too
            print(f"bench: the baseline did not run: {exc}", file=sys.stderr)
            return float("nan")
        BASELINE_CACHE.write_text(json.dumps(cache))
    return cache[key]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--seq", type=int, default=7680)
    p.add_argument("--steps", type=int, default=500,
                   help="replays of the captured step a rep (3 reps)")
    p.add_argument("--warmup", type=int, default=10,
                   help="eager steps before the capture (at least 1 is taken)")
    p.add_argument("--gru-impl", choices=GRU_IMPLS, default="pallas_db",
                   help="both directions of a layer as two lanes of one kernel walk "
                        "(default), per-direction kernels (pallas: the same kernels "
                        "in the port), the fused float32 pair (pallas_fused), or the "
                        "plain loop (scan)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="bfloat16")
    p.add_argument("--no-last-prune", action="store_true",
                   help="disable the final-layer backward-walk pruning")
    p.add_argument("--dropout-rng", choices=("auto", "threefry", "rbg"), default="auto",
                   help="accepted and ignored: the port draws dropout from one "
                        "torch generator kind")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu (an eager "
                        "step, for tests)")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    out = bench_torch(args.batch, args.channels, args.seq, args.steps, args.warmup,
                      args.gru_impl, args.dtype, not args.no_last_prune, device)
    mode = "captured CUDA graph" if device.type == "cuda" else "eager"
    counted = ("" if out["launches"] is None else "; launches per captured step "
               + str({k: v for k, v in out["launches"].items() if v}))
    print(f"bench: {device_name(device)}, {mode}, {out['ms']:.4f} ms a step{counted}",
          flush=True)
    baseline = get_baseline(args.batch, args.channels, args.seq, device)
    vs = out["steps_per_sec"] / baseline if np.isfinite(baseline) and baseline > 0 else None
    # vs_baseline compares this dtype's step to the float32 nn.GRU reference
    # step on the same device; the dtype and the device kind are named in the
    # metric string so the ratio is never read as the JAX bench's.
    where = "CUDA" if device.type == "cuda" else "CPU"
    print(json.dumps({
        "metric": "cnn_gru_attention train steps/sec/chip "
                  f"(B={args.batch}, C={args.channels}, T={args.seq}, {args.dtype}, "
                  f"{mode}; baseline torch-{where} float32 nn.GRU)",
        "value": round(out["steps_per_sec"], 3),
        "unit": "steps/sec/chip",
        "vs_baseline": round(vs, 3) if vs is not None else None,
    }))


if __name__ == "__main__":
    main()
