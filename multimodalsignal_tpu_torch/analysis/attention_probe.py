"""Channel-attention mechanism probe: does the gate earn its name?
(Counterpart of multimodalsignal_tpu/analysis/attention_probe.py: the same
corruption stream, gate and tables; the forwards run through the port's
Predictor, on the card unless --device cpu.)

The reference's headline claims attention fusion beats traditional fusion
(reference README.md:13: 82.44% vs ~75%), with the mechanism being the
squeeze-and-excitation channel gate (reference models.py:7-31). On the
calibrated benchmark corpus the opposite holds (benchmarks/BENCHMARK.md:
cnn_gru 82.96% vs cnn_gru_attention 81.64%). This module probes the
mechanism directly instead of arguing from end-to-end accuracy alone:

  1. **Corruption sweep** — evaluate trained fold checkpoints on the
     held-out subject while corrupting one randomly chosen channel per
     window (rail / flatline, the mean-shifting signatures of
     data/synthetic._apply_artifacts) at increasing rates. If the gate can
     detect and down-weight a corrupted channel, the attention model's
     accuracy should degrade more slowly than the gateless baseline's.
  2. **Gate response** — compute the gate activations (directly from the
     checkpoint's channel_attention params) on clean vs corrupted windows
     and report the gate given to the corrupted channel vs the others. A
     working gate shows corrupted-channel gate << clean-channel gate.

Architectural context for reading the results: with C input channels and
reduction ratio r the bottleneck width is C // r (torch floor division,
reference models.py:17-21). At the reference's headline 3-channel config
the width is 0 and the gate is the constant 0.5 quirk (models/cnn_gru.py
ChannelAttention); at the benchmark's fusion6 config it is 6 // 4 = 1 — a
RANK-1 gate: every channel's gate moves monotonically along a fixed curve
of the single scalar s = relu(w1 . mean_t(x)), so the gate cannot
independently down-weight whichever channel happens to be corrupted. A
full-rank gate needs reduction_ratio=1; the probe is designed to compare both.

CLI (run dirs are sharded-sweep or serial LOSO outputs with per-fold
best_model.msgpack + config.json):

    python -m multimodalsignal_tpu_torch.analysis.attention_probe \
        --run cnn_gru=/out/abl/fusion6__cnn_gru \
        --run attention_r4=/out/abl/fusion6__cnn_gru_attention \
        --data /tmp/bench/data/chest_raw \
        --rates 0 0.25 0.5 1.0 --kinds rail flatline \
        --out /out/probe_attention.json [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import zlib
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.data.dataset import build_dataset, read_channel_names
from multimodalsignal_tpu_torch.train import metrics as M

_EVAL_CHUNK = 256  # fixed forward shape, as the JAX probe's (one compile there)


def corrupt_windows(
    x: np.ndarray,
    rate: float,
    kind: str,
    seed: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Corrupt one randomly chosen channel in a `rate` fraction of windows.

    `x` is [N, C, T] of per-subject NORMALIZED windows (z-units), so the
    artifact levels mirror data/synthetic._apply_artifacts expressed in
    standard deviations: rail = mu + U(4,7) sd with small jitter, flatline =
    mu - U(2,4) sd. Returns (x_corrupted, corrupted_mask [N] bool,
    channel_idx [N] int, -1 where clean). Deterministic in `seed`.
    """
    rng = np.random.default_rng(seed)
    n, c, _t = x.shape
    out = x.copy()
    hit = rng.random(n) < rate
    chan = np.where(hit, rng.integers(0, c, n), -1)
    for i in np.nonzero(hit)[0]:
        ch = chan[i]
        if kind == "rail":
            level = rng.uniform(4.0, 7.0)
            out[i, ch] = level + 0.2 * rng.standard_normal(out.shape[-1])
        elif kind == "flatline":
            out[i, ch] = -rng.uniform(2.0, 4.0)
        else:
            raise ValueError(f"unknown corruption kind: {kind}")
    return out, hit, chan


def _gate_kernels(source):
    """(fc1 kernel [C, hidden], fc2 kernel [hidden, C]) in flax's layout,
    from a port model's ChannelAttention or a checkpoint's params tree;
    None for a gateless model or the constant gate."""
    if isinstance(source, torch.nn.Module):
        att = getattr(source, "channel_attention", None)
        if att is None or att.constant_gate:
            return None
        return tuple(np.ascontiguousarray(fc.weight.detach().cpu().numpy().T)
                     for fc in (att.fc1, att.fc2))
    att = source.get("channel_attention") if hasattr(source, "get") else None
    if att is None or "fc1" not in att:
        return None
    return np.asarray(att["fc1"]["kernel"]), np.asarray(att["fc2"]["kernel"])


def gate_activations(source, x: np.ndarray) -> np.ndarray:
    """The channel gate [N, C] for input windows [N, C, T], computed exactly
    as ChannelAttention does (models/cnn_gru.py: time-mean squeeze -> fc1 ->
    ReLU -> fc2 -> sigmoid), on the host from the weights of `source`: a
    port model (its ChannelAttention) or a checkpoint's params tree.
    Returns the constant 0.5 gate when the model has no attention weights or
    the C // reduction_ratio == 0 degenerate config."""
    n, c, _t = x.shape
    kernels = _gate_kernels(source)
    if kernels is None:
        return np.full((n, c), 0.5, dtype=np.float32)
    w1, w2 = kernels
    m = x.mean(axis=-1)  # [N, C] — AdaptiveAvgPool1d(1) over time
    s = np.maximum(m @ w1, 0.0)
    z = s @ w2
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def _batched_probs(predictor, x: np.ndarray) -> np.ndarray:
    """Softmax probs in fixed [chunk, C, T] forwards on the Predictor's
    device: Predictor.predict_windows pads the tail chunk with zeros and
    runs each chunk through predict_tensor, as the JAX probe pads its."""
    return predictor.predict_windows(x, batch_size=_EVAL_CHUNK)


def probe_fold(
    predictor,
    x: np.ndarray,
    y: np.ndarray,
    rates: list[float],
    kinds: list[str],
    seed: int,
    num_classes: int,
) -> dict:
    """Corruption sweep for one trained fold on its held-out subject.

    Returns {kind: {rate: {"accuracy", "f1", "gate_corrupted",
    "gate_clean_mean"}}} — gate stats are NaN for rate 0 / gateless models.
    """
    results: dict = {}
    for kind in kinds:
        results[kind] = {}
        for rate in rates:
            if rate == 0.0:
                xc, hit, chan = x, np.zeros(len(x), bool), np.full(len(x), -1)
            else:
                xc, hit, chan = corrupt_windows(x, rate, kind, seed)
            probs = _batched_probs(predictor, xc)
            preds = probs.argmax(axis=-1)
            cm = np.zeros((num_classes, num_classes), np.int64)
            np.add.at(cm, (y, preds), 1)
            acc = float((preds == y).mean())
            f1 = float(M.weighted_f1_from_cm(torch.from_numpy(cm).float()))

            gates = gate_activations(predictor.model, xc)
            if hit.any():
                g_hit = float(gates[hit, chan[hit]].mean())
                mask = np.ones_like(gates, bool)
                mask[np.nonzero(hit)[0], chan[hit]] = False
                g_rest = float(gates[np.nonzero(hit)[0]][
                    mask[np.nonzero(hit)[0]]].mean())
            else:
                g_hit, g_rest = float("nan"), float("nan")
            results[kind][f"{rate:g}"] = {
                "accuracy": acc,
                "f1": f1,
                "gate_corrupted": g_hit,
                "gate_other": g_rest,
                "gate_clean_mean": float(gates[~hit].mean()) if (~hit).any()
                else float("nan"),
            }
    return results


def probe_run(
    run_dir: Path | str,
    data_path: Path | str,
    rates: list[float],
    kinds: list[str],
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    """Probe every fold checkpoint of a LOSO run on `device`; aggregate
    across folds."""
    from multimodalsignal_tpu_torch.experiments.predict import Predictor

    run_dir = Path(run_dir)
    all_names = read_channel_names(data_path)
    folds = sorted(run_dir.glob("fold_test_on_*"))
    if not folds:
        raise FileNotFoundError(f"no fold_test_on_* dirs under {run_dir}")

    per_fold = []
    cfg = None
    for fold_dir in folds:
        subject = fold_dir.name.removeprefix("fold_test_on_")
        if not (fold_dir / "best_model.msgpack").exists():
            continue
        predictor = Predictor.from_run(run_dir, subject, device=device)
        cfg = predictor.cfg
        ds = build_dataset(
            data_path=data_path,
            subjects=[subject],
            channels_to_use=list(cfg.channels_to_use),
            all_channel_names=all_names,
            classification_mode=cfg.classification_mode,
            normalization=cfg.normalization,
        )
        per_fold.append(probe_fold(
            predictor, ds.x, ds.y, rates, kinds,
            # Stable per-subject stream (hash() is salted per process).
            seed=seed + zlib.crc32(subject.encode()) % 10_000,
            num_classes=cfg.num_classes,
        ))

    if not per_fold:
        raise FileNotFoundError(
            f"No fold checkpoints (best_model.msgpack) found under "
            f"{run_dir}/fold_test_on_*/ — was this run made before "
            f"checkpoint export, or only partially synced?"
        )
    agg: dict = {"num_folds": len(per_fold), "model": cfg.model.name,
                 "reduction_ratio": cfg.model.reduction_ratio,
                 "channels": list(cfg.channels_to_use)}
    for kind in kinds:
        agg[kind] = {}
        for rate in rates:
            key = f"{rate:g}"
            vals = [f[kind][key] for f in per_fold]

            def nanmean(stat):
                col = [v[stat] for v in vals]
                return float(np.nanmean(col)) if not np.all(np.isnan(col)) \
                    else float("nan")

            agg[kind][key] = {
                stat: nanmean(stat)
                for stat in ("accuracy", "f1", "gate_corrupted",
                             "gate_other", "gate_clean_mean")
            }
            agg[kind][key]["accuracy_std"] = float(
                np.std([v["accuracy"] for v in vals])
            )
    return agg


def format_table(results: dict[str, dict], kinds: list[str],
                 rates: list[float]) -> str:
    """Accuracy-vs-corruption table across models + gate response columns."""
    lines = []
    for kind in kinds:
        lines.append(f"\n== corruption: {kind} (one random channel/window) ==")
        header = f"{'model':<22}" + "".join(
            f"  acc@{r:g}" .rjust(9) for r in rates)
        lines.append(header)
        for name, agg in results.items():
            row = f"{name:<22}"
            for r in rates:
                row += f"{agg[kind][f'{r:g}']['accuracy']:9.4f}"
            lines.append(row)
        for name, agg in results.items():
            gc = [agg[kind][f"{r:g}"]["gate_corrupted"] for r in rates]
            go = [agg[kind][f"{r:g}"]["gate_other"] for r in rates]
            if all(np.isnan(v) for v in gc[1:]):
                continue
            lines.append(
                f"{name + ' gate':<22}"
                + "".join(f"{c:5.2f}/{o:.2f}" if not np.isnan(c) else "    -    "
                          for c, o in zip(gc, go))
                + "   (corrupted/other)"
            )
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--run", action="append", required=True,
                        metavar="NAME=RUN_DIR",
                        help="labelled LOSO run dir (repeatable)")
    parser.add_argument("--data", required=True,
                        help="preprocessed raw data dir (chest_raw)")
    parser.add_argument("--rates", nargs="+", type=float,
                        default=[0.0, 0.25, 0.5, 1.0])
    parser.add_argument("--kinds", nargs="+", default=["rail", "flatline"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="JSON output path")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the forwards run (default cuda; raises without it)")
    args = parser.parse_args(argv)

    results = {}
    for spec in args.run:
        name, _, run_dir = spec.partition("=")
        if not run_dir:
            raise SystemExit(f"--run must be NAME=DIR, got: {spec}")
        print(f"probing {name}: {run_dir}")
        results[name] = probe_run(run_dir, args.data, args.rates, args.kinds,
                                  seed=args.seed, device=args.device)

    table = format_table(results, args.kinds, args.rates)
    print(table)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"rates": args.rates, "kinds": args.kinds, "results": results},
            indent=2))
        print(f"\nwritten: {out}")


if __name__ == "__main__":
    main()
