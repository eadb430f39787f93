"""Online (streaming) classification of a live multichannel signal feed.

Counterpart of multimodalsignal_tpu/experiments/streaming.py. The batch
path (experiments/predict.py) needs a whole recording; a deployment that
watches a subject live classifies windows as they complete:

    sc = StreamingClassifier.for_predictor(predictor, calib_sec=120)
    for chunk in feed:            # [n, C] float at the model's target rate,
        for ev in sc.push(chunk): # channels in cfg.channels_to_use order
            print(ev.t_start_sec, ev.label, ev.probs)

CLI (`mms-stream`): replay a raw recording as a live feed (by default
through the causal native-rate front end, the path a live deployment
takes) or tail a text feed on stdin, one JSON event line per completed
window; the model runs on "cuda" unless --device names another device:

    python -m multimodalsignal_tpu_torch.experiments.streaming \
        --run-dir output/run_x --fold S2 --pkl WESAD/S2/S2.pkl \
        --out events.jsonl [--device cuda]

Semantics (each divergence from the batch path is inherent to streaming):

* Input may be at the model's target rate (128 Hz) or at a native
  acquisition rate (`input_fs=700` for a raw chest feed). Whole-signal FFT
  resampling (the batch path's) is not causal, so a native-rate feed goes
  through a causal polyphase front end (`data.resample.StreamingPolyResampler`)
  with a fixed Kaiser-sinc filter and a ~78 ms group delay: less than a
  stride, so window k of the stream is window k of the batch pipeline.
* Per-subject normalization statistics cannot come from the whole
  recording. The stream opens with a calibration span (`calib_sec`) whose
  samples fix the per-channel statistics (the training transform domain:
  chest_EDA log1p, eps 1e-8; data/dataset.py channel_norm_stats); every
  window, those inside the span included, is then classified with the
  frozen statistics. Given the same statistics, stream and batch agree.
* Events fire in order, one a stride, as soon as a window's last sample
  arrives (the earliest windows after the calibration span closes).
  Classification goes through the predictor's predict_windows, whose
  forwards take padded batches of batch_size windows, as the batch path's.
* A hybrid checkpoint (`hybrid_cnn_gru`) streams too: its features read
  each window's own 60 s of the unnormalized feed, so the feed carries the
  model channels plus the four feature sensors (`sc.feed_channels` gives
  the column order); the feature z-score statistics are frozen on the
  windows wholly inside the calibration span (the batch path uses the whole
  recording's), so `calib_sec` must cover two windows (window_sec +
  stride_sec): one window would freeze a zero feature std.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch.config import ALL_CHANNEL_NAMES, CHEST_SENSORS
from multimodalsignal_tpu_torch.data.dataset import apply_channel_norm, channel_norm_stats
from multimodalsignal_tpu_torch.data.features import (
    FEATURE_NAMES,
    FEATURE_SENSOR_CHANNELS,
    extract_features_batch,
)
from multimodalsignal_tpu_torch.data.resample import StreamingPolyResampler
from multimodalsignal_tpu_torch.data.wesad_io import chest_signals, load_pkl
from multimodalsignal_tpu_torch.experiments.predict import (
    CLASS_NAMES,
    EnsemblePredictor,
    HierarchicalPredictor,
    Predictor,
    _recording_grid,
)


@dataclass
class StreamEvent:
    """One classified window."""

    index: int           # 0-based window number
    t_start_sec: float
    t_end_sec: float
    label: str
    probs: np.ndarray    # [num_classes]


class StreamingClassifier:
    """Incremental windowed classification with calibration-frozen stats."""

    def __init__(self, predictor, channel_names: list[str],
                 target_fs: int, window_sec: int, stride_sec: int,
                 calib_sec: float = 120.0, batch_size: int = 64,
                 input_fs: int | None = None):
        if calib_sec <= 0:
            raise ValueError("calib_sec must be positive")
        self.predictor = predictor
        self.channel_names = list(channel_names)
        self.is_hybrid = bool(getattr(predictor, "is_hybrid", False))
        # Hybrid feeds must carry the feature sensors alongside the model
        # channels; feed_channels is the required chunk column order (for a
        # raw model it equals channel_names).
        if self.is_hybrid:
            self.feature_names = tuple(predictor.feature_names)
            self.feed_channels = self.channel_names + [
                s for s in FEATURE_SENSOR_CHANNELS
                if s not in self.channel_names]
            self._feat_cols = [self.feed_channels.index(s)
                               for s in FEATURE_SENSOR_CHANNELS]
            if calib_sec < window_sec + stride_sec:
                # One lone calibration window would freeze feats.std() == 0
                # (z-scores divided by the bare 1e-3 epsilon -> ~1000x
                # inflated model inputs); require >= 2 complete windows so
                # the frozen std reflects actual feature variance.
                raise ValueError(
                    f"hybrid streaming needs calib_sec >= window_sec + "
                    f"stride_sec ({window_sec + stride_sec}) to freeze "
                    f"feature statistics over at least two complete "
                    f"windows; got {calib_sec}")
        else:
            self.feature_names = ()
            self.feed_channels = self.channel_names
            self._feat_cols = []
        self.input_fs = int(input_fs) if input_fs else int(target_fs)
        if self.input_fs != target_fs:
            self._resampler = StreamingPolyResampler(
                self.input_fs, target_fs,
                num_channels=len(self.feed_channels))
        else:
            self._resampler = None
        self.target_fs = target_fs
        self.window_samples = window_sec * target_fs
        self.stride_samples = stride_sec * target_fs
        self.calib_samples = int(round(calib_sec * target_fs))
        self.batch_size = batch_size
        self.class_names = CLASS_NAMES[predictor.cfg.classification_mode] \
            if hasattr(predictor, "cfg") else tuple(predictor.class_names)
        self._chunks: list[np.ndarray] = []
        self._n = 0                 # total samples received
        self._buf: np.ndarray | None = None
        self._buf_offset = 0        # absolute sample index of _buf[0]
        self._next_window = 0       # next window index to classify
        self.stats: tuple[np.ndarray, np.ndarray] | None = None
        self.feat_stats: tuple[np.ndarray, np.ndarray] | None = None

    @classmethod
    def for_predictor(cls, predictor, calib_sec: float = 120.0,
                      batch_size: int = 64,
                      input_fs: int | None = None) -> "StreamingClassifier":
        """Wire geometry + channel order from a Predictor/EnsemblePredictor
        (cfg-backed) or an export.ExportedPredictor (meta-backed).
        input_fs: the live feed's native rate (e.g. 700 for a raw chest
        stream); omitted = feed already at the model's target rate."""
        meta = getattr(predictor, "meta", None)
        if meta is not None:
            return cls(predictor, list(meta["channels"]), meta["target_fs"],
                       meta["window_sec"], meta["stride_sec"],
                       calib_sec=calib_sec, batch_size=batch_size,
                       input_fs=input_fs)
        if hasattr(predictor, "cfg"):
            return cls(
                predictor, list(predictor.cfg.channels_to_use),
                predictor.target_fs, predictor.window_sec,
                predictor.stride_sec, calib_sec=calib_sec,
                batch_size=batch_size, input_fs=input_fs,
            )
        # HierarchicalPredictor surface: no single cfg (two stages), but the
        # union channel order + geometry travel on the composed predictor.
        return cls(
            predictor, list(predictor.channels), predictor.target_fs,
            predictor.window_sec, predictor.stride_sec,
            calib_sec=calib_sec, batch_size=batch_size, input_fs=input_fs,
        )

    # -- feed -------------------------------------------------------------------
    def push(self, chunk: np.ndarray) -> list[StreamEvent]:
        """Feed [n, C] samples at `input_fs` (native-rate feeds are causally
        resampled to the model rate first); returns the windows completed by
        this chunk (empty while the calibration span is still filling)."""
        chunk = np.atleast_2d(np.asarray(chunk, dtype=np.float32))
        if chunk.shape[1] != len(self.feed_channels):
            raise ValueError(
                f"chunk has {chunk.shape[1]} channels, stream expects "
                f"{len(self.feed_channels)} ({self.feed_channels})")
        if not np.isfinite(chunk).all():
            raise ValueError("chunk contains NaN/Inf")
        if self._resampler is not None:
            chunk = self._resampler.push(chunk).astype(np.float32)
            if len(chunk) == 0:
                return []
        self._chunks.append(chunk)
        self._n += len(chunk)

        if self.stats is None:
            if self._n < self.calib_samples:
                return []
            # Calibration closes: freeze per-channel stats on exactly the
            # calibration span (deterministic w.r.t. chunking). For hybrid
            # feeds only the model channels (the leading columns) are
            # z-scored; the trailing feature-sensor columns stay raw.
            self._consolidate()
            calib = self._buf[: self.calib_samples]
            self.stats = channel_norm_stats(
                calib[:, : len(self.channel_names)], self.channel_names)
            if self.is_hybrid:
                self.feat_stats = self._freeze_feature_stats(calib)
        return self._classify_ready()

    def flush(self) -> list[StreamEvent]:
        """End of stream: classify any final complete windows (a partial
        trailing window is dropped, matching the batch path's windowing)."""
        if self.stats is None:
            return []
        return self._classify_ready()

    # -- internals ---------------------------------------------------------------
    def _window_features(self, windows: np.ndarray) -> np.ndarray:
        """Unnormalized feed windows [k, T, C_feed] -> raw feature matrix
        [k, F_selected] (the offline feature target's math: float64 sensor
        windows, NaN groups zero-filled, reference preprocess.py:211)."""
        channel_windows = {
            s: np.ascontiguousarray(windows[:, :, c].astype(np.float64))
            for s, c in zip(FEATURE_SENSOR_CHANNELS, self._feat_cols)
        }
        feats = extract_features_batch(channel_windows, self.target_fs)
        feats = np.nan_to_num(feats, nan=0.0, posinf=0.0, neginf=0.0)
        idx = [FEATURE_NAMES.index(f) for f in self.feature_names]
        return feats[:, idx]

    def _freeze_feature_stats(self, calib: np.ndarray):
        """Feature z-score stats from the windows fully contained in the
        calibration span (normalize_features' 1e-3 epsilon — the batch path's
        all-recording stats are not causally computable)."""
        starts = np.arange(0, len(calib) - self.window_samples + 1,
                           self.stride_samples)
        wins = np.stack([calib[s : s + self.window_samples] for s in starts])
        feats = self._window_features(wins).astype(np.float64)
        return feats.mean(axis=0), feats.std(axis=0) + 1e-3

    def _consolidate(self) -> None:
        parts = ([self._buf] if self._buf is not None else []) + self._chunks
        self._buf = np.concatenate(parts) if len(parts) > 1 else parts[0]
        self._chunks = []

    def _classify_ready(self) -> list[StreamEvent]:
        self._consolidate()
        events: list[StreamEvent] = []
        windows = []
        first = self._next_window
        while (self._next_window * self.stride_samples - self._buf_offset
               + self.window_samples) <= len(self._buf):
            s = self._next_window * self.stride_samples - self._buf_offset
            windows.append(self._buf[s : s + self.window_samples])
            self._next_window += 1
        if not windows:
            return events
        # Samples before the next window's start are never read again: trim
        # them so a long-lived feed stays O(window) in memory instead of
        # retaining (and re-concatenating) the entire history every push.
        cut = min(self._next_window * self.stride_samples - self._buf_offset,
                  len(self._buf))
        if cut > 0:
            # `windows` holds views into the old buffer; they are consumed by
            # np.stack below, after which the old allocation is released.
            self._buf = self._buf[cut:].copy()
            self._buf_offset += cut
        mean, std = self.stats
        stacked = np.stack(windows)                       # [k, T, C_feed]
        win = apply_channel_norm(stacked[:, :, : len(self.channel_names)],
                                 self.channel_names, mean, std)  # [k, T, C]
        x = np.ascontiguousarray(win.transpose(0, 2, 1))  # [k, C, T]
        if self.is_hybrid:
            f_mean, f_std = self.feat_stats
            feats = self._window_features(stacked)
            x_feat = ((feats - f_mean) / f_std).astype(np.float32)
            x = (x, x_feat)
        # Hierarchical predictors label by the reference's hard M1 gate
        # (main.py:241-244), which can differ from the product-prob argmax
        # near the M1 boundary — stream events must carry the gated label,
        # exactly like the batch predict_recording path.
        if hasattr(self.predictor, "predict_windows_labeled"):
            probs, labels = self.predictor.predict_windows_labeled(
                x, self.batch_size)
        else:
            probs = self.predictor.predict_windows(x, self.batch_size)
            labels = np.asarray(probs).argmax(axis=-1)
        for j, p in enumerate(probs):
            idx = first + j
            s_sec = idx * self.stride_samples / self.target_fs
            events.append(StreamEvent(
                index=idx, t_start_sec=s_sec,
                t_end_sec=s_sec + self.window_samples / self.target_fs,
                label=self.class_names[int(labels[j])],
                probs=np.asarray(p),
            ))
        return events


# ------------------------------------------------------------------------
# CLI: replay a recording (or tail a live text feed) through the streaming
# classifier, emitting one JSON event line per completed window.
# ------------------------------------------------------------------------

def _event_json(ev: StreamEvent) -> str:
    return json.dumps({
        "index": ev.index,
        "t_start_sec": round(float(ev.t_start_sec), 3),
        "t_end_sec": round(float(ev.t_end_sec), 3),
        "label": ev.label,
        "probs": [round(float(p), 6) for p in ev.probs],
    })


def _native_chest_grid(pkl_path):
    """Raw WESAD pickle -> the UNRESAMPLED [n, 8] chest grid at the device's
    native rate + its channel names. The native-feed replay source: columns
    are pushed through the stream's causal polyphase front-end exactly as a
    live chest acquisition would be (no whole-signal FFT resample). Channel
    assembly order matches offline preprocessing (reference
    preprocess.py:128-129,143-153: ACC x/y/z then ECG/EDA/EMG/Resp/Temp)."""
    chest = chest_signals(load_pkl(pkl_path))
    cols = []
    for sensor in CHEST_SENSORS:
        sig = np.asarray(chest[sensor], dtype=np.float32)
        if sig.ndim == 1:
            sig = sig[:, None]
        cols.append(sig)
    n = min(len(c) for c in cols)  # guard ragged sensor lengths
    return np.concatenate([c[:n] for c in cols], axis=1), list(ALL_CHANNEL_NAMES)


def _pkl_feed(pkl_path, sc: StreamingClassifier, feed: str, original_fs: int):
    """Build the replay feed matrix [n, C_feed] for a StreamingClassifier.

    feed='native': the raw chest grid at original_fs (the stream's causal
    resampler front-end does the 700->128 Hz conversion — the faithful
    live-deployment path; wrist channels have per-sensor rates and no native
    feed, use 'resampled'). feed='resampled': the batch pipeline's
    FFT-resampled grid at target_fs (the predict CLI's windows bit for bit,
    modulo the calibration-vs-all-recording stats divergence the module
    docstring documents)."""
    if feed == "native":
        grid, names = _native_chest_grid(pkl_path)
        missing = [ch for ch in sc.feed_channels if ch not in names]
        if missing:
            raise SystemExit(
                f"native feed is chest-only (wrist sensors each record at "
                f"their own rate); {missing} unavailable — rerun with "
                f"--feed resampled")
        feed_fs = original_fs
    else:
        grid, names = _recording_grid(pkl_path, list(sc.feed_channels),
                                      original_fs, sc.target_fs)
        feed_fs = sc.target_fs
    idx = [names.index(ch) for ch in sc.feed_channels]
    return np.ascontiguousarray(grid[:, idx], dtype=np.float32), feed_fs


def _stdin_rows(fh, n_channels: int):
    """Parse a text feed: one sample per line, comma/whitespace-separated
    floats in feed-channel order; blank lines and '#' comments skipped."""
    for lineno, line in enumerate(fh, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = line.replace(",", " ").split()
        if len(vals) != n_channels:
            raise SystemExit(
                f"stdin line {lineno}: expected {n_channels} values "
                f"(feed channels), got {len(vals)}")
        yield [float(v) for v in vals]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Stream a recording (or a live stdin feed) through the "
                    "online classifier; one JSON event line per completed "
                    "window.")
    p.add_argument("--checkpoint", help="best_model.msgpack (with --config)")
    p.add_argument("--config", help="the run's config.json (with --checkpoint)")
    p.add_argument("--artifact",
                   help="exported .mms artifact (experiments/export.py); "
                        "replaces --checkpoint/--config")
    p.add_argument("--run-dir",
                   help="run directory: streams through the fold ensemble "
                        "(or one fold via --fold; a hierarchical run's "
                        "composed stages of one fold); replaces "
                        "--checkpoint/--config")
    p.add_argument("--fold", default="all",
                   help="with --run-dir: a subject id, or 'all' (default)")
    p.add_argument("--pkl", help="replay this raw WESAD S*.pkl as the feed")
    p.add_argument("--feed", choices=("native", "resampled"), default="native",
                   help="with --pkl: 'native' pushes the raw chest grid at "
                        "the recording rate through the causal resampler "
                        "front-end (the live-deployment path, default); "
                        "'resampled' pushes the batch pipeline's FFT-"
                        "resampled grid at the model rate")
    p.add_argument("--stdin", action="store_true",
                   help="read the feed from stdin instead: one sample per "
                        "line, comma/whitespace-separated floats in the "
                        "feed-channel order printed at startup")
    p.add_argument("--input-fs", type=int, default=None,
                   help="with --stdin: the feed's native rate (engages the "
                        "causal resampler); default = the model rate")
    p.add_argument("--chunk-sec", type=float, default=1.0,
                   help="replay granularity: samples are pushed in chunks "
                        "of this many seconds (events still fire once per "
                        "completed stride)")
    p.add_argument("--calib-sec", type=float, default=120.0,
                   help="calibration span that freezes normalization stats "
                        "(see module docstring)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--out", default=None,
                   help="append JSONL events here (default stdout)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run the model on (default cuda)")
    args = p.parse_args(argv)

    if sum(map(bool, (args.artifact, args.run_dir,
                      args.checkpoint or args.config))) > 1:
        p.error("--artifact, --run-dir and --checkpoint/--config are "
                "mutually exclusive")
    if bool(args.pkl) == bool(args.stdin):
        p.error("provide exactly one feed source: --pkl or --stdin")
    if args.artifact:
        from multimodalsignal_tpu_torch.experiments.export import ExportedPredictor

        predictor = ExportedPredictor.load(args.artifact, args.device)
    elif args.run_dir:
        raw = json.loads((Path(args.run_dir) / "config.json").read_text())
        if "m1_channels" in raw:  # a hierarchical run: the composed two stages
            if args.fold == "all":
                p.error("hierarchical runs need --fold <subject> "
                        "(per-fold M1+M2 composition)")
            predictor = HierarchicalPredictor.from_run(args.run_dir, args.fold, args.device)
        else:
            predictor = EnsemblePredictor.from_run(args.run_dir, args.fold, args.device)
    elif args.checkpoint and args.config:
        predictor = Predictor.from_files(args.checkpoint, args.config, args.device)
    else:
        p.error("provide --artifact, --run-dir, or --checkpoint with --config")

    meta = getattr(predictor, "meta", None)
    original_fs = int(meta["original_fs"]) if meta is not None \
        else int(predictor.original_fs)

    if args.pkl:
        # Geometry probe first (cheap, no model work) so the feed matrix and
        # the classifier agree on channel order, then one classifier reused
        # for the whole replay.
        sc = StreamingClassifier.for_predictor(
            predictor, calib_sec=args.calib_sec, batch_size=args.batch_size)
        feed, feed_fs = _pkl_feed(args.pkl, sc, args.feed, original_fs)
        if feed_fs != sc.target_fs:
            sc = StreamingClassifier.for_predictor(
                predictor, calib_sec=args.calib_sec,
                batch_size=args.batch_size, input_fs=feed_fs)
        chunks = (feed[i : i + max(1, int(round(args.chunk_sec * feed_fs)))]
                  for i in range(0, len(feed),
                                 max(1, int(round(args.chunk_sec * feed_fs)))))
        feed_sec = len(feed) / feed_fs
    else:
        sc = StreamingClassifier.for_predictor(
            predictor, calib_sec=args.calib_sec, batch_size=args.batch_size,
            input_fs=args.input_fs)

        def _stdin_chunks():
            step = max(1, int(round(args.chunk_sec
                                    * (args.input_fs or sc.target_fs))))
            buf = []
            for row in _stdin_rows(sys.stdin, len(sc.feed_channels)):
                buf.append(row)
                if len(buf) >= step:
                    yield np.asarray(buf, dtype=np.float32)
                    buf = []
            if buf:
                yield np.asarray(buf, dtype=np.float32)

        chunks = _stdin_chunks()
        feed_sec = None

    print(f"feed channels (in order): {list(sc.feed_channels)}",
          file=sys.stderr, flush=True)
    sink = open(args.out, "a") if args.out else sys.stdout
    n_events = 0
    counts: dict[str, int] = {}
    t0 = time.perf_counter()
    try:
        for chunk in chunks:
            for ev in sc.push(chunk):
                sink.write(_event_json(ev) + "\n")
                n_events += 1
                counts[ev.label] = counts.get(ev.label, 0) + 1
            if n_events:
                sink.flush()
        for ev in sc.flush():
            sink.write(_event_json(ev) + "\n")
            n_events += 1
            counts[ev.label] = counts.get(ev.label, 0) + 1
        sink.flush()
    finally:
        if args.out:
            sink.close()
    wall = time.perf_counter() - t0
    summary = f"{n_events} events in {wall:.1f}s"
    if feed_sec is not None and wall > 0:
        summary += (f" ({feed_sec:.0f}s of signal -> "
                    f"{feed_sec / wall:.0f}x realtime)")
    for name in sorted(counts):
        summary += f" | {name}: {counts[name]}"
    print(summary, file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
