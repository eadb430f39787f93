"""Dataset layer: windowed npy files -> dense, normalized [N, C, T] arrays,
the hybrid model's (raw, feature) pairs, and the sharded sweep's packed
corpus, from npy files or straight from WESAD pickles, memoized on disk
(counterpart of multimodalsignal_tpu/data/dataset.py).

The host window engine. As in the JAX package, float32 windows take the
C++ engine (native/) where it is built: normalize_subject's
use_native=None, the fused select + z-score + transpose of every packer
(_pack_subject: pack_corpus, with the subject's X memory-mapped, and the
pickles' pack), double accumulators over the float32 data. The NumPy
float64 path below stays the oracle, and what runs where the engine did
not build; the two agree to float32 round-off, and the port's engine packs
equal the JAX package's bit for bit (the same source and flags).

The pack cache. A packed corpus depends only on its inputs, so pack_corpus
and pack_corpus_from_pickles keep it under `<data>/.pack_cache/<key>/`
(x.npy, y.npy, mask.npy, meta.json), keyed on the pack inputs and the
(mtime_ns, size) of every source file, as the JAX package does; a later
identical pack reads it back (x as a read-only memory map) instead of
loading and normalizing every subject again. The key's payload names this
package: the port's pack equals the JAX package's only to float32
round-off, so neither package reads the other's entries. `cache=False` or
MMS_PACK_CACHE=0 turns it off; the entries are pruned, least recently used
first, to MMS_PACK_CACHE_GB (default 16), never the newest.

A preprocessed data directory (data/preprocess.py) holds, per subject,
`S*_X.npy` windows and `S*_y.npy` raw labels (1 Base, 2 TSST, 3 Fun,
4 Medi), plus `_channel_names.txt` or `_feature_names.txt` (one name per
line) and `_preprocess_meta.json`. The raw targets' X is [N, T, C_all]
float32, the feature target's [N, F] float64."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from multimodalsignal_tpu_torch import native

EDA_CHANNEL = "chest_EDA"
# Floor for the EDA log1p (keeps it defined when FFT resampling rings below
# -1 at artifact steps).
_LOG1P_FLOOR = -1.0 + 1e-6
NORMALIZATION_SCHEMES = ("all", "baseline", "none")


def read_channel_names(data_path: Path | str) -> list[str]:
    """The _channel_names.txt contract: one channel name per line."""
    with open(Path(data_path) / "_channel_names.txt") as f:
        return [line.strip() for line in f if line.strip()]


def read_preprocess_meta(data_path: Path | str) -> dict | None:
    """_preprocess_meta.json beside the windowed npy files (the fs, window
    and stride contract), or None for data written without it."""
    path = Path(data_path) / "_preprocess_meta.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def experiment_preprocess_meta(cfg) -> dict | None:
    """The preprocess meta a run directory embeds in config.json: the raw
    windows' contract (the raw-align target's for the hybrid model), for a
    hybrid run merged with the feature target's extractor version stamp,
    which the hybrid Predictor checks against its own extractor."""
    hybrid = cfg.model.name == "hybrid_cnn_gru"
    meta = read_preprocess_meta(cfg.raw_align_path if hybrid else cfg.data_path)
    if hybrid:
        feat_meta = read_preprocess_meta(cfg.feature_path) or {}
        if "feature_extractor_version" in feat_meta:
            meta = dict(meta or {})
            meta["feature_extractor_version"] = feat_meta["feature_extractor_version"]
    return meta


def load_subject_windows(data_path: Path | str, sid: str, mmap: bool = False):
    """One subject's (X [N, T, C_all], y_raw [N]), or None with a warning
    when its files are missing; with `mmap` X is a read-only memory map."""
    data_path = Path(data_path)
    x_file = data_path / f"{sid}_X.npy"
    y_file = data_path / f"{sid}_y.npy"
    if not x_file.exists() or not y_file.exists():
        print(f"Warning: Skipping subject {sid} for data, file not found.")
        return None
    return np.load(x_file, mmap_mode="r" if mmap else None), np.load(y_file)


def map_labels(y_raw: np.ndarray, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """Raw labels {1: Base, 2: TSST, 3: Fun, 4: Medi} -> (labels, keep mask)
    by classification mode. stress_binary and ternary keep every window;
    amusement_binary keeps Base and Fun only. "binary" is an alias of
    stress_binary."""
    if mode == "binary":
        mode = "stress_binary"
    if mode == "stress_binary":
        return np.where(y_raw == 2, 1, 0).astype(np.int32), np.ones(len(y_raw), bool)
    if mode == "ternary":
        y = np.where(y_raw == 1, 0, np.where(y_raw == 3, 1, np.where(y_raw == 2, 2, 0)))
        return y.astype(np.int32), np.ones(len(y_raw), bool)
    if mode == "amusement_binary":
        keep = np.isin(y_raw, (1, 3))
        return np.where(y_raw == 3, 1, 0).astype(np.int32), keep
    raise ValueError(f"Unknown classification_mode: {mode}")


def normalize_subject(x: np.ndarray, y_raw: np.ndarray,
                      channel_names: list[str], scheme: str = "all",
                      use_native: bool | None = None) -> np.ndarray:
    """Per-subject normalization of [N, T, C] windows with float64 stats.

    scheme="all":      z-score per channel over all windows; chest_EDA gets
                       log1p first and its own log-domain stats (eps 1e-8).
    scheme="baseline": stats from Base-only (y_raw == 1) windows, with the
                       all-window stats when a subject has none.
    scheme="none":     passthrough.

    use_native=None takes the C++ engine's channel_stats_f32 and
    normalize_windows_f32 for float32 windows where it is built (double
    accumulation over the float32 data; float32 round-off from the NumPy
    path); float64 windows, use_native=False and an engine that did not
    build take the NumPy float64 path below.
    """
    if scheme == "none":
        return x.astype(np.float32)
    if scheme not in NORMALIZATION_SCHEMES:
        raise ValueError(f"Unknown normalization scheme: {scheme}")
    if use_native is None:
        use_native = np.asarray(x).dtype == np.float32
    if use_native and native.available():
        return _normalize_subject_native(x, y_raw, channel_names, scheme)
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x, dtype=np.float32)
    if scheme == "baseline":
        ref = x[y_raw == 1] if (y_raw == 1).any() else x
        if not (y_raw == 1).any():
            print("Warning: no baseline windows; falling back to all-data stats.")
    else:
        ref = x
    for c, name in enumerate(channel_names):
        if name == EDA_CHANNEL:
            log_all = np.log1p(np.maximum(x[:, :, c], _LOG1P_FLOOR))
            log_ref = np.log1p(np.maximum(ref[:, :, c], _LOG1P_FLOOR))
            mean, std = log_ref.mean(), log_ref.std() + 1e-8
            out[:, :, c] = ((log_all - mean) / std).astype(np.float32)
        else:
            mean, std = ref[:, :, c].mean(), ref[:, :, c].std() + 1e-8
            out[:, :, c] = ((x[:, :, c] - mean) / std).astype(np.float32)
    return out


def _log1p_mask(channel_names) -> np.ndarray:
    return np.array([name == EDA_CHANNEL for name in channel_names], dtype=np.uint8)


def _stat_rows(y_raw: np.ndarray, scheme: str) -> np.ndarray:
    """The windows whose statistics normalize a subject: the Base windows
    under "baseline" (all of them, with a warning, where it has none), else
    all."""
    if scheme == "baseline":
        if (y_raw == 1).any():
            return y_raw == 1
        print("Warning: no baseline windows; falling back to all-data stats.")
    return np.ones(len(y_raw), bool)


def _normalize_subject_native(x: np.ndarray, y_raw: np.ndarray, channel_names: list[str],
                              scheme: str) -> np.ndarray:
    """normalize_subject through the engine (counterpart of the JAX
    package's _normalize_subject_native)."""
    xw = np.ascontiguousarray(x, dtype=np.float32)
    mask = _log1p_mask(channel_names)
    rows = _stat_rows(y_raw, scheme)
    ref = xw if rows.all() else np.ascontiguousarray(xw[rows])
    mean, std = native.channel_stats_f32(ref, mask)
    return native.normalize_windows_f32(xw.copy(), mean, std + 1e-8, mask)


def channel_norm_stats(samples: np.ndarray, channel_names: list[str]
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel (mean, std) over a flat [M, C] span of samples, in the
    training transform domain (log1p for chest_EDA, floored; eps 1e-8 on
    std): the streaming form of the statistics normalize_subject computes
    over a window batch. normalize_subject(x, y, names, "all") equals
    apply_channel_norm(x, names, *channel_norm_stats(x.reshape(-1, C),
    names))."""
    x = np.asarray(samples, np.float64)
    mean = np.empty(x.shape[1])
    std = np.empty(x.shape[1])
    for c, name in enumerate(channel_names):
        col = x[:, c]
        if name == EDA_CHANNEL:
            col = np.log1p(np.maximum(col, _LOG1P_FLOOR))
        mean[c] = col.mean()
        std[c] = col.std() + 1e-8
    return mean, std


def apply_channel_norm(x: np.ndarray, channel_names: list[str],
                       mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """Normalize [..., C]-last windows with given statistics (see
    channel_norm_stats); chest_EDA is log1p-transformed first. float32."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty_like(x, dtype=np.float32)
    for c, name in enumerate(channel_names):
        col = x[..., c]
        if name == EDA_CHANNEL:
            col = np.log1p(np.maximum(col, _LOG1P_FLOOR))
        out[..., c] = ((col - mean[c]) / std[c]).astype(np.float32)
    return out


def normalize_features(x_feat: np.ndarray, y_raw: np.ndarray,
                       scheme: str = "baseline") -> np.ndarray:
    """Per-subject z-score of feature vectors [N, F] in float64, std + 1e-3
    (not the raw streams' 1e-8); "baseline" takes the statistics from the
    Base windows (all windows where a subject has none), "all" from every
    window, "none" passes through. Returns float32."""
    x_feat = np.asarray(x_feat, dtype=np.float64)
    if scheme == "none":
        return x_feat.astype(np.float32)
    ref = x_feat[y_raw == 1] if (scheme == "baseline" and (y_raw == 1).any()) else x_feat
    mean = ref.mean(axis=0)
    std = ref.std(axis=0) + 1e-3
    return ((x_feat - mean) / std).astype(np.float32)


@dataclass
class WindowDataset:
    """Dense dataset: x [N, C, T] float32 (channels first, the model's
    input layout), y [N] int32, and the subjects it holds in order."""

    x: np.ndarray
    y: np.ndarray
    subjects: tuple[str, ...]

    def __len__(self) -> int:
        return len(self.y)


def build_dataset(data_path: Path | str, subjects: list[str],
                  channels_to_use: list[str], all_channel_names: list[str],
                  classification_mode: str = "stress_binary",
                  normalization: str = "all") -> WindowDataset:
    """Select the channels, map the labels, normalize each subject on its
    own and concatenate the subjects in order; subjects whose files are
    missing are skipped, and none loaded raises ValueError."""
    channel_indices = [all_channel_names.index(ch) for ch in channels_to_use]
    xs, ys, loaded = [], [], []
    for sid in subjects:
        item = load_subject_windows(data_path, sid)
        if item is None:
            continue
        x_raw, y_raw = item
        x_sel = x_raw[:, :, channel_indices]
        y, keep = map_labels(y_raw, classification_mode)
        x_norm = normalize_subject(x_sel, y_raw, channels_to_use, normalization)
        xs.append(x_norm[keep])
        ys.append(y[keep])
        loaded.append(sid)
    if not xs:
        raise ValueError(
            f"No data loaded for subjects: {subjects}. Check paths and data existence.")
    x = np.concatenate(xs, axis=0).transpose(0, 2, 1)  # [N, C, T]
    y = np.concatenate(ys, axis=0)
    return WindowDataset(np.ascontiguousarray(x), y, tuple(loaded))


@dataclass
class HybridWindowDataset:
    """Raw windows paired with handcrafted features: x_raw [N, C, T]
    float32, x_feat [N, F] float32, y [N] int32. Its `x` is the pair the
    hybrid model and the Trainer take."""

    x_raw: np.ndarray
    x_feat: np.ndarray
    y: np.ndarray
    subjects: tuple[str, ...]

    def __len__(self) -> int:
        return len(self.y)

    @property
    def x(self) -> tuple[np.ndarray, np.ndarray]:
        return self.x_raw, self.x_feat


def read_feature_names(feature_path: Path | str) -> list[str]:
    """The _feature_names.txt contract: one feature name per line."""
    with open(Path(feature_path) / "_feature_names.txt") as f:
        return [line.strip() for line in f if line.strip()]


def _feature_indices(feature_path, features_to_use) -> list[int]:
    names = read_feature_names(feature_path)
    return ([names.index(f) for f in features_to_use] if features_to_use
            else list(range(len(names))))


def build_hybrid_dataset(raw_align_path: Path | str, feature_path: Path | str,
                         subjects: list[str], channels_to_use: list[str],
                         all_channel_names: list[str],
                         features_to_use: list[str] | None = None,
                         classification_mode: str = "stress_binary",
                         normalization: str = "baseline") -> HybridWindowDataset:
    """build_dataset over the raw-align target, paired with the feature
    target: both streams normalized per subject by `normalization` (the raw
    one with EDA log1p, the features with normalize_features), in subject
    order. The two streams must hold the same window count and labels; a
    subject missing either is skipped, and none loaded raises ValueError."""
    channel_indices = [all_channel_names.index(ch) for ch in channels_to_use]
    feat_idx = _feature_indices(feature_path, features_to_use)
    raw_parts, feat_parts, y_parts, y_feat_parts, loaded = [], [], [], [], []
    for sid in subjects:
        raw_item = load_subject_windows(raw_align_path, sid)
        feat_item = load_subject_windows(feature_path, sid)
        if raw_item is None or feat_item is None:
            continue
        x_raw, y = _pack_subject(*raw_item, channel_indices, channels_to_use,
                                 classification_mode, normalization)
        raw_parts.append(x_raw)
        y_parts.append(y)
        x_feat, y_feat_raw = feat_item
        y_feat, keep_feat = map_labels(y_feat_raw, classification_mode)
        feat_parts.append(normalize_features(x_feat[:, feat_idx], y_feat_raw,
                                             normalization)[keep_feat])
        y_feat_parts.append(y_feat[keep_feat])
        loaded.append(sid)
    if not raw_parts:
        raise ValueError(f"No hybrid data loaded for subjects: {subjects}.")
    x_raw_all = np.concatenate(raw_parts, axis=0)
    x_feat_all = np.concatenate(feat_parts, axis=0)
    y_all = np.concatenate(y_parts, axis=0)
    if x_raw_all.shape[0] != x_feat_all.shape[0] or not np.array_equal(
            y_all, np.concatenate(y_feat_parts, axis=0)):
        raise ValueError(
            f"raw-align vs feature streams disagree: {x_raw_all.shape[0]} raw windows vs "
            f"{x_feat_all.shape[0]} feature windows (or labels differ); regenerate both "
            "preprocess targets together.")
    return HybridWindowDataset(np.ascontiguousarray(x_raw_all), x_feat_all, y_all,
                               tuple(loaded))


@dataclass
class PackedCorpus:
    """All subjects padded to a common window count for the sharded sweep.

    x    [S, Wmax, C, T] float32, normalized per subject
    y    [S, Wmax] int32 (mapped labels; padded rows hold 0)
    mask [S, Wmax] bool (True = a real window that the mode's filter kept)
    feat [S, Wmax, F] float32 handcrafted features window for window with x
         (pack_hybrid_corpus), or None
    """

    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    subjects: tuple[str, ...]
    feat: np.ndarray | None = None

    def flat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The [S*Wmax, C, T] view with labels and mask, for the sweep's
        index pools (subject s, window w -> s * Wmax + w)."""
        s, wmax = self.x.shape[:2]
        return (self.x.reshape(s * wmax, *self.x.shape[2:]), self.y.reshape(s * wmax),
                self.mask.reshape(s * wmax))

    def flat_feat(self) -> np.ndarray | None:
        """The [S*Wmax, F] feature view, indexed as flat()."""
        if self.feat is None:
            return None
        s, wmax = self.feat.shape[:2]
        return self.feat.reshape(s * wmax, self.feat.shape[2])


def _stack_packed(per_subject) -> PackedCorpus:
    """Pad per-subject (sid, x [n, C, T], y [n]) tuples to a common window
    count and stack them into one PackedCorpus."""
    wmax = max(x.shape[0] for _, x, _ in per_subject)
    c, t = per_subject[0][1].shape[1:]
    x_out = np.zeros((len(per_subject), wmax, c, t), dtype=np.float32)
    y_out = np.zeros((len(per_subject), wmax), dtype=np.int32)
    mask = np.zeros((len(per_subject), wmax), dtype=bool)
    for i, (_, x, y) in enumerate(per_subject):
        x_out[i, :len(x)] = x
        y_out[i, :len(x)] = y
        mask[i, :len(x)] = True
    return PackedCorpus(x_out, y_out, mask, tuple(sid for sid, _, _ in per_subject))


def _fused_pack(normalization: str) -> bool:
    """Whether the packers take the engine's fused pack: a z-score scheme
    and an engine that built (the JAX package's _pack_arrays_native)."""
    return normalization in ("all", "baseline") and native.available()


def _pack_subject(x_raw, y_raw, channel_indices, channels_to_use, classification_mode,
                  normalization) -> tuple[np.ndarray, np.ndarray]:
    """One subject's windows [N, T, C_all] -> (x [keep, C, T], y [keep]):
    select the channels, map the labels, normalize, drop what the mode does
    not keep. The npy and the pickle staging share it. Float32 windows (a
    memory map will do) take the engine's fused pack where _fused_pack
    says, in two streaming passes; otherwise the NumPy path, which is also
    where a subject with no windows (so no statistics rows) goes, as the
    JAX package's packers send it: an empty pack and an all-false mask row."""
    y, keep = map_labels(y_raw, classification_mode)
    if _fused_pack(normalization) and x_raw.dtype == np.float32 and x_raw.ndim == 3:
        stat_rows = _stat_rows(y_raw, normalization)
        if stat_rows.any():
            x = native.pack_subject_f32(x_raw, np.asarray(channel_indices),
                                        _log1p_mask(channels_to_use), stat_rows, keep)
            return x, y[keep]
    x_norm = normalize_subject(x_raw[:, :, channel_indices], y_raw, channels_to_use,
                               normalization)
    return x_norm[keep].transpose(0, 2, 1), y[keep]


def _pack_subjects(pack_one, subjects, what: str) -> PackedCorpus:
    """pack_one(sid) -> (sid, x, y) or None, over a pool of up to 8 threads
    (NumPy and SciPy release the GIL), stacked in subject order."""
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(subjects)))) as ex:
        packed = list(ex.map(pack_one, subjects))
    per_subject = [p for p in packed if p is not None]
    if not per_subject:
        raise ValueError(f"No {what} loaded for subjects: {subjects}.")
    return _stack_packed(per_subject)


# Bump when the packed layout or the normalization changes: every existing
# pack cache entry then misses. The tag keeps the two packages' entries apart.
# 2: the packs go through the host window engine (float32 round-off).
_PACK_CACHE_VERSION = 2
_PACK_CACHE_TAG = "multimodalsignal_tpu_torch"


def _file_states(files) -> list:
    """(name, mtime_ns, size) of each file, None for a missing one."""
    states = []
    for name, f in files:
        try:
            st = f.stat()
            states.append([*name, st.st_mtime_ns, st.st_size])
        except OSError:
            states.append([*name, None, None])
    return states


def _cache_key(*payload) -> str:
    text = json.dumps([_PACK_CACHE_TAG, _PACK_CACHE_VERSION, *payload])
    return hashlib.sha256(text.encode()).hexdigest()[:24]


def _pack_cache_key(data_path, subjects, channels_to_use, classification_mode,
                    normalization) -> str:
    """Key of a pack_corpus result: its inputs and the (mtime_ns, size) of
    every subject's npy files, so a re-run preprocessor or another subject
    set, channel set, mode or scheme never reads a stale pack."""
    data_path = Path(data_path)
    states = _file_states(((sid, suffix), data_path / f"{sid}_{suffix}.npy")
                          for sid in subjects for suffix in ("X", "y"))
    return _cache_key(list(subjects), list(channels_to_use), classification_mode,
                      normalization, states)


def _pickles_cache_key(wesad_root, subjects, channels_to_use, classification_mode,
                       normalization, meta) -> str:
    """Key of a pack_corpus_from_pickles result: its inputs, the preprocess
    parameters and the (mtime_ns, size) of every subject's pickle and
    questionnaire."""
    root = Path(wesad_root)
    states = _file_states(((f.name,), f) for sid in subjects
                          for f in (root / sid / f"{sid}.pkl", root / sid / f"{sid}_quest.csv"))
    return _cache_key("pickles", list(subjects), list(channels_to_use), classification_mode,
                      normalization, meta, states)


def _pack_cache_load(cache_dir: Path, key: str) -> PackedCorpus | None:
    """A cached pack, or None. x comes back as a read-only memory map:
    whoever makes a tensor of it copies it first (the sweep's staging)."""
    entry = cache_dir / key
    try:
        subjects = tuple(json.loads((entry / "meta.json").read_text())["subjects"])
        x = np.load(entry / "x.npy", mmap_mode="r")
        y = np.load(entry / "y.npy")
        mask = np.load(entry / "mask.npy")
    except OSError:
        return None
    except (ValueError, KeyError, EOFError) as exc:  # a corrupt entry: drop it, pack again
        print(f"Warning: dropping corrupt pack cache entry {entry} ({exc})")
        shutil.rmtree(entry, ignore_errors=True)
        return None
    try:
        entry.touch()  # recency for the LRU prune
    except OSError:
        pass  # a read-only cache: the hit is still a hit
    return PackedCorpus(x, y, mask, subjects)


def _pack_cache_store(cache_dir: Path, key: str, corpus: PackedCorpus) -> None:
    """Write an entry atomically (a temporary directory, then a rename),
    then prune; never raises: a read-only data directory or a full disk
    leaves the run uncached."""
    tmp = cache_dir / f".tmp-{key}-{os.getpid()}"
    try:
        tmp.mkdir(parents=True, exist_ok=True)
        np.save(tmp / "x.npy", np.ascontiguousarray(corpus.x))
        np.save(tmp / "y.npy", corpus.y)
        np.save(tmp / "mask.npy", corpus.mask)
        (tmp / "meta.json").write_text(json.dumps(
            {"package": _PACK_CACHE_TAG, "version": _PACK_CACHE_VERSION,
             "subjects": list(corpus.subjects)}))
        try:
            os.rename(tmp, cache_dir / key)
        except OSError:
            # Another process (a rank of the same sweep) stored the entry
            # first; its copy is the same pack.
            if not (cache_dir / key).exists():
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    except OSError as exc:
        print(f"Warning: pack cache write failed ({exc}); the run stays uncached.")
        shutil.rmtree(tmp, ignore_errors=True)
        return
    max_bytes = int(float(os.environ.get("MMS_PACK_CACHE_GB", "16")) * (1 << 30))
    _prune_pack_cache(cache_dir, max_bytes)


def _prune_pack_cache(cache_dir: Path, max_bytes: int) -> None:
    """Evict the least recently used entries until the cache fits
    max_bytes; the newest entry (the one just written or read) stays."""
    try:
        sized = []
        for e in cache_dir.iterdir():
            if e.is_dir() and not e.name.startswith(".tmp-"):
                size = sum(f.stat().st_size for f in e.iterdir() if f.is_file())
                sized.append((e.stat().st_mtime_ns, size, e))
        sized.sort(reverse=True)   # newest first
        total = 0
        for i, (_, size, e) in enumerate(sized):
            total += size
            if i > 0 and total > max_bytes:
                shutil.rmtree(e, ignore_errors=True)
    except OSError:
        pass


def _pack_cache_enabled(cache: bool | None) -> bool:
    if cache is not None:
        return cache
    return os.environ.get("MMS_PACK_CACHE", "1") != "0"


def _cached_pack(cache: bool | None, cache_dir: Path, key_fn, pack) -> PackedCorpus:
    """pack(), or its cache entry under cache_dir (written on a miss)."""
    if not _pack_cache_enabled(cache):
        return pack()
    key = key_fn()
    hit = _pack_cache_load(cache_dir, key)
    if hit is not None:
        print(f"  pack cache hit: {cache_dir / key}")
        return hit
    corpus = pack()
    _pack_cache_store(cache_dir, key, corpus)
    return corpus


def pack_corpus(data_path: Path | str, subjects: list[str], channels_to_use: list[str],
                all_channel_names: list[str], classification_mode: str = "stress_binary",
                normalization: str = "all", cache: bool | None = None) -> PackedCorpus:
    """Load and normalize every subject once and pad to [S, Wmax, C, T].
    Normalization is per subject, so one packed corpus serves every LOSO
    fold. Subjects whose files are missing are skipped; none loaded raises
    ValueError. The result is kept in and read back from the pack cache
    under <data_path>/.pack_cache (module docstring; `cache=False` or
    MMS_PACK_CACHE=0 turns it off)."""
    channel_indices = [all_channel_names.index(ch) for ch in channels_to_use]

    def pack_one(sid):
        # The engine's fused pack streams the subject's X from a memory map.
        item = load_subject_windows(data_path, sid, mmap=_fused_pack(normalization))
        if item is None:
            return None
        return (sid, *_pack_subject(*item, channel_indices, channels_to_use,
                                    classification_mode, normalization))

    return _cached_pack(
        cache, Path(data_path) / ".pack_cache",
        lambda: _pack_cache_key(data_path, subjects, channels_to_use, classification_mode,
                                normalization),
        lambda: _pack_subjects(pack_one, subjects, "data"))


def from_pickles_meta(channels_to_use, preprocess_cfg=None) -> tuple[list[str], dict]:
    """(all_channel_names, preprocess_meta) that pickle staging of this
    channel set produces; the meta is the preprocess CLI's raw
    _preprocess_meta.json (the serving-time windowing contract)."""
    from multimodalsignal_tpu_torch.config import (
        ALL_CHANNEL_NAMES,
        WRIST_CHANNEL_NAMES,
        PreprocessConfig,
    )

    if preprocess_cfg is None:
        preprocess_cfg = PreprocessConfig(
            targets=("raw",),
            include_wrist=any(ch.startswith("wrist_") for ch in channels_to_use))
    all_channel_names = list(ALL_CHANNEL_NAMES)
    if preprocess_cfg.include_wrist:
        all_channel_names += list(WRIST_CHANNEL_NAMES)
    meta = {"original_fs": preprocess_cfg.original_chest_fs, "fs": preprocess_cfg.raw_fs,
            "window_sec": preprocess_cfg.raw_window_sec,
            "stride_sec": preprocess_cfg.raw_stride_sec,
            "include_wrist": preprocess_cfg.include_wrist}
    return all_channel_names, meta


def pack_corpus_from_pickles(wesad_root: Path | str, subjects: list[str],
                             channels_to_use: list[str],
                             classification_mode: str = "stress_binary",
                             normalization: str = "all",
                             subject_cache: dict | None = None,
                             cache: bool | None = None
                             ) -> tuple[PackedCorpus, list[str], dict]:
    """The sweep's corpus straight from raw WESAD pickles: each subject's
    windows are preprocessed in memory (data/preprocess.py's raw target)
    and packed as pack_corpus packs them, with no npy round trip; the
    result is bit-identical to running the preprocess CLI and then
    pack_corpus. Wrist channels are included when channels_to_use names
    any; the rest of the preprocessing is PreprocessConfig's defaults.
    Returns (corpus, all_channel_names, preprocess_meta).

    `subject_cache` (optional dict, keyed on (sid, include_wrist)) keeps
    each subject's windows across calls, for callers that pack several
    corpora from the same pickles; the caller owns its lifetime. The
    corpus is kept in and read back from the pack cache under
    <wesad_root>/.pack_cache, keyed on the pickles' and questionnaires'
    states (module docstring; `cache=False` or MMS_PACK_CACHE=0 turns it
    off)."""
    from multimodalsignal_tpu_torch.config import PreprocessConfig
    from multimodalsignal_tpu_torch.data.preprocess import preprocess_subject

    preprocess_cfg = PreprocessConfig(
        wesad_root=str(wesad_root), targets=("raw",), subjects=tuple(subjects),
        include_wrist=any(ch.startswith("wrist_") for ch in channels_to_use))
    all_channel_names, meta = from_pickles_meta(channels_to_use, preprocess_cfg)
    unknown = [ch for ch in channels_to_use if ch not in all_channel_names]
    if unknown:
        raise ValueError(f"Unknown channels {unknown}; from-pickles staging produces "
                         f"{all_channel_names}.")
    channel_indices = [all_channel_names.index(ch) for ch in channels_to_use]

    def pack_one(sid):
        memo_key = (sid, preprocess_cfg.include_wrist)
        if subject_cache is not None and memo_key in subject_cache:
            item = subject_cache[memo_key]
        else:
            result = preprocess_subject(sid, preprocess_cfg)
            item = None
            if result is not None:
                x_raw, y_raw = result["raw"]
                item = (np.ascontiguousarray(x_raw, dtype=np.float32), y_raw)
            if subject_cache is not None:
                subject_cache[memo_key] = item
        if item is None:
            return None
        return (sid, *_pack_subject(*item, channel_indices, channels_to_use,
                                    classification_mode, normalization))

    corpus = _cached_pack(
        cache, Path(wesad_root) / ".pack_cache",
        lambda: _pickles_cache_key(wesad_root, subjects, channels_to_use, classification_mode,
                                   normalization, meta),
        lambda: _pack_subjects(pack_one, subjects, "pickles"))
    return corpus, all_channel_names, meta


def pack_hybrid_corpus(raw_align_path: Path | str, feature_path: Path | str,
                       subjects: list[str], channels_to_use: list[str],
                       all_channel_names: list[str],
                       features_to_use: list[str] | None = None,
                       classification_mode: str = "stress_binary",
                       normalization: str = "all") -> PackedCorpus:
    """pack_corpus over the raw-align target plus the feature stream
    aligned window for window: the sweep's form of build_hybrid_dataset.
    Per subject the raw-align and feature window counts and mapped labels
    must agree, so the sweep's index pools address both streams. The raw
    stream goes through pack_corpus's cache; the features are read again
    every time (cheap, and uncached, as in the JAX package)."""
    corpus = pack_corpus(raw_align_path, subjects, channels_to_use, all_channel_names,
                         classification_mode, normalization)
    feat_idx = _feature_indices(feature_path, features_to_use)
    s, wmax = corpus.y.shape
    feat_out = np.zeros((s, wmax, len(feat_idx)), dtype=np.float32)
    for i, sid in enumerate(corpus.subjects):
        item = load_subject_windows(feature_path, sid)
        if item is None:
            raise ValueError(f"Subject {sid} has raw-align data but no feature files "
                             f"under {feature_path}.")
        x_feat, y_feat_raw = item
        y_feat, keep = map_labels(y_feat_raw, classification_mode)
        xf = normalize_features(x_feat[:, feat_idx], y_feat_raw, normalization)
        xf, yk = xf[keep], y_feat[keep]
        n = int(corpus.mask[i].sum())
        if len(yk) != n or not np.array_equal(yk, corpus.y[i, :n]):
            raise ValueError(
                f"raw-align vs feature streams disagree for {sid}: {n} raw windows vs "
                f"{len(yk)} feature windows (or labels differ); regenerate both "
                "preprocess targets together.")
        feat_out[i, :n] = xf
    return dataclasses.replace(corpus, feat=feat_out)
