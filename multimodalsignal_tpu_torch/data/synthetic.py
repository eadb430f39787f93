"""Synthetic WESAD-shaped fixtures (a copy of
multimodalsignal_tpu/data/synthetic.py: the same generators, the same
random streams, so both packages write byte-identical pickles and quest
CSVs from one seed; with seed=None a subject is seeded from the salted
hash(subject_id), as there, which differs from process to process).

The real WESAD corpus is a manual download (reference README.md:27-31), so the
test/CI story needs a generator that fabricates S*/S*.pkl + S*_quest.csv files
with the exact layout the loaders expect (byte-keyed pickle dict with chest
channels ACC [T,3] and ECG/EDA/EMG/Resp/Temp [T,1] at 700 Hz, ';'-separated
quest CSV with # ORDER/# START/# END rows).

Signals are label-dependent (heart rate, EDA tonic level, respiration rate and
EMG amplitude all shift with the protocol condition) so end-to-end tests can
actually learn the classification task rather than fit noise.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np

DEFAULT_TASKS = (
    ("Base", 3.0),
    ("TSST", 2.0),
    ("Medi 1", 1.0),
    ("Fun", 1.5),
    ("Medi 2", 1.0),
)

# The real WESAD protocol's approximate task durations (reference
# preprocess.py:41-58 parses these from the quest CSVs; README.md:18-23) —
# the full-scale shape used by benchmarks/BENCHMARK.md.
BENCHMARK_TASKS = (
    ("Base", 20.0),
    ("TSST", 10.0),
    ("Medi 1", 7.0),
    ("Fun", 6.5),
    ("Medi 2", 7.0),
)

# Per-condition physiology used to synthesize separable signals.
_CONDITION = {
    "Base": dict(hr=65.0, eda=2.0, resp=14.0, emg=0.02),
    "TSST": dict(hr=95.0, eda=6.0, resp=22.0, emg=0.12),
    "Fun": dict(hr=78.0, eda=3.5, resp=17.0, emg=0.05),
    "Medi1": dict(hr=60.0, eda=1.5, resp=11.0, emg=0.015),
    "Medi2": dict(hr=58.0, eda=1.4, resp=10.0, emg=0.015),
}


def _ecg_like(t: np.ndarray, hr_hz: float, rng: np.random.Generator) -> np.ndarray:
    """Spiky pseudo-ECG: narrow gaussian R peaks on a jittered beat grid."""
    phase = (t * hr_hz + rng.uniform(0, 1)) % 1.0
    r_wave = np.exp(-((phase - 0.5) ** 2) / (2 * 0.003))
    t_wave = 0.25 * np.exp(-((phase - 0.75) ** 2) / (2 * 0.01))
    return 0.9 * r_wave + t_wave + 0.02 * rng.standard_normal(t.shape)


def synthesize_subject(
    subject_id: str,
    tasks=DEFAULT_TASKS,
    fs: int = 700,
    seed: int | None = None,
    subject_variability: float = 1.0,
    noise: float = 1.0,
) -> tuple[dict, str]:
    """Build one subject: (pickle-ready dict, quest CSV text).

    subject_variability scales the cross-subject physiological offsets and
    noise scales all additive noise — raise both (e.g. 2.5 / 4.0) to make
    LOSO generalization non-trivial, so early stopping and cross-subject
    normalization behave like they do on real WESAD."""
    if seed is None:
        seed = abs(hash(subject_id)) % (2**31)
    rng = np.random.default_rng(seed)
    # Subject-specific physiological offsets: makes the per-subject
    # normalization in the dataset layer load-bearing, like real WESAD.
    hr_off = rng.uniform(-8, 8) * subject_variability
    eda_off = rng.uniform(0.5, 2.0) ** subject_variability
    # Subject-specific RESPONSE MAGNITUDE: at subject_variability > 1 some
    # subjects are weak physiological responders (their condition deltas
    # shrink toward baseline), which is what actually makes cross-subject
    # LOSO generalization hard on real WESAD. 1.0 at default variability.
    if subject_variability > 1.0:
        response_scale = rng.uniform(0.15, 1.0)
    else:
        response_scale = 1.0
    base_cond = _CONDITION["Base"]

    segments = {k: [] for k in ("ACC", "ECG", "EDA", "EMG", "Resp", "Temp")}
    # Wrist (Empatica E4) channels at their native rates (wesad_io.WRIST_RATES).
    wrist_segments = {k: [] for k in ("ACC", "BVP", "EDA", "TEMP")}
    wrist_fs = {"ACC": 32, "BVP": 64, "EDA": 4, "TEMP": 4}
    order, starts, ends = [], [], []
    cursor_min = 0.0
    for task, dur_min in tasks:
        key = task.replace(" ", "").strip()
        cond = _CONDITION.get(key, _CONDITION["Base"])
        if response_scale != 1.0:
            cond = {
                k: base_cond[k] + (cond[k] - base_cond[k]) * response_scale
                for k in cond
            }
        n = int(dur_min * 60 * fs)
        t = np.arange(n) / fs
        hr_hz = max(cond["hr"] + hr_off + rng.uniform(-2, 2) * noise, 35.0) / 60.0
        ecg = _ecg_like(t, hr_hz, rng)
        if noise != 1.0:
            ecg += 0.02 * (noise - 1.0) * rng.standard_normal(n)
        scr_events = rng.poisson(max(cond["eda"] - 1.0, 0.2) * dur_min)
        eda = np.full(n, cond["eda"] * eda_off) + 0.1 * np.sin(2 * np.pi * 0.01 * t)
        for _ in range(scr_events):
            onset = rng.integers(0, max(n - fs, 1))
            tau = rng.uniform(1.0, 4.0) * fs
            rise = np.clip(np.arange(n) - onset, 0, None)
            eda += 0.4 * (rise / tau) * np.exp(1 - rise / tau)
        eda += 0.01 * noise * rng.standard_normal(n)
        resp_rate = cond["resp"] + 0.3 * hr_off
        resp = (np.sin(2 * np.pi * resp_rate / 60.0 * t)
                + 0.05 * noise * rng.standard_normal(n))
        emg = cond["emg"] * rng.standard_normal(n)
        temp = 34.0 + 0.2 * np.sin(2 * np.pi * 0.001 * t) + 0.01 * rng.standard_normal(n)
        acc = 0.1 * rng.standard_normal((n, 3)) + np.array([0.0, 0.0, 1.0])

        segments["ACC"].append(acc)
        segments["ECG"].append(ecg[:, None])
        segments["EDA"].append(eda[:, None])
        segments["EMG"].append(emg[:, None])
        segments["Resp"].append(resp[:, None])
        segments["Temp"].append(temp[:, None])

        # Wrist channels: BVP mirrors the cardiac rhythm, wrist EDA the tonic
        # level, each at the E4's native rate.
        tb = np.arange(int(dur_min * 60 * wrist_fs["BVP"])) / wrist_fs["BVP"]
        bvp = np.sin(2 * np.pi * hr_hz * tb) + 0.1 * rng.standard_normal(tb.shape)
        n_eda = int(dur_min * 60 * wrist_fs["EDA"])
        w_eda = (np.full(n_eda, cond["eda"] * eda_off * 0.8)
                 + 0.05 * noise * rng.standard_normal(n_eda))
        n_tmp = int(dur_min * 60 * wrist_fs["TEMP"])
        w_tmp = 33.0 + 0.02 * rng.standard_normal(n_tmp)
        n_acc = int(dur_min * 60 * wrist_fs["ACC"])
        w_acc = 0.1 * rng.standard_normal((n_acc, 3)) + np.array([0.0, 1.0, 0.0])
        wrist_segments["BVP"].append(bvp[:, None])
        wrist_segments["EDA"].append(w_eda[:, None])
        wrist_segments["TEMP"].append(w_tmp[:, None])
        wrist_segments["ACC"].append(w_acc)
        order.append(task)
        starts.append(cursor_min)
        ends.append(cursor_min + dur_min)
        cursor_min += dur_min

    chest = {
        k.encode(): np.concatenate(v, axis=0).astype(np.float64)
        for k, v in segments.items()
    }
    wrist = {
        k.encode(): np.concatenate(v, axis=0).astype(np.float64)
        for k, v in wrist_segments.items()
    }
    data = {
        b"signal": {b"chest": chest, b"wrist": wrist},
        b"subject": subject_id.encode(),
    }
    fmt = lambda xs: ";".join(str(v) for v in xs)
    quest_csv = (
        f"# ORDER;{fmt(order)}\n"
        f"# START;{fmt(starts)}\n"
        f"# END;{fmt(ends)}\n"
    )
    return data, quest_csv


def write_synthetic_wesad(
    root: Path | str,
    subjects: list[str],
    tasks=DEFAULT_TASKS,
    fs: int = 700,
    seed: int = 0,
    subject_variability: float = 1.0,
    noise: float = 1.0,
    hardness: "Hardness | None" = None,
) -> Path:
    """Write a synthetic WESAD tree: root/S*/S*.pkl + root/S*/S*_quest.csv.

    With ``hardness`` set, subjects come from the calibrated-hard generator
    (synthesize_subject_hard) instead of the separable easy one."""
    root = Path(root)
    for i, sid in enumerate(subjects):
        if hardness is not None:
            data, quest = synthesize_subject_hard(
                sid, tasks=tasks, fs=fs, seed=seed + i, hardness=hardness,
            )
        else:
            data, quest = synthesize_subject(
                sid, tasks=tasks, fs=fs, seed=seed + i,
                subject_variability=subject_variability, noise=noise,
            )
        subj_dir = root / sid
        subj_dir.mkdir(parents=True, exist_ok=True)
        with open(subj_dir / f"{sid}.pkl", "wb") as f:
            pickle.dump(data, f)
        (subj_dir / f"{sid}_quest.csv").write_text(quest)
    return root


# ---------------------------------------------------------------------------
# Calibrated-hard corpus (benchmarks/BENCHMARK.md)
# ---------------------------------------------------------------------------
#
# The easy generator above produces condition-separable signals, so a full
# LOSO sweep sits at ~100% accuracy and cannot exercise the learning stack
# (normalization choice, early stopping, attention fusion). The hard
# generator below layers in the effects that make real cross-subject WESAD
# hard (reference README.md:13 reports 82.44% fusion vs ~75% naive fusion):
#
#   * sparse per-subject RESPONDER PROFILES — each physiological axis
#     (cardiac / electrodermal / respiratory / muscular) responds with a
#     subject-specific magnitude; most subjects are weak in most axes, so
#     no single channel is reliable across held-out subjects;
#   * exponential response RAMPS at task boundaries (physiological latency),
#     making windows that straddle a boundary genuinely ambiguous;
#   * slow Ornstein-Uhlenbeck DRIFT of the tonic levels, comparable in size
#     to the condition responses — false "responses" inside Base segments;
#   * mean-shifting motion/contact ARTIFACTS (electrode noise, rail-high,
#     contact-loss flatlines) that corrupt individual channels per window —
#     the signature is visible in the channel itself, so an input-conditioned
#     channel gate (ChannelAttention, reference models.py:7-31) can learn to
#     downweight a corrupted channel while naive fusion cannot;
#   * whole-channel DROPOUT spans (detached sensor) per subject.


@dataclass(frozen=True)
class Hardness:
    """Difficulty knobs for the calibrated-hard synthetic corpus.

    Defaults are the calibration that lands the full 15-fold LOSO sweep in
    the reference's realistic accuracy band (see benchmarks/BENCHMARK.md)."""

    # Probability an axis is a weak responder; response-scale ranges.
    responder_sparsity: float = 0.7
    weak_response: tuple[float, float] = (0.05, 0.35)
    strong_response: tuple[float, float] = (0.55, 1.15)
    # Minimum count of strong CORE axes (hr/eda/resp) per subject: keeps
    # multimodal fusion learnable for every subject while single channels
    # stay unreliable for subjects weak on that channel.
    min_strong_axes: int = 1
    # Exact-responder mode: when set, each subject is strong in EXACTLY this
    # many core axes (uniformly chosen) and weak elsewhere — the cleanest way
    # to make every single channel unreliable for ~(1 - k/3) of subjects
    # while fusion always has k informative channels. Overrides
    # responder_sparsity/min_strong_axes for the core axes.
    strong_axes_exact: int | None = None
    # Physiological latency at task boundaries (exponential time constant).
    ramp_sec: float = 60.0
    # Tonic-drift magnitude as a fraction of the strong TSST response.
    drift: float = 1.3
    drift_tau_sec: float = 300.0
    # Channel-corruption process.
    artifact_rate_per_min: float = 0.45
    artifact_max_sec: float = 25.0
    channel_dropout_prob: float = 0.10
    # Broadband measurement-noise multiplier.
    noise: float = 2.0
    # Amusement signature: laughter episodes during Fun — phasic EMG bursts
    # with a coupled fast respiration oscillation (real-WESAD amusement shows
    # somatic EMG activity and laughter-modulated breathing). PHASIC
    # within-window structure, so the tonic OU drift that drowns the Fun
    # *mean* shifts (drift=2.2 calibration) does not touch it — this is the
    # honest mechanism that gives the hierarchical M2 stage (Fun vs Base,
    # reference main.py:159-247) learnable signal. Rate is episodes/min of
    # Fun time; 0 disables (and leaves every other stream bit-identical —
    # laughter draws from its own child RNG).
    fun_laughter_rate_per_min: float = 0.0
    fun_laughter_strength: float = 1.0


# The benchmark-corpus calibration (benchmarks/BENCHMARK.md): every core
# axis responds MODERATELY while condition-uncorrelated tonic drift is
# cranked to the same scale, so no single channel separates stress from a
# 60 s window (each sits at the ~80% majority floor of the LOSO sweep) but
# fusing channels with independent drift averages the wander out and
# clears the floor — the reference's headline structure (README.md:13,
# multimodal fusion > single-modality) reproduced by a physiologically
# honest mechanism rather than by construction.
BENCHMARK_HARDNESS = Hardness(
    responder_sparsity=1.0,
    weak_response=(0.35, 0.6),
    strong_response=(0.35, 0.6),
    drift=2.2,
    channel_dropout_prob=0.10,
    # Amusement signature calibration (round 3): with the Fun *mean* shifts
    # deliberately drowned by the drift above, M2 (Fun vs Base) was at its
    # majority floor. Laughter episodes give it phasic signal: host-probe
    # LOSO (window stats + GBT, scale 0.5, M2 channels + chest_EMG) measures
    # 0.885 +- 0.154 vs a 0.785 floor at these knobs (0.682 with the knob
    # off, i.e. below floor). Stress-task calibration is untouched: only
    # Fun-segment EMG/Resp change (child-RNG isolation, test-enforced).
    fun_laughter_rate_per_min=6.0,
    fun_laughter_strength=2.5,
)


# Axis deltas from Base per condition (hr bpm, EDA tonic uS, resp bpm,
# EMG amplitude). Smaller than the easy generator's separations; scaled per
# subject by the responder profile.
_HARD_BASE = dict(hr=65.0, eda=2.0, resp=14.0, emg=0.02)
_HARD_DELTA = {
    "Base": dict(hr=0.0, eda=0.0, resp=0.0, emg=0.0),
    "TSST": dict(hr=22.0, eda=3.0, resp=6.0, emg=0.08),
    "Fun": dict(hr=9.0, eda=1.2, resp=2.5, emg=0.03),
    "Medi1": dict(hr=-5.0, eda=-0.5, resp=-2.5, emg=-0.004),
    "Medi2": dict(hr=-6.0, eda=-0.6, resp=-3.0, emg=-0.004),
}
# Behavioral motion level per condition (drives ACC + artifact realism).
_HARD_MOTION = {"Base": 0.2, "TSST": 1.0, "Fun": 0.7, "Medi1": 0.05, "Medi2": 0.05}
_CTRL_FS = 10  # control-track rate (Hz); 700/10 = 70x upsample for chest


def _one_pole(target: np.ndarray, tau_sec: float, fs: float) -> np.ndarray:
    """First-order exponential tracker of a piecewise-constant target."""
    if tau_sec <= 0:
        return target
    from scipy.signal import lfilter

    alpha = 1.0 - np.exp(-1.0 / (tau_sec * fs))
    out = lfilter([alpha], [1.0, -(1.0 - alpha)], target - target[0])
    return out + target[0]


def _ou_drift(n: int, sigma: float, tau_sec: float, fs: float,
              rng: np.random.Generator) -> np.ndarray:
    """Ornstein-Uhlenbeck track with stationary std `sigma`."""
    if sigma <= 0:
        return np.zeros(n)
    from scipy.signal import lfilter

    dt = 1.0 / fs
    a = np.exp(-dt / tau_sec)
    noise = rng.standard_normal(n) * sigma * np.sqrt(1.0 - a * a)
    return lfilter([1.0], [1.0, -a], noise)


def _apply_artifacts(sig: np.ndarray, fs: float, rng: np.random.Generator,
                     hard: Hardness, kinds: tuple[str, ...]) -> np.ndarray:
    """Corrupt `sig` in place with Poisson artifact bursts.

    Every kind shifts the channel's local mean strongly (rails, flatlines,
    offset noise bursts), so corruption is detectable from the window itself."""
    dur_min = len(sig) / fs / 60.0
    n_events = rng.poisson(hard.artifact_rate_per_min * dur_min)
    if n_events == 0:
        return sig
    mu, sd = float(sig.mean()), float(sig.std()) + 1e-9
    for _ in range(n_events):
        length = int(rng.uniform(2.0, hard.artifact_max_sec) * fs)
        start = int(rng.integers(0, max(len(sig) - length, 1)))
        seg = slice(start, start + length)
        kind = kinds[rng.integers(0, len(kinds))]
        if kind == "noise":
            sig[seg] = mu + rng.uniform(1.5, 3.0) * sd + 4.0 * sd * rng.standard_normal(
                sig[seg].shape
            )
        elif kind == "rail_high":
            sig[seg] = mu + rng.uniform(4.0, 7.0) * sd + 0.2 * sd * rng.standard_normal(
                sig[seg].shape
            )
        elif kind == "flatline":
            sig[seg] = mu - rng.uniform(2.0, 4.0) * sd
    return sig


def _apply_laughter(emg_seg: np.ndarray, resp_seg: np.ndarray, fs: float,
                    rng: np.random.Generator, hard: "Hardness") -> None:
    """Superimpose laughter episodes on a Fun segment, in place.

    Each episode (3-8 s) is a train of ~4.5 Hz expiratory pulses: the EMG
    amplitude multiplies up strongly (somatic bursts) and the respiration
    trace gains a fast low-amplitude oscillation under a smooth envelope.
    Within-window (phasic) structure only — segment means barely move, so
    stress-task calibration is untouched."""
    n = len(emg_seg)
    dur_min = n / fs / 60.0
    n_events = rng.poisson(hard.fun_laughter_rate_per_min * dur_min)
    s = hard.fun_laughter_strength
    emg_sd = float(np.std(emg_seg)) + 1e-9
    for _ in range(n_events):
        length = int(rng.uniform(3.0, 8.0) * fs)
        start = int(rng.integers(0, max(n - length, 1)))
        span = slice(start, start + length)
        m = len(emg_seg[span])
        if m == 0:
            continue
        # Smooth raised-cosine envelope over the episode.
        env = 0.5 * (1.0 - np.cos(2 * np.pi * np.arange(m) / m))
        pulse_hz = rng.uniform(4.0, 5.5)
        phase = 2 * np.pi * pulse_hz * np.arange(m) / fs + rng.uniform(0, 6.28)
        # EMG: burst noise amplitude-modulated at the laugh pulse rate.
        am = env * (0.6 + 0.4 * np.sin(phase)) ** 2
        emg_seg[span] += 4.0 * s * emg_sd * am * rng.standard_normal(m)
        # Resp: fast oscillation rides the breathing trace.
        resp_seg[span] += 0.45 * s * env * np.sin(phase)


def _apply_dropout(sig: np.ndarray, rng: np.random.Generator,
                   prob: float) -> np.ndarray:
    """Whole-channel detached-sensor span (30-70% of the recording)."""
    if rng.uniform() >= prob:
        return sig
    n = len(sig)
    length = int(rng.uniform(0.3, 0.7) * n)
    start = int(rng.integers(0, n - length))
    sig[start:start + length] = float(sig[start]) + 0.01 * rng.standard_normal(length)
    return sig


def synthesize_subject_hard(
    subject_id: str,
    tasks=BENCHMARK_TASKS,
    fs: int = 700,
    seed: int | None = None,
    hardness: Hardness = Hardness(),
) -> tuple[dict, str]:
    """Calibrated-hard subject: same pickle/quest layout as
    synthesize_subject, realistic LOSO difficulty (module docstring above)."""
    hard = hardness
    if seed is None:
        seed = abs(hash(subject_id)) % (2**31)
    rng = np.random.default_rng(seed)

    # --- responder profile: per-axis response magnitude ------------------
    axes = ("hr", "eda", "resp", "emg")
    response = {}
    for ax in axes:
        weak = rng.uniform() < hard.responder_sparsity
        lo, hi = hard.weak_response if weak else hard.strong_response
        response[ax] = rng.uniform(lo, hi)
    # Every subject responds SOMEWHERE (else even fusion is unlearnable):
    # promote fusion-relevant axes until min_strong_axes of them are strong.
    core = ("hr", "eda", "resp")
    if hard.strong_axes_exact is not None:
        k = min(hard.strong_axes_exact, len(core))
        strong_set = rng.choice(len(core), size=k, replace=False)
        for i, ax in enumerate(core):
            lo, hi = (hard.strong_response if i in strong_set
                      else hard.weak_response)
            response[ax] = rng.uniform(lo, hi)
    else:
        strong_lo = hard.strong_response[0]
        n_strong = sum(response[ax] >= strong_lo for ax in core)
        weak_core = [ax for ax in core if response[ax] < strong_lo]
        for _ in range(min(hard.min_strong_axes - n_strong, len(weak_core))):
            promote = weak_core.pop(int(rng.integers(0, len(weak_core))))
            response[promote] = rng.uniform(*hard.strong_response)

    # --- control tracks over the whole session ---------------------------
    seg_n700 = [int(d * 60 * fs) for _, d in tasks]
    n700 = sum(seg_n700)
    up = fs // _CTRL_FS
    nc = -(-n700 // up)  # ceil
    target = {ax: np.empty(nc) for ax in axes}
    motion_t = np.empty(nc)
    cursor = 0
    for (task, dur), n7 in zip(tasks, seg_n700):
        key = task.replace(" ", "").strip()
        delta = _HARD_DELTA.get(key, _HARD_DELTA["Base"])
        length = -(-n7 // up)
        seg = slice(cursor, min(cursor + length, nc))
        for ax in axes:
            target[ax][seg] = _HARD_BASE[ax] + delta[ax] * response[ax]
        motion_t[seg] = _HARD_MOTION.get(key, 0.2)
        cursor += length
    # trailing remainder (rounding): hold last value
    if cursor < nc:
        for ax in axes:
            target[ax][cursor:] = target[ax][cursor - 1]
        motion_t[cursor:] = motion_t[cursor - 1]

    drift_sigma = {
        "hr": 6.0, "eda": 0.8, "resp": 1.5, "emg": 0.012,
    }
    track = {}
    for ax in axes:
        smoothed = _one_pole(target[ax], hard.ramp_sec, _CTRL_FS)
        smoothed = smoothed + _ou_drift(
            nc, hard.drift * drift_sigma[ax], hard.drift_tau_sec, _CTRL_FS, rng
        )
        track[ax] = smoothed
    motion = _one_pole(motion_t, 10.0, _CTRL_FS)
    t_ctrl = np.arange(nc) / _CTRL_FS

    def up700(ctrl: np.ndarray) -> np.ndarray:
        return np.repeat(ctrl, up)[:n700]

    # --- chest channels at 700 Hz ----------------------------------------
    noise = hard.noise
    hr_hz = np.clip(up700(track["hr"]), 35.0, 210.0) / 60.0
    # Respiratory sinus arrhythmia shrinks under stress: extra in-band HRV.
    resp_hz = np.clip(up700(track["resp"]), 4.0, 60.0) / 60.0
    resp_phase = np.cumsum(resp_hz) / fs
    rsa_depth = 0.06 * np.clip(
        1.5 - (up700(track["hr"]) - _HARD_BASE["hr"]) / 30.0, 0.3, 1.5
    )
    hr_hz = hr_hz * (1.0 + rsa_depth * np.sin(2 * np.pi * resp_phase))
    phase = (np.cumsum(hr_hz) / fs + rng.uniform(0, 1)) % 1.0
    ecg = (0.9 * np.exp(-((phase - 0.5) ** 2) / (2 * 0.003))
           + 0.25 * np.exp(-((phase - 0.75) ** 2) / (2 * 0.01))
           + 0.02 * noise * rng.standard_normal(n700))

    eda_level = np.clip(up700(track["eda"]), 0.05, None)
    eda = eda_level + 0.05 * np.sin(2 * np.pi * 0.01 * np.arange(n700) / fs)
    # SCR events: inhomogeneous Poisson, rate follows the tonic level.
    rate_ctrl = np.clip(eda_level[::up][:nc] - 1.0, 0.2, None) / 60.0
    event_mask = rng.uniform(size=len(rate_ctrl)) < rate_ctrl / _CTRL_FS
    for onset_c in np.nonzero(event_mask)[0]:
        onset = onset_c * up
        tau = rng.uniform(1.0, 4.0) * fs
        span = min(int(12 * tau), n700 - onset)  # SCR support ~12 tau
        rise = np.arange(span)
        eda[onset:onset + span] += 0.4 * (rise / tau) * np.exp(1 - rise / tau)
    eda += 0.01 * noise * rng.standard_normal(n700)

    resp = (np.sin(2 * np.pi * resp_phase)
            + 0.05 * noise * rng.standard_normal(n700))
    emg_amp = np.clip(up700(track["emg"]), 0.002, None)
    emg = emg_amp * rng.standard_normal(n700)
    motion700 = up700(motion)
    temp = (34.0 - 0.3 * (up700(track["hr"]) - _HARD_BASE["hr"]) / 30.0
            + _ou_drift(n700, 0.15, 600.0, fs, rng)
            + 0.01 * rng.standard_normal(n700))
    acc = ((0.05 + 0.25 * motion700)[:, None] * rng.standard_normal((n700, 3))
           + np.array([0.0, 0.0, 1.0]))

    # --- amusement signature (laughter) ------------------------------------
    # Child RNG keeps every other stream bit-identical whether or not the
    # knob is on; see Hardness.fun_laughter_rate_per_min.
    if hard.fun_laughter_rate_per_min > 0:
        rng_laugh = np.random.default_rng((seed ^ 0x1AA9) & 0x7FFFFFFF)
        cursor700 = 0
        for (task, _dur), n7 in zip(tasks, seg_n700):
            if task.replace(" ", "").strip() == "Fun":
                _apply_laughter(emg[cursor700:cursor700 + n7],
                                resp[cursor700:cursor700 + n7],
                                fs, rng_laugh, hard)
            cursor700 += n7

    # --- artifacts + dropout ----------------------------------------------
    ecg = _apply_artifacts(ecg, fs, rng, hard, ("noise", "rail_high"))
    eda = _apply_artifacts(eda, fs, rng, hard, ("flatline", "rail_high"))
    eda = np.clip(eda, 0.01, None)  # keep log1p-safe
    resp = _apply_artifacts(resp, fs, rng, hard, ("rail_high", "flatline"))
    emg = _apply_artifacts(emg, fs, rng, hard, ("noise", "rail_high"))
    ecg = _apply_dropout(ecg, rng, hard.channel_dropout_prob)
    eda = np.clip(_apply_dropout(eda, rng, hard.channel_dropout_prob), 0.01, None)
    resp = _apply_dropout(resp, rng, hard.channel_dropout_prob)

    # --- wrist channels at native rates ------------------------------------
    wrist_fs = {"ACC": 32, "BVP": 64, "EDA": 4, "TEMP": 4}
    dur_s = n700 / fs

    def wrist_track(ctrl: np.ndarray, rate: int) -> np.ndarray:
        tw = np.arange(int(dur_s * rate)) / rate
        return np.interp(tw, t_ctrl, ctrl)

    hrw = np.clip(wrist_track(track["hr"], wrist_fs["BVP"]), 35.0, 210.0) / 60.0
    bvp_phase = np.cumsum(hrw) / wrist_fs["BVP"]
    bvp = (np.sin(2 * np.pi * bvp_phase)
           + 0.1 * noise * rng.standard_normal(bvp_phase.shape))
    bvp = _apply_artifacts(bvp, wrist_fs["BVP"], rng, hard, ("noise", "flatline"))
    bvp = _apply_dropout(bvp, rng, hard.channel_dropout_prob)

    w_eda = 0.8 * np.clip(wrist_track(track["eda"], wrist_fs["EDA"]), 0.05, None)
    w_eda = w_eda + 0.05 * noise * rng.standard_normal(w_eda.shape)
    w_eda = _apply_artifacts(w_eda, wrist_fs["EDA"], rng, hard,
                             ("flatline", "rail_high"))
    w_eda = np.clip(_apply_dropout(w_eda, rng, hard.channel_dropout_prob), 0.01, None)

    n_tmp = int(dur_s * wrist_fs["TEMP"])
    w_tmp = (33.0 + _ou_drift(n_tmp, 0.1, 600.0, wrist_fs["TEMP"], rng)
             + 0.02 * rng.standard_normal(n_tmp))
    motion_w = wrist_track(motion, wrist_fs["ACC"])
    w_acc = ((0.05 + 0.25 * motion_w)[:, None]
             * rng.standard_normal((len(motion_w), 3))
             + np.array([0.0, 1.0, 0.0]))

    chest = {
        b"ACC": acc.astype(np.float64),
        b"ECG": ecg[:, None].astype(np.float64),
        b"EDA": eda[:, None].astype(np.float64),
        b"EMG": emg[:, None].astype(np.float64),
        b"Resp": resp[:, None].astype(np.float64),
        b"Temp": temp[:, None].astype(np.float64),
    }
    wrist = {
        b"ACC": w_acc.astype(np.float64),
        b"BVP": bvp[:, None].astype(np.float64),
        b"EDA": w_eda[:, None].astype(np.float64),
        b"TEMP": w_tmp[:, None].astype(np.float64),
    }
    data = {
        b"signal": {b"chest": chest, b"wrist": wrist},
        b"subject": subject_id.encode(),
    }
    order = [task for task, _ in tasks]
    starts, ends, cursor_min = [], [], 0.0
    for _, dur in tasks:
        starts.append(cursor_min)
        ends.append(cursor_min + dur)
        cursor_min += dur
    fmt = lambda xs: ";".join(str(v) for v in xs)
    quest_csv = (
        f"# ORDER;{fmt(order)}\n"
        f"# START;{fmt(starts)}\n"
        f"# END;{fmt(ends)}\n"
    )
    return data, quest_csv
