"""The port's channel-attention probe (multimodalsignal_tpu_torch/analysis/
attention_probe.py) against the JAX package's, on the CPU: the corruption
stream, the gate computed from the weights, and the per-fold sweep and its
run-level aggregate over run directories that both packages read (random
weights from a torch seed, H = 8, conv 8, T = 128 windows of
tests/test_torch_fold_sweep.py's data directory).

Tolerances: corrupt_windows bitwise (the same numpy stream); the gate
within 1e-6 (the port's is the JAX module's numpy on the same weights);
the probe's gate statistics within 1e-5 and its accuracies equal up to one
window a fold (the forwards are float32 in other op orders, so a window
whose two probabilities nearly tie may go either way)."""

import json

import numpy as np
import pytest
import torch

from multimodalsignal_tpu.analysis import attention_probe as jprobe
from multimodalsignal_tpu.experiments.predict import Predictor as JaxPredictor
from multimodalsignal_tpu_torch.analysis import attention_probe as pprobe
from multimodalsignal_tpu_torch.config import ExperimentConfig, ModelConfig
from multimodalsignal_tpu_torch.data.dataset import build_dataset, read_channel_names
from multimodalsignal_tpu_torch.experiments.predict import Predictor
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from tests.test_torch_fold_sweep import N_WIN, SUBJECTS, one_torch_thread, write_tree  # noqa: F401
from tests.test_torch_streaming import write_run

SMALL = dict(gru_hidden_size=8, cnn_out_channels=8)
GATES = {"rank1": ("chest_ECG", "chest_EDA", "chest_Resp", "chest_Temp"),   # C // 4 = 1
         "constant": ("chest_ECG", "chest_EDA", "chest_Resp")}               # C // 4 = 0
RATES, KINDS = [0.0, 0.5, 1.0], ["rail", "flatline"]
GATE_STATS = ("gate_corrupted", "gate_other", "gate_clean_mean")


@pytest.mark.parametrize("rate,kind", [(0.5, "rail"), (1.0, "flatline"), (0.0, "rail"),
                                       (0.3, "flatline")])
def test_corrupt_windows_is_the_jax_stream(rate, kind):
    x = np.random.default_rng(1).standard_normal((40, 4, 32)).astype(np.float32)
    for got, want in zip(pprobe.corrupt_windows(x, rate, kind, seed=7),
                         jprobe.corrupt_windows(x, rate, kind, seed=7)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for probe in (pprobe, jprobe):
        with pytest.raises(ValueError, match="unknown corruption kind"):
            probe.corrupt_windows(x, 1.0, "bogus", seed=0)


@pytest.mark.parametrize("gate", ["rank1", "constant"])
def test_gate_activations_match_jax_and_the_module(gate):
    """From the port model, from its flax params tree and in JAX from the
    same tree: one gate, which is the model's own ChannelAttention (x gated
    over x); the constant gate is 0.5."""
    channels = len(GATES[gate])
    torch.manual_seed(3)
    model = build_model(ModelConfig(**SMALL), 2, channels)
    if gate == "rank1":   # positive inputs and fc1 weights: the ReLU passes, the gate moves
        model.channel_attention.fc1.weight.data.abs_()
    x = np.random.default_rng(2).uniform(0.5, 1.5, (6, channels, 64)).astype(np.float32)
    got = pprobe.gate_activations(model, x)
    params = export_jax_variables(model)["params"]
    want = jprobe.gate_activations(params, x)
    assert got.shape == (6, channels) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pprobe.gate_activations(params, x), want, rtol=0, atol=1e-6)
    with torch.inference_mode():
        xt = torch.from_numpy(x)
        module = (model.channel_attention(xt) / xt)[:, :, 0].numpy()
    np.testing.assert_allclose(got, module, rtol=0, atol=1e-6)
    if gate == "constant":
        assert (got == 0.5).all()
    else:
        assert np.ptp(got) > 1e-3, "the rank-1 gate does not move"


@pytest.fixture(scope="module")
def probe_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("probe")
    data = write_tree(root / "data", t=128)
    runs = {gate: write_run(root / gate, ExperimentConfig(
                model=ModelConfig(**SMALL), channels_to_use=channels,
                subjects=SUBJECTS, data_path=str(data)), folds=SUBJECTS[:3], seed=11)
            for gate, channels in GATES.items()}
    return data, runs


def _assert_probe_close(got, want, windows):
    for kind in KINDS:
        for rate in RATES:
            g, w = got[kind][f"{rate:g}"], want[kind][f"{rate:g}"]
            assert abs(g["accuracy"] - w["accuracy"]) <= 1 / windows + 1e-12, (kind, rate)
            for stat in GATE_STATS:
                np.testing.assert_allclose(g[stat], w[stat], rtol=0, atol=1e-5,
                                           err_msg=f"{kind} {rate} {stat}")


@pytest.mark.parametrize("gate", ["rank1", "constant"])
def test_probe_fold_and_run_match_jax(gate, probe_runs):
    """probe_fold on one fold through both packages' Predictors, then
    probe_run of the whole run directory (the port at --device cpu)."""
    data, runs = probe_runs
    run = runs[gate]
    port = Predictor.from_run(run, "S2", device="cpu")
    ds = build_dataset(data, ["S2"], list(GATES[gate]), read_channel_names(data))
    got = pprobe.probe_fold(port, ds.x, ds.y, RATES, KINDS, seed=4, num_classes=2)
    want = jprobe.probe_fold(JaxPredictor.from_run(run, "S2"), ds.x, ds.y, RATES, KINDS,
                             seed=4, num_classes=2)
    _assert_probe_close(got, want, len(ds.y))
    if gate == "rank1":
        assert abs(got["rail"]["1"]["gate_corrupted"] - got["rail"]["1"]["gate_other"]) > 1e-4
    else:
        assert got["rail"]["1"]["gate_corrupted"] == 0.5

    got = pprobe.probe_run(run, data, RATES, KINDS, seed=1, device="cpu")
    want = jprobe.probe_run(run, data, RATES, KINDS, seed=1)
    assert {k: got[k] for k in ("num_folds", "model", "reduction_ratio", "channels")} == {
        k: want[k] for k in ("num_folds", "model", "reduction_ratio", "channels")}
    assert got["num_folds"] == 3
    _assert_probe_close(got, want, min(N_WIN[s] for s in SUBJECTS[:3]))


def test_probe_cli_matches_jax_and_asks_for_cuda(probe_runs, tmp_path, capsys):
    """The CLI over both runs at --device cpu: the JSON of the JAX CLI's
    keys, numbers as above, the same table rows; without --device it asks
    for CUDA."""
    data, runs = probe_runs
    argv = [arg for gate, run in runs.items() for arg in ("--run", f"{gate}={run}")]
    argv += ["--data", str(data), "--rates", "0", "0.5", "1", "--kinds", *KINDS]
    pprobe.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    port_table = capsys.readouterr().out
    jprobe.main(argv + ["--out", str(tmp_path / "jax.json")])
    jax_table = capsys.readouterr().out
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert got.keys() == want.keys() and got["rates"] == want["rates"] == RATES
    for gate in GATES:
        _assert_probe_close(got["results"][gate], want["results"][gate],
                            min(N_WIN[s] for s in SUBJECTS[:3]))
    def rows(table):
        return [line.split()[0] for line in table.splitlines() if line.strip()]

    assert rows(port_table) == rows(jax_table)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pprobe.main(argv)
