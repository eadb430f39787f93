"""The port's import of a reference PyTorch checkpoint
(multimodalsignal_tpu_torch/experiments/import_torch.py) against the JAX
package's, on the CPU.

The reference-topology torch model (the reference's module names, so its
state_dict keys are a real checkpoint's) is the JAX package's test model,
tests/test_import_torch.py make_reference_torch_model, with numpy-seeded
batch-norm statistics. Both packages import the same `.pt`.

Tolerances: the two best_model.msgpack files decode to bitwise-equal leaves
(the bytes differ in map order only); the port's Predictor on the imported run
against the torch model's softmax within 1e-5 (float32, other op orders)."""

import json

import numpy as np
import pytest
import torch

from multimodalsignal_tpu.experiments import import_torch as jimport
from multimodalsignal_tpu_torch.experiments import import_torch as pimport
from multimodalsignal_tpu_torch.experiments.import_torch import (
    TorchImportError,
    import_torch_checkpoint,
    infer_model_config,
    load_torch_state_dict,
)
from multimodalsignal_tpu_torch.experiments.predict import Predictor
from multimodalsignal_tpu_torch.train.checkpoints import packb, unpackb

from tests.test_import_torch import _randomize_bn_stats, make_reference_torch_model

CASES = {   # channels, classes, hidden, layers
    "degenerate_gate_c3": (("chest_ECG", "chest_EDA", "chest_Resp"), 3, 8, 1),
    "degenerate_gate_c2": (("chest_ECG", "chest_EDA"), 2, 8, 2),
    "active_gate_c6": (("chest_ECG", "chest_EDA", "chest_EMG", "chest_Resp",
                        "wrist_BVP", "wrist_EDA"), 2, 16, 2),
}


def _reference_pt(tmp_path, channels, classes, hidden, layers, seed=0):
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    tm = make_reference_torch_model(len(channels), classes, cnn_out=16, hidden=hidden,
                                    layers=layers)
    with torch.no_grad():
        _randomize_bn_stats(tm, rng)
    tm.eval()
    pt = tmp_path / "best_model.pt"
    torch.save(tm.state_dict(), pt)
    return tm, pt


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_writes_the_jax_import_and_predicts_as_torch(case, tmp_path):
    channels, classes, hidden, layers = CASES[case]
    tm, pt = _reference_pt(tmp_path, channels, classes, hidden, layers)
    mode = "ternary" if classes == 3 else "stress_binary"
    cfg, variables = import_torch_checkpoint(pt, channels, mode, tmp_path / "port")
    jimport.import_torch_checkpoint(pt, channels, mode, tmp_path / "jax")
    got_bytes, want_bytes = ((tmp_path / d / "best_model.msgpack").read_bytes()
                             for d in ("port", "jax"))
    got, want = dict(_leaves(unpackb(got_bytes))), dict(_leaves(unpackb(want_bytes)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(want[path]),
                                      err_msg=str(path))
        assert np.asarray(got[path]).dtype == np.asarray(want[path]).dtype
    # Not byte-for-byte: flax writes the TrainState's fields in their
    # declaration order, the port's writer sorts every map; re-encoded, equal.
    assert got_bytes != want_bytes and packb(unpackb(want_bytes)) == got_bytes
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))
    assert ("channel_attention" in variables["params"]) == (case == "active_gate_c6")

    x = np.random.default_rng(1).standard_normal((5, len(channels), 512)).astype(np.float32)
    with torch.no_grad():
        want_probs = torch.softmax(tm(torch.from_numpy(x)), dim=-1).numpy()
    pred = Predictor.from_files(tmp_path / "port" / "best_model.msgpack",
                                tmp_path / "port" / "config.json", device="cpu")
    np.testing.assert_allclose(pred.predict_windows(x, batch_size=4), want_probs,
                               rtol=0, atol=1e-5)


def test_infer_model_config_matches_jax(tmp_path):
    tm = make_reference_torch_model(6, 2, cnn_out=24, hidden=32, layers=2)
    torch.save(tm.state_dict(), tmp_path / "m.pt")
    sd = load_torch_state_dict(tmp_path / "m.pt")
    mc, c, k = infer_model_config(sd)
    jmc, jc, jk = jimport.infer_model_config(jimport.load_torch_state_dict(tmp_path / "m.pt"))
    assert (c, k) == (jc, jk) == (6, 2)
    assert (mc.name, mc.cnn_out_channels, mc.gru_hidden_size, mc.gru_num_layers,
            mc.reduction_ratio) == (jmc.name, jmc.cnn_out_channels, jmc.gru_hidden_size,
                                    jmc.gru_num_layers, jmc.reduction_ratio) == (
        "cnn_gru_attention", 24, 32, 2, 6)


def test_import_rejects_what_jax_rejects(tmp_path):
    _, pt = _reference_pt(tmp_path, ("a",) * 6, 2, 8, 1)
    for mod in (pimport, jimport):
        with pytest.raises(mod.TorchImportError, match="6 input channels"):
            mod.import_torch_checkpoint(pt, ("chest_ECG",), "stress_binary", tmp_path / "o")
    alien = tmp_path / "alien.pt"
    torch.save(torch.nn.Linear(4, 2).state_dict(), alien)
    with pytest.raises(TorchImportError, match="missing"):
        import_torch_checkpoint(alien, ("chest_ECG",), "stress_binary", tmp_path / "o")
    sd = torch.load(pt, weights_only=True)
    sd["classifier.9.weight"] = torch.zeros(3)
    torch.save(sd, tmp_path / "extra.pt")
    with pytest.raises(TorchImportError, match="unmapped"):
        import_torch_checkpoint(tmp_path / "extra.pt", ("x",) * 6, "stress_binary",
                                tmp_path / "o")
    del sd["classifier.9.weight"]
    sd["gru.bias_hh_l0"] = torch.zeros(5)
    torch.save(sd, tmp_path / "shape.pt")
    with pytest.raises(TorchImportError, match="shape mismatch"):
        import_torch_checkpoint(tmp_path / "shape.pt", ("x",) * 6, "stress_binary",
                                tmp_path / "o")


def test_import_cli(tmp_path, capsys):
    channels = ("chest_ECG", "chest_EDA", "chest_Resp")
    _, pt = _reference_pt(tmp_path, channels, 2, 8, 2)
    pimport.main(["--pt", str(pt), "--channels", *channels, "--out", str(tmp_path / "run")])
    assert "serve it:   python -m multimodalsignal_tpu_torch.serving" in capsys.readouterr().out
    saved = json.loads((tmp_path / "run" / "config.json").read_text())
    assert saved["run_name"] == "imported_best_model"
    assert saved["channels_to_use"] == list(channels)
    assert saved["model"]["gru_num_layers"] == 2
