"""The port's model export (multimodalsignal_tpu_torch/experiments/export.py:
export_predictor, ExportedPredictor, the CLI), the server's artifact backend
(serving --artifact) and the stream CLI on an artifact, against the port's
Predictor and the JAX package's ExportedPredictor, on the CPU.

Checkpoints are tests/test_torch_streaming.py's random-weight runs (H = 8,
conv 8, T = 128): one fold, a 3-fold ensemble, a hybrid model (artifact
version 2), and a bfloat16 model. One export each serves N = 1, 7 and 100.

Tolerances: float32 1e-5 (the artifact's aten.gru against the Predictor's
plain loop and JAX's lax.scan: other op orders); bfloat16 3e-2 (PROB_ATOL's,
bf16 products in other orders); the server against the artifact 1e-6 (JSON
rounds to 6 decimals)."""

import collections
import json
import re
import threading
import urllib.request
import zipfile

import numpy as np
import pytest
import torch
from torch.export.passes import move_to_device_pass

from multimodalsignal_tpu.experiments import export as jexport
from multimodalsignal_tpu.experiments import streaming as jstream
from multimodalsignal_tpu.experiments.predict import EnsemblePredictor as JaxEnsemble
from multimodalsignal_tpu.experiments.predict import Predictor as JaxPredictor
from multimodalsignal_tpu_torch import serving
from multimodalsignal_tpu_torch.config import ExperimentConfig, ModelConfig
from multimodalsignal_tpu_torch.experiments import export as pexport
from multimodalsignal_tpu_torch.experiments import streaming as pstream
from multimodalsignal_tpu_torch.experiments.export import ExportedPredictor, export_predictor
from multimodalsignal_tpu_torch.experiments.predict import EnsemblePredictor, Predictor

from tests.test_torch_fold_sweep import one_torch_thread  # noqa: F401
from tests.test_torch_streaming import SMALL, _run_cli, recording, runs, write_run  # noqa: F401

C, T = 3, 128
ATOL = {"float32": 1e-5, "bfloat16": 3e-2}
KINDS = ("single", "ensemble", "hybrid", "bf16")


def _predictors(runs, bf16_run, kind):
    """(port Predictor on the CPU, JAX Predictor) of one kind."""
    if kind == "ensemble":
        return (EnsemblePredictor.from_run(runs["raw"], device="cpu"),
                JaxEnsemble.from_run(runs["raw"]))
    run = {"single": runs["raw"], "hybrid": runs["hybrid"], "bf16": bf16_run}[kind]
    return Predictor.from_run(run, "S2", device="cpu"), JaxPredictor.from_run(run, "S2")


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    cfg = ExperimentConfig(model=ModelConfig(dtype="bfloat16", **SMALL))
    return write_run(tmp_path_factory.mktemp("bf16"), cfg, folds=("S2",), seed=7)


@pytest.fixture(scope="module")
def exported(runs, bf16_run, tmp_path_factory):
    """kind -> (port artifact path, port meta, JAX artifact path, JAX meta,
    port Predictor)."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for kind in KINDS:
        port, jax_p = _predictors(runs, bf16_run, kind)
        meta = export_predictor(port, root / f"{kind}.mms")
        jmeta = jexport.export_predictor(jax_p, root / f"{kind}_jax.mms", platforms=("cpu",))
        out[kind] = (root / f"{kind}.mms", meta, root / f"{kind}_jax.mms", jmeta, port)
    return out


def _inputs(n, hybrid, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, C, T)).astype(np.float32)
    return (x, rng.standard_normal((n, 10)).astype(np.float32)) if hybrid else x


def test_artifact_contents_and_meta_match_jax(exported):
    for kind in KINDS:
        path, meta, _, jmeta, _ = exported[kind]
        with zipfile.ZipFile(path) as zf:
            assert set(zf.namelist()) == {"model.pt2", "meta.json"}
            assert json.loads(zf.read("meta.json")) == meta
        assert set(meta) == (set(jmeta) - {"jax_version"}) | {"torch_version", "format"}
        assert meta["format"] == "torch.export" and meta["torch_version"] == torch.__version__
        assert meta["platforms"] == ["cpu", "cuda"] and jmeta["platforms"] == ["cpu"]
        same = set(meta) - {"torch_version", "format", "platforms"}
        assert {k: meta[k] for k in same} == {k: jmeta[k] for k in same}
    assert exported["hybrid"][1]["artifact_version"] == 2
    assert exported["single"][1]["artifact_version"] == 1
    assert exported["ensemble"][1]["ensemble_folds"] == ["S2", "S3", "S4"]


@pytest.mark.parametrize("kind", KINDS)
def test_artifact_matches_predictor_and_jax(exported, kind):
    """One export answers N = 1, 7 and 100 windows unpadded, as the port's
    Predictor (padded batches of 64) and the JAX artifact do."""
    path, _, jpath, _, port = exported[kind]
    ep = ExportedPredictor.load(path, device="cpu")
    jep = jexport.ExportedPredictor.load(jpath)
    atol = ATOL["bfloat16" if kind == "bf16" else "float32"]
    for n in (1, 7, 100):
        x = _inputs(n, kind == "hybrid", seed=n)
        got = ep.predict_windows(x)
        assert got.shape == (n, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(got, port.predict_windows(x), rtol=0, atol=atol)
        np.testing.assert_allclose(got, jep.predict_windows(x), rtol=0, atol=atol)
    assert (ep.is_hybrid, ep.feature_names) == (jep.is_hybrid, jep.feature_names)
    assert ep.class_names == jep.class_names


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("folds", [None, 2])
def test_aten_gru_impl_matches_the_plain_loop(prune, folds):
    """gru_impl "aten" (the artifact's recurrence) against "scan" (the plain
    loop) on the same weights, with and without last-step pruning, one
    fold and fold-stacked; it refuses training mode."""
    from multimodalsignal_tpu_torch.models.cnn_gru import build_model
    from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model

    x = torch.from_numpy(_inputs(3, False, seed=5))
    models = []
    for impl in ("scan", "aten"):
        mc = ModelConfig(gru_impl=impl, gru_last_prune=prune, **SMALL)
        torch.manual_seed(1)
        models.append((build_fold_model(mc, 2, C, folds, seeds=[1, 2]) if folds
                       else build_model(mc, 2, C)).eval())
    inp = x.expand(folds, *x.shape) if folds else x
    with torch.no_grad():
        np.testing.assert_allclose(models[1](inp), models[0](inp), rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="inference only"):
        models[1].train()(inp)


def test_program_is_one_aten_gru_a_layer_and_moves_its_device(exported):
    """The recurrence is aten.gru nodes (a fold's pruned last layer forward
    only), not an unrolled loop; move_to_device_pass leaves no device
    literal of the trace behind."""
    for kind, grus in (("single", 2), ("ensemble", 6)):
        ep = ExportedPredictor.load(exported[kind][0], device="cpu")
        calls = collections.Counter(str(n.target) for n in ep.program.graph.nodes
                                    if n.op == "call_function")
        assert calls["aten.gru.input"] == grus and sum(calls.values()) < 300, calls
        def devices(program):
            return {str(n.kwargs["device"]) for n in program.graph.nodes if "device" in n.kwargs}

        assert devices(ep.program) == {"cpu"}
        moved = move_to_device_pass(ep.program, "meta")
        assert devices(moved) == {"meta"}
        assert {p.device.type for p in moved.state_dict.values()} == {"meta"}


def test_gru_weights_packed_once_at_load(exported):
    """On the GPU, load lays each aten.gru's weights out as one buffer (cuDNN's
    layout; here a stand-in, concatenation) and the program reads them as
    constants: the same probabilities, fewer nodes, one storage a call."""
    def concatenate(weights, batch_first, bidirectional):
        flat = torch.cat([w.reshape(-1) for w in weights])
        for w, v in zip(weights, flat.split([w.numel() for w in weights])):
            w.set_(v.view(w.shape))

    for kind in ("ensemble", "bf16"):
        ep = ExportedPredictor.load(exported[kind][0], device="cpu")
        x = _inputs(9, False, seed=4)
        before = ep.predict_windows(x)
        nodes = sum(1 for n in ep._run.graph.nodes if n.op == "call_function")
        pexport._pack_gru_weights(ep._run, concatenate)
        np.testing.assert_array_equal(ep.predict_windows(x), before)
        assert sum(1 for n in ep._run.graph.nodes if n.op == "call_function") < nodes
        grus = [n for n in ep._run.graph.nodes if n.target is torch.ops.aten.gru.input]
        for node in grus:
            weights = [ep._run.get_buffer(a.target) for a in node.args[2]]
            assert {w.untyped_storage().data_ptr() for w in weights} == {
                weights[0].untyped_storage().data_ptr()}
            assert {w.dtype for w in weights} == {node.args[0].meta["val"].dtype}
        assert len(grus) == {"ensemble": 6, "bf16": 2}[kind]


def test_version_gates_input_checks_and_jax_artifact(exported, tmp_path):
    path, meta, jpath, _, _ = exported["single"]

    def rewrite(name, **changes):
        out = tmp_path / name
        with zipfile.ZipFile(path) as src, zipfile.ZipFile(out, "w") as dst:
            dst.writestr("model.pt2", src.read("model.pt2"))
            dst.writestr("meta.json", json.dumps(dict(meta, **changes)))
        return out

    with pytest.raises(ValueError, match="artifact version 3"):
        ExportedPredictor.load(rewrite("v3.mms", artifact_version=3), device="cpu")
    with pytest.raises(ValueError, match="feature extractor v1"):
        ExportedPredictor.load(rewrite("fv1.mms", feature_names=["hr_mean"],
                                       feature_extractor_version=1), device="cpu")
    with pytest.raises(ValueError, match="JAX package artifact"):
        ExportedPredictor.load(jpath, device="cpu")
    ep = ExportedPredictor.load(path, device="cpu")
    for bad in (np.zeros((2, C + 1, T)), np.zeros((2, C, T + 1)), np.zeros((C, T))):
        with pytest.raises(ValueError, match="expected windows"):
            ep.predict_windows(bad.astype(np.float32))
    hy = ExportedPredictor.load(exported["hybrid"][0], device="cpu")
    with pytest.raises(ValueError, match="hybrid artifact expects"):
        hy.predict_windows(np.zeros((2, C, T), np.float32))
    with pytest.raises(ValueError, match="expected features"):
        hy.predict_windows((np.zeros((2, C, T), np.float32), np.zeros((3, 10), np.float32)))


def test_windows_from_recording_is_the_predictors(exported, recording):
    for kind in ("single", "hybrid"):
        path, _, _, _, port = exported[kind]
        ep = ExportedPredictor.load(path, device="cpu")
        (got, starts), (want, want_starts) = (p.windows_from_recording(recording)
                                              for p in (ep, port))
        np.testing.assert_array_equal(starts, want_starts)
        for a, b in zip(*((g,) if kind == "single" else g for g in (got, want))):
            np.testing.assert_array_equal(a, b)


def test_export_cli(runs, tmp_path, capsys):
    pexport.main(["--run-dir", str(runs["raw"]), "--out", str(tmp_path / "all.mms")])
    assert "3-fold ensemble" in capsys.readouterr().out
    run = runs["raw"]
    pexport.main(["--checkpoint", str(run / "fold_test_on_S3" / "best_model.msgpack"),
                  "--config", str(run / "config.json"), "--out", str(tmp_path / "s3.mms")])
    assert "single fold" in capsys.readouterr().out
    x = _inputs(5, False)
    ens = ExportedPredictor.load(tmp_path / "all.mms", device="cpu")
    np.testing.assert_allclose(ens.predict_windows(x), EnsemblePredictor.from_run(
        run, device="cpu").predict_windows(x), rtol=0, atol=1e-5)
    one = ExportedPredictor.load(tmp_path / "s3.mms", device="cpu")
    np.testing.assert_allclose(one.predict_windows(x), Predictor.from_run(
        run, "S3", device="cpu").predict_windows(x), rtol=0, atol=1e-5)
    for argv in (["--run-dir", str(run), "--config", "c.json"], []):
        with pytest.raises(SystemExit):
            pexport.main(argv + ["--out", str(tmp_path / "x.mms")])


@pytest.mark.parametrize("platforms", ["cpu", "cuda", "cuda,cpu", "cpu,cuda,cpu"])
def test_platforms_are_recorded_and_enforced_at_load(runs, tmp_path, capsys, platforms):
    """--platforms (JAX export.py's flag): the list goes into the meta's
    `platforms` in the order given, once each, as the JAX CLI records its
    own; ExportedPredictor.load refuses a device whose platform the meta
    lacks, as a jax.export artifact refuses an unlisted platform."""
    run, out = runs["raw"], tmp_path / "m.mms"
    pexport.main(["--checkpoint", str(run / "fold_test_on_S2" / "best_model.msgpack"),
                  "--config", str(run / "config.json"), "--out", str(out),
                  "--platforms", platforms])
    want = list(dict.fromkeys(platforms.split(",")))
    assert f"for {want}" in capsys.readouterr().out
    with zipfile.ZipFile(out) as zf:
        assert json.loads(zf.read("meta.json"))["platforms"] == want
    if "cpu" in want:
        probs = ExportedPredictor.load(out, device="cpu").predict_windows(_inputs(3, False))
        assert probs.shape == (3, 2)
    else:
        with pytest.raises(ValueError, match=r"exported for \['cuda'\], not cpu"):
            ExportedPredictor.load(out, device="cpu")


@pytest.mark.parametrize("platforms, message", [
    ("tpu", "not one a torch.export artifact runs on"),
    ("cpu,tpu", "not one a torch.export artifact runs on"),
    ("cpu,rocm", r"unknown platform\(s\) \['rocm'\]"),
    (",", "at least one platform"),
])
def test_platforms_flag_refuses(runs, tmp_path, capsys, platforms, message):
    """An empty list, tpu or an unknown platform ends the CLI with a message
    before anything is traced; export_predictor refuses the same."""
    run = runs["raw"]
    with pytest.raises(SystemExit):
        pexport.main(["--run-dir", str(run), "--out", str(tmp_path / "x.mms"),
                      "--platforms", platforms])
    assert re.search(message, capsys.readouterr().err)
    assert not (tmp_path / "x.mms").exists()
    with pytest.raises(ValueError, match=message):
        export_predictor(Predictor.from_run(run, "S2", device="cpu"), tmp_path / "y.mms",
                         tuple(p for p in platforms.split(",") if p))


def test_serving_artifact_backend(exported, capsys):
    """PredictionService on an ensemble artifact: /healthz names the
    artifact backend, /v1/predict answers as the artifact does."""
    ep = ExportedPredictor.load(exported["ensemble"][0], device="cpu")
    service = serving.PredictionService(ep, batch_size=4, micro_batch_ms=1.0)
    server = serving.make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            card = json.loads(resp.read())
        x = _inputs(6, False, seed=3)
        req = urllib.request.Request(url + "/v1/predict", method="POST",
                                     data=json.dumps({"windows": x.tolist()}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        service.close()
    assert card["backend"] == "artifact-ensemble[3]" and card["platform"] == "cpu"
    assert card["window_shape"] == [C, T] and card["model"] == "cnn_gru_attention"
    np.testing.assert_allclose(reply["probs"], ep.predict_windows(x), rtol=0, atol=1e-6)
    single = serving.PredictionService(ExportedPredictor.load(exported["single"][0],
                                                              device="cpu"), micro_batch_ms=0)
    assert single.health()["backend"] == "artifact"
    with pytest.raises(SystemExit):
        serving.main(["--artifact", str(exported["single"][0]), "--run-dir", "r"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_stream_cli_on_artifact_matches_jax(exported, recording, tmp_path, capsys):
    """mms-stream --artifact: the port's ensemble artifact and JAX's give
    the same events line for line."""
    _, _, jpath, _, _ = exported["ensemble"]
    argv = ["--pkl", str(recording), "--calib-sec", "20"]
    got, got_err = _run_cli(pstream.main, argv + ["--artifact", str(exported["ensemble"][0]),
                                                  "--device", "cpu"], tmp_path / "p.jsonl", capsys)
    want, _ = _run_cli(jstream.main, argv + ["--artifact", str(jpath)], tmp_path / "j.jsonl",
                       capsys)
    assert len(got) == len(want) == 17 and "17 events in" in got_err
    assert [g["label"] for g in got] == [w["label"] for w in want]
    np.testing.assert_allclose([g["probs"] for g in got], [w["probs"] for w in want],
                               rtol=0, atol=1e-5 + 1e-6)
