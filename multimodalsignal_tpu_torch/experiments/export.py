"""Model export: trained checkpoint -> one self-contained `.mms` artifact.

Counterpart of multimodalsignal_tpu/experiments/export.py. `torch.export`
traces the inference function (softmax of the model, or for a fold
ensemble the mean of the folds' softmax) with the weights inside and a
symbolic batch dimension, and `torch.export.save` writes the program; it
runs with torch alone, without this package's model code:

    python -m multimodalsignal_tpu_torch.experiments.export \\
        --checkpoint output/.../fold_test_on_S2/best_model.msgpack \\
        --config output/.../config.json --out model.mms
    python -m multimodalsignal_tpu_torch.experiments.export \\
        --run-dir output/.../run_X [--fold all|S2] --out ensemble.mms [--platforms cpu]

    from multimodalsignal_tpu_torch.experiments.export import ExportedPredictor
    ep = ExportedPredictor.load("model.mms")        # on "cuda" by default
    probs = ep.predict_windows(x)                   # [N, C, T] float32, any N

Artifact format (`.mms` = a zip): `model.pt2` (the ExportedProgram) and
`meta.json` (the JAX artifact's keys: class names, channels, window
geometry, normalization, platforms (`--platforms`, default ["cpu", "cuda"]:
`ExportedPredictor.load` refuses a device whose platform is not listed, as a
`jax.export` artifact refuses an unlisted one), ensemble folds; with
`torch_version` in place of `jax_version` and `"format": "torch.export"`).
Version 1 takes windows [N, C, T]; version 2 (a hybrid model) the pair
(windows, features [N, F]).

The program's recurrence is one `torch.ops.aten.gru` a layer (per fold for
an ensemble; models/gru.py impl "aten"), nn.GRU's op on the same weights,
as the JAX export builds its model with the portable lax.scan GRU. The
package's CUDA kernels are bound through ctypes and cannot be serialised;
on a GPU the artifact's GRU is cuDNN's. The export traces a CPU copy of the
weights and runs no model on a device: the artifact holds no device, and
`ExportedPredictor.load` moves the program to the one asked for.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from multimodalsignal_tpu_torch.data.features import FEATURE_EXTRACTOR_VERSION
from multimodalsignal_tpu_torch.experiments.predict import (
    CLASS_NAMES,
    EnsemblePredictor,
    Predictor,
    recording_to_hybrid_windows,
    recording_to_windows,
    resolve_device,
)
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.fold_stack import build_fold_model

# Version 1: one input array (raw models). Version 2: hybrid artifacts,
# whose program takes the (raw, feat) pair, another input contract: a
# loader that knows only version 1 rejects them at load().
ARTIFACT_VERSION = 1
HYBRID_ARTIFACT_VERSION = 2
SUPPORTED_ARTIFACT_VERSIONS = (1, 2)
PLATFORMS = ("cpu", "cuda")   # every platform an artifact may list; the default
# Export with an example batch of at least 2, or the batch specialises to 1.
_EXAMPLE_BATCH = 2


def check_platforms(platforms) -> tuple[str, ...]:
    """The platforms an artifact lists: a non-empty subset of PLATFORMS, in
    the order given, each once. tpu is refused: the program is a
    torch.export program, which runs on a CPU or a CUDA device."""
    platforms = tuple(dict.fromkeys(platforms))
    if not platforms:
        raise ValueError(f"an artifact lists at least one platform of {list(PLATFORMS)}")
    if "tpu" in platforms:
        raise ValueError("platform 'tpu' is not one a torch.export artifact runs on "
                         f"(the port's are {list(PLATFORMS)}); a TPU artifact is the "
                         "JAX package's export (multimodalsignal_tpu.experiments.export)")
    unknown = [q for q in platforms if q not in PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platform(s) {unknown}; choose from {list(PLATFORMS)}")
    return platforms


class _Probs(nn.Module):
    """Softmax of `model` over its inputs (windows, or windows and
    features); with `folds`, the model is fold-stacked and each batch goes
    to every lane, the softmax averaged over folds."""

    def __init__(self, model: nn.Module, folds: int | None):
        super().__init__()
        self.model = model
        self.folds = folds

    def forward(self, x: torch.Tensor, feat: torch.Tensor | None = None) -> torch.Tensor:
        inputs = (x,) if feat is None else (x, feat)
        if self.folds is not None:  # every lane sees the batch
            inputs = tuple(a.expand((self.folds,) + tuple(a.shape)) for a in inputs)
        probs = torch.softmax(self.model(inputs[0] if feat is None else inputs), dim=-1)
        return probs if self.folds is None else probs.mean(dim=0)


@contextlib.contextmanager
def _gru_output_shapes():
    """For the span of a trace, aten.gru's outputs come from their shapes
    alone. torch.export keeps aten.gru as one node, but works out its output
    by running the op's composite decomposition on fake tensors, one time
    step at a time, with the batch symbolic: minutes at T = 480. A kernel at
    the AutogradCPU key (taken before the decomposition) answers with empty
    tensors of the outputs' shapes instead; it is removed after the trace,
    and the program holds aten.gru unchanged. Meanwhile an aten.gru on CPU
    tensors elsewhere in the process would get the empty tensors too."""
    lib = torch.library.Library("aten", "IMPL")

    def shapes(x, hx, params, has_biases, num_layers, dropout, train, bidirectional,
               batch_first):
        dirs = 2 if bidirectional else 1
        return x.new_empty(tuple(x.shape[:-1]) + (dirs * hx.shape[-1],)), hx.new_empty(hx.shape)

    lib.impl("gru.input", shapes, "AutogradCPU")
    try:
        yield
    finally:
        lib._destroy()


def _artifact_module(predictor) -> _Probs:
    """A CPU copy of the predictor's model with the aten GRU, in eval mode."""
    cfg = predictor.cfg
    model_cfg = dataclasses.replace(cfg.model, gru_impl="aten")
    fold_names = getattr(predictor, "fold_names", None)
    c, nf = len(cfg.channels_to_use), len(predictor.feature_names)
    if fold_names is not None:
        model = build_fold_model(model_cfg, cfg.num_classes, c, len(fold_names),
                                 num_features=nf)
    else:
        model = build_model(model_cfg, cfg.num_classes, c, nf)
    model.load_state_dict({k: v.cpu() for k, v in predictor.model.state_dict().items()})
    return _Probs(model.eval(), None if fold_names is None else len(fold_names))


def export_predictor(predictor, out_path: Path | str,
                     platforms: tuple[str, ...] = PLATFORMS) -> dict:
    """Write `predictor`'s (a Predictor or an EnsemblePredictor) inference
    function and weights to `out_path`, for `platforms` (check_platforms);
    returns the artifact's meta dict. The batch dimension is symbolic: one
    export serves any N without padding."""
    platforms = check_platforms(platforms)
    cfg = predictor.cfg
    module = _artifact_module(predictor)
    c = len(cfg.channels_to_use)
    t = predictor.window_sec * predictor.target_fs
    feature_names = list(predictor.feature_names)
    batch = torch.export.Dim("batch", min=1)
    args = (torch.zeros((_EXAMPLE_BATCH, c, t)),)
    if feature_names:
        args += (torch.zeros((_EXAMPLE_BATCH, len(feature_names))),)
    with torch.no_grad(), _gru_output_shapes():
        program = torch.export.export(module, args,
                                      dynamic_shapes=tuple({0: batch} for _ in args))
    blob = io.BytesIO()
    torch.export.save(program, blob)
    fold_names = getattr(predictor, "fold_names", None)
    meta = {
        "artifact_version": HYBRID_ARTIFACT_VERSION if feature_names else ARTIFACT_VERSION,
        "format": "torch.export",
        "model": cfg.model.name,
        "classification_mode": cfg.classification_mode,
        "class_names": list(CLASS_NAMES[cfg.classification_mode]),
        "channels": list(cfg.channels_to_use),
        "feature_names": feature_names,  # non-empty iff hybrid
        # A hybrid artifact's features are computed live by the loader,
        # which must run the extractor version the model trained on.
        "feature_extractor_version": FEATURE_EXTRACTOR_VERSION if feature_names else None,
        "window_shape": [c, t],
        "window_sec": predictor.window_sec,
        "stride_sec": predictor.stride_sec,
        "target_fs": predictor.target_fs,
        "original_fs": predictor.original_fs,
        "normalization": cfg.normalization,
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "ensemble_folds": list(fold_names) if fold_names is not None else None,
    }
    with zipfile.ZipFile(Path(out_path), "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("model.pt2", blob.getvalue())
        zf.writestr("meta.json", json.dumps(meta, indent=2))
    return meta


def _flat_gru_weights(weights: list[torch.Tensor], batch_first: bool,
                      bidirectional: bool) -> None:
    """Copy one aten.gru's weights into one buffer in cuDNN's layout and make
    each tensor a view of it, in place, as nn.GRU.flatten_parameters does."""
    torch._cudnn_rnn_flatten_weight(
        weights, 4, weights[0].shape[1], torch.backends.cudnn.rnn.get_cudnn_mode("GRU"),
        weights[1].shape[1], 0, 1, batch_first, bidirectional)


def _pack_gru_weights(module: torch.fx.GraphModule, flatten=_flat_gru_weights) -> None:
    """Give every aten.gru of the program its weights as views of one
    buffer, computed once. The program computes them from the parameters on
    every call (casts, a fold's lane of the stacked weights), and cuDNN takes
    separate weight tensors only by copying them into its layout, with a
    warning printed, on every call. Here the nodes that compute them are
    evaluated once, `flatten` lays each call's weights out as cuDNN's buffer,
    and the call reads them as constants; the nodes left unused go."""
    graph = module.graph

    def value(node):
        if not isinstance(node, torch.fx.Node):
            return node
        if node.op == "get_attr":
            return functools.reduce(getattr, node.target.split("."), module)
        if node.op != "call_function":
            raise ValueError(f"aten.gru weight from {node.op} {node.target}")
        return node.target(*torch.fx.node.map_arg(node.args, value),
                           **torch.fx.node.map_arg(node.kwargs, value))

    grus = [n for n in graph.nodes if n.target is torch.ops.aten.gru.input]
    with torch.no_grad():
        for i, node in enumerate(grus):
            x, hx, params, *flags = node.args
            weights = [value(p).detach().clone() for p in params]
            flatten(weights, batch_first=flags[-1], bidirectional=flags[-2])
            with graph.inserting_before(node):
                attrs = []
                for j, w in enumerate(weights):
                    module.register_buffer(f"_gru{i}_w{j}", w, persistent=False)
                    attrs.append(graph.get_attr(f"_gru{i}_w{j}"))
            node.args = (x, hx, attrs, *flags)
    graph.eliminate_dead_code()
    module.recompile()


class ExportedPredictor:
    """Run an exported artifact on one device (Predictor interface). The
    program needs torch only; this class adds input checks and the
    recording pipeline."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self._run = program.module()
        self.meta = meta
        self.device = device
        self.class_names = tuple(meta["class_names"])
        self.is_hybrid = bool(meta.get("feature_names"))
        self.feature_names = tuple(meta.get("feature_names") or ())

    @classmethod
    def load(cls, path: Path | str, device: str | torch.device = "cuda"
             ) -> "ExportedPredictor":
        """Read the artifact and move its program to `device` (raises if it
        names CUDA and there is none, or if the artifact does not list the
        device's platform)."""
        device = resolve_device(device)
        with zipfile.ZipFile(Path(path)) as zf:
            names = set(zf.namelist())
            meta = json.loads(zf.read("meta.json"))
            if "model.pt2" not in names:
                what = ("a JAX package artifact (model.stablehlo): it runs with "
                        "multimodalsignal_tpu's ExportedPredictor; re-export the "
                        "checkpoint with this package" if "model.stablehlo" in names
                        else "not a torch.export artifact")
                raise ValueError(f"{path} has no model.pt2: {what}")
            blob = zf.read("model.pt2")
        if device.type not in meta.get("platforms", PLATFORMS):
            raise ValueError(f"{path} was exported for {meta['platforms']}, not "
                             f"{device.type}; export it again with --platforms naming it")
        if meta.get("artifact_version") not in SUPPORTED_ARTIFACT_VERSIONS:
            raise ValueError(
                f"artifact version {meta.get('artifact_version')} not in "
                f"supported {SUPPORTED_ARTIFACT_VERSIONS} — the artifact "
                f"needs a newer package")
        fv = meta.get("feature_extractor_version")
        if meta.get("feature_names") and fv is not None and int(fv) != FEATURE_EXTRACTOR_VERSION:
            raise ValueError(
                f"hybrid artifact assumes feature extractor v{fv}; this "
                f"package computes v{FEATURE_EXTRACTOR_VERSION} features live — "
                "re-export from a retrained checkpoint or use the matching "
                "package version")
        program = torch.export.load(io.BytesIO(blob))
        if device.type != "cpu":
            # Moves the weights and the device literals traced on the CPU
            # (the GRU's h0 zeros), which .to() on the module would not.
            program = move_to_device_pass(program, device)
        ep = cls(program, meta, device)
        if device.type == "cuda":
            _pack_gru_weights(ep._run)
        return ep

    def predict_windows(self, x, batch_size: int | None = None) -> np.ndarray:
        """[N, C, T] float32 (or the hybrid ([N, C, T], [N, F]) pair) ->
        probs [N, num_classes]. The batch is symbolic: any N runs as one
        call, unpadded (batch_size is accepted for the Predictor interface
        and ignored)."""
        c, t = self.meta["window_shape"]
        if self.is_hybrid:
            if not isinstance(x, (tuple, list)) or len(x) != 2:
                raise ValueError("hybrid artifact expects (raw [N, C, T], feat [N, F])")
            raw = np.asarray(x[0], np.float32)
            feat = np.asarray(x[1], np.float32)
            f = len(self.feature_names)
            if raw.ndim != 3 or raw.shape[1] != c or raw.shape[2] != t:
                raise ValueError(f"expected raw windows [N, {c}, {t}], got {list(raw.shape)}")
            if feat.ndim != 2 or feat.shape != (raw.shape[0], f):
                raise ValueError(f"expected features [{raw.shape[0]}, {f}], "
                                 f"got {list(feat.shape)}")
            inputs = (raw, feat)
        else:
            x = np.asarray(x, np.float32)
            if x.ndim != 3 or x.shape[1] != c or x.shape[2] != t:
                raise ValueError(f"expected windows [N, {c}, {t}], got {list(x.shape)}")
            inputs = (x,)
        with torch.inference_mode():
            probs = self.predict_tensor(*(torch.from_numpy(np.ascontiguousarray(a))
                                          .to(self.device) for a in inputs))
        return probs.cpu().numpy()

    def predict_tensor(self, *inputs: torch.Tensor) -> torch.Tensor:
        """The program on tensors already on the device -> probs [N, K]."""
        return self._run(*inputs)

    def windows_from_recording(self, pkl_path):
        """Raw WESAD pickle -> normalized windows (a hybrid artifact's
        (raw, feat) pair) + start times, with the artifact's recorded
        pipeline parameters."""
        m = self.meta
        if self.is_hybrid:
            return recording_to_hybrid_windows(
                pkl_path, list(m["channels"]), m["normalization"],
                list(self.feature_names), m["original_fs"], m["target_fs"],
                m["window_sec"], m["stride_sec"])
        return recording_to_windows(
            pkl_path, list(m["channels"]), m["normalization"],
            m["original_fs"], m["target_fs"], m["window_sec"], m["stride_sec"])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", help="one fold's best_model.msgpack")
    p.add_argument("--config", help="the run's config.json")
    p.add_argument("--run-dir",
                   help="run directory (with --fold); replaces --checkpoint/--config")
    p.add_argument("--fold", default="all",
                   help="with --run-dir: a subject id, or 'all' for the fold "
                        "ensemble (default)")
    p.add_argument("--out", required=True, help="artifact path (.mms)")
    p.add_argument("--platforms", default=",".join(PLATFORMS),
                   help="comma-separated platforms the artifact may be loaded on, "
                        f"a subset of {','.join(PLATFORMS)} (default all)")
    args = p.parse_args(argv)
    try:
        platforms = check_platforms(s.strip() for s in args.platforms.split(",") if s.strip())
    except ValueError as exc:
        p.error(f"--platforms: {exc}")
    # The export traces a CPU copy of the weights: the artifact holds no device.
    if args.run_dir:
        if args.checkpoint or args.config:
            p.error("--run-dir replaces --checkpoint/--config")
        predictor = EnsemblePredictor.from_run(args.run_dir, args.fold, device="cpu")
    elif args.checkpoint and args.config:
        predictor = Predictor.from_files(args.checkpoint, args.config, device="cpu")
    else:
        p.error("provide --run-dir, or --checkpoint with --config")
    meta = export_predictor(predictor, args.out, platforms)
    size_kb = Path(args.out).stat().st_size / 1024
    folds = meta.get("ensemble_folds")
    kind = f"{len(folds)}-fold ensemble" if folds else "single fold"
    print(f"Exported {meta['model']} ({meta['classification_mode']}, {kind}) "
          f"for {meta['platforms']} -> {args.out} ({size_kb:.0f} KiB)")


if __name__ == "__main__":
    main()
