"""Import a reference PyTorch checkpoint (`best_model.pt`) as a run directory.

Counterpart of multimodalsignal_tpu/experiments/import_torch.py. The
reference saves its best model as a bare `state_dict` of its
CnnGruAttentionModel; this module loads it into the port's model under the
port's names, then writes the run directory every other surface reads:
`best_model.msgpack` (the JAX package's TrainState layout, with the zero
Adam moments a fresh optimizer holds) and `config.json`. The predict,
serving, streaming and export CLIs of both packages take it as a single-fold
run.

The architecture comes from the tensors' shapes, so the CLI needs only what
a state_dict cannot carry: the channel list and the classification mode:

    python -m multimodalsignal_tpu_torch.experiments.import_torch \\
        --pt output/run_x/fold_test_on_S2/best_model.pt \\
        --channels chest_ECG chest_EDA chest_Resp \\
        --mode stress_binary --out ./imported_S2

It writes files and runs no model. Names (reference -> port; the port keeps
torch's layouts, so no tensor is transposed):

    channel_attention.fc.0.weight     -> channel_attention.fc1.weight
    channel_attention.fc.2.weight     -> channel_attention.fc2.weight
    cnn_encoder.0.weight              -> cnn_encoder.conv1.weight
    cnn_encoder.1.{weight,bias,running_mean,running_var} -> cnn_encoder.bn1.*
    cnn_encoder.4.weight              -> cnn_encoder.conv2.weight
    cnn_encoder.5.*                   -> cnn_encoder.bn2.*
    gru.{weight,bias}_{ih,hh}_l{k}[_reverse] -> gru.l{k}_{fwd,bwd}_{w,b}_{ih,hh}
    classifier.0.*                    -> head1.*
    classifier.3.*                    -> head2.*

The reference's degenerate channel gate (C < reduction ratio: Linear(C, 0)
then Linear(0, C), a constant gate of 0.5) imports as it does in the JAX
package: its zero-width tensors are dropped and the model applies 0.5.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
import torch

from multimodalsignal_tpu_torch.config import ExperimentConfig, ModelConfig, save_config
from multimodalsignal_tpu_torch.models.cnn_gru import build_model
from multimodalsignal_tpu_torch.models.convert import export_jax_variables
from multimodalsignal_tpu_torch.train.checkpoints import write_initial_train_state


class TorchImportError(ValueError):
    pass


def load_torch_state_dict(pt_path: Path | str) -> dict[str, np.ndarray]:
    """Read a .pt file (a state_dict, or {"state_dict": ...}) into {name:
    float32 ndarray}, with weights_only=True."""
    obj = torch.load(pt_path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and not hasattr(obj["state_dict"], "numpy"):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise TorchImportError(f"{pt_path}: expected a state_dict, got {type(obj).__name__}")
    return {k: np.asarray(v.detach().to(torch.float32).numpy())
            for k, v in obj.items() if hasattr(v, "detach")}


def infer_model_config(sd: dict[str, np.ndarray]) -> tuple[ModelConfig, int, int]:
    """Architecture from the tensors' shapes: (ModelConfig, in_channels,
    num_classes)."""
    def need(key: str) -> np.ndarray:
        if key not in sd:
            raise TorchImportError(
                f"state_dict is missing '{key}' — not a reference "
                f"CnnGruAttentionModel checkpoint? Keys present: {sorted(sd)[:8]}...")
        return sd[key]

    conv1 = need("cnn_encoder.0.weight")        # [16, C, 7]
    conv2 = need("cnn_encoder.4.weight")        # [out, 16, 5]
    w_ih0 = need("gru.weight_ih_l0")            # [3H, out]
    head2 = need("classifier.3.weight")         # [classes, 64]
    in_channels = int(conv1.shape[1])
    layers = len({m.group(1) for k in sd if (m := re.fullmatch(r"gru\.weight_ih_l(\d+)", k))})
    if "gru.weight_ih_l0_reverse" not in sd:
        raise TorchImportError("checkpoint's GRU is unidirectional; the reference model "
                               "is bidirectional and so is this package's")
    att = sd.get("channel_attention.fc.0.weight")  # [C // r, C], maybe 0 rows
    if att is None:
        name, reduction = "cnn_gru", 4               # the gateless baseline
    elif att.shape[0] == 0:
        # Degenerate gate: any r > C gives torch's floor(C / r) == 0.
        name = "cnn_gru_attention"
        reduction = 4 if in_channels < 4 else in_channels + 1
    else:
        name = "cnn_gru_attention"
        reduction = in_channels // int(att.shape[0])
    model_cfg = ModelConfig(name=name, cnn_out_channels=int(conv2.shape[0]),
                            gru_hidden_size=int(w_ih0.shape[0]) // 3,
                            gru_num_layers=layers, reduction_ratio=reduction)
    return model_cfg, in_channels, int(head2.shape[0])


def _port_names(sd: dict[str, np.ndarray]) -> dict[str, str]:
    """Reference name -> the port model's name, for every tensor the port
    model has a place for."""
    names = {"channel_attention.fc.0.weight": "channel_attention.fc1.weight",
             "channel_attention.fc.2.weight": "channel_attention.fc2.weight",
             "cnn_encoder.0.weight": "cnn_encoder.conv1.weight",
             "cnn_encoder.4.weight": "cnn_encoder.conv2.weight"}
    for idx, bn in ((1, "bn1"), (5, "bn2")):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            names[f"cnn_encoder.{idx}.{leaf}"] = f"cnn_encoder.{bn}.{leaf}"
    for key in sd:
        m = re.fullmatch(r"gru\.(weight|bias)_(ih|hh)_l(\d+)(_reverse)?", key)
        if m:
            kind, gate, layer, rev = m.groups()
            names[key] = (f"gru.l{layer}_{'bwd' if rev else 'fwd'}_"
                          f"{'w' if kind == 'weight' else 'b'}_{gate}")
    for idx, head in ((0, "head1"), (3, "head2")):
        for leaf in ("weight", "bias"):
            names[f"classifier.{idx}.{leaf}"] = f"{head}.{leaf}"
    return names


def load_state_dict_into(model: torch.nn.Module, sd: dict[str, np.ndarray]) -> None:
    """Copy the reference tensors into `model` under the port's names. Every
    parameter and statistic of the model must come from a tensor of its
    shape, and every tensor must be used (but BN's num_batches_tracked and
    the degenerate gate's zero-width tensors)."""
    names = _port_names(sd)
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    mapped = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked") or value.size == 0:
            continue
        port = names.get(key)
        if port not in target:
            raise TorchImportError(f"unmapped state_dict tensors (wrong architecture?): {[key]}")
        if tuple(target[port].shape) != value.shape:
            raise TorchImportError(
                f"shape mismatch importing '{key}' -> {port}: checkpoint "
                f"{value.shape} vs model {tuple(target[port].shape)}")
        mapped[port] = torch.from_numpy(value)
    missing = sorted(set(target) - set(mapped))
    if missing:
        back = {v: k for k, v in names.items()}
        raise TorchImportError(f"state_dict is missing '{back.get(missing[0], missing[0])}'")
    model.load_state_dict(mapped, strict=False)


def import_torch_checkpoint(pt_path: Path | str, channels_to_use: tuple[str, ...],
                            classification_mode: str, out_dir: Path | str,
                            normalization: str = "all"):
    """.pt state_dict -> run directory (best_model.msgpack + config.json).
    Returns (ExperimentConfig, the flax {"params", "batch_stats"} pair
    written). The directory is a single-fold run:
    `Predictor.from_files(out/best_model.msgpack, out/config.json)`, the
    server and the export take it."""
    sd = load_torch_state_dict(pt_path)
    model_cfg, in_channels, num_classes = infer_model_config(sd)
    if len(channels_to_use) != in_channels:
        raise TorchImportError(
            f"checkpoint was trained on {in_channels} input channels but "
            f"{len(channels_to_use)} channel names were given: {list(channels_to_use)}")
    cfg = ExperimentConfig(run_name=f"imported_{Path(pt_path).stem}",
                           classification_mode=classification_mode,
                           num_classes=num_classes, channels_to_use=tuple(channels_to_use),
                           normalization=normalization, model=model_cfg)
    model = build_model(cfg.model, cfg.num_classes, in_channels)
    load_state_dict_into(model, sd)
    variables = export_jax_variables(model)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_initial_train_state(out_dir / "best_model.msgpack", variables,
                              cfg.trainer.learning_rate)
    save_config(cfg, out_dir / "config.json")
    print(
        f"Imported {pt_path} -> {out_dir}/best_model.msgpack\n"
        f"  model: {model_cfg.name} (C={in_channels}, "
        f"cnn_out={model_cfg.cnn_out_channels}, H={model_cfg.gru_hidden_size}, "
        f"layers={model_cfg.gru_num_layers}, classes={num_classes})\n"
        f"  serve it:   python -m multimodalsignal_tpu_torch.serving "
        f"--checkpoint {out_dir}/best_model.msgpack --config {out_dir}/config.json\n"
        f"  predict:    python -m multimodalsignal_tpu_torch.experiments.predict "
        f"--checkpoint {out_dir}/best_model.msgpack "
        f"--config {out_dir}/config.json --pkl <recording.pkl>")
    return cfg, variables


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pt", type=Path, required=True,
                   help="reference best_model.pt (a torch state_dict)")
    p.add_argument("--channels", nargs="+", required=True,
                   help="channel names the model was trained on, in order")
    p.add_argument("--mode", default="stress_binary",
                   choices=("stress_binary", "ternary", "amusement_binary"),
                   help="classification mode the model was trained with")
    p.add_argument("--normalization", default="all", choices=("all", "baseline", "none"))
    p.add_argument("--out", type=Path, required=True, help="output run directory")
    args = p.parse_args(argv)
    import_torch_checkpoint(args.pt, tuple(args.channels), args.mode, args.out,
                            normalization=args.normalization)


if __name__ == "__main__":
    main()
