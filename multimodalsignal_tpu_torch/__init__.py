"""multimodalsignal_tpu_torch — the PyTorch/CUDA port of multimodalsignal_tpu.

A second package beside the JAX one, for an NVIDIA H100 (sm_90a). It turns
WESAD pickles into the windowed npy contract, trains the CnnGru,
CnnGruAttention and hybrid models (one fold, the serial LOSO run, or every
fold as a lane of one model), and serves their checkpoints, its own or the
JAX package's (`best_model.msgpack` + `config.json`, read unchanged),
through the same HTTP routes. The GRU recurrence runs in CUDA kernels
written by hand (ops/csrc/), built with nvcc at first use. It imports torch,
numpy, scipy and the standard library (the feature-analysis tools also
scikit-learn, matplotlib, seaborn and pandas, inside their functions),
never JAX or the JAX package.

Layer map:
  main.py      experiment CLI (sharded sweep, --execution serial, --from-pickles,
               --profile-dir)
  serving.py   HTTP server, micro-batcher
  experiments/ predict (Predictor, EnsemblePredictor, recording -> windows),
               loso (serial LOSO), splits
  parallel/    fold_sweep: every LOSO fold a lane of one model
  data/        WESAD pickles, synthetic pickles, protocol, resampling,
               windowing, handcrafted features, the preprocess CLI, datasets
  models/      CnnGru(Attention), hybrid, BiGRU, the fold-stacked model,
               flax-weight conversion
  ops/         CUDA kernels, their wrappers and plain versions
  train/       Trainer, Adam and FoldAdam, metrics, flax checkpoints and
               resume bundles
  analysis/    preprocess checker, feature tools (host), attention probe
"""

__version__ = "0.1.0"
