"""multimodalsignal_tpu_torch — the PyTorch/CUDA port of multimodalsignal_tpu.

A second package beside the JAX one, for an NVIDIA H100 (sm_90a). It serves
a trained CnnGru / CnnGruAttention checkpoint that the JAX package wrote
(`best_model.msgpack` + `config.json`, read unchanged), through the same
HTTP routes; the GRU recurrence runs in CUDA kernels written by hand
(ops/csrc/), built with nvcc at first use. It imports torch, numpy and the
standard library, never JAX or the JAX package.

Layer map:
  serving.py   HTTP server, micro-batcher
  experiments/ predict: Predictor, recording -> windows
  data/        WESAD pickle reading, resampling, windowing, normalization
  models/      CnnGru(Attention), BiGRU, flax-weight conversion
  ops/         CUDA kernels, their wrappers and plain versions
  train/       flax checkpoint reader
"""

__version__ = "0.1.0"
