"""Data QA and exploratory analysis (counterpart of
multimodalsignal_tpu/analysis/): the preprocess output checker, the
feature-importance ranking, the feature-distribution plots (host tools; the
two feature modules need scikit-learn, matplotlib, seaborn and pandas,
imported only where they are used) and the channel-attention probe, whose
forwards run on the card through the Predictor."""

from multimodalsignal_tpu_torch.analysis.preprocess_check import PreprocessChecker

__all__ = ["PreprocessChecker"]
