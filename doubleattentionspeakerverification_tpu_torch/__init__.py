"""PyTorch + CUDA port of the speaker-verification system, for one H100.

The port of ``doubleattentionspeakerverification_tpu`` (the JAX package,
which stays the reference). Module names mirror the JAX package's. This
package imports torch and numpy, never jax and nothing of the JAX package.
The Pallas TPU kernels on its path are hand-written CUDA kernels under
``csrc/`` (``ops/``), each beside its plain PyTorch version.
"""

from .config import ExperimentConfig, FeatureConfig, ModelConfig, TrainConfig

__all__ = ["ExperimentConfig", "FeatureConfig", "ModelConfig", "TrainConfig"]
