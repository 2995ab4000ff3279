"""PyTorch + CUDA port of the speaker-verification system, for one H100.

The port of ``doubleattentionspeakerverification_tpu`` (the JAX package,
which stays the reference). Module names mirror the JAX package's, and this
module exports the same names. This package imports torch and numpy, never
jax and nothing of the JAX package. The Pallas TPU kernels on its path are
hand-written CUDA kernels under ``csrc/`` (``ops/``), each beside its plain
PyTorch version, chosen by the kernel dispatcher (``utils/kernel_auto.py``).
"""

from .config import (
    DataConfig,
    ExperimentConfig,
    FeatureConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    count_speakers,
)

__version__ = "0.1.0"

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "FeatureConfig",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
    "count_speakers",
    "__version__",
]
