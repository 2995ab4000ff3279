"""Configuration of the serving path.

A copy of the fields of the JAX package's ``config.py`` that embedding and
serving read, with the same names and defaults (the paper configuration:
VGG4L, kernel_size 1024, 32 heads, DoubleMHA, embedding 400). Training,
data and mesh settings are not read here; ``ExperimentConfig.from_dict``
skips them, so a JAX checkpoint's embedded config loads as it is.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class FeatureConfig:
    """Log-mel front-end constants (reference ``featureExtractor.py:8-23``)."""

    sample_rate: int = 16000
    window_size_s: float = 0.025     # 25 ms -> win_length 400
    window_stride_s: float = 0.010   # 10 ms -> hop 160
    n_fft: int = 512
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None     # None -> sample_rate / 2
    preemphasis: float = 0.97
    rescale: float = 32768.0         # 16-bit scale applied before pre-emphasis
    log_floor: float = 1.0           # log(max(1, mel))

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.window_size_s)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride_s)

    @property
    def fmax_hz(self) -> float:
        return self.sample_rate / 2 if self.fmax is None else self.fmax


@dataclass(frozen=True)
class ModelConfig:
    """Network shape; defaults are the paper configuration."""

    front_end: str = "VGG4L"              # 'VGG3L' | 'VGG4L'
    kernel_size: int = 1024               # top conv channel count
    embedding_size: int = 400
    heads_number: int = 32
    pooling_method: str = "DoubleMHA"     # 'Attention' | 'MHA' | 'DoubleMHA' | 'StatisticalPooling'
    feature_size: int = 80
    compute_dtype: str = "float32"        # 'float32' | 'bfloat16' for the convs
    # Reference quirk: MHA scores are divided by sqrt(heads_number), not
    # sqrt(head_size) (reference poolings.py:75-76).
    mha_dk_is_heads: bool = True
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5


@dataclass(frozen=True)
class ExperimentConfig:
    model_name: str = "CNN"
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def describe(self) -> str:
        """Short model name for ``/health``."""
        m = self.model
        return (f"{self.model_name}_{m.front_end}_{m.kernel_size}kernel_"
                f"{m.embedding_size}embSize_{m.pooling_method}_{m.heads_number}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        """Build from the JAX package's ``ExperimentConfig.to_dict()``;
        keys this package does not read are skipped."""

        def pick(tp, val):
            names = {f.name for f in dataclasses.fields(tp)}
            return tp(**{k: v for k, v in (val or {}).items() if k in names})

        return cls(
            model_name=d.get("model_name", cls.model_name),
            features=pick(FeatureConfig, d.get("features")),
            model=pick(ModelConfig, d.get("model")),
        )
