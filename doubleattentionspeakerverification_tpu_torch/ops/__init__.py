"""Hand-written CUDA kernels of the serving path, each beside its plain version.

- B1 ``mha_pool``: fused masked multi-head attention pooling.
- B2 ``logmel``: fused log-mel spectrogram.
"""

from . import logmel, mha_pool

KERNELS = [mha_pool.KERNEL, logmel.KERNEL]
