"""Hand-written CUDA kernels of the serving and training paths, each beside
its plain version.

- B1 ``mha_pool``: fused masked multi-head attention pooling, with its
  gradient (``MhaPoolFunction``).
- B2 ``logmel``: fused log-mel spectrogram.
- B3 ``conv_int8``: SAME 3x3 int8 conv with a fused requantize epilogue
  (the int8 encoder, ``models/quantized.py``).
"""

from . import conv_int8, logmel, mha_pool

KERNELS = [mha_pool.KERNEL, logmel.KERNEL, conv_int8.KERNEL]
