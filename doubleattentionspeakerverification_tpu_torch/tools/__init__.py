"""Probes of the card, each a hand-written kernel beside its plain version.

- ``rate_probe``: tiled int8 and bf16 matrix products at 4096³ (P1,
  ``csrc/mm_probe.cu``).
- ``conv_int8_probe``: kernel B3 split into full / dot-only / copy-only
  variants at conv22's shape (P2, ``csrc/conv_int8.cu``).

``timing`` holds the card's peak rates and the device timer they share
with ``chip_smoke.py``.
"""
