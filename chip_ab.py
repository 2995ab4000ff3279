#!/usr/bin/env python3
"""A/B timing of kernel B3 across source trees on one GPU.

    python3 chip_ab.py TREE CHECK

imports the port package and ``chip_smoke.py`` from TREE (a checkout of
this repository, such as a ``git archive`` of another commit unpacked into
a directory that ``.gitignore`` lists), builds B3 there, times its seven
paper-width convs at B=8 (``chip_smoke.CONV_PAPER``, CUDA-graph replay)
and P2's three modes, and prints one JSON line. With CHECK = 1 each conv is
first held bit for bit to its plain version and P2's full mode to B3. To
compare two versions, run them in turns in one call on one card (A B B A),
one process per tree:

    python3 chip_ab.py old 1 && python3 chip_ab.py . 1 && python3 chip_ab.py . 0 && python3 chip_ab.py old 0

Imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import sys

tree, check = sys.argv[1], sys.argv[2] == "1"
sys.path.insert(0, tree)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from doubleattentionspeakerverification_tpu_torch.ops import conv_int8  # noqa: E402
from doubleattentionspeakerverification_tpu_torch.ops.kernels import build_all  # noqa: E402
from doubleattentionspeakerverification_tpu_torch.tools import conv_int8_probe  # noqa: E402
from doubleattentionspeakerverification_tpu_torch.tools.timing import cuda_ms  # noqa: E402
from doubleattentionspeakerverification_tpu_torch.utils.device import resolve_device  # noqa: E402

assert conv_int8.__file__.startswith(
    os.path.join(os.path.abspath(tree), cs.PKG) + os.sep), conv_int8.__file__
resolve_device("cuda")
logs = build_all([conv_int8.KERNEL])
for line in logs["conv_int8"].splitlines():
    if "spill" in line and "0 bytes spill" not in line or "wgmma" in line:
        print(tree, line.strip())
rng = np.random.default_rng(4)
out = {"tree": tree, "convs": {}}
for name, t, f, cin, cout in cs.CONV_PAPER:
    q, w9, mult, bias = cs.conv_inputs(rng, cs.CONV_B, t, f, cin, cout)
    if check:
        assert cs.conv_check(q, w9, mult, bias) == 0.0
    wp = conv_int8.pack_weights(w9)
    out["convs"][name] = cuda_ms(lambda: conv_int8.conv3x3_int8_cuda(q, wp, mult, bias), 5)
out["total"] = sum(out["convs"].values())
if check:
    out["p2_check"] = conv_int8_probe.check()
m = conv_int8_probe.measure()
out["p2"] = {k: m[k] for k in ("full_ms", "dot_only_ms", "copy_only_ms")}
print(json.dumps(out), flush=True)
