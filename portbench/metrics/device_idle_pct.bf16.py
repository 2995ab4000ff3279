"""``device_idle_pct.train``, read in the bf16 training cell."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)), "device_idle_pct.train.py"))["read"]
