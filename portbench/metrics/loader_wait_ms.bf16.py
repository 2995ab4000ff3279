"""``loader_wait_ms.train``, read in the bf16 training cell."""

import os
import runpy

read = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader_wait_ms.train.py"))["read"]
