"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``cuda`` (the default) or ``cpu``. Asking for CUDA where there is none
    raises: there is no fallback to the CPU.

    On CUDA this also switches TF32 off for convolutions and matrix products:
    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits, and the float32 model is held to 1e-4 of its
    reference (``ModelConfig.compute_dtype = "float32"``).
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
