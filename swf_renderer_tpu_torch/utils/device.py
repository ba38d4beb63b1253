"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``).  With no device given and no card present they raise:
nothing quietly falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
