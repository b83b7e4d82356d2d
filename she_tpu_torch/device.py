"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller names another device
(the tests pass device="cpu"). With no device given and no card present
they raise: nothing falls back to the host silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Normalize `device`; None means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
