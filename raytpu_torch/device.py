"""The device the port's entry points put their tensors on.

Bakes, the bridge and the camera take ``device="cuda"`` by default: the
port runs on the card unless the caller names the CPU.  There is no
fallback; asking for CUDA where there is none raises.
"""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that torch cannot
    find raises instead of carrying on elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch finds no CUDA "
            "device; name device='cpu' to run on the CPU")
    return dev

