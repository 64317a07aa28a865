"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` whose default is
``"cuda"``.  Asking for the card where there is none raises: nothing
here silently picks the CPU.  Only ``device="cpu"`` (the tests' path)
runs the plain PyTorch twins of the kernels on the host.
"""

from __future__ import annotations

import torch

HAS_CUDA = torch.cuda.is_available()


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names a CUDA device
    and no card is visible to this process."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False (no NVIDIA card or a CPU-only PyTorch); pass "
            "device='cpu' to run the plain PyTorch path"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return d


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, ``"cpu"`` otherwise."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
