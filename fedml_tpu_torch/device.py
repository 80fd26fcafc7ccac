"""Device selection: the GPU unless the caller asks for the CPU.

There is no silent fallback.  A run that did not ask for the CPU and
finds no CUDA device raises, so a CPU number can never be reported as a
GPU one."""

from __future__ import annotations

from typing import Optional, Union

import torch

_GPU_NAMES = (None, "", "gpu", "cuda")


def resolve_device(platform: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/``"gpu"``/``"cuda"`` -> ``cuda`` (raises without a GPU);
    ``"cpu"`` -> ``cpu``; a ``torch.device`` or ``"cuda:N"`` passes
    through after the same check."""
    if isinstance(platform, torch.device):
        dev = platform
    elif platform in _GPU_NAMES:
        dev = torch.device("cuda")
    else:
        dev = torch.device(platform)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --platform cpu (or "
            "device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
