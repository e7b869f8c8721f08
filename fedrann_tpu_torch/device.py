"""Explicit device selection.

The main path runs on a CUDA device and says so when there is none: a
missing GPU is an error, never a silent fallback to the CPU. CPU runs are
for tests and must be asked for by name.
"""

from __future__ import annotations

import torch

# shared memory one thread block may opt in to on sm_90 (227 KB)
SM90_SMEM_OPTIN = 232448


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """torch.device for `name`; raises RuntimeError for a CUDA device that
    this process cannot see."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the fedrann_tpu_torch main "
                "path runs its stages as CUDA kernels and needs a GPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU), so a host
    clock read afterwards covers it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shared_memory_limit(device: torch.device | None = None) -> int:
    """Bytes of shared memory one thread block may opt in to on `device`
    (SM90_SMEM_OPTIN when no CUDA device is given)."""
    if device is None or device.type != "cuda":
        return SM90_SMEM_OPTIN
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)
