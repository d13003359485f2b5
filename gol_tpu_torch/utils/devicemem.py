"""Device-memory budget probe — the counterpart of
`gol_tpu/utils/devicemem.py`, shared by every subsystem that sizes itself
against device memory (the engine's pipeline-depth clamp, the sparse
engine's window ceiling), so the heuristic lives in one place.
"""

from __future__ import annotations

import torch


def half_device_memory(default: int, device=None) -> int:
    """Half the device's memory — kernel temporaries and working sets
    need the other half — or `default` for a device that reports none
    (the CPU). `device=None` is the current CUDA device where there is
    one."""
    if device is None:
        if not torch.cuda.is_available():
            return default
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return default
    return torch.cuda.get_device_properties(device).total_memory // 2
