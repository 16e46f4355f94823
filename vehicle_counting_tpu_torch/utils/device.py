"""Device info (reference: utilities/cuda.py:14-19) and the card line that
tags every measurement of this package."""

from __future__ import annotations

import contextlib
import subprocess


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them;
    "unknown" where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def require_device(device):
    """`torch.device(device)`; raises when a CUDA device is asked for and
    none is present (no entry point drops to the CPU by itself)."""
    import torch

    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device '{dev}' requested but no CUDA device is available")
    return dev


def _needs_guard(device) -> bool:
    return device.type == "cuda"


def on_device(device):
    """`device` made the thread's current CUDA device for the block (a no-op
    on the CPU). The kernel wrappers launch through `ctypes` on the current
    device with the stream of their tensors' device, which must agree, so
    every entry point that takes a device runs its launches inside this."""
    import torch

    device = torch.device(device)
    return torch.cuda.device(device) if _needs_guard(device) else contextlib.nullcontext()


def get_devices_info() -> str:
    import torch

    if not torch.cuda.is_available():
        return "Backend: cpu (no CUDA device)"
    n = torch.cuda.device_count()
    lines = [f"Backend: cuda {torch.version.cuda} ({n} device(s))"]
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"  [{i}] {p.name} {p.total_memory / 2 ** 30:.0f} GiB, {p.multi_processor_count} SMs")
    lines.append(f"  card: {card_line()}")
    return "\n".join(lines)
