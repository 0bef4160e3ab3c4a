"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    `None` means the card: `"cuda"`, and a RuntimeError when PyTorch
    sees no CUDA device. The CPU is used only when the caller asks for
    it by name.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "icepy4d_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Matrix products and cuDNN convolutions in full float32 (no TF32)
    inside the block, whatever the caller set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def card_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (a card below its
    maximum limit runs slower under load, so a time is printed beside
    it); "cpu" for the CPU."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(dev)}, power limit not read"
