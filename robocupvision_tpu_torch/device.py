"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no CUDA device is present: the port never falls back to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def no_tf32() -> None:
    """Run f32 convolutions and matmuls in f32, not in the TF32 that cuDNN
    takes by default for f32 convolutions: training without bf16 trains
    in f32, as on the CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
