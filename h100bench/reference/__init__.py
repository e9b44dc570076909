"""The plain references the benchmark holds the program to: plain PyTorch
in f32, importing nothing of the program or of the JAX package."""

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool = False):
    """Convolutions and matmuls in TF32 or not (the reference runs with it
    off, its control with it on); the flags as they were afterwards."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
