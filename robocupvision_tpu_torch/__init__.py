"""PyTorch/CUDA port of robocupvision_tpu for NVIDIA Hopper (H100).

The JAX package ``robocupvision_tpu`` stays the reference; this package
mirrors its layout (``ops/``, ``models/``, ``export/``, ``utils/``) and its
public signatures (NHWC activations, the same parameter names), with the
TPU's Pallas kernels replaced by hand-written CUDA C++ kernels under
``csrc/`` (built at first use by ``csrc/build.py``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device it raises instead of quietly
running on the CPU (``robocupvision_tpu_torch.device.resolve_device``).
"""

__all__ = ["device", "ops", "models", "export", "utils"]
