"""The port's device: named explicitly, never probed.

The JAX package measured a device round trip and routed work by it
(wfmash_tpu/runner.py:_device_rtt_ms). The port runs where it is told:
`WFMASH_TPU_TORCH_DEVICE` (default `cuda`), or a `device` argument.
"""

from __future__ import annotations

import os

import torch

ENV = "WFMASH_TPU_TORCH_DEVICE"


def resolve(name: str | None = None) -> torch.device:
    """torch.device for `name`, else for $WFMASH_TPU_TORCH_DEVICE, else
    cuda. Raises RuntimeError when a CUDA device is asked for and absent."""
    dev = torch.device(name if name is not None
                       else os.environ.get(ENV, "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch sees no CUDA device; "
            f"set {ENV}=cpu to run the kernels' plain PyTorch versions")
    return dev
