"""Device and precision policy.

Every entry point takes an explicit `torch.device` and passes it
down; nothing in the port reads a global default device. The
resample chain is specified in full float32 (the JAX reference's
`preferred_element_type=f32`), so TF32 is switched off for both
matmuls and convolutions.
"""

from __future__ import annotations

import torch


def configure() -> None:
    """Pin full-f32 math for every float32 product the port runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device to serve on; raises when CUDA is absent (the
    server never carries on silently on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the PyTorch port serves on a CUDA "
            "device (pass torch.device('cpu') explicitly to run the "
            "plain versions)"
        )
    return torch.device("cuda", index)


def device_count(device: torch.device) -> int:
    """How many devices of `device`'s type this process sees: what a
    data-parallel mesh would span (the CPU counts as one). On CUDA this
    initialises the driver, so call it only where CUDA may be touched:
    never in a parent process before it forks its workers."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1
