"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), each
beside its plain PyTorch version.  ``_build`` compiles the sources with
``nvcc`` at first use."""

import functools

import torch

KERNEL_SOURCES = ("decode_attention", "flash_attention", "ghost_norm")


@functools.cache
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA device (an H100 SXM has 132); the kernels' split plans
    are made from it."""
    return torch.cuda.get_device_properties(device).multi_processor_count
