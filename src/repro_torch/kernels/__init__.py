"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``), each
beside its plain PyTorch version.  ``_build`` compiles the sources with
``nvcc`` at first use."""

KERNEL_SOURCES = ("decode_attention", "ghost_norm")
