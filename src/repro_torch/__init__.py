"""repro_torch — the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
layout so each module's counterpart is easy to find, and imports nothing
of it (and no JAX).  What is ported so far is the serving path:

  * ``configs``   — ``ModelConfig`` and the ``smollm-360m`` config;
  * ``models``    — RMSNorm, RoPE, FFN, GQA decode and the dense decoder
    stack's ``decode_step`` / ``decode_step_positions`` / ``prefill``;
  * ``kernels.decode_attention`` — single-query GQA attention as a CUDA
    C++ kernel for ``sm_90a`` (``csrc/decode_attention.cu``), with its
    plain PyTorch version beside it;
  * ``serve``     — the fixed-slot continuous-batching ``ServeEngine``,
    the seeded open-loop traffic harness and its metrics;
  * ``instrument``, ``obs`` — program-call counting and tracing;
  * ``convert``   — JAX parameter pytrees in, reference cache layout out.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; importing ``repro_torch.device`` (done here) turns TF32
off so float32 products are full float32.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
