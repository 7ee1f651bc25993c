"""repro_torch — the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
layout so each module's counterpart is easy to find, and imports nothing
of it (and no JAX).  What is ported so far is the serving path and DP
training of the dense decoder:

  * ``configs``   — ``ModelConfig`` and the ``smollm-360m`` config;
  * ``models``    — RMSNorm, RoPE, FFN, full-sequence and decode GQA, and
    the dense decoder stack's ``forward`` / ``loss_fn`` /
    ``per_example_loss_fn`` / ``decode_step`` / ``decode_step_positions``
    / ``prefill``;
  * ``kernels.decode_attention`` — single-query GQA attention as a CUDA
    C++ kernel for ``sm_90a`` (``csrc/decode_attention.cu``), with its
    plain PyTorch version beside it;
  * ``kernels.ghost_norm`` — per-example ghost gradient norms of a dense
    layer as a CUDA C++ kernel for ``sm_90a`` (``csrc/ghost_norm.cu``),
    with its plain version and the full-Gram oracle beside it;
  * ``core``      — the RDP accountant, DP clipping and noise shares,
    ghost clipping (``autograd.Function`` collectors) and the leader
    schedule;
  * ``arms``      — ``arms.run`` with the ``decaph`` arm on the ``ideal``
    backend: the fused cohort round, one program call per round;
  * ``serve``     — the fixed-slot continuous-batching ``ServeEngine``,
    the seeded open-loop traffic harness and its metrics, and the
    ``transformer_model`` / ``token_silos`` federation glue;
  * ``instrument``, ``obs`` — program-call counting, tracing and the
    hash-chained privacy ledger;
  * ``convert``   — JAX parameter pytrees in and out, reference cache
    layout out.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; importing ``repro_torch.device`` (done here) turns TF32
off so float32 products are full float32.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
