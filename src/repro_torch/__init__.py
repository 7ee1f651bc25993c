"""repro_torch — the PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its module
layout so each module's counterpart is easy to find, and imports nothing
of it (and no JAX).  What is ported so far is the serving path, DP
training of the dense decoder, and the paper's own DeCaPH (SecAgg, the
tabular and DenseNet models and their synthetic hospital data):

  * ``configs``   — ``ModelConfig`` and the ``smollm-360m`` config;
  * ``models``    — RMSNorm, RoPE, FFN, full-sequence and decode GQA, and
    the dense decoder stack's ``forward`` / ``loss_fn`` /
    ``per_example_loss_fn`` / ``decode_step`` / ``decode_step_positions``
    / ``prefill``; ``models.tabular``, the paper's own models (the GEMINI
    and pancreas MLPs, logistic regression, SVC, the BN-free DenseNet);
  * ``data``      — the synthetic hospital data (GEMINI-, pancreas- and
    X-ray-like) and the silo partitioners, numpy copies of the
    reference's;
  * ``kernels.decode_attention`` — single-query GQA attention as a CUDA
    C++ kernel for ``sm_90a`` (``csrc/decode_attention.cu``), with its
    plain PyTorch version beside it;
  * ``kernels.ghost_norm`` — per-example ghost gradient norms of a dense
    layer as a CUDA C++ kernel for ``sm_90a`` (``csrc/ghost_norm.cu``),
    with its plain version and the full-Gram oracle beside it;
  * ``core``      — the RDP accountant, DP clipping and noise shares,
    ghost clipping (``autograd.Function`` collectors), fixed-point SecAgg
    (``core.secagg``, host numpy) and the leader schedule;
  * ``arms``      — ``arms.run`` with the ``decaph`` arm on the ``ideal``
    backend: the fused cohort round, one program call per round, SecAgg
    on by default; ``run`` is ``python -m repro_torch.run``, the
    reference's CLI;
  * ``serve``     — the fixed-slot continuous-batching ``ServeEngine``,
    the seeded open-loop traffic harness and its metrics, and the
    ``transformer_model`` / ``token_silos`` federation glue;
  * ``instrument``, ``obs`` — program-call counting, tracing and the
    hash-chained privacy ledger;
  * ``convert``   — JAX parameter pytrees in and out, reference cache
    layout out.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``); importing
``repro_torch.device`` turns TF32 off so float32 products are full
float32.  ``tree`` and ``kernels``, which every module that computes on
tensors imports, import it first.  The package itself imports no torch:
the host-only layers (``population``'s trace phase, ``scenarios``'
specs, cache, grid and reports, ``sim``, ``obs``) load without it.
"""
