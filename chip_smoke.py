#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports only ``repro_torch`` (from ``src/``), ``torch``, ``numpy`` and the
standard library, and runs these phases in order; any failure raises and the
script exits non-zero, printing no result:

  1. card    — the card's name and power limit from ``nvidia-smi``;
  2. build   — ``nvcc`` builds every kernel of the serving, training and
     evaluation paths from ``src/repro_torch/csrc`` (one process per
     source, all at once) and prints each kernel's registers, static
     shared memory and spills as ``ptxas -v`` reported them, and the HMMA
     (tensor-core) instructions of each flash and ghost-norm kernel where
     ``cuobjdump`` exists (the bf16 flash kernels and every ghost-norm
     instantiation, one per (a, g) dtype pair, must have some); the
     decode kernel must have its split and combine kernels at every head
     dim it takes (32, 64, 128, 192, 256) in both dtypes, with no spills
     at 192 and 256; the flash kernel its tensor-core and SIMT kernels at
     every head dim it takes (32, 64, 128, 192, 256), none of them
     spilling;
  3. kernel vs plain — each kernel against its plain PyTorch version on
     the card, in bfloat16 and float32, and against a second launch on the
     same inputs bit for bit: ``decode_attention`` at the shapes of
     ``tests/test_kernels.py``, the serving shape and a long cache, the
     model zoo's decode shapes (phase 20: head dims 128, 192 and 256,
     groups 1, 6, 8 and 12), with
     per-row indices that include 0 and L-1, and at the edges of its split
     kernel's chunks (index 0, one below, at and one above a chunk
     boundary, a window across two chunks, L not a multiple of the chunk,
     rows of one batch far apart), at 1e-4 in float32 and atol 1e-3 +
     rtol 1e-2 in bfloat16; ``ghost_norm`` at the shapes of
     ``tests/test_kernels.py``, at the training shapes (B=16, S=256,
     every dense layer of SmolLM-360M and its head), at the "lm" presets'
     full-size shapes (B=16, S=64, every dense layer of d 256 and the
     256 -> 1024 head) and at its tiles' and
     copies' edges (ragged S, widths of one K-step, rows that are not
     16-byte multiples, base addresses off 16 bytes), in every (a, g)
     dtype pair (bf16 and float32 either way round too, as a round meets
     them once the parameters are float32), at rtol 1e-4, and bit for bit
     on a second launch; ``flash_attention`` at the
     shapes of ``tests/test_kernels.py`` (MQA, a window, non-causal), L != S,
     the evaluation shape (B=8, S=2048, 15 heads on 5) and the edges of its
     tiles (ragged S and L, windows of 1, one key tile and three, groups of
     1, 4 and 5, rows that see no key, D = 32 and 128), and at head dims
     192 and 256 (Gemma-7B's and Nemotron-4-340B's heads, MQA, windows,
     ragged tiles, rows that see no key), at atol = rtol =
     3e-5 in float32 and atol 1e-3 + rtol 1e-2 in bfloat16 (a few output
     ulps), each dtype through its own kernel (tensor cores for bf16);
  4. serve main path — ``ServeEngine`` serves SmolLM-360M at full width in
     bfloat16 (seeded random weights) over a seeded open-loop trace; every
     request must complete, and the decode kernel's launch count must equal
     n_layers x (decode steps + prefill positions);
  5. serve whole path — at full width in float32, ``decode_kernel=True``
     against ``decode_kernel=False`` (the model's plain attention): the
     same greedy tokens, logits within atol 1e-3;
  6. train main path — ``arms.run("decaph", ...)`` trains SmolLM-360M with
     an untied head (408,944,640 parameters) at full width for 3 rounds on
     4 ``token_silos`` hospitals (64 sequences of 256 tokens each, batch
     16, sigma 1.0) with ghost clipping: 3 rounds complete, the losses are
     finite, ε is the accountant's, one program call per round, and
     ``ghost_norm`` launches 225 times per participant and round; every
     round is published by a ``CheckpointPublisher(keep_last=2)`` on
     ``on_round`` (the round wall times exclude it; its time per round and
     the file size are printed);
  7. train whole path — one sigma = 0 round in float32 with the kernel and
     one with the plain ghost norm: the norms agree at rtol 1e-4 and the
     two rounds' updates (trained - initial parameters) within 1e-5 in L2;
  8. eval main path — with ``use_flash``, full-sequence ``forward``,
     ``loss_fn`` and ``predict_fn`` of SmolLM-360M (untied head, full
     width) under ``torch.no_grad()`` score 4 held-out ``token_silos``
     hospitals x 2 sequences of 2048 tokens, once with seeded bf16 weights
     and once with phase 6's trained float32 parameters: finite logits and
     loss, exactly 32 ``flash_attention`` launches per forward, all of the
     dtype's kernel (tensor-core bf16, CUDA-core float32), and
     ``predict_fn`` the forward's argmax at the last position; prints the
     pooled next-token accuracy and the mean cross-entropy;
  9. eval whole path — at full width in float32, the forward with
     ``use_flash`` (the kernel) against the model's plain ``_sdpa``:
     logits within atol 1e-3, the same argmax wherever the top two differ
     by more than 2e-3; then the bf16 forward once, with each of the 32
     layers' kernel output held against ``attention_plain`` on that layer's
     own q, k and v at the bf16 limit of phase 3;
 10. blocked training — one sigma = 0 float32 ghost round at full width and
     4 layers (B=4, S=1024: two KV blocks) with ``use_flash``
     (``_sdpa_blocked``) against one without: updates within 1e-5 in L2,
     and no ``flash_attention`` launch;
 11. times — each kernel, its plain version and one PyTorch library call
     (a yardstick the port never calls) on CUDA events, beside the least
     time the card could take (float32 ghost-norm products at the 3xTF32
     rate, a third of TF32's); a training round's wall time, a profiled
     round's device busy time and ``ghost_norm`` share, the wall time of
     one evaluation forward and the flash kernel's share of it, and a
     profiled evaluation forward's device busy time, idle share and top
     device ops; ``flash_attention`` also at Gemma-7B's heads (16 on 16 of
     256) and Nemotron-4-340B's (96 on 8 of 192), B=8 S=L=2048 causal, in
     both dtypes;
 12. hot swap — a float32 ``ServeEngine`` (SmolLM-360M, untied head, full
     width, 8 slots x 512, the decode kernel, greedy) starts from seeded
     weights at round -1, admits 4 requests and steps; ``poll_watcher``
     swaps in the newest round phase 6 published (the last one), without
     reallocating the KV cache, and the swapped parameters must be phase
     6's final ones bit for bit; the in-flight requests finish their full
     budget, and 4 requests admitted after the swap emit the greedy tokens
     of an engine built directly from phase 6's parameters (same slots,
     same steps); then ``run_open_loop`` with the watcher serves a seeded
     trace, every request completes, and every step samples
     ``latest_round`` = ``serving_round`` = the last round; prints the
     load-and-swap time, and the publish and the load in their parts
     (copy to the host, write, read and decode, copy to the card);
 13. tabular main path — the paper's own DeCaPH, noise shares behind
     fixed-point SecAgg, at paper scale through ``arms.run("decaph", ...)``
     on ``ideal``: the pancreas MLP 15558-1000-100-4 (15,659,504
     parameters) on ``make_pancreas_like`` (10,548 cells, 5 hospitals),
     batch 96, sigma 1.0, 3 rounds; the GEMINI MLP 436-300-100-50-10-1 on
     ``make_gemini_like`` (40,114 admissions, 8 hospitals, 28 mask pairs);
     the DenseNet's "full" preset on ``make_xray_like`` (1,800 images of
     32 x 32, 3 hospitals).  Each: 3 rounds, finite losses, ε the
     accountant's, one program call per round, each aggregate batch the
     round's Poisson total (``secure_sum_ints``), and each round's decoded
     secure sum within n * 2^-17 (+ float32 rounding) of the float64 sum
     of the payloads that left the card.  Prints a steady pancreas round's
     wall time and its parts (cohort step, the payloads' copy to the host,
     encode and masks, aggregate and decode, the copy back), bytes per
     upload, peak memory, a profiled round's device idle share and each
     model's pooled accuracy (printed only); then ``python -m
     repro_torch.run --arm decaph --rounds 3`` (``main``) on the card by
     default;
 14. tabular whole path — in float32 at sigma 0: one pancreas round with
     SecAgg against the same round without it, every coordinate of the
     update within lr * n * 2^-17 / batch plus float32 rounding; and
     ``ghost_clipped_grad_sum_mlp`` against ``per_example_clipped_grad_sum``
     on one Poisson batch of the full-width pancreas MLP (clipped sums
     within 1e-5 relative in L2, norms at rtol 1e-5);
 15. comparison arms — on phase 13's GEMINI configuration (8 hospitals,
     batch 128, sigma 1.0, 3 rounds; the node arms 3 local steps each)
     ``fl``, ``fl`` with ``fl_local_steps=3``, ``fedprox``, ``scaffold``,
     ``primia``, ``local``, ``gossip`` and ``gossip-dp`` on ``ideal``:
     finite parameters, ε 0 for the non-private arms and each client's ε
     its own fresh ``RDPAccountant``'s for the private ones, exactly one
     program call per round for every round arm; round walls, logged and
     pooled losses; ``fl`` and ``primia`` once more with
     ``fused_rounds=False`` at sigma 0, within 1e-5 of the fused round;
     then ``primia`` on SmolLM-360M (untied head, full width, phase 6's
     silos, batch 16, sigma 1.0) for 2 rounds with ghost clipping: 225
     ``ghost_norm`` launches per participant and round (counted from 0 for
     this run and added to the kernels line), one program call per round,
     each client's ε its accountant's;
 16. simulated time — phase 13's pancreas DeCaPH with SecAgg on ``sim``
     (``nodes_from_trace(heterogeneous_trace(5))``): on the clean trace
     the parameters and losses are bit-identical (``torch.equal``) to phase
     13's ``ideal`` run; then the slowest hospital that does not lead round
     1 drops out a quarter into round 1's upload window and rejoins before
     round 2: at least one Shamir recovery and one noise top-up, every
     secure total (with its top-up) within n half-steps of the fixed-point
     grid plus float32 rounding of the float64 sum of the delivered
     payloads plus the top-up, ε the accountant's; prints ``SimTiming`` and
     the host ms of the ``secagg.recover`` and ``noise_topup`` spans;
 17. privacy audit (Fig. 5) — ``core.mia.lira_attack`` at
     ``benchmarks/mia.py``'s fast scale (400 GEMINI-like admissions, 8
     shadows, 60 steps of MLP 436-64-16-1, lr 1.0) against an FL target
     and a DP target (C 1.0, sigma 0.8), every model trained on the card
     with the port's ``core.dp``: AUROC and TPR at 1% FPR finite in
     [0, 1], the ROC curve non-decreasing; the gap is printed only;
 18. the scenario suite — ``scenarios.run_spec`` on the presets
     ``lm-full`` (d 256, 4 layers, untied head, 4 hospitals x 48 x 64
     tokens, 8 rounds of batch 16, ghost clipping), ``gemini-full`` (MLP
     436-300-100-50-10-1, 8 hospitals, 5,000 examples, 12 rounds,
     SecAgg), ``gemini-5hospital`` and ``gemini-5hospital-churn``, each as
     the reference defines it, all on ``sim``: ε a fresh accountant's,
     ``lm-full`` one program call per round and 29 = 7 x 4 + 1
     ``ghost_norm`` launches per participant and round (added to the
     kernels line), every ``ghost_norm`` shape it meets among phase 3's,
     its pooled next-token accuracy in [0, 1] from a forward on the card;
     the ``capacity-lm`` sweep (6 cells, ``ideal``) through ``run_sweep``
     into a fresh cache, ghost cells launching ``ghost_norm`` (15 or 29
     per participant and round) and per-example cells none, each ghost
     cell's ε equal to its per-example twin's and its mean loss and
     accuracy within 1e-5 and 1e-3 of them, then replayed wholly from
     the cache (6 hits, the same rows); ``python -m
     repro_torch.scenarios --run gemini-small`` in a subprocess.  On
     every ghost path of phases 18-19 the first (a, g) of each shape and
     dtype pair is kept, and after the run's counts are read
     ``ghost_norm`` is held against its plain version on it (rtol 1e-4)
     and against a second launch bit for bit;
 19. the population backend — ``python -m repro_torch.population
     --hospitals 50,200,1000 --seeds 0 --check-determinism`` in a
     subprocess (the reference's ``population-scaling`` cells at seed 0,
     every graph re-traced byte for byte); the same spec at the paper's
     GEMINI width (MLP 436-300-100-50-10-1, 40,114 admissions, 1000
     hospitals, q 0.1, decaph sigma 0.8, 5 rounds): ε the accountant's at
     rate · q, one program call per executed round, mean cohort below
     1000, the trace's and each round's host ms, and a re-trace under
     ``cProfile`` (byte-identical; the share of ``Topology.neighbors``
     printed); and ``lm-full``'s model
     and silos at q = 1, sigma 0, 3 rounds on ``population`` bit for bit
     ``ideal`` (``torch.equal``), with the same ``ghost_norm`` launches.

 20. the model zoo served — after every earlier phase's memory is
     released (at least 64 GB free), Qwen3-30B-A3B (MoE, 128 experts top-8,
     30.53 B parameters) at full width in bf16, seeded on the card (init
     peak below 64 GB), behind ``ServeEngine`` with the decode kernel: 8
     slots x 512, 16 requests at 4 q/s through ``run_open_loop`` (prompts
     and outputs of 8-32 tokens): every request served, 48
     ``decode_attention`` launches per position, one program call per
     decode step and two per admission; tok/s, TTFT and TPOT p50/p99, a
     decode step's host and device ms and the device's idle share; one
     ``moe_apply`` at the decode shape under
     ``set_sync_debug_mode("error")``; the decode step twice and two
     greedy runs of 4 prompts bit for bit.  Then Gemma-7B (D 256),
     Qwen2-VL-2B (M-RoPE, group 6), OLMo-1B (``ln_nonparam``) at full width
     and Nemotron-4-340B at full width and 2 of its 96 layers (D 192, group
     12): ``batch_generate`` of 8 prompts of 8 tokens x 16 greedy tokens
     in bf16 with the kernel and with ``decode_kernel=False``: n_layers
     launches per position and none without, ms per step, the rows whose
     tokens agree (bf16 near-ties split some), and every layer's kernel
     output of the first decode step held against its plain version on
     that layer's own q, k and v at phase 3's bf16 limit; then the same
     width in float32 (phase 5's check): greedy tokens with and without
     the kernel identical, teacher-forced logits within atol 1e-3.
     Gemma-7B (2 sequences of 2048 tokens) and Nemotron-4-340B (2 layers,
     1 sequence of 2048) also evaluate with ``use_flash``: the bf16
     forward's every layer's kernel output held against ``attention_plain``
     on that layer's own q, k and v at phase 3's bf16 limit, and the
     float32 forward with the kernel against the plain ``_sdpa`` within
     atol 1e-3;
 21. DeCaPH on the zoo's families — OLMo-1B at full width (untied head,
     non-parametric LayerNorm) on 4 ``token_silos`` hospitals x 32 x 256
     tokens, batch 16, sigma 1.0, 2 rounds with ghost clipping: ε a fresh
     accountant's, one program call per round, ``ghost_norm`` launches per
     participant and round = its dense weights per layer x 16 + 1 (113),
     the round walls; every (a, g) shape the path gave the kernel (d 2048
     -> 8192, 8192 -> 2048, 2048 -> 50304 among them) held against the
     plain version at rtol 1e-4 and a second launch; Qwen3-30B-A3B's smoke
     config in 2 rounds of faithful DeCaPH (per-example gradients through
     the MoE dispatch) at sigma 0, run twice, bit for bit.
 22. the recurrent mixers served — ``rwkv6-3b`` whole at full width in
     bf16 (2.86 B parameters), behind ``ServeEngine`` with the decode
     kernel over phase 4's trace (8 slots x 512, 16 requests at 16 q/s):
     every request served, no ``decode_attention`` launch (no attention
     layer), one program call per decode step and two per admission; tok/s,
     TTFT and TPOT p50/p99, a decode step's host and device ms and idle
     share, the recurrent state per slot; the step twice bit for bit and
     under ``set_sync_debug_mode("error")``.  Then Jamba-v0.1-52B at full
     width with 2 of its 4 blocks (16 layers, 26.05 B parameters; cut to
     what one card holds): the init's peak memory, ``batch_generate`` of 8
     prompts of 8 tokens x 16 greedy tokens with the kernel and with
     ``decode_kernel=False`` (2 launches per position, its attention
     layers', and none), ms per step, each attention layer's kernel output
     of the first decode step held against the plain version on its own
     inputs at phase 3's bf16 limit, the step twice bit for bit and with no
     host sync.  Then in float32, ``rwkv6-3b`` whole and Jamba at 1 block
     (at capacity factor = experts, so no choice is dropped): greedy tokens
     with and without the kernel identical, teacher-forced decode logits
     against ``forward`` within atol 1e-3.
 23. the zoo's last two architectures — DeepSeek-V3 at full width with its
     3 dense layers and 2 of its 58 MoE layers (26.62 B parameters, 53.24
     GB in bf16; init peak printed), behind ``ServeEngine`` over a seeded
     open-loop trace (8 slots x 512, 8 requests at 2 q/s, prompts and
     outputs of 8-16 tokens): every request served, one program call per
     decode step and two per admission, no ``decode_attention`` launch
     (MLA's absorbed decode is plain products over the compressed cache);
     tok/s, TTFT and TPOT, a decode step's host and device ms and idle
     share beside its bytes (every weight but the embedding) over the HBM
     rate, the MLA cache per slot; the MoE layer with no host sync; each
     MLA layer's absorbed decode over a 16-token prefill against
     ``mla_apply`` on the same inputs within bf16's 3e-2.  In float32 at
     3 dense + 1 MoE layer (capacity factor 256) teacher-forced
     ``decode_step`` against ``forward`` below 5e-4; with ``mtp_depth=1``
     (3 dense + 1 MoE layer and the MTP block, bf16) ``loss_fn`` on 2 x
     256 tokens finite and above the loss without MTP, with its wall.
     Then Whisper-small whole on seeded stub frames [8, 1500, 768]: the
     ``use_flash`` forward at decoder length 448 (12 ``flash_attention``
     launches, none for the non-causal encoder; bf16 each decoder layer
     against ``attention_plain`` on its own inputs; float32 logits within
     1e-4 of the plain forward), ``_encode`` once with each layer's
     ``cross_kv_cache`` written into the cache, a prefill of 8 tokens and
     16 greedy tokens through ``decode_step_positions`` with the kernel
     (12 launches a position, the first decode step's layers against the
     plain version in bf16, host and device ms a step), in float32 the
     same tokens without the kernel and decode against forward below
     5e-4; ``ServeEngine`` refusing the arch.  Phase 3 holds both kernels
     at Whisper's group 1, D 64 and phase 11 times them there.
 24. the launch layer — ``launch.steps.build_program`` for SmolLM-360M at
     full width: the ``train_4k`` programs (ghost, per-example, no DP)
     allocate nothing on the card and their meta ``args`` are a 256 x 4096
     batch, ``tf.init``'s tree and dtypes and the AdamW state's; each runs
     2 timed steps and a profiled one (device busy, idle share, top device
     ops; the ghost program a fourth under ``analyze_program``) on a
     ``make_lm_stream`` batch cut to 16 x 256 (256 x 4096 would need far
     more than the card's 80 GB of ghost activations): finite losses, 225
     ``ghost_norm`` launches a ghost step (7 a layer + the head) and none
     otherwise, each step's wall beside ``dp_round_roofline`` of it on the
     H100's constants and ``analyze_program``'s ATen FLOPs plus the Grams'
     ``ghost_norm_flops``, and peak memory.  At sigma 0 with SGD (lr 0.05),
     untied and in float32 (a tied head's norm is not the per-example
     norm, and bf16 rounds the two paths' gradients apart), the ghost
     program's update against the per-example program's within
     2 lr C 1e-4 in L2 (phase 7's bound).  ``python -m
     repro_torch.launch.train --arch smollm-360m --scale full --steps 3
     --batch 8 --seq 256 --checkpoint`` (``main``, AdamW, per-example, on
     the card by default): finite losses, ε a fresh ``RDPAccountant``'s bit
     for bit, the checkpoint read back leaf for leaf.  The ``prefill_32k``
     and ``decode_32k`` programs: no allocation, their meta ``args``
     (cache [32, 128, 32768, 5, 64] bf16), then on a cut of 8 x 2048 the
     prefill's logits bit for bit ``tf.forward``'s and 4 decode steps'
     ``tf.decode_step``'s.  ``python -m repro_torch.launch.serve`` at its
     defaults: n_layers ``decode_attention`` launches a position, the
     same greedy tokens from ``batch_generate`` on the same engine and from
     an engine on the same weights with ``decode_kernel=False`` (float32:
     the model's plain attention, no launch); phase 3 holds the kernel at
     this shape, 4 slots x 48.
 25. the last one-card modules — the PATE baseline against DeCaPH at
     ``benchmarks/pate_ablation.py``'s settings at paper scale (GEMINI-like,
     40,114 admissions, 8 hospitals, 80/20 split, the public pool a quarter
     of the test split; MLP 436-64-16-1, batch 128, lr 0.5, sigma for ε 4,
     no SecAgg; 60 rounds, cut from 400): ``run_decaph`` (ε the
     accountant's) and ``run_pate`` at GNMax sigma 2 and 8 (ε
     ``rdp_to_eps_delta`` of |pool| x α / (2 sigma²) bit for bit), each
     run's held-out AUROC, ε and wall, PATE's split into its teachers,
     labelling and student spans.  The deprecated ``run_decaph`` on phase
     6's SmolLM-360M (untied head, full width, 4 hospitals x 64 x 256
     tokens, ghost clipping, sigma 1.0, 2 rounds): 225 ``ghost_norm``
     launches per participant and round (added to the kernels line), bit
     for bit ``arms.run("decaph", ...)`` with ``fused_rounds=False`` and
     with the fused default.  The deprecated ``simulate_decaph`` on phase
     16's pancreas with dropout-robust SecAgg and phase 16's dropout trace,
     built through ``scenario_from_trace``: bit for bit phase 16's
     ``arms.run(..., backend="sim")``, ``SimTiming`` included, and each
     legacy property (``wall_clock``, ``recoveries``, ...) its ``timing``
     field.  ``python -m repro_torch.run --arm decaph --obs DIR`` on the
     card, then ``python -m repro_torch.obs``: ``--validate`` exits 0 and
     1 on a copy with one ledger entry's ε halved, ``--to-chrome`` writes
     a trace ``validate_chrome_trace`` accepts, and the summary's
     per-hospital ε is the run's (the accountant's).
 26. shard — the multi-card layer on ranks that share the one card:
     each rank is ``python3 chip_smoke.py --shard-rank CELL OUT``,
     spawned by ``repro_torch.launch.ranks.spawn`` into a ``gloo`` group
     (NCCL refuses two ranks on one device), so every collective is
     staged through host memory, DTensor's too.  (a) Phase 13's GEMINI
     DeCaPH (8 hospitals, paper width, sigma 1.0, 3 rounds, SecAgg off)
     on 2 ranks ("data",): max|params - ideal's| <= 1e-5, ε identical,
     ``sharded_puts > 0``.  (b) Phase 6's SmolLM-360M (untied, 4
     hospitals x 64 x 256, batch 16, ghost clipping, 2 rounds) at full
     width cut to 4 of 32 layers, in float32 (phase 7's dtype, where PR
     12's bound holds), on 4 ranks (1, 2, 2) ("pod", "data", "model"),
     at the same time as (a)'s ranks:
     ``participant_shards > 0`` and ``param_shards > 0`` on every rank,
     the update within 2 lr C 1e-4 of ideal's (L2), the summed peak under
     80 GB; ``ghost_norm`` on rank 0's local-shard inputs against its
     plain version at phase 3's limit; every rank's launches go to the
     kernels line; per rank the peak memory, the round walls and the
     collectives' bytes and seconds by kind (host-staged, not NVLink).
     The dry run (``python -m repro_torch.launch.dryrun``, meta DTensors
     on a ``fake`` group, on the CPU under the card machine's torch), one
     process a cell started with the phase: SmolLM-360M ``train_4k``
     (per-example DP) on (4, 2), OLMo-1B ``train_4k`` on (2, 2, 2),
     SmolLM-360M ``decode_32k`` on (4, 2) and SmolLM-360M ``prefill_32k``
     on the (16, 16) mesh: each one's FLOPs, collective bytes, bottleneck
     and trace seconds; the phase fails if one exits non-zero.

Artifacts and caches of phases 18–19, 25 and 26 go into temp dirs under
``build/``.
The next-to-last line is one JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import cProfile
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import pstats
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.arms as arms  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    active_param_count,
    dense_stack,
    param_count,
)
from repro_torch.core import ghost as ghost_lib  # noqa: E402
from repro_torch.core.accountant import RDPAccountant  # noqa: E402
from repro_torch.core.dp import DPConfig  # noqa: E402
from repro_torch.instrument import jit_dispatches, reset_jit_dispatches  # noqa: E402
from repro_torch.kernels import KERNEL_SOURCES, _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_plain  # noqa: E402
from repro_torch.kernels.ghost_norm import ops as ghost_ops  # noqa: E402
from repro_torch.kernels.ghost_norm.ops import ghost_norm_blocked  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve.federation import token_silos, transformer_model  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.convert import params_from_tree, params_to_tree  # noqa: E402
from repro_torch.tree import tree_device, tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServeEngine, batch_generate  # noqa: E402
from repro_torch.serve.handoff import (  # noqa: E402
    CheckpointPublisher,
    CheckpointWatcher,
    checkpoint_path,
    list_rounds,
)
from repro_torch.serve.metrics import summarize  # noqa: E402
from repro_torch.serve.traffic import (  # noqa: E402
    Request,
    TrafficConfig,
    generate_requests,
    run_open_loop,
)
import repro_torch.run as run_cli  # noqa: E402
from repro_torch.arms import fused as fused_lib, runners  # noqa: E402
from repro_torch.arms.base import batch_loss_fn, poisson_batch  # noqa: E402
from repro_torch.core import dp as dp_lib, secagg  # noqa: E402
from repro_torch.data import (  # noqa: E402
    make_gemini_like,
    make_pancreas_like,
    make_xray_like,
)
from repro_torch.models import tabular  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro_torch.core import mia as mia_lib  # noqa: E402
from repro_torch.core.leader import leader_schedule  # noqa: E402
from repro_torch.sim import heterogeneous_trace, nodes_from_trace  # noqa: E402
from repro_torch.sim import Topology  # noqa: E402
import repro_torch.scenarios as scenario_lib  # noqa: E402
from repro_torch.scenarios import presets as presets_lib  # noqa: E402
from repro_torch.scenarios.executor import n_params  # noqa: E402
from repro_torch.population.backend import PopulationRunner  # noqa: E402
from repro_torch.population.spec import PopulationSpec  # noqa: E402
from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.data import make_lm_stream  # noqa: E402
from repro_torch.launch import roofline as roofline_lib  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.optim import get_optimizer  # noqa: E402
from repro_torch.core import federation  # noqa: E402
from repro_torch.core.accountant import (  # noqa: E402
    DEFAULT_ORDERS,
    rdp_to_eps_delta,
    sigma_for_epsilon,
)
from repro_torch.data.partition import train_test_split_silos  # noqa: E402
from repro_torch.obs.convert import validate_chrome_trace  # noqa: E402
from repro_torch.sim import protocols  # noqa: E402
from repro_torch.launch import federated as federated_lib  # noqa: E402
from repro_torch.launch.mesh import make_host_data_mesh, make_mesh  # noqa: E402
from repro_torch.launch.ranks import init_rank, spawn  # noqa: E402

ARCH = "smollm-360m"
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the ghost-norm kernel's float32 products are three TF32 products each
# (3xTF32 on the tensor cores), so the least time for its float32 work is
# at a third of the TF32 peak; its bf16 products at the bf16 peak
GHOST_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
L2_BYTES = 50 * 2**20
# a library call against the plain version, before it is timed as a
# yardstick (SDPA may round P to bf16, so bf16 gets test_kernels.py's 3e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# decode kernel against its plain version, |err| <= atol + rtol |plain|.
# bfloat16: both sides accumulate in float32 from the same bf16 inputs and
# differ by the output's rounding (<= 1 ulp, 2^-8 of |plain|), as in
# FLASH_TOL; an absolute 3e-2 is as large as the typical output (~0.03 on
# a long cache) and would pass a wrong tile
DECODE_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 1e-2)}

# the serving shape: 8 slots of SmolLM-360M (15 query heads on 5 KV heads of
# 64) with 512 cache rows each, and the same at a long cache
SERVE_SHAPE = dict(b=8, l=512, h=15, kv=5, d=64)
# where the serve main path's positions are (prompts and outputs of a few
# dozen tokens); the decode step is timed there too
SERVE_POSITION = 64
LONG_SHAPE = dict(b=8, l=4096, h=15, kv=5, d=64)

# (b, l, h, kv, d, index, window): the decode shapes of tests/test_kernels.py,
# the serving shape, the long cache and a windowed MQA case at serving width
KERNEL_CASES = [
    (2, 256, 4, 2, 32, 100, None),
    (1, 512, 8, 8, 64, 511, None),
    (2, 256, 4, 1, 32, 200, 64),
    (1, 1024, 4, 4, 128, 0, None),
    (8, 512, 15, 5, 64, None, None),
    (8, 4096, 15, 5, 64, None, None),
    (8, 512, 15, 1, 64, None, 128),
    # the zoo's decode shapes (phase 20): Qwen3-30B-A3B's 8 slots x 512 (32
    # query heads on 4 KV heads of 128), the batch_generate caches of
    # Gemma-7B (16 on 16 of 256), Qwen2-VL-2B (12 on 2 of 128), OLMo-1B (16
    # on 16 of 128) and Nemotron-4-340B (96 on 8 of 192), the two new head
    # dims at 512 rows, and a window at D = 256
    (8, 512, 32, 4, 128, None, None),
    (8, 64, 16, 16, 256, None, None),
    (8, 64, 12, 2, 128, None, None),
    (8, 64, 16, 16, 128, None, None),
    (8, 64, 96, 8, 192, None, None),
    (8, 512, 16, 16, 256, None, None),
    (8, 512, 96, 8, 192, None, None),
    (2, 300, 16, 16, 256, 150, 64),
    # Whisper-small's decoder (phase 23): group 1, 12 heads of 64, over the
    # 8 rows x 24 of its greedy decode and over 8 slots x 512
    (8, 24, 12, 12, 64, None, None),
    (8, 512, 12, 12, 64, None, None),
    # launch.serve at its defaults (phase 24): SmolLM-360M smoke, 4 slots x
    # 48 (32-token prompts + 16), 4 query heads on 2 of 32
    (4, 48, 4, 2, 32, None, None),
]
# decode_attention at the zoo's new head dims, timed beside the main shape:
# Gemma-7B's and Nemotron-4-340B's attention at 8 slots x 512
NEW_HEAD_DIMS = (192, 256)    # the decode kernel's, added for the zoo
ZOO_DECODE_SHAPES = [dict(b=8, l=512, h=16, kv=16, d=256),
                     dict(b=8, l=512, h=96, kv=8, d=192)]
# Whisper-small's decoder heads (group 1, D 64) at 8 slots x 512
WHISPER_DECODE_SHAPE = dict(b=8, l=512, h=12, kv=12, d=64)

# ghost_norm (b, s, d_in, d_out): the shapes of tests/test_kernels.py, then
# the training shapes — B=16 rows of S=256 tokens through SmolLM-360M's dense
# layers (q and o 960->960, k and v 960->320, up and gate 960->2560, down
# 2560->960) and its untied head (960->49152) — with the launches of each per
# participant and round
GHOST_TEST_CASES = [(2, 64, 32, 16), (1, 96, 48, 48), (3, 128, 64, 8),
                    (2, 32, 16, 16)]
# the edges of the kernel's tiles (64 rows) and copies (16 bytes): ragged S;
# widths of one 32-byte K-step (8 float32, 16 bf16 columns); rows that are
# not 16-byte multiples (100, 70 and 33 columns: 200, 140, 66 bytes in
# bf16, 400, 280, 132 in float32), which take 8-, 4- and 2-byte copies;
# one tile pair over wide rows, which split_plan shares among 8 blocks
GHOST_EDGE_CASES = [(4, 300, 100, 70), (2, 100, 33, 37), (2, 64, 8, 16),
                    (1, 65, 16, 8), (3, 200, 960, 320), (1, 64, 4096, 4096)]
# (shape, storage offset in elements): a and g views that start 1, 2 or 3
# elements into their buffers, off a 16-byte address, so the kernel takes
# its narrower copies at widths whose rows are 16-byte multiples
GHOST_OFFSET_CASES = [((2, 128, 64, 48), 1), ((2, 256, 960, 2560), 2),
                      ((3, 100, 40, 24), 3)]
GHOST_TRAIN_SHAPES = {(16, 256, 960, 960): 64, (16, 256, 960, 320): 64,
                      (16, 256, 960, 2560): 64, (16, 256, 2560, 960): 32,
                      (16, 256, 960, 49152): 1}
# the "lm" presets' shapes at their full size (phase 18's lm-full and phase
# 19's q = 1 run): the Poisson pad of B=16 rows of S=64 tokens through d 256
# (q and o 256->256, k and v 256->128, up and gate 256->512, down 512->256)
# and the untied head (256->1024); phase 18 also holds every shape it
# records on that path against this list
GHOST_LM_SHAPES = [(16, 64, 256, 256), (16, 64, 256, 128), (16, 64, 256, 512),
                   (16, 64, 512, 256), (16, 64, 256, 1024)]
GHOST_ROW_SHAPE = (16, 256, 960, 2560)   # the kernels line's ghost_norm times
GHOST_RTOL = 1e-4   # kernel vs plain: the same float32 sums, other order

# the training run: 4 hospitals x 64 sequences of 256 tokens, batch 16
TRAIN = dict(hospitals=4, n_per=64, seq_len=256, rounds=3, batch_size=16,
             lr=0.05, clip=1.0, sigma=1.0)
TRAIN_PARAMS = 408_944_640   # SmolLM-360M, untied head (param_count: no norms)

# flash_attention (b, s, l, h, kv, d, causal, window): the shapes of
# tests/test_kernels.py, keys longer than the queries, the evaluation shape
# (8 sequences of 2048 tokens through SmolLM-360M's 15 heads on 5), then the
# edges of the kernels' tiles (64 query rows; 64 keys in bf16, 32 in
# float32): ragged S and L, windows of 1, of one key tile and across three,
# groups of 1, 4 and 5, and L < S with a window, where late rows see no key
# and come out 0 (with L > S every row i sees key i); then head dims 256
# and 192 (32-key tiles in bf16, 32 query rows a block in float32) at
# Gemma-7B's and Nemotron-4-340B's heads and the same kinds of edges
FLASH_CASES = [
    (1, 128, 128, 4, 2, 32, True, None),
    (2, 128, 128, 4, 4, 64, True, 32),
    (1, 256, 256, 8, 2, 32, False, None),
    (1, 128, 128, 2, 1, 128, True, None),
    (2, 64, 192, 6, 2, 64, True, 48),
    (8, 2048, 2048, 15, 5, 64, True, None),
    (2, 96, 96, 15, 5, 64, True, None),
    (1, 200, 200, 15, 5, 64, True, None),
    (1, 200, 200, 15, 5, 64, True, 1),
    (2, 256, 256, 4, 4, 64, True, 64),
    (1, 320, 320, 8, 2, 64, True, 150),
    (1, 128, 128, 5, 1, 32, True, None),
    (1, 128, 320, 8, 2, 64, True, 100),
    (1, 200, 72, 15, 5, 64, True, 40),
    (1, 96, 160, 4, 1, 64, False, 50),
    (1, 200, 200, 4, 2, 32, True, 70),
    (2, 200, 200, 8, 2, 128, True, None),
    (2, 256, 256, 16, 16, 256, True, None),
    (1, 200, 200, 96, 8, 192, True, None),
    (1, 130, 130, 8, 1, 256, True, 40),
    (1, 200, 200, 6, 2, 192, True, 1),
    (1, 96, 160, 4, 1, 256, False, 50),
    (1, 200, 72, 6, 2, 192, True, 40),
    (2, 33, 33, 4, 4, 256, True, None),
    # Whisper-small's decoder under use_flash (phase 23): group 1, 12 heads
    # of 64 at 448 tokens (7 query tiles, the kernel's only blocks), and a
    # ragged length
    (8, 448, 448, 12, 12, 64, True, None),
    (2, 100, 100, 12, 12, 64, True, None),
]
# |kernel - plain| <= atol + rtol * |plain|, as (atol, rtol).  float32:
# test_kernels.py's 3e-5.  bfloat16: both sides accumulate in float32 from
# the same bf16 inputs (the kernel on tensor cores, with P in two bf16 terms,
# about 2^-17 of each probability) and differ by the output's rounding
# (<= 1 ulp, 2^-8 of |plain|), so rtol 1e-2 (2.5 ulps) and atol 1e-3, under
# the typical output of ~0.03 on a long row; test_kernels.py's 3e-2 would
# pass a wrong tile.
FLASH_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (1e-3, 1e-2)}
EVAL_SHAPE = dict(b=8, s=2048, h=15, kv=5, d=64)
# flash_attention at the zoo's head dims, timed beside the evaluation shape:
# Gemma-7B's and Nemotron-4-340B's attention over 8 sequences of 2048
ZOO_FLASH_SHAPES = [dict(b=8, s=2048, h=16, kv=16, d=256),
                    dict(b=8, s=2048, h=96, kv=8, d=192)]
# Whisper-small's decoder forward: 8 sequences of 448, group 1, D 64
WHISPER_FLASH_SHAPE = dict(b=8, s=448, h=12, kv=12, d=64)

# the evaluation: 4 held-out hospitals x 2 sequences of 2048 tokens (B=8),
# scored with use_flash at full width
EVAL = dict(hospitals=4, n_per=2, seq_len=2048, seed=1)
# the blocked training round: full width, 4 layers, B=4 rows of S=1024
# tokens, so _sdpa_blocked's 512-key blocks really are two
BLOCKED = dict(n_layers=4, hospitals=2, n_per=8, seq_len=1024, batch_size=4)

# one entry per kernel on the serving, training and evaluation paths
KERNELS = [{
    "name": "decode_attention",
    "route": "cuda",
    "source": "src/repro_torch/csrc/decode_attention.cu",
    "replaces": "src/repro/kernels/decode_attention/kernel.py:68",
}, {
    "name": "flash_attention",
    "route": "cuda",
    "source": "src/repro_torch/csrc/flash_attention.cu",
    "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
}, {
    "name": "ghost_norm",
    "route": "cuda",
    "source": "src/repro_torch/csrc/ghost_norm.cu",
    "replaces": "src/repro/kernels/ghost_norm/kernel.py:44",
}]


def say(*parts) -> None:
    print(*parts, flush=True)


def lap(t0: float, done: str) -> None:
    """The script's seconds so far, after the phases ``done`` names."""
    say(f"elapsed: {time.perf_counter() - t0:.1f} s after {done}")


# -- 1. card --------------------------------------------------------------------


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    say(line)
    return line


# -- 2. build -------------------------------------------------------------------


def _short(kernel: str) -> str:
    """A demangled kernel name without its anonymous namespace, the casts
    of its template arguments, its return type and its parameters."""
    name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:unsigned )?int\)",
                  "", kernel)
    return name.split("(", 1)[0].removeprefix("void ")


def build() -> None:
    """Build every source; print each kernel's registers, static shared
    memory and spills as ptxas reported them, the ghost-norm kernel's
    dynamic shared memory and resident blocks per SM, and the tensor-core
    (HMMA) instructions per flash and ghost-norm kernel."""
    spent = _build.build(KERNEL_SOURCES)
    say(f"build: {', '.join(f'{n}.cu' for n in KERNEL_SOURCES)} -> "
        f"{', '.join(_build.library_path(n).name for n in KERNEL_SOURCES)} "
        f"in {spent:.2f} s")
    for name in KERNEL_SOURCES:
        for r in _build.resources(name):
            say(f"resources: {name}.cu {_short(r['kernel'])}: "
                f"{r['registers']} registers, {r['smem']} B static shared "
                f"memory, {r['stack']} B stack, spills {r['spill_stores']} B "
                f"stored / {r['spill_loads']} B loaded")
    decode = {_short(r["kernel"]): r
              for r in _build.resources("decode_attention")}
    for d in decode_ops.HEAD_DIMS:
        for dt in ("float", "__nv_bfloat16"):
            rows = [decode.get(f"decode_{part}_kernel<{dt}, {d}>")
                    for part in ("split", "combine")]
            if None in rows:
                raise AssertionError(f"decode_attention.cu has no kernels "
                                     f"for {dt} at head_dim {d}")
            if d in NEW_HEAD_DIMS and any(r["spill_stores"] for r in rows):
                raise AssertionError(f"decode_attention.cu spills at "
                                     f"head_dim {d}")
    say(f"resources: decode_attention.cu split + combine kernels for head "
        f"dims {decode_ops.HEAD_DIMS} in float32 and bf16; no spills at "
        f"{NEW_HEAD_DIMS}")
    flash = {_short(r["kernel"]): r
             for r in _build.resources("flash_attention")}
    for d in flash_ops.HEAD_DIMS:
        rows = [flash.get(f"flash_attention_{kind}_kernel<{d}>")
                for kind in ("mma", "simt")]
        if None in rows:
            raise AssertionError(f"flash_attention.cu has no kernels at "
                                 f"head_dim {d}")
        if any(r["spill_stores"] or r["spill_loads"] for r in rows):
            raise AssertionError(f"flash_attention.cu spills at head_dim {d}")
    say(f"resources: flash_attention.cu mma (bf16) + simt (float32) kernels "
        f"for head dims {flash_ops.HEAD_DIMS}; no spills")
    for ta, tg in GHOST_DTYPES:
        blocks = ghost_ops.blocks_per_sm(ta, tg)
        say(f"resources: ghost_norm.cu ghost_norm_tiles a {str(ta)[6:]}, g "
            f"{str(tg)[6:]}: {ghost_ops.smem_bytes(ta, tg)} B dynamic shared"
            f" memory, {blocks} blocks resident per SM")
        if blocks < 2:
            raise AssertionError("fewer than 2 ghost-norm blocks fit on an SM")
    for name, tensor_core in (("flash_attention", "mma_kernel"),
                              ("ghost_norm", "ghost_norm_tiles")):
        hmma = _build.sass_counts(name, "HMMA")
        if hmma is None:
            say("sass: no cuobjdump on this machine; HMMA not counted")
            return
        say(f"sass: HMMA instructions in {name}.cu: " +
            ", ".join(f"{_short(k)} {n}" for k, n in hmma.items()))
        mma = [n for k, n in hmma.items() if tensor_core in k]
        want = len(flash_ops.HEAD_DIMS) if name == "flash_attention" else \
            len(GHOST_DTYPES)
        if len(mma) != want or min(mma) < 1:
            raise AssertionError(f"a tensor-core kernel of {name}.cu has no "
                                 f"tensor-core instructions")


# -- 3. kernel against its plain version ----------------------------------------


def _decode_inputs(b, l, h, kv, d, dtype, rows, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (0.5 * torch.randn((b, 1, h, d), generator=g, device=dev)).to(dtype)
    k = (0.5 * torch.randn((b, l, kv, d), generator=g, device=dev)).to(dtype)
    v = torch.randn((b, l, kv, d), generator=g, device=dev).to(dtype)
    index = torch.tensor(rows, dtype=torch.int32, device=dev)
    return q, k, v, index


def _case_rows(b, l, index, seed) -> list[int]:
    """Per-row indices: the case's own index on every row, or seeded draws,
    then a row at 0 and one at L-1 (the batch grows by two)."""
    if index is None:
        rows = np.random.default_rng(seed).integers(0, l, b).tolist()
    else:
        rows = [index] * b
        if b > 1:
            rows[1] = index // 2
    return rows + [0, l - 1]


def kernel_vs_plain(dev) -> float:
    """Every case in both dtypes; returns the largest |kernel - plain|."""
    worst = 0.0
    for i, (b, l, h, kv, d, index, window) in enumerate(KERNEL_CASES):
        rows = _case_rows(b, l, index, seed=i)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, idx = _decode_inputs(len(rows), l, h, kv, d, dtype, rows,
                                          seed=i, dev=dev)
            worst = max(worst, _decode_check(q, k, v, idx, window, ""))
    for i, (rows, l, h, kv, d, window, what) in enumerate(
            _decode_split_cases(dev)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, idx = _decode_inputs(len(rows), l, h, kv, d, dtype, rows,
                                          seed=50 + i, dev=dev)
            worst = max(worst, _decode_check(q, k, v, idx, window, what))
    return worst


def _decode_split_cases(dev) -> list:
    """(rows, l, h, kv, d, window, what): the split kernel's edges, with c
    the chunk ``split_plan`` gives the case's shapes."""
    cases = []
    for l, h, kv, d in [(512, 15, 5, 64), (1000, 15, 5, 64),
                        (1000, 8, 1, 128), (300, 4, 2, 32),
                        (1000, 96, 8, 192), (1000, 16, 16, 256)]:
        n, c = decode_ops.split_plan(8, l, kv, decode_ops.sm_count(dev))
        cases += [
            ([0] * 8, l, h, kv, d, None, "index 0"),
            ([c - 1, c, c + 1, 2 * c - 1, 2 * c, 2 * c + 1, l - 2, l - 1], l,
             h, kv, d, None, f"around the split boundaries (chunk {c})"),
            ([c + c // 2] * 4 + [c + 1] * 4, l, h, kv, d, c,
             f"a window of {c} across two splits"),
            ([0, 1, c, l // 2, l - c - 1, l - 3, l - 2, l - 1], l, h, kv, d,
             None, f"rows far apart, {n} splits of {c} over L={l}"),
        ]
    return cases


def _decode_check(q, k, v, idx, window, what) -> float:
    """The kernel against the plain version at DECODE_TOL, and against a
    second launch bit for bit; returns the largest |kernel - plain|."""
    out = decode_ops.decode_attention(q, k, v, idx, window=window)
    again = decode_ops.decode_attention(q, k, v, idx, window=window)
    ref = decode_attention_plain(q, k, v, idx, window=window)
    torch.cuda.synchronize()
    b, l, kv, d = k.shape
    dtype = q.dtype
    if out.shape != ref.shape or out.dtype != dtype:
        raise AssertionError(f"kernel output {tuple(out.shape)} "
                             f"{out.dtype}, expected {tuple(ref.shape)}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    same = torch.equal(out, again)
    atol, rtol = DECODE_TOL[dtype]
    ok = (math.isfinite(err) and same
          and bool(torch.all(diff <= atol + rtol * ref.float().abs())))
    say(f"kernel vs plain: B={b} L={l} H={q.shape[2]} KV={kv} D={d} "
        f"window={window} {str(dtype)[6:]}{', ' + what if what else ''}: "
        f"max|err| {err:.3e} (atol {atol:g}, rtol {rtol:g}; mean|plain| "
        f"{float(ref.float().abs().mean()):.3e}); repeat "
        f"{'bit-identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode_attention disagrees with its plain "
                             "version, or with itself")
    return err


def _offset(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of x that starts ``offset`` elements into its
    buffer."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


def _ghost_inputs(b, s, d_in, d_out, dtype, seed, dev, *, unit=False,
                  g_dtype=None, offset=0):
    """a and g for one ghost-norm call, a in ``dtype`` and g in ``g_dtype``
    (default: ``dtype``).  ``unit``: activations of unit scale and
    cotangents scaled so each example's norm^2 is about 1, as in training;
    otherwise the scales of tests/test_kernels.py.  ``offset``: both start
    that many elements into their buffers."""
    g_ = torch.Generator(device=dev).manual_seed(seed)
    sa, sg = (1.0, 1.0 / math.sqrt(s * d_in * d_out)) if unit else (0.5, 0.1)
    a = (sa * torch.randn((b, s, d_in), generator=g_, device=dev)).to(dtype)
    g = (sg * torch.randn((b, s, d_out), generator=g_, device=dev)).to(
        g_dtype or dtype)
    if offset:
        a, g = _offset(a, offset), _offset(g, offset)
    return a, g


# (a, g) dtypes: the same in both, and the mixed pairs a training round
# meets once float32 gradients have promoted the parameters (layer 0's q,
# k and v projections take bf16 activations and float32 cotangents)
GHOST_DTYPES = [(torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.float32),
                (torch.bfloat16, torch.float32),
                (torch.float32, torch.bfloat16)]


def _ghost_check(a, g, what: str) -> float:
    """ghost_norm on (a, g) against its plain version (|kernel - plain| <=
    GHOST_RTOL * |plain| + 1e-6) and against a second launch bit for bit;
    returns the largest |kernel - plain|."""
    out = ghost_ops.ghost_norm(a, g)
    again = ghost_ops.ghost_norm(a, g)
    ref = ghost_norm_blocked(a, g)
    torch.cuda.synchronize()
    b = a.shape[0]
    if out.shape != (b,) or out.dtype != torch.float32:
        raise AssertionError(f"kernel output {tuple(out.shape)} "
                             f"{out.dtype}, expected ({b},) float32")
    err = (out - ref).abs()
    same = torch.equal(out, again)
    ok = bool(torch.all(err <= GHOST_RTOL * ref.abs() + 1e-6)) and same
    rel = float((err / ref.abs().clamp(min=1e-30)).max())
    say(f"kernel vs plain: ghost_norm {what} a {str(a.dtype)[6:]}, g "
        f"{str(g.dtype)[6:]}: max|err| {float(err.max()):.3e}, max rel "
        f"{rel:.3e} (rtol {GHOST_RTOL:g}), second launch "
        f"{'identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ghost_norm disagrees with its plain "
                             "version, or with itself")
    return float(err.max())


def ghost_vs_plain(dev) -> float:
    """``_ghost_check`` on every case in every (a, g) dtype pair; returns
    the largest |kernel - plain|."""
    worst = 0.0
    cases = [(c, False, 0) for c in GHOST_TEST_CASES + GHOST_EDGE_CASES] + \
        [(c, False, off) for c, off in GHOST_OFFSET_CASES] + \
        [(c, True, 0) for c in [*GHOST_TRAIN_SHAPES, *GHOST_LM_SHAPES]]
    for i, ((b, s, d_in, d_out), unit, offset) in enumerate(cases):
        for a_dtype, g_dtype in GHOST_DTYPES:
            a, g = _ghost_inputs(b, s, d_in, d_out, a_dtype, i, dev,
                                 unit=unit, g_dtype=g_dtype, offset=offset)
            what = (f"B={b} S={s} d_in={d_in} d_out={d_out}"
                    f"{f', offset {offset}' if offset else ''}")
            worst = max(worst, _ghost_check(a, g, what))
    return worst


@contextlib.contextmanager
def recording_ghost_inputs():
    """Keep a copy of the first (a, g) of every shape and dtype pair that
    the training path hands ``ghost_norm`` (through ``core.ghost``); the
    kernel runs and counts its launches as before.  Yields the dict
    {(b, s, d_in, d_out, a dtype, g dtype): (a, g)}."""
    seen: dict = {}
    real = ghost_lib.ghost_norm

    def recording(a, g):
        key = (*a.shape, g.shape[-1], a.dtype, g.dtype)
        if key not in seen:
            seen[key] = (a.detach().clone(), g.detach().clone())
        return real(a, g)

    with mock.patch.object(ghost_lib, "ghost_norm", recording):
        yield seen


def path_ghost_vs_plain(seen: dict, what: str) -> float:
    """``_ghost_check`` on the inputs ``recording_ghost_inputs`` kept, after
    the path's launches were read; returns the largest |kernel - plain|."""
    if not seen:
        raise AssertionError(f"{what}: ghost_norm saw no inputs")
    worst = 0.0
    for (b, s, d_in, d_out, _, _), (a, g) in seen.items():
        worst = max(worst, _ghost_check(
            a, g, f"{what}'s B={b} S={s} d_in={d_in} d_out={d_out}"))
    return worst


def _flash_inputs(b, s, l, h, kv, d, dtype, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (0.5 * torch.randn((b, s, h, d), generator=g, device=dev)).to(dtype)
    k = (0.5 * torch.randn((b, l, kv, d), generator=g, device=dev)).to(dtype)
    v = torch.randn((b, l, kv, d), generator=g, device=dev).to(dtype)
    return q, k, v


def flash_vs_plain(dev) -> float:
    """flash_attention against attention_plain on every case in both
    dtypes; returns the largest |kernel - plain|."""
    worst = 0.0
    for i, (b, s, l, h, kv, d, causal, window) in enumerate(FLASH_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _flash_inputs(b, s, l, h, kv, d, dtype, 300 + i, dev)
            variant = flash_ops.VARIANTS[dtype]
            before = flash_ops.launches(variant)
            # blocks of the whole sequence: the reference's contract takes
            # any S and L that way
            out = flash_ops.flash_attention(q, k, v, causal=causal,
                                            window=window, block_q=s,
                                            block_k=l)
            again = flash_ops.flash_attention(q, k, v, causal=causal,
                                              window=window, block_q=s,
                                              block_k=l)
            ref = attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != dtype:
                raise AssertionError(f"kernel output {tuple(out.shape)} "
                                     f"{out.dtype}, expected {tuple(ref.shape)}")
            err = (out.float() - ref.float()).abs()
            atol, rtol = FLASH_TOL[dtype]
            ok = bool(torch.all(err <= atol + rtol * ref.float().abs()))
            same = torch.equal(out, again)
            ran = flash_ops.launches(variant) - before == 2
            say(f"kernel vs plain: flash_attention B={b} S={s} L={l} H={h} "
                f"KV={kv} D={d} causal={causal} window={window} "
                f"{str(dtype)[6:]} ({variant}): max|err| "
                f"{float(err.max()):.3e} (atol {atol:g}, rtol {rtol:g}; "
                f"mean|plain| {float(ref.float().abs().mean()):.3e}); "
                f"repeat {'bit-identical' if same else 'DIFFERS'} "
                f"{'ok' if ok and same and ran else 'FAIL'}")
            if not (ok and same and ran):
                raise AssertionError("flash_attention disagrees with its "
                                     "plain version, or with itself, or "
                                     "did not run its dtype's kernel")
            worst = max(worst, float(err.max()))
            del q, k, v, out, again, ref, err
    return worst


# -- 4. the serve main path -----------------------------------------------------------


def _n_attention(cfg) -> int:
    """The stack's attention layers, each one decode_attention launch per
    position."""
    return sum(r for r, pattern in cfg.stack for spec in pattern
               if spec.mixer == "attn")


def _check_open_loop(mcfg, requests, result, calls, launches) -> int:
    """Every request served to its budget with tokens in the vocabulary,
    one program call per decode step and two per admission, and one
    decode_attention launch per attention layer and position; returns the
    decode steps."""
    done = sorted(result.completed, key=lambda r: r.rid)
    if [r.rid for r in done] != [r.rid for r in requests]:
        raise AssertionError(f"{len(done)} of {len(requests)} requests "
                             "completed")
    short = [r.rid for r in done if len(r.tokens) != r.max_new_tokens]
    if short:
        raise AssertionError(f"requests {short} ended short of their budget")
    if not all(0 <= t < mcfg.vocab_size for r in done for t in r.tokens):
        raise AssertionError("a sampled token lies outside the vocabulary")
    steps = result.decode_steps
    if result.decode_dispatches != steps or calls != steps + 2 * len(done):
        raise AssertionError(f"program calls {calls} (decode "
                             f"{result.decode_dispatches}) for {steps} decode "
                             f"steps and {len(done)} admissions")
    prefill_positions = sum(len(r.prompt) for r in requests)
    n_attn = _n_attention(mcfg)
    if launches != n_attn * (steps + prefill_positions):
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {n_attn} x ({steps} decode "
                             f"steps + {prefill_positions} prefill positions)")
    return steps


def main_path(dev, smi: str):
    """Serve a seeded open-loop trace at full width; returns the engine and
    each kernel's launches in that run."""
    engine = ServeEngine(ServeConfig(
        arch=ARCH, smoke=False, slots=8, max_len=512, temperature=1.0,
        seed=SEED, device=str(dev)))
    mcfg = engine.model_cfg
    vocab = mcfg.vocab_size
    # warm-up (allocator, cuBLAS handles), outside the counted run
    batch_generate(engine, np.arange(1, 9, dtype=np.int32)[None], 2)
    requests = generate_requests(TrafficConfig(rate=16, n_requests=16,
                                               vocab_size=vocab, seed=SEED))
    prefill_positions = sum(len(r.prompt) for r in requests)

    decode_ops.reset_launches()
    reset_jit_dispatches()
    result = run_open_loop(engine, requests)
    launches = decode_ops.launches()
    calls = jit_dispatches()

    steps = _check_open_loop(mcfg, requests, result, calls, launches)
    positions = steps + prefill_positions
    row = summarize(result, slots=8, rate=16)
    say(f"main path: {ARCH} full width {str(mcfg.cdtype)[6:]}, 8 slots x 512,"
        f" 16 requests @ 16 q/s on {smi}: {row['throughput_tok_s']} tok/s, "
        f"TTFT p50/p99 {row['ttft_p50_ms']}/{row['ttft_p99_ms']} ms, TPOT "
        f"p50/p99 {row['tpot_p50_ms']}/{row['tpot_p99_ms']} ms; {steps} decode"
        f" steps + {prefill_positions} prefill positions, {calls} program "
        f"calls, decode_attention launches {launches} "
        f"({launches // positions} per position)")
    say("main path row: " + json.dumps(row, sort_keys=True))
    return engine, {"decode_attention": launches}


# -- 5. the serve whole path, kernel against the model's plain attention ---------


def whole_path(dev) -> None:
    cfg = get_config(ARCH).replace(param_dtype="float32",
                                   compute_dtype="float32")
    params = tf.init(cfg, SEED, dev)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, 16)).astype(np.int32)
    gen, max_len = 8, 64
    tokens = {}
    for kernel in (True, False):
        engine = ServeEngine(
            ServeConfig(arch=ARCH, slots=1, max_len=max_len, temperature=0.0,
                        decode_kernel=kernel, device=str(dev)),
            model_cfg=cfg, params=params)
        tokens[kernel] = batch_generate(engine, prompt, gen)[0]
    if not np.array_equal(tokens[True], tokens[False]):
        raise AssertionError(f"greedy tokens differ: kernel {tokens[True]} "
                             f"plain {tokens[False]}")
    # teacher-forced: the prefill's logits, then one decode step per token
    cfgs = {kernel: cfg.replace(use_decode_kernel=kernel)
            for kernel in (True, False)}
    state = {kernel: tf.prefill(c, params, tf.init_cache(c, 1, max_len, dev),
                                torch.from_numpy(prompt).to(dev))
             for kernel, c in cfgs.items()}
    worst = 0.0
    for i in range(gen):
        if i:
            tok = torch.tensor([[tokens[True][i - 1]]], dtype=torch.int32,
                               device=dev)
            pos = torch.tensor([prompt.shape[1] + i - 1], dtype=torch.int32,
                               device=dev)
            state = {kernel: tf.decode_step_positions(c, params,
                                                      state[kernel][1], tok,
                                                      pos)
                     for kernel, c in cfgs.items()}
        a, b = state[True][0], state[False][0]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError("non-finite logits")
        worst = max(worst, float((a - b).abs().max()))
    ok = worst <= 1e-3
    say(f"whole path: {ARCH} full width float32, 16-token prompt + {gen} "
        f"greedy tokens: tokens identical, logits max|kernel - plain| "
        f"{worst:.3e} (atol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("decode kernel and plain attention disagree "
                             "over the whole path")


# -- 6. the training main path ------------------------------------------------


def _train_cfg(rounds: int, sigma: float) -> arms.ArmConfig:
    return arms.ArmConfig(
        rounds=rounds, batch_size=TRAIN["batch_size"], lr=TRAIN["lr"],
        seed=SEED, use_secagg=False,
        dp=DPConfig(clip_norm=TRAIN["clip"], noise_multiplier=sigma))


def _silos(mcfg):
    return token_silos(mcfg, hospitals=TRAIN["hospitals"],
                       n_per=TRAIN["n_per"], seq_len=TRAIN["seq_len"],
                       seed=SEED)


def train_main_path(dev, smi, ckpt_dir: str) -> dict:
    """DeCaPH rounds with ghost clipping at full width, each round published
    into ``ckpt_dir``; returns the ghost_norm launches of the run and its
    round wall times (without the publishing)."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False)
    if param_count(mcfg) != TRAIN_PARAMS:
        raise AssertionError(f"{param_count(mcfg)} parameters, expected "
                             f"{TRAIN_PARAMS}")
    model = transformer_model(mcfg, device=str(dev))
    silos = _silos(mcfg)
    cfg = _train_cfg(TRAIN["rounds"], TRAIN["sigma"])
    publisher = CheckpointPublisher(
        ckpt_dir, keep_last=2, metadata={"arm": "decaph", "arch": mcfg.name})
    marks, resumes, publish_ms, dtypes = [], [], [], []

    def on_round(t, params):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        dtypes.append(sorted({str(p.dtype)[6:] for p in tree_leaves(params)}))
        publisher.publish(t, params)       # D2H copy + write + rename
        resumes.append(time.perf_counter())
        publish_ms.append((resumes[-1] - marks[-1]) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    ghost_ops.reset_launches()
    reset_jit_dispatches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = arms.run("decaph", model, silos, cfg, backend="ideal",
                      on_round=on_round)
    launches = ghost_ops.launches()
    calls = jit_dispatches()

    n_params = sum(p.numel() for p in tree_leaves(report.params))
    norm_scales = (2 * mcfg.n_layers + 1) * mcfg.d_model
    if n_params != TRAIN_PARAMS + norm_scales:
        raise AssertionError(f"trained {n_params} parameters, expected "
                             f"{TRAIN_PARAMS} + {norm_scales} norm scales")
    if report.rounds_completed != TRAIN["rounds"] or len(marks) != \
            TRAIN["rounds"]:
        raise AssertionError(f"{report.rounds_completed} rounds completed, "
                             f"expected {TRAIN['rounds']}")
    losses = [l.loss for l in report.logs]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite round losses {losses}")
    if not all(bool(torch.isfinite(p).all())
               for p in tree_leaves(report.params)):
        raise AssertionError("non-finite trained parameters")
    acct = RDPAccountant(sampling_rate=TRAIN["batch_size"]
                         / (TRAIN["hospitals"] * TRAIN["n_per"]),
                         noise_multiplier=TRAIN["sigma"], delta=cfg.dp.delta)
    acct.step(TRAIN["rounds"])
    if report.epsilon != acct.epsilon():
        raise AssertionError(f"ε {report.epsilon} != the accountant's "
                             f"{acct.epsilon()}")
    if calls != TRAIN["rounds"]:
        raise AssertionError(f"{calls} program calls for "
                             f"{TRAIN['rounds']} fused rounds")
    per_participant = 7 * mcfg.n_layers + 1
    expected = per_participant * TRAIN["hospitals"] * TRAIN["rounds"]
    if launches != expected:
        raise AssertionError(f"ghost_norm launched {launches} times, "
                             f"expected {per_participant} x "
                             f"{TRAIN['hospitals']} participants x "
                             f"{TRAIN['rounds']} rounds = {expected}")
    round_s = [b - a for a, b in zip([t0] + resumes[:-1], marks)]
    if publisher.published != list(range(TRAIN["rounds"])):
        raise AssertionError(f"published rounds {publisher.published}")
    last = TRAIN["rounds"] - 1
    if list_rounds(ckpt_dir) != [last - 1, last]:
        raise AssertionError(f"rounds on disk {list_rounds(ckpt_dir)}, "
                             f"expected the last two (keep_last=2)")
    size = Path(checkpoint_path(ckpt_dir, last)).stat().st_size
    say(f"train main path: {ARCH} untied head, {TRAIN_PARAMS:,} parameters "
        f"(+ {norm_scales:,} norm scales), full"
        f" width, {TRAIN['hospitals']} hospitals x {TRAIN['n_per']} x "
        f"{TRAIN['seq_len']} tokens, batch {TRAIN['batch_size']}, sigma "
        f"{TRAIN['sigma']}, ghost clipping, on {smi}: {report.rounds_completed}"
        f" rounds, aggregate batches "
        f"{[l.aggregate_batch for l in report.logs]}, losses "
        f"{[round(x, 4) for x in losses]}, ε {report.epsilon:.6f} (accountant"
        f" {acct.epsilon():.6f}), {calls} program calls, ghost_norm launches "
        f"{launches} ({per_participant} per participant and round), round "
        f"wall s {[round(x, 4) for x in round_s]}, parameter dtypes after "
        f"each round {dtypes}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"train publish: CheckpointPublisher.publish per round (D2H copy + "
        f"write + rename), ms {[round(x, 2) for x in publish_ms]} on {smi}")
    say(f"train publish: checkpoint file {size:,} bytes "
        f"({size / 2**30:.3f} GiB) per round")
    return {"launches": launches, "round_s": round_s, "model": model,
            "silos": silos, "params": report.params,
            "publish_ms": publish_ms, "ckpt_bytes": size}


def _update_l2(initial, a, b) -> tuple[float, float]:
    """Two rounds' updates (trained - initial, over the whole tree) in
    float64: L2 of their difference, and L2 of b's update."""
    diff_sq = upd_sq = 0.0
    for p0, pa, pb in zip(tree_leaves(initial), tree_leaves(a),
                          tree_leaves(b)):
        ua, ub = pa.double() - p0.double(), pb.double() - p0.double()
        diff_sq += float((ua - ub).square().sum())
        upd_sq += float(ub.square().sum())
    return math.sqrt(diff_sq), math.sqrt(upd_sq)


def train_whole_path(dev, silos) -> None:
    """One sigma = 0 round in float32 with the kernel and one with the plain
    ghost norm, from the same parameters.  The norms agree at rtol 1e-4.
    The round's update is lr * (sum of clipped gradients) / batch, and a
    relative norm error e moves each clipped gradient (of L2 norm <= C) by
    at most C * e in L2, so the two updates (trained - initial parameters,
    over the whole tree) differ by at most lr * C * 1e-4 = 5e-6 in L2; the
    limit is twice that, for float32 sums ordered differently.  Updates, not
    parameters: one clipped step spreads at most lr * C over 409M elements,
    below any useful per-element tolerance on the parameters themselves."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    model = transformer_model(mcfg, device=str(dev))
    params = model.init_fn(SEED)
    model = dataclasses.replace(model, init_fn=lambda seed: params)
    x = torch.from_numpy(silos[0].x[:16]).to(dev)
    batch = {"tokens": x.long(),
             "labels": torch.from_numpy(silos[0].y[:16]).to(dev).long()}
    mask = torch.zeros(16, device=dev)
    mask[:4] = 1.0
    norms, trained = {}, {}
    for kernel in (True, False):
        impl = ghost_ops.ghost_norm if kernel else ghost_norm_blocked
        with mock.patch.object(ghost_lib, "ghost_norm", impl):
            before = ghost_ops.launches()
            _, _, norms[kernel] = ghost_lib.ghost_clipped_grad_sum(
                mcfg, params, batch, clip_norm=TRAIN["clip"], mask=mask)
            trained[kernel] = arms.run("decaph", model, silos,
                                       _train_cfg(1, 0.0)).params
            if (ghost_ops.launches() > before) != kernel:
                raise AssertionError("the kernel was launched where it "
                                     "should not be, or not where it should")
    nk, npl = norms[True], norms[False]
    norm_ok = bool(torch.all((nk - npl).abs() <= 1e-4 * npl.abs())) and \
        bool(torch.all(nk[4:] == 0))
    diff, upd = _update_l2(params, trained[True], trained[False])
    limit = 2 * TRAIN["lr"] * TRAIN["clip"] * 1e-4
    ok = norm_ok and diff <= limit and upd > 0
    say(f"train whole path: {ARCH} untied head, full width float32, sigma 0, "
        f"kernel vs plain ghost norm: norms {[round(float(v), 6) for v in nk[:4]]}"
        f" vs {[round(float(v), 6) for v in npl[:4]]} (rtol 1e-4, pad rows "
        f"0); one round's update, L2 over the tree: plain {upd:.6e}, "
        f"|kernel - plain| {diff:.3e} (limit {limit:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ghost-norm kernel and the plain ghost norm "
                             "disagree over a training round")


# -- 8. the evaluation main path ------------------------------------------------


def _eval_batch(mcfg, dev) -> dict:
    """The held-out silos as one batch: tokens [8, 2048] and labels."""
    silos = token_silos(mcfg, **EVAL)
    x = np.concatenate([p.x for p in silos])
    y = np.concatenate([p.y for p in silos])
    return {"tokens": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(y).to(dev)}


def eval_main_path(dev, smi, trained) -> int:
    """Score the held-out silos with use_flash at full width, under
    ``torch.no_grad()``: seeded bf16 weights, then the trained float32
    parameters (whose products promote q, k and v to float32).  Returns
    the flash_attention launches of the run."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False, use_flash=True)
    batch = _eval_batch(mcfg, dev)
    model = transformer_model(mcfg, device=str(dev))
    if trained["layers"]["wq"].dtype != torch.float32:
        raise AssertionError("the trained parameters are not float32")
    # each run's q, k and v are in its weights' dtype, so it must go
    # through that dtype's kernel only
    runs = {"seeded bfloat16": (tf.init(mcfg, SEED, dev), "mma_bf16"),
            "trained float32": (trained, "simt_fp32")}
    n = mcfg.n_layers
    total = 0
    for name, (params, variant) in runs.items():
        flash_ops.reset_launches()
        with torch.no_grad():
            logits, _ = tf.forward(mcfg, params, batch)
            after_forward = flash_ops.launches()
            loss = float(tf.loss_fn(mcfg, params, batch))
            after_loss = flash_ops.launches()
            pred = model.predict_fn(params, batch["tokens"])
            launches = flash_ops.launches()
        b, s = batch["tokens"].shape
        if logits.shape != (b, s, mcfg.vocab_size):
            raise AssertionError(f"logits {tuple(logits.shape)}")
        if not (bool(torch.isfinite(logits).all()) and math.isfinite(loss)):
            raise AssertionError(f"{name}: non-finite logits or loss")
        if (after_forward, after_loss, launches) != (n, 2 * n, 3 * n) or \
                flash_ops.launches(variant) != launches:
            raise AssertionError(
                f"{name}: flash_attention launched {after_forward}, "
                f"{after_loss}, {launches} times after forward, loss_fn and "
                f"predict_fn ({flash_ops.launches(variant)} of them "
                f"{variant}); expected {n} per forward, all {variant}")
        last = torch.argmax(logits[:, -1], dim=-1)
        if not torch.equal(pred, last):
            raise AssertionError(f"{name}: predict_fn {pred.tolist()} is not "
                                 f"the forward's last argmax {last.tolist()}")
        real = batch["labels"] >= 0      # as the "lm" scenarios' pooled_metric
        acc = float((torch.argmax(logits, dim=-1)[real]
                     == batch["labels"][real]).float().mean())
        say(f"eval main path: {ARCH} untied head, full width, {name} "
            f"weights, use_flash, {EVAL['hospitals']} held-out hospitals x "
            f"{EVAL['n_per']} x {EVAL['seq_len']} tokens, on {smi}: "
            f"logits {str(logits.dtype)[6:]} finite, mean cross-entropy "
            f"{loss:.6f}, pooled next-token accuracy {acc:.6f}, predict_fn = "
            f"last-position argmax, flash_attention launches {launches} "
            f"({n} per forward: forward, loss_fn, predict_fn), all of the "
            f"{variant} kernel")
        total += launches
        del logits, pred
    return total


# -- 9. the evaluation whole path, kernel against the model's plain attention ----


def eval_whole_path(dev) -> None:
    mcfg = get_config(ARCH).replace(tie_embeddings=False,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    params = tf.init(mcfg, SEED, dev)
    batch = _eval_batch(mcfg, dev)
    before = flash_ops.launches()
    with torch.no_grad():
        kernel, _ = tf.forward(mcfg.replace(use_flash=True), params, batch)
        if flash_ops.launches() != before + mcfg.n_layers:
            raise AssertionError("the use_flash forward did not launch the "
                                 "kernel once per layer")
        plain, _ = tf.forward(mcfg, params, batch)
    err = float((kernel - plain).abs().max())
    top2 = torch.topk(plain, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2e-3
    same = torch.argmax(kernel, dim=-1) == torch.argmax(plain, dim=-1)
    ok = err <= 1e-3 and bool(same[sure].all()) and math.isfinite(err)
    say(f"eval whole path: {ARCH} untied head, full width float32, B=8 S=2048,"
        f" use_flash (kernel) vs plain _sdpa: logits max|kernel - plain| "
        f"{err:.3e} (atol 1e-3); argmax identical at {int(same[sure].sum())} "
        f"of {int(sure.sum())} positions whose top two differ by > 2e-3 "
        f"({int(same.sum())} of {same.numel()} overall) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the flash kernel and the plain attention "
                             "disagree over the evaluation forward")


@contextlib.contextmanager
def capturing_flash():
    """Keep the inputs and output of every ``flash_attention`` call that
    ``gqa_apply`` makes; the kernel runs and counts as before.  Yields the
    list of (q, k, v, the mask's kwargs, out)."""
    seen = []
    kernel = attn_lib.flash_attention

    def capture(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        # the mask's arguments (not the block sizes, which only the
        # kernel's contract check reads)
        seen.append((q, k, v, {n: kw[n] for n in ("causal", "window")
                               if n in kw}, out))
        return out

    with mock.patch.object(attn_lib, "flash_attention", capture):
        yield seen


def bf16_forward_layers(mcfg, params, batch, what: str) -> tuple[int, float]:
    """One bf16 ``use_flash`` forward, every layer's q, k, v and attention
    output captured where ``gqa_apply`` calls the kernel, and each layer's
    output held against ``attention_plain`` on that layer's own inputs at
    FLASH_TOL[bf16]: the kernel on real activations, not only on random
    normals.  Returns the launches and the largest |kernel - plain|."""
    before = flash_ops.launches("mma_bf16")
    with capturing_flash() as seen, torch.no_grad():
        logits, _ = tf.forward(mcfg, params, batch)
    launches = flash_ops.launches("mma_bf16") - before
    if len(seen) != mcfg.n_layers or launches != mcfg.n_layers:
        raise AssertionError(f"{len(seen)} attention calls, {launches} "
                             f"launches, expected {mcfg.n_layers} through the "
                             f"bf16 kernel")
    atol, rtol = FLASH_TOL[torch.bfloat16]
    errs, worst_rel, bad = [], 0.0, []
    for i, (q, k, v, kw, out) in enumerate(seen):
        ref = attention_plain(q, k, v, **kw).float()
        err = (out.float() - ref).abs()
        errs.append(float(err.max()))
        worst_rel = max(worst_rel,
                        float((err / (atol + rtol * ref.abs())).max()))
        if not bool(torch.all(err <= atol + rtol * ref.abs())):
            bad.append(i)
        del ref, err
    seen.clear()
    ok = not bad and bool(torch.isfinite(logits).all())
    say(f"{what}, use_flash, each layer's kernel output vs attention_plain "
        f"on its own q, k, v: max|err| per layer "
        f"{[float(f'{e:.3e}') for e in errs]} (atol {atol:g}, rtol {rtol:g};"
        f" worst err / limit {worst_rel:.3f}) at {mcfg.n_layers - len(bad)} "
        f"of {mcfg.n_layers} layers {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the bf16 flash kernel disagrees with its plain "
                             f"version on real activations at layers {bad}")
    return launches, max(errs)


def eval_layers_bf16(dev) -> float:
    """Phase 9's bf16 half: the evaluation forward's layers against the
    plain version (``bf16_forward_layers``).  Returns the largest
    |kernel - plain|."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False, use_flash=True)
    params = tf.init(mcfg, SEED, dev)
    return bf16_forward_layers(
        mcfg, params, _eval_batch(mcfg, dev),
        f"eval whole path: {ARCH} untied head, full width bfloat16, B=8 "
        f"S=2048")[1]


# -- 10. blocked training: _sdpa_blocked inside a ghost round ----------------------


def blocked_train_path(dev) -> None:
    """One sigma = 0 float32 ghost round with use_flash (the ghost forward's
    attention is then _sdpa_blocked, two 512-key blocks at S = 1024) and
    one without, from the same parameters: the updates agree within 1e-5
    in L2 and the flash kernel never launches."""
    base = get_config(ARCH).replace(
        tie_embeddings=False, param_dtype="float32", compute_dtype="float32",
        n_layers=BLOCKED["n_layers"], stack=dense_stack(BLOCKED["n_layers"]))
    silos = token_silos(base, hospitals=BLOCKED["hospitals"],
                        n_per=BLOCKED["n_per"], seq_len=BLOCKED["seq_len"],
                        seed=SEED)
    params = tf.init(base, SEED, dev)
    cfg = arms.ArmConfig(rounds=1, batch_size=BLOCKED["batch_size"],
                         lr=TRAIN["lr"], seed=SEED, use_secagg=False,
                         dp=DPConfig(clip_norm=TRAIN["clip"],
                                     noise_multiplier=0.0))
    trained, launches = {}, {}
    for flash in (True, False):
        model = dataclasses.replace(
            transformer_model(base.replace(use_flash=flash), device=str(dev)),
            init_fn=lambda seed: params)
        flash_ops.reset_launches()
        report = arms.run("decaph", model, silos, cfg)
        launches[flash] = flash_ops.launches()
        if report.rounds_completed != 1 or not math.isfinite(
                report.logs[0].loss):
            raise AssertionError("the blocked ghost round did not complete")
        trained[flash] = report.params
    diff, upd = _update_l2(params, trained[True], trained[False])
    ok = diff <= 1e-5 and upd > 0 and launches[True] == launches[False] == 0
    say(f"blocked training: {ARCH} untied head, full width float32, "
        f"{BLOCKED['n_layers']} layers, B={BLOCKED['batch_size']} S="
        f"{BLOCKED['seq_len']}, sigma 0, one ghost round with use_flash "
        f"(_sdpa_blocked, two 512-key blocks) vs plain _sdpa: update L2 "
        f"{upd:.6e}, |blocked - plain| {diff:.3e} (limit 1e-5); "
        f"flash_attention launches {launches[True]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the blocked ghost round disagrees with the "
                             "plain one, or launched the flash kernel")


# -- 11. times -------------------------------------------------------------------


@functools.cache
def _sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    torch.cuda.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def device_ms(fn, arg_sets, reps: int) -> float:
    """Median device time of one ``fn(*args)`` in ms, over ``reps`` calls
    that rotate through ``arg_sets`` (enough copies that the L2 cache holds
    none of them, as the decode step finds each layer's cache cold).

    A sleep kernel holds the stream while the host enqueues every call
    between CUDA events, so each event pair brackets device work, not the
    host's Python; the sleep is sized from one call's enqueue time, and the
    script checks that it outlasted the whole enqueue.
    """
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*arg_sets[-1])
    one_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 3 * reps * one_ms + 20
    t_sleep = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    t_sleep[0].record()
    torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
    t_sleep[1].record()
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
        ev[i + 1].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    slept_ms = t_sleep[0].elapsed_time(t_sleep[1])
    if enqueue_ms >= slept_ms:
        raise RuntimeError(f"enqueue took {enqueue_ms:.1f} ms, longer than "
                           f"the {slept_ms:.1f} ms sleep: times would include "
                           "host gaps")
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def graph_ms(graph, reps: int) -> float:
    """Median device time of one replay of a CUDA graph, each replay alone
    between two CUDA events on an idle stream: a replay is one host call,
    so the events bracket its device work and the launch's few
    microseconds.  (Replays queued behind a sleep, as ``device_ms`` does,
    block once a graph has more kernels than the launch queue holds, as
    a Qwen3-30B-A3B decode step's several thousand do.)"""
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _library_decode(q, k, v, mask):
    # one PyTorch call for the same function: SDPA with the KV heads shared
    # by their query groups (a yardstick only; the port never calls it)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).transpose(1, 2)


def decode_bound_ms(q, k, index) -> tuple[float, str]:
    """Least time for one call on these inputs: the K and V rows each batch
    row attends to (0 .. index[b]), plus q, the output and the indices,
    over the HBM rate; against 4*H*D operations per attended row over the
    peak for the dtype.  Returns (ms, "bytes" or "operations")."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    rows = int((index.long().cpu().clamp(max=k.shape[1] - 1) + 1).sum())
    es = q.element_size()
    nbytes = 2 * rows * kv * d * es + 2 * q.numel() * es + 4 * b
    ops = 4 * rows * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_decode(shape, dev, smi, position: int | None = None) -> dict:
    """Times at every row's index ``position`` (default L-1, a full cache
    of L rows)."""
    b, l, h, kv, d = (shape[x] for x in ("b", "l", "h", "kv", "d"))
    dtype = torch.bfloat16
    per_copy = 2 * b * l * kv * d * 2
    copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
    position = l - 1 if position is None else position
    rows = [position] * b
    sets = [_decode_inputs(b, l, h, kv, d, dtype, rows, seed=100 + i, dev=dev)
            for i in range(copies)]
    kj = torch.arange(l, device=dev)
    masks = [(kj[None, :] <= s[3].long()[:, None])[:, None, None, :]
             for s in sets]
    lib_sets = [(q, k, v, m) for (q, k, v, _), m in zip(sets, masks)]
    # the yardstick must compute the same function
    q, k, v, idx = sets[0]
    lib_err = float((_library_decode(q, k, v, masks[0]).float()
                     - decode_attention_plain(q, k, v, idx).float()
                     ).abs().max())
    if not lib_err <= TOL[dtype]:
        raise AssertionError(f"library call disagrees with the plain version "
                             f"by {lib_err:.3e}")
    reps = max(30, 3 * copies)
    kernel_ms = device_ms(decode_ops.decode_attention, sets, reps)
    plain_ms = device_ms(decode_attention_plain, sets, reps)
    library_ms = device_ms(_library_decode, lib_sets, reps)
    bound_ms, bound_by = decode_bound_ms(q, k, idx)
    say(f"times: decode_attention B={b} L={l} H={h} KV={kv} D={d} bfloat16, "
        f"every row at index {position}, {copies} rotating copies, median of "
        f"{reps}, on {smi}: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA, enable_gqa) {library_ms:.4f} ms,"
        f" bound {bound_ms:.4f} ms ({bound_by}; "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _library_ghost(a, g):
    # the per-example-gradient approach: materialise A_b^T G_b with one
    # batched product, then its squared Frobenius norm (a yardstick only;
    # the port never calls it)
    return torch.bmm(a.mT, g).float().square().sum(dim=(1, 2))


def ghost_bound_ms(a, g) -> tuple[float, str]:
    """Least time for one call: a and g read once and [B] float32 written,
    over the HBM rate; against the two Gram products' upper triangles (the
    Grams are symmetric), B*S*(S+1)*d operations for each, over the peak
    for its operand's dtype (GHOST_OPS_PER_S: float32 at the 3xTF32
    rate)."""
    b, s, d_in = a.shape
    nbytes = a.numel() * a.element_size() + g.numel() * g.element_size() \
        + 4 * b
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = b * s * (s + 1) * (d_in / GHOST_OPS_PER_S[a.dtype]
                               + g.shape[2] / GHOST_OPS_PER_S[g.dtype])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_ghost(dev, smi) -> dict:
    """ghost_norm, its plain version and the library yardstick at every
    training shape in both dtypes; returns the GHOST_ROW_SHAPE bfloat16
    times for the kernels line (its float32 times are printed beside them)
    and each participant's sums."""
    rows, per_participant = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for i, (shape, count) in enumerate(GHOST_TRAIN_SHAPES.items()):
            b, s, d_in, d_out = shape
            per_copy = b * s * (d_in + d_out) * (2 if dtype ==
                                                 torch.bfloat16 else 4)
            copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
            sets = [_ghost_inputs(b, s, d_in, d_out, dtype, 200 + 10 * i + c,
                                  dev, unit=True) for c in range(copies)]
            a, g = sets[0]
            lib_err = float(((_library_ghost(a, g) - ghost_norm_blocked(a, g))
                             .abs() / ghost_norm_blocked(a, g).abs()).max())
            if not lib_err <= 3e-2:
                raise AssertionError(f"library call disagrees with the plain "
                                     f"version by {lib_err:.3e} (relative)")
            reps = 20 if d_out > 10_000 else 40
            row = {"ms": device_ms(ghost_ops.ghost_norm, sets, reps),
                   "plain_ms": device_ms(ghost_norm_blocked, sets, reps),
                   "library_ms": device_ms(_library_ghost, sets, reps)}
            row["bound_ms"], row["bound_by"] = ghost_bound_ms(a, g)
            say(f"times: ghost_norm B={b} S={s} d_in={d_in} d_out={d_out} "
                f"{str(dtype)[6:]}, {copies} rotating copies, median of "
                f"{reps}, on {smi}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library (bmm + squared norm) "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; {100 * row['bound_ms'] / row['ms']:.1f}%"
                f" of bound); {count} per participant and round")
            rows[(shape, dtype)] = row
            for k in total:
                total[k] += count * row[k]
            del sets, a, g
        per_participant[dtype] = total
        say(f"times: ghost_norm per participant and round ({sum(GHOST_TRAIN_SHAPES.values())}"
            f" launches) {str(dtype)[6:]}, on {smi}: kernel "
            f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, library "
            f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms")
    bf, fp = (rows[(GHOST_ROW_SHAPE, dt)]
              for dt in (torch.bfloat16, torch.float32))
    say(f"times: ghost_norm at the kernels line's shape "
        f"{GHOST_ROW_SHAPE}, on {smi}: kernel / plain / library / bound ms "
        f"bfloat16 {bf['ms']:.4f} / {bf['plain_ms']:.4f} / "
        f"{bf['library_ms']:.4f} / {bf['bound_ms']:.4f}, float32 "
        f"{fp['ms']:.4f} / {fp['plain_ms']:.4f} / {fp['library_ms']:.4f} / "
        f"{fp['bound_ms']:.4f}")
    return {"row": bf, "per_participant": per_participant}


def _library_flash(q, k, v):
    # one PyTorch call for the same function: causal SDPA with the KV heads
    # shared by their query groups (a yardstick only; the port never calls
    # it)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def flash_bound_ms(q, k) -> tuple[float, str]:
    """Least time for one causal call on these inputs: q, k, v and the
    output each read or written once, over the HBM rate; against 4*D
    operations per attended (query, key) pair — row i attends min(i+1, L)
    keys, B*H*S*(S+1)/2 pairs at L = S — over the peak for the dtype."""
    b, s, h, d = q.shape
    l = k.shape[1]
    pairs = b * h * int(torch.clamp(torch.arange(1, s + 1), max=l).sum())
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * k.numel() * es
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * d * pairs / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def time_flash(dev, smi, shape=EVAL_SHAPE) -> dict:
    """flash_attention, attention_plain and causal SDPA at ``shape`` (the
    evaluation shape unless given) in both dtypes; returns the bfloat16
    times (the evaluation shape's go to the kernels line)."""
    b, s, h, kv, d = (shape[x] for x in ("b", "s", "h", "kv", "d"))
    where = "32 per evaluation forward" if shape is EVAL_SHAPE else \
        f"{h} query heads on {kv} of {d}"
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        per_copy = (2 * b * s * h * d + 2 * b * s * kv * d) * (
            2 if dtype == torch.bfloat16 else 4)
        copies = max(2, math.ceil(2 * L2_BYTES / per_copy))
        sets = [_flash_inputs(b, s, s, h, kv, d, dtype, 400 + c, dev)
                for c in range(copies)]
        q, k, v = sets[0]
        lib_err = float((_library_flash(q, k, v).float()
                         - attention_plain(q, k, v).float()).abs().max())
        if not lib_err <= TOL[dtype]:
            raise AssertionError(f"library call disagrees with the plain "
                                 f"version by {lib_err:.3e}")
        # whole-sequence blocks, as gqa_apply calls it (S = 448 is not a
        # multiple of the reference's 128-row block)
        kernel = functools.partial(flash_ops.flash_attention, block_q=s,
                                   block_k=s)
        row = {"ms": device_ms(kernel, sets, 20),
               "plain_ms": device_ms(attention_plain, sets, 6),
               "library_ms": device_ms(_library_flash, sets, 20)}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(q, k)
        say(f"times: flash_attention B={b} S=L={s} H={h} KV={kv} D={d} "
            f"causal {str(dtype)[6:]}, {copies} rotating copies, on {smi}: "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library (SDPA, is_causal, enable_gqa) {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of bound); "
            f"{4 * d * b * h * s * (s + 1) // 2 / 1e9:.1f} GFLOP per call; "
            f"{where}")
        rows[dtype] = row
        del sets, q, k, v
        torch.cuda.empty_cache()
    return rows[torch.bfloat16]


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        us = getattr(evt, name, None)
        if us is not None:
            return float(us)
    return 0.0


def _union_us(spans) -> float:
    """The time covered by (start, end) intervals, each counted once."""
    total, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def _device_profile(fn) -> tuple[float, dict, float, list]:
    """``fn()`` once under ``torch.profiler``: the device's busy time in us
    (the union of its kernels' intervals, so that a kernel launched
    programmatically dependent, which waits on the device for the one
    before, counts once; the sum of self times where the trace has no
    intervals), the self device time by kernel name, the host wall time of
    the profiled call in ms, and the (name, start, end) of every device
    event."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + _self_device_us(evt)
    spans = [(evt.name, evt.time_range.start, evt.time_range.end)
             for evt in prof.events()
             if getattr(evt, "device_type", None) ==
             torch.autograd.DeviceType.CUDA]
    busy = _union_us((a, b) for _, a, b in spans) if spans else \
        sum(by_kernel.values())
    return busy, by_kernel, prof_ms, spans


def time_eval_forward(dev, smi, flash_ms: float) -> float:
    """Host wall time of one full-width bf16 evaluation forward (B=8,
    S=2048, use_flash, synchronised), median of 5 after a warm-up; the
    flash kernel's share of it at the times phase's median; then one more
    forward under ``torch.profiler``: the device's busy time, its idle
    share of the unprofiled wall time, and the device ops that take the
    most self time, with their shares of busy time."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False, use_flash=True)
    params = tf.init(mcfg, SEED, dev)
    batch = _eval_batch(mcfg, dev)
    walls = []
    with torch.no_grad():
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tf.forward(mcfg, params, batch)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls)
        share = mcfg.n_layers * flash_ms / wall_ms
        say(f"eval forward: {ARCH} untied head full width bfloat16, use_flash,"
            f" B=8 S=2048, on {smi}: wall {wall_ms:.2f} ms (median of 5); "
            f"flash_attention at the times phase's median: {mcfg.n_layers} x "
            f"{flash_ms:.4f} ms = {100 * share:.1f}% of it")
        busy_us, by_kernel, prof_ms, _ = _device_profile(
            lambda: tf.forward(mcfg, params, batch))
    if busy_us <= 0:
        say("eval forward profile: torch.profiler recorded no device time on"
            " this machine, so device busy and idle share are not measured")
        return wall_ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    say(f"eval forward profile: bfloat16, on {smi}: wall {wall_ms:.2f} ms "
        f"({prof_ms:.1f} ms with the profiler on), device busy "
        f"{busy_us / 1e3:.2f} ms, device idle "
        f"{100 * (1 - busy_us / 1e3 / wall_ms):.1f}% of the forward; top "
        f"device ops by self time: " + "; ".join(
            f"{_short(name)[:90]} {us / 1e3:.2f} ms "
            f"({100 * us / busy_us:.1f}%)"
            for name, us in top))
    return wall_ms


def profile_round(dev, smi, train, ghost) -> None:
    """One steady-state round: float32 (as rounds 2 and on are), from the
    trained parameters, its arm built beforehand.  After a warm-up round
    (the allocator refills after the times phase), it runs once on the
    host clock and once more under ``torch.profiler``, which gives the
    device's busy time (the union of its kernels' intervals) and
    ghost_norm's share of it; the device idle share is busy time against
    the unprofiled wall time.  Beside it the main-path round times and the
    kernel share that the times phase's medians imply."""
    steady = dataclasses.replace(train["model"],
                                 init_fn=lambda seed: train["params"])
    cfg = _train_cfg(1, TRAIN["sigma"])
    t0 = time.perf_counter()
    arm = arms.get("decaph")(steady, train["silos"], cfg)
    build_s = time.perf_counter() - t0
    warm, arm_again = (arms.get("decaph")(steady, train["silos"], cfg)
                       for _ in range(2))
    arms.LocalRunner().run(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arms.LocalRunner().run(arm)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, by_kernel, prof_ms, spans = _device_profile(
        lambda: arms.LocalRunner().run(arm_again))
    # the row-sum kernel waits on the device for the tiles' grid, so the
    # union of both kernels' intervals, not the sum of their times
    ghost_us = _union_us((a, b) for name, a, b in spans
                         if "ghost_norm" in name) if spans else \
        sum(us for name, us in by_kernel.items() if "ghost_norm" in name)
    round_s = train["round_s"]
    est = {dt: TRAIN["hospitals"] * ghost["per_participant"][dt]["ms"]
           for dt in (torch.bfloat16, torch.float32)}
    say(f"train round: {ARCH} untied head full width, {TRAIN['hospitals']} "
        f"participants, on {smi}: main-path round wall s "
        f"{[round(x, 4) for x in round_s]} (round 1 computes in bfloat16 and "
        f"includes building the model and the arm; stepping float32 "
        f"gradients makes the parameters float32, so rounds 2 and on compute"
        f" in float32); ghost_norm at the times phase's medians: "
        f"{est[torch.bfloat16]:.2f} ms per bfloat16 round, "
        f"{est[torch.float32]:.2f} ms per float32 round = "
        f"{100 * est[torch.float32] / (1e3 * round_s[-1]):.1f}% of round "
        f"{len(round_s)}; building the arm {build_s:.3f} s")
    if busy_us <= 0:
        say(f"train round profile: steady float32 round wall {wall_ms:.1f} "
            f"ms; torch.profiler recorded no device time on this machine, so"
            f" device busy and idle share are not measured")
        return
    say(f"train round profile: steady float32 round, on {smi}: wall "
        f"{wall_ms:.1f} ms ({prof_ms:.1f} ms with the profiler on), device "
        f"busy {busy_us / 1e3:.1f} ms, device idle "
        f"{100 * (1 - busy_us / 1e3 / wall_ms):.1f}% of the round; "
        f"ghost_norm {ghost_us / 1e3:.1f} ms = {100 * ghost_us / busy_us:.1f}%"
        f" of device busy time, {100 * ghost_us / 1e3 / wall_ms:.1f}% of the "
        f"round")


def time_decode_step(engine, smi, position: int = SERVE_POSITION) -> dict:
    """``time_step`` of an engine's model, parameters and cache."""
    return time_step(engine.model_cfg, engine.params, engine.cache, smi,
                     position, engine.cfg.max_len)


def time_step(mcfg, params, cache, smi, position: int, max_len: int
              ) -> dict:
    """One full-width decode step of every slot of ``cache`` at
    ``position``: its time on the host clock (call + synchronise), its
    time on the device (the same step captured in a CUDA graph and
    replayed, so the host's per-op cost is out of the way; a capture also
    fails if the step syncs to the host), and the decode kernel's share of
    the device time."""
    caches = tf.layer_caches(mcfg, cache)
    slots = tree_leaves(caches[0])[0].shape[0]
    dev = tree_leaves(caches[0])[0].device
    tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    positions = torch.full((slots,), position, dtype=torch.int32, device=dev)
    args = (mcfg, params, cache, tokens, positions)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        tf.decode_step_positions(*args)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tf.decode_step_positions(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tf.decode_step_positions(*args)
    step_ms = graph_ms(graph, 20)
    # the layers whose attention runs the kernel (GQA's K and V; MLA's
    # compressed cache has none)
    attn = [c["attn"] for c in caches if "k" in c.get("attn", {})]
    kernel_ms, share = None, "no decode_attention layer"
    if attn and mcfg.use_decode_kernel:
        q = torch.randn((slots, 1, mcfg.n_heads, mcfg.head_dim), device=dev
                        ).to(mcfg.cdtype)
        layers = [(q, c["k"], c["v"], positions)
                  for c in attn]                 # each layer's cache, cold
        kernel_ms = device_ms(decode_ops.decode_attention, layers, 64)
        share = (f"decode_attention {kernel_ms:.4f} ms x {len(attn)} layers"
                 f" = {100 * len(attn) * kernel_ms / step_ms:.1f}% of the "
                 f"device step")
    del graph
    say(f"decode step: {mcfg.name} full width {str(mcfg.cdtype)[6:]}, "
        f"{slots} slots at position {position} of {max_len}, medians, on "
        f"{smi}: host {host_ms:.4f} ms, device {step_ms:.4f} ms (CUDA graph "
        f"replay), device idle {100 * (1 - step_ms / host_ms):.1f}% of the "
        f"host step; {share}")
    return {"host_ms": host_ms, "step_ms": step_ms, "kernel_ms": kernel_ms}


# -- 12. hot swap: phase 6's published rounds into a serving engine --------------


def _run_slots(engine, first, later, swap_after: int, watcher=None):
    """Admit ``first``, step ``swap_after`` times, then (with a watcher)
    poll it once, admit ``later`` and step until every request is done.
    Returns the poll's wall time in ms (None without a watcher)."""
    for r in first:
        if engine.admit(r):
            raise AssertionError(f"request {r.rid} ended at admission")
    for _ in range(swap_after):
        engine.step()
    swap_ms = None
    if watcher is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swapped = engine.poll_watcher(watcher)
        torch.cuda.synchronize()
        swap_ms = (time.perf_counter() - t0) * 1e3
        if not swapped:
            raise AssertionError("poll_watcher found no round to swap in")
    for r in later:
        if engine.admit(r):
            raise AssertionError(f"request {r.rid} ended at admission")
    while engine.busy():
        engine.step()
    return swap_ms


def _identical(a, b) -> bool:
    """Two parameter trees with the same keys, dtypes, shapes and bits."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _identical(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))


def hot_swap_path(dev, smi, train, ckpt_dir: str) -> int:
    """Serve phase 6's published rounds: a float32 engine at round -1 swaps
    in the newest one mid-stream; returns the decode kernel's launches on
    that engine (the directly built engine it is held against runs first
    and does not count)."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False,
                                    param_dtype="float32",
                                    compute_dtype="float32")
    scfg = ServeConfig(arch=ARCH, smoke=False, slots=8, max_len=512,
                       temperature=0.0, seed=SEED, device=str(dev))
    last = list_rounds(ckpt_dir)[-1]
    if last != TRAIN["rounds"] - 1:
        raise AssertionError(f"newest published round {last}")
    final = train["params"]
    rng = np.random.default_rng(SEED + 12)
    prompts = rng.integers(0, mcfg.vocab_size, (8, 16)).astype(np.int32)
    budget, swap_after = 24, 4

    def requests(rows, start):
        return [Request(rid=start + i, arrival=0.0, prompt=prompts[i],
                        max_new_tokens=budget) for i in rows]

    # the yardstick: an engine built directly from phase 6's parameters,
    # the same requests in the same slots at the same steps
    direct = ServeEngine(scfg, model_cfg=mcfg, params=final)
    want = requests(range(4, 8), 4)
    _run_slots(direct, requests(range(4), 0), want, swap_after)
    del direct

    engine = ServeEngine(scfg, model_cfg=mcfg)      # seeded, round -1
    cache = {k: v.data_ptr() for k, v in engine.cache.items()}
    trace = generate_requests(TrafficConfig(rate=16, n_requests=16,
                                            vocab_size=mcfg.vocab_size,
                                            seed=SEED + 12))
    watcher = CheckpointWatcher(ckpt_dir)
    inflight, later = requests(range(4), 0), requests(range(4, 8), 4)
    decode_ops.reset_launches()
    swap_ms = _run_slots(engine, inflight, later, swap_after, watcher)
    result = run_open_loop(engine, trace, watcher=watcher)
    launches = decode_ops.launches()

    if engine.serving_round != last or engine.swaps != 1:
        raise AssertionError(f"serving round {engine.serving_round} after "
                             f"{engine.swaps} swaps, expected {last} after 1")
    if {k: v.data_ptr() for k, v in engine.cache.items()} != cache:
        raise AssertionError("the swap reallocated the KV cache")
    if not _identical(engine.params, final):
        raise AssertionError("the swapped parameters are not phase 6's "
                             "final ones bit for bit")
    short = [r.rid for r in inflight + later if len(r.tokens) != budget]
    if short:
        raise AssertionError(f"requests {short} ended short of their budget")
    if any(r.round_at_first != -1 for r in inflight) or \
            any(r.round_at_first != last for r in later):
        raise AssertionError("a request's first token came from the wrong "
                             "round")
    mismatched = [r.rid for r, w in zip(later, want) if r.tokens != w.tokens]
    if mismatched:
        raise AssertionError(f"greedy tokens after the swap differ from the "
                             f"directly built engine's for {mismatched}")
    done = sorted(r.rid for r in result.completed)
    if done != [r.rid for r in trace] or \
            any(len(r.tokens) != r.max_new_tokens for r in result.completed):
        raise AssertionError(f"{len(done)} of {len(trace)} watched requests "
                             "completed their budget")
    if not result.steps or any(
            (st.latest_round, st.serving_round) != (last, last)
            for st in result.steps) or result.swaps:
        raise AssertionError("the watched run did not serve the last round "
                             "throughout")
    positions = engine.decode_steps + sum(
        len(r.prompt) for r in inflight + later + trace)
    if launches != mcfg.n_layers * positions:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {mcfg.n_layers} x {positions} "
                             "positions")
    row = summarize(result, slots=8, rate=16)
    say(f"hot swap: {ARCH} untied head, full width float32, 8 slots x 512, "
        f"greedy: round -1 -> {last} after {swap_after} steps with 4 requests"
        f" in flight (each finished its {budget} tokens); swapped parameters "
        f"= phase 6's bit for bit; 4 requests admitted after the swap = the "
        f"directly built engine's tokens; watched trace of {len(trace)} "
        f"requests: all completed, latest_round = serving_round = {last} at "
        f"all {len(result.steps)} steps, {row['throughput_tok_s']} tok/s; "
        f"decode_attention launches {launches}")
    say(f"hot swap: load-and-swap (poll_watcher: read "
        f"{Path(checkpoint_path(ckpt_dir, last)).stat().st_size:,} bytes, "
        f"decode, copy to the card) {swap_ms:.2f} ms on {smi}")
    time_handoff(dev, smi, mcfg, final, checkpoint_path(ckpt_dir, last))
    return launches


def time_handoff(dev, smi, cfg, params, path: str) -> None:
    """The publish and the load-and-swap in their parts, on the host clock
    (each synchronised): the parameters' copy to the host, the file's
    write from host tensors, the file's read and decode, and the copy of
    its tree to the card."""
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    host = timed("D2H copy", lambda: tree_map(
        lambda t: t.cpu(), params_to_tree(params)))
    spare = str(Path(path).with_name("timed.msgpack"))
    timed("write", lambda: save_checkpoint(spare, host, step=0))
    Path(spare).unlink()
    tree, _, _ = timed("read + decode", lambda: load_checkpoint(path))
    timed("H2D copy", lambda: params_from_tree(tree, cfg, dev))
    say(f"handoff parts: {', '.join(f'{k} {v:.2f} ms' for k, v in ms.items())}"
        f" ({Path(path).stat().st_size:,} bytes) on {smi}")


# -- 13. the tabular main path: the paper's DeCaPH behind SecAgg ----------------

# the paper's three case studies at paper scale, with the settings of
# benchmarks/{pancreas,gemini,xray}_utility.py; SecAgg on, sigma 1.0
PANCREAS = dict(sizes=[15558, 1000, 100, 4], task="multiclass",
                data=dict(seed=SEED, n_total=10548, n_silos=5, n_genes=15558,
                          n_types=4),
                rounds=3, batch_size=96, lr=0.3, clip=0.5, sigma=1.0,
                microbatch=8, params=15_659_504)
GEMINI = dict(sizes=[436, 300, 100, 50, 10, 1], task="binary",
              data=dict(seed=SEED, n_total=40114, n_silos=8),
              rounds=3, batch_size=128, lr=0.5, clip=1.0, sigma=1.0,
              microbatch=16, params=166_771)
XRAY = dict(densenet=tabular.DenseNetConfig(),          # the "full" preset
            data=dict(seed=SEED, n_total=1800, n_silos=3, image_size=32),
            rounds=3, batch_size=48, lr=0.1, clip=0.5, sigma=1.0,
            microbatch=8)
F32_EPS = 2.0 ** -24   # float32 unit roundoff


def _tabular_cfg(case, *, rounds=None, sigma=None, use_secagg=True
                 ) -> arms.ArmConfig:
    return arms.ArmConfig(
        rounds=case["rounds"] if rounds is None else rounds,
        batch_size=case["batch_size"], lr=case["lr"], seed=SEED,
        use_secagg=use_secagg,
        dp=DPConfig(clip_norm=case["clip"],
                    noise_multiplier=case["sigma"] if sigma is None
                    else sigma,
                    microbatch_size=case["microbatch"]))


def _sum_tree(trees, fn):
    """{leaf index: float64 sum over the trees of fn(leaf)}."""
    out = [np.zeros(np.shape(leaf), np.float64)
           for leaf in tree_leaves(trees[0])]
    for tree in trees:
        for acc, leaf in zip(out, tree_leaves(tree)):
            acc += fn(np.asarray(leaf, np.float64))
    return out


def _checked_secure_sum(worst: list):
    """``runners.secure_sum`` that holds every decoded total against the
    float64 sum of the payloads that left the card: within n half-steps of
    the fixed-point grid, plus the float32 rounding of the total.  Appends
    each round's (max |error|, max error / limit) to ``worst``."""
    real = runners.secure_sum

    def checked(trees, scfg, **kw):
        out = real(trees, scfg, **kw)
        n, step = len(trees), 2.0 ** -(scfg.frac_bits + 1)
        err = ratio = 0.0
        for ref, got in zip(_sum_tree(trees, lambda a: a), tree_leaves(out)):
            got = got.cpu().numpy().astype(np.float64)
            diff = np.abs(got - ref)
            limit = n * step + 2 * F32_EPS * np.abs(got)
            if diff.size:
                err = max(err, float(diff.max()))
                ratio = max(ratio, float((diff / limit).max()))
        worst.append((err, ratio))
        if ratio > 1.0:
            raise AssertionError(f"secure sum off the payloads' float64 sum "
                                 f"by {err:.3e}, {ratio:.3f} x its limit")
        return out

    return checked


def _counting_stack_poisson(sizes: list):
    """``fused.stack_poisson`` that records each round's Poisson total."""
    real = fused_lib.stack_poisson

    def counting(*a, **kw):
        cb = real(*a, **kw)
        sizes.append(sum(cb.sizes))
        return cb

    return counting


def secure_main_run(name, smi, model, silos, case, n_params) -> dict:
    """``arms.run("decaph", ...)`` with SecAgg for ``case["rounds"]``
    rounds: losses finite, ε the accountant's, one program call per round,
    each aggregate batch the round's Poisson total, each secure sum within
    its fixed-point limit of the payloads' float64 sum."""
    cfg = _tabular_cfg(case)
    if not cfg.use_secagg:
        raise AssertionError("the tabular main path must run SecAgg")
    sums, sizes, marks = [], [], []

    def on_round(t, params):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()       # what earlier phases still hold
    reset_jit_dispatches()
    with mock.patch.object(runners, "secure_sum", _checked_secure_sum(sums)), \
            mock.patch.object(fused_lib, "stack_poisson",
                              _counting_stack_poisson(sizes)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = arms.run("decaph", model, silos, cfg, backend="ideal",
                          on_round=on_round)
    calls = jit_dispatches()
    peak = torch.cuda.max_memory_allocated()
    got = sum(p.numel() for p in tree_leaves(report.params))
    if got != n_params:
        raise AssertionError(f"{name}: {got} parameters, expected {n_params}")
    rounds = case["rounds"]
    if report.rounds_completed != rounds or len(sums) != rounds:
        raise AssertionError(f"{name}: {report.rounds_completed} rounds "
                             f"completed, {len(sums)} secure sums, expected "
                             f"{rounds}")
    losses = [l.loss for l in report.logs]
    if not all(math.isfinite(x) for x in losses) or not all(
            bool(torch.isfinite(p).all()) for p in tree_leaves(report.params)):
        raise AssertionError(f"{name}: non-finite losses {losses} or "
                             "parameters")
    n_examples = sum(len(p) for p in silos)
    acct = RDPAccountant(sampling_rate=case["batch_size"] / n_examples,
                         noise_multiplier=case["sigma"], delta=cfg.dp.delta)
    acct.step(rounds)
    if report.epsilon != acct.epsilon():
        raise AssertionError(f"{name}: ε {report.epsilon} != the "
                             f"accountant's {acct.epsilon()}")
    if calls != rounds:
        raise AssertionError(f"{name}: {calls} program calls for {rounds} "
                             "fused rounds")
    batches = [l.aggregate_batch for l in report.logs]
    if batches != sizes:
        raise AssertionError(f"{name}: aggregate batches {batches} != the "
                             f"rounds' Poisson totals {sizes}")
    round_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    bytes_up = secagg.secagg_message_bytes(n_params, len(silos))
    say(f"tabular {name}: {n_params:,} parameters, {len(silos)} hospitals "
        f"({n_examples:,} examples), batch {case['batch_size']}, sigma "
        f"{case['sigma']}, SecAgg on, on {smi}: {rounds} rounds, aggregate "
        f"batches {batches} = the Poisson totals, losses "
        f"{[round(x, 4) for x in losses]}, ε {report.epsilon:.6f} "
        f"(accountant {acct.epsilon():.6f}), {calls} program calls; secure "
        f"sum vs the payloads' float64 sum: max |error| "
        f"{max(e for e, _ in sums):.3e}, at most "
        f"{max(r for _, r in sums):.3f} of its limit; round wall s "
        f"{[round(x, 4) for x in round_s]} (with that check); "
        f"{bytes_up['per_participant_bytes']:,.0f} bytes per upload; peak "
        f"memory {(peak - held) / 2**30:.2f} GiB above the "
        f"{held / 2**30:.2f} GiB held before the run")
    return {"report": report, "round_s": round_s, "peak": peak}


def _timed(store: dict, key: str, fn):
    """``fn`` that adds its synchronised wall time in ms to ``store[key]``."""

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        store[key] = store.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    return wrapper


def secure_round_parts(smi, model, silos, params, case) -> None:
    """One steady SecAgg round of ``case`` from ``params`` (the main run
    has just run these shapes, so no warm-up): its wall time and its parts,
    each synchronised (the cohort step on the card; the payloads' copy to
    the host; encode and masking, with the pair pads apart; aggregate and
    decode; the copy back; the batch-size sum), then the same round
    profiled for the device busy time and idle share."""
    steady = dataclasses.replace(model, init_fn=lambda seed: params)
    arm_cls = arms.get("decaph")
    # built once, outside the timed rounds (its accountant's RDP table takes
    # seconds on the host); each run restarts from ``params`` and reseeds
    # the Poisson draws, so every round below is the same round
    arm = arm_cls(steady, silos, _tabular_cfg(case, rounds=1))

    def one_round():
        arms.LocalRunner().run(arm)

    parts: dict[str, float] = {}
    real_aggregate = secagg.SecAggSession.aggregate
    with mock.patch.object(arm, "_fused_step", _timed(
            parts, "cohort step", arm._fused_step)), \
            mock.patch.object(fused_lib, "build_contributions", _timed(
                parts, "payloads to host", fused_lib.build_contributions)), \
            mock.patch.object(secagg.SecAggSession, "upload_all", _timed(
                parts, "encode + masks", secagg.SecAggSession.upload_all)), \
            mock.patch.object(secagg.SecAggSession, "_flat_masks", _timed(
                parts, "pads", secagg.SecAggSession._flat_masks)), \
            mock.patch.object(secagg.SecAggSession, "aggregate", _timed(
                parts, "aggregate", real_aggregate)), \
            mock.patch.object(secagg, "_to_tensors", _timed(
                parts, "copy back", secagg._to_tensors)), \
            mock.patch.object(runners, "secure_sum_ints", _timed(
                parts, "batch-size sum", runners.secure_sum_ints)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the pads are drawn inside upload_all (the masks are built lazily), and
    # the copy back happens inside aggregate: each part once
    parts["encode + mask add"] = parts.pop("encode + masks") - parts["pads"]
    parts["aggregate + decode"] = parts.pop("aggregate") - parts["copy back"]
    parts["rest"] = wall_ms - sum(parts.values())
    n_params = sum(p.numel() for p in tree_leaves(params))
    say(f"tabular round parts: pancreas MLP steady round with SecAgg, "
        f"{len(silos)} hospitals x {4 * n_params:,} bytes of payload, on "
        f"{smi}: wall {wall_ms:.1f} ms = "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in parts.items()))
    busy_us, by_kernel, prof_ms, _ = _device_profile(one_round)
    if busy_us <= 0:
        say("tabular round profile: torch.profiler recorded no device time "
            "on this machine, so device busy and idle share are not measured")
        return
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    say(f"tabular round profile: pancreas MLP steady round with SecAgg, on "
        f"{smi}: wall {wall_ms:.1f} ms ({prof_ms:.1f} ms with the profiler "
        f"on), device busy {busy_us / 1e3:.1f} ms, device idle "
        f"{100 * (1 - busy_us / 1e3 / wall_ms):.1f}% of the round; top device"
        f" ops: " + "; ".join(f"{_short(k)[:60]} {us / 1e3:.2f} ms"
                              for k, us in top))


def _argmax_accuracy(model, params, silos) -> float:
    x = np.concatenate([p.x for p in silos])
    y = np.concatenate([p.y for p in silos])
    with torch.no_grad():
        probs = model.predict_fn(params, torch.from_numpy(x).to(
            tree_leaves(params)[0].device))
    return float((probs.argmax(-1).cpu().numpy() == y).mean())


def tabular_main_path(dev, smi) -> dict:
    """The paper's three case studies with DeCaPH behind SecAgg at paper
    scale, the pancreas round in its parts, and the CLI on the card.
    Returns the pancreas model, silos, report and trained parameters, and
    the GEMINI model and silos."""
    t0 = time.perf_counter()
    silos = arms.normalize_participants(make_pancreas_like(**PANCREAS["data"]))
    data_s = time.perf_counter() - t0
    model = tabular.make_mlp_classifier(PANCREAS["sizes"], PANCREAS["task"],
                                        device=str(dev))
    out = secure_main_run("pancreas MLP", smi, model, silos, PANCREAS,
                          PANCREAS["params"])
    params = out["report"].params
    say(f"tabular pancreas MLP: data {data_s:.1f} s on the host; pooled "
        f"argmax accuracy after {PANCREAS['rounds']} rounds "
        f"{_argmax_accuracy(model, params, silos):.4f} (printed only)")
    secure_round_parts(smi, model, silos, params, PANCREAS)
    torch.cuda.empty_cache()

    gsilos = arms.normalize_participants(make_gemini_like(**GEMINI["data"]))
    gmodel = tabular.make_mlp_classifier(GEMINI["sizes"], GEMINI["task"],
                                         device=str(dev))
    g = secure_main_run(f"GEMINI MLP ({len(gsilos) * (len(gsilos) - 1) // 2} "
                        "mask pairs)", smi, gmodel, gsilos, GEMINI,
                        GEMINI["params"])
    say(f"tabular GEMINI MLP: pooled accuracy "
        f"{tabular.pooled_accuracy(gmodel, g['report'].params, gsilos):.4f}"
        " (printed only)")

    xsilos = arms.normalize_participants(make_xray_like(**XRAY["data"]))
    xmodel = tabular.make_densenet(XRAY["densenet"], device=str(dev))
    x_params = sum(p.numel() for p in tree_leaves(xmodel.init_fn(SEED)))
    x = secure_main_run("DenseNet (full preset)", smi, xmodel, xsilos, XRAY,
                        x_params)
    say(f"tabular DenseNet: pooled multilabel accuracy "
        f"{tabular.pooled_accuracy(xmodel, x['report'].params, xsilos):.4f}"
        " (printed only)")

    t0 = time.perf_counter()
    rc = run_cli.main(["--arm", "decaph", "--rounds", "3"])
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.run returned {rc}")
    say(f"tabular CLI: repro_torch.run.main(['--arm', 'decaph', '--rounds', "
        f"'3']) on the card by default: rc 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"model": model, "silos": silos, "params": params,
            "report": out["report"],
            "gemini": {"model": gmodel, "silos": gsilos}}


# -- 14. the tabular whole path: SecAgg against the plain sum, ghost vs faithful --


def _update_bound(params0, sec, plain, abs_sum, lr, n, frac_bits, batch):
    """Per coordinate, |(sec - p0) - (plain - p0)| against the fixed-point
    limit lr * n * 2^-(frac_bits+1) / batch plus float32 rounding: of the
    two totals (n + 4 roundings of the payloads' absolute sum, decode,
    division and product included) and of the two final subtractions.
    Returns (max |difference|, max difference / limit, L2 of the plain
    update)."""
    diff = ratio = upd_sq = 0.0
    for p0, ps, pp, a in zip(tree_leaves(params0), tree_leaves(sec),
                             tree_leaves(plain), abs_sum):
        p0, ps, pp = (t.double().cpu().numpy() for t in (p0, ps, pp))
        d = np.abs((ps - p0) - (pp - p0))
        limit = lr / batch * (n * 2.0 ** -(frac_bits + 1)
                              + (n + 4) * F32_EPS * a) \
            + F32_EPS * (np.abs(ps) + np.abs(pp))
        diff = max(diff, float(d.max()))
        ratio = max(ratio, float((d / limit).max()))
        upd_sq += float(np.square(pp - p0).sum())
    return diff, ratio, math.sqrt(upd_sq)


def tabular_whole_path(dev, smi, pancreas) -> None:
    """At sigma 0 in float32: one pancreas round with SecAgg against the
    same round without it, and ``ghost_clipped_grad_sum_mlp`` against the
    faithful per-example clipped sum on one Poisson batch of the full-width
    pancreas MLP."""
    case, silos = PANCREAS, pancreas["silos"]
    params0 = pancreas["params"]
    model = dataclasses.replace(pancreas["model"],
                                init_fn=lambda seed: params0)
    abs_sum: list = []
    real = runners.secure_sum

    def keep_abs(trees, scfg, **kw):
        abs_sum.extend(_sum_tree(trees, np.abs))
        return real(trees, scfg, **kw)

    with mock.patch.object(runners, "secure_sum", keep_abs):
        sec = arms.run("decaph", model, silos,
                       _tabular_cfg(case, rounds=1, sigma=0.0))
    plain = arms.run("decaph", model, silos,
                     _tabular_cfg(case, rounds=1, sigma=0.0,
                                  use_secagg=False))
    batch = sec.logs[0].aggregate_batch
    if batch != plain.logs[0].aggregate_batch or not abs_sum:
        raise AssertionError("the secure and plain rounds saw different "
                             "batches, or the secure sum never ran")
    diff, ratio, upd = _update_bound(params0, sec.params, plain.params,
                                     abs_sum, case["lr"], len(silos), 16,
                                     batch)
    ok = ratio <= 1.0 and upd > 0
    say(f"tabular whole path: pancreas MLP full width float32, sigma 0, one "
        f"round with SecAgg vs without (aggregate batch {batch}), on {smi}: "
        f"plain update L2 {upd:.6e}, max |difference| {diff:.3e}, at most "
        f"{ratio:.3f} of the limit lr n 2^-17 / batch + float32 rounding "
        f"({case['lr'] * len(silos) * 2.0 ** -17 / batch:.3e} + ...) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the SecAgg round and the plain round disagree "
                             "beyond the fixed-point limit")

    rng = np.random.default_rng(SEED)
    rate = case["batch_size"] / sum(len(p) for p in silos)
    b, _, k = poisson_batch(rng, silos[0], rate, 8)
    batch = {"x": torch.from_numpy(b["x"][:k]).to(dev),
             "y": torch.from_numpy(b["y"][:k]).to(dev)}
    clip = case["clip"]
    ghost, gnorms = tabular.ghost_clipped_grad_sum_mlp(
        params0, batch, case["sizes"], case["task"], clip)
    faithful, _ = dp_lib.per_example_clipped_grad_sum(
        model.loss_fn, params0, batch, clip_norm=clip,
        microbatch_size=case["microbatch"])
    grad = torch.func.vmap(torch.func.grad(model.loss_fn), in_dims=(None, 0))
    norms = torch.cat([
        torch.func.vmap(dp_lib.global_l2_norm)(grad(
            params0, {key: v[i:i + case["microbatch"]]
                      for key, v in batch.items()}))
        for i in range(0, k, case["microbatch"])])
    diff_sq = ref_sq = 0.0
    for g, f in zip(tree_leaves(ghost), tree_leaves(faithful)):
        diff_sq += float((g.double() - f.double()).square().sum())
        ref_sq += float(f.double().square().sum())
    rel = math.sqrt(diff_sq / ref_sq)
    norm_rel = float(((gnorms - norms).abs() / norms).max())
    ok = rel <= 1e-5 and norm_rel <= 1e-5 and bool((norms > 0).all())
    say(f"tabular whole path: pancreas MLP full width float32, one Poisson "
        f"batch of {k} examples, ghost_clipped_grad_sum_mlp vs "
        f"per_example_clipped_grad_sum: clipped sums {rel:.3e} relative in L2"
        f" (limit 1e-5), norms {norm_rel:.3e} relative (rtol 1e-5), "
        f"{int((norms > clip).sum())} of {k} clipped "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ghost and faithful clipping disagree on the "
                             "pancreas MLP")


# -- 15. the comparison arms at the paper's scale --------------------------------

# every other arm on phase 13's GEMINI configuration (the node arms take
# gossip_steps=3), and primia through the ghost_norm kernel at full width
ARMS_GEMINI = [("fl", {}), ("fl", {"fl_local_steps": 3}), ("fedprox", {}),
               ("scaffold", {}), ("primia", {}), ("local", {}),
               ("gossip", {}), ("gossip-dp", {})]
PRIMIA_LM = dict(TRAIN, rounds=2)        # phase 6's silos, batch and sigma


def _arm_label(name, kw) -> str:
    return name + "".join(f" {k}={v}" for k, v in kw.items())


def _client_epsilons(arm, rounds: int) -> list[tuple[float, float]]:
    """(arm's ε, a fresh RDPAccountant's ε) per client of a per-client-DP
    arm (primia, gossip-dp) after ``rounds`` steps each."""
    out = []
    for rate, acct in zip(arm.rates, arm.accts):
        fresh = RDPAccountant(sampling_rate=rate,
                              noise_multiplier=arm.cfg.dp.noise_multiplier,
                              delta=arm.cfg.dp.delta)
        fresh.step(rounds)
        out.append((acct.epsilon(), fresh.epsilon()))
    return out


def _pooled_loss(model, params, silos) -> float:
    """Mean per-example loss of ``params`` over every silo's examples."""
    x = torch.from_numpy(np.concatenate([p.x for p in silos]))
    y = torch.from_numpy(np.concatenate([p.y for p in silos]))
    dev = tree_leaves(params)[0].device
    with torch.no_grad():
        loss = batch_loss_fn(model)(params, {"x": x.to(dev), "y": y.to(dev)})
    return float(loss.double().mean())


def _run_arm(arm, dev) -> tuple[arms.RunReport, list[float], int]:
    """One arm object on ``ideal`` (as ``arms.run`` runs it): the report,
    its round walls (synchronised at each round's end) and its program
    calls."""
    marks = []

    def on_round(t, params):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    reset_jit_dispatches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = arms.LocalRunner(on_round=on_round).run(arm)
    torch.cuda.synchronize()
    end = time.perf_counter()
    walls = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    return report, walls or [end - t0], jit_dispatches()


def comparison_arms_path(dev, smi, gemini) -> int:
    """Phase 15: the paper's comparison arms on GEMINI at paper scale (ε,
    one program call per fused round, the per-participant path against
    the fused round at sigma 0), then primia on SmolLM-360M at full width
    through ``ghost_norm``; returns that run's ghost_norm launches."""
    model, silos = gemini["model"], gemini["silos"]
    case = GEMINI
    n_examples = sum(len(p) for p in silos)
    for name, kw in ARMS_GEMINI:
        cfg = dataclasses.replace(_tabular_cfg(case, use_secagg=False),
                                  gossip_steps=case["rounds"], **kw)
        arm_cls = arms.get(name)
        arm = arm_cls(model, silos, cfg)
        report, walls, calls = _run_arm(arm, dev)
        rounds = case["rounds"]
        if report.rounds_completed != rounds or not all(
                bool(torch.isfinite(p).all())
                for p in tree_leaves(report.params)):
            raise AssertionError(f"{name}: {report.rounds_completed} rounds "
                                 "or non-finite parameters")
        if arm_cls.mode == "round" and calls != rounds:
            raise AssertionError(f"{name}: {calls} program calls for "
                                 f"{rounds} fused rounds")
        eps_note = ""
        if arm_cls.private:
            pairs = _client_epsilons(arm, rounds)
            if any(a != b for a, b in pairs) or \
                    report.epsilon != max(b for _, b in pairs):
                raise AssertionError(f"{name}: per-client ε {pairs} vs the "
                                     f"accountants', run ε {report.epsilon}")
            eps_note = (f", every client's ε its own accountant's (max "
                        f"{report.epsilon:.6f})")
        elif report.epsilon != 0.0:
            raise AssertionError(f"{name}: ε {report.epsilon} for a "
                                 "non-private arm")
        losses = [l.loss for l in report.logs]
        say(f"arms {_arm_label(name, kw)}: GEMINI MLP, {len(silos)} hospitals"
            f" ({n_examples:,} examples), batch {case['batch_size']}, sigma "
            f"{case['sigma']}, on {smi}: {report.rounds_completed} rounds, "
            f"logged losses {[round(x, 4) for x in losses]} (NaN where the "
            f"arm logs none, as in the reference), pooled loss after "
            f"{_pooled_loss(model, report.params, silos):.4f}, ε "
            f"{report.epsilon:.6f}{eps_note}, {calls} program calls "
            f"({calls / rounds:g} per round), wall s "
            f"{[round(x, 4) for x in walls]}, pooled accuracy "
            f"{tabular.pooled_accuracy(model, report.params, silos):.4f}")
    for name in ("fl", "primia"):
        cfg = _tabular_cfg(case, sigma=0.0, use_secagg=False)
        fused = arms.run(name, model, silos, cfg)
        loop = arms.run(name, model, silos,
                        dataclasses.replace(cfg, fused_rounds=False))
        diff = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(fused.params), tree_leaves(loop.params)))
        say(f"arms {name} per-participant path: fused_rounds=False vs the "
            f"fused round at sigma 0, GEMINI, 3 rounds, on {smi}: max "
            f"|difference| {diff:.3e} (limit 1e-5)")
        if not diff <= 1e-5:
            raise AssertionError(f"{name}: the per-participant path is "
                                 f"{diff} off the fused round")

    mcfg = get_config(ARCH).replace(tie_embeddings=False)
    lm = transformer_model(mcfg, device=str(dev))
    lm_silos = _silos(mcfg)
    cfg = _train_cfg(PRIMIA_LM["rounds"], PRIMIA_LM["sigma"])
    arm = arms.get("primia")(lm, lm_silos, cfg)
    if arm.clipping_path != "ghost":
        raise AssertionError(f"primia took {arm.clipping_path} clipping")
    ghost_ops.reset_launches()
    report, walls, calls = _run_arm(arm, dev)
    launches = ghost_ops.launches()
    per_participant = 7 * mcfg.n_layers + 1
    expected = per_participant * PRIMIA_LM["hospitals"] * PRIMIA_LM["rounds"]
    if launches != expected:
        raise AssertionError(f"primia: ghost_norm launched {launches} times, "
                             f"expected {expected}")
    pairs = _client_epsilons(arm, PRIMIA_LM["rounds"])
    if report.rounds_completed != PRIMIA_LM["rounds"] or \
            calls != PRIMIA_LM["rounds"] or any(a != b for a, b in pairs):
        raise AssertionError(f"primia: {report.rounds_completed} rounds, "
                             f"{calls} program calls, ε {pairs}")
    if not all(bool(torch.isfinite(p).all())
               for p in tree_leaves(report.params)):
        raise AssertionError("primia: non-finite parameters")
    say(f"arms primia: {ARCH} untied head, full width, "
        f"{PRIMIA_LM['hospitals']} hospitals x {PRIMIA_LM['n_per']} x "
        f"{PRIMIA_LM['seq_len']} tokens, batch {PRIMIA_LM['batch_size']} "
        f"({PRIMIA_LM['batch_size'] // PRIMIA_LM['hospitals']} per client),"
        f" sigma {PRIMIA_LM['sigma']}, ghost clipping, on {smi}: "
        f"{report.rounds_completed} rounds, ghost_norm launches {launches} "
        f"({per_participant} per participant and round), {calls} program "
        f"calls, every client's ε its own accountant's "
        f"({pairs[0][0]:.6f}), round wall s {[round(x, 4) for x in walls]}")
    return launches


# -- 16. the simulated-time backend: DeCaPH with dropout-robust SecAgg ------------


def _checked_sim_sums(worst: list):
    """``_SimServices.sum_payloads`` that holds each secure total (with its
    top-up, if any) against the float64 sum of the delivered payloads plus
    the top-up: within n half-steps of the fixed-point grid, plus the
    float32 roundings of the decode and of the top-up's add.  Appends
    (survivors, topped up, max |error|, max error / limit) per round."""
    real = runners._SimServices.sum_payloads

    def checked(self, payloads):
        out = real(self, payloads)
        trees = [payloads[i] for i in sorted(payloads)]
        ref = _sum_tree(trees, lambda a: a)
        if self._topup is not None:
            for acc, t in zip(ref, tree_leaves(self._topup)):
                acc += t.double().cpu().numpy()
        step = 2.0 ** -(self._session.cfg.frac_bits + 1)
        err = ratio = 0.0
        for want, got in zip(ref, tree_leaves(out)):
            got = got.cpu().numpy().astype(np.float64)
            diff = np.abs(got - want)
            limit = len(trees) * step + 3 * F32_EPS * np.abs(got)
            if diff.size:
                err = max(err, float(diff.max()))
                ratio = max(ratio, float((diff / limit).max()))
        worst.append((len(trees), self._topup is not None, err, ratio))
        if ratio > 1.0:
            raise AssertionError(f"sim secure sum off the payloads' float64 "
                                 f"sum by {err:.3e}, {ratio:.3f} x its limit")
        return out

    return checked


def _sim_run(model, silos, cfg, nodes):
    """``arms.run(..., backend="sim")`` with every secure sum checked, the
    obs spans recorded and each round's upload window kept; returns
    (report, checks, span totals, [(start, end) simulated s], wall s)."""
    checks: list = []
    windows: list = []
    real_gather = runners.SimRunner._gather_round

    def gather(self, engine, dst, work):
        start = engine.now
        out = real_gather(self, engine, dst, work)
        windows.append((start, engine.now))
        return out

    with obs.recording() as rec, mock.patch.object(
            runners._SimServices, "sum_payloads", _checked_sim_sums(checks)), \
            mock.patch.object(runners.SimRunner, "_gather_round", gather):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = arms.run("decaph", model, silos, cfg, backend="sim",
                          nodes=nodes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = rec.span_totals()
    return report, checks, spans, windows, wall


def _timing(report) -> str:
    t = report.timing
    return (f"sim wall {t.wall_clock:.3f} s, {t.bytes_on_wire:,.0f} bytes on "
            f"the wire, {t.dropout_events} dropouts, {t.recoveries} "
            f"recoveries, {t.noise_topups} top-ups, {t.lost_rounds} lost "
            f"rounds, {t.events} events")


def sim_path(dev, smi, pancreas) -> dict:
    """Phase 16: phase 13's pancreas DeCaPH on ``sim`` with SecAgg — on a
    clean heterogeneous trace bit for bit phase 13's ``ideal`` run, then
    with a hospital dropping out during round 1's upload: recovered,
    topped up, within the fixed-point limit, ε the accountant's.  Returns
    the dropout run's node trace and report (phase 25 replays them)."""
    case, model, silos = PANCREAS, pancreas["model"], pancreas["silos"]
    h = len(silos)
    cfg = _tabular_cfg(case)
    ideal = pancreas["report"]
    clean, checks, spans, windows, wall = _sim_run(
        model, silos, cfg, nodes_from_trace(heterogeneous_trace(h)))
    same = clean.rounds_completed == ideal.rounds_completed and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(clean.params),
                                          tree_leaves(ideal.params))) and \
        [l.loss for l in clean.logs] == [l.loss for l in ideal.logs]
    say(f"sim clean: pancreas MLP, {h} hospitals, SecAgg "
        f"(dropout-robust session), heterogeneous_trace({h}), on {smi}: "
        f"{clean.rounds_completed} rounds, {_timing(clean)}; parameters and "
        f"losses bit-identical to phase 13's ideal run: {same}; host wall "
        f"{wall:.2f} s")
    if not same:
        raise AssertionError("sim and ideal disagree under a clean trace")
    # the slowest hospital that does not lead round 1 (the last upload to
    # land) drops out a quarter into round 1's upload window of the clean
    # run, and rejoins between that window and round 2's
    leader = int(leader_schedule(h, case["rounds"], seed=SEED)[1])
    drop = h - 1 if leader != h - 1 else h - 2
    (start, end), (next_start, _) = windows[1], windows[2]
    t_off, t_on = start + 0.25 * (end - start), (end + next_start) / 2
    trace = heterogeneous_trace(h)
    trace[drop] = dict(trace[drop], dropouts=[[t_off, t_on]])
    report, checks, spans, _, wall = _sim_run(model, silos, cfg,
                                              nodes_from_trace(trace))
    t = report.timing
    acct = RDPAccountant(
        sampling_rate=case["batch_size"] / sum(len(p) for p in silos),
        noise_multiplier=case["sigma"], delta=cfg.dp.delta)
    acct.step(report.rounds_completed)
    ms = {k: 1e3 * spans.get(k, (0, 0.0))[1]
          for k in ("secagg.recover", "noise_topup", "secagg.encode",
                    "aggregate", "fused_round")}
    say(f"sim dropout: hospital {drop} off from {t_off:.3f} to {t_on:.3f} "
        f"simulated s (round 1's uploads {start:.3f}-{end:.3f} s), on {smi}: "
        f"{report.rounds_completed} rounds, {_timing(report)}; secure sums "
        f"(survivors, topped up, max |error|, / limit) "
        f"{[(n, tu, float(f'{e:.3e}'), round(r, 3)) for n, tu, e, r in checks]};"
        f" ε {report.epsilon:.6f} (accountant {acct.epsilon():.6f}); host ms: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
        + f"; host wall {wall:.2f} s")
    if t.recoveries < 1 or t.noise_topups < 1 or not any(
            tu and n < h for n, tu, _, _ in checks):
        raise AssertionError("the dropout run recovered or topped up nothing")
    if report.rounds_completed != case["rounds"] or \
            report.epsilon != acct.epsilon():
        raise AssertionError(f"{report.rounds_completed} rounds, ε "
                             f"{report.epsilon} != {acct.epsilon()}")
    return {"model": model, "silos": silos, "cfg": cfg, "trace": trace,
            "report": report}


# -- 17. the privacy audit (Fig. 5): LiRA on FL and DP targets -------------------

# benchmarks/mia.py's fast scale
MIA = dict(n=400, steps=60, shadows=8, sizes=[436, 64, 16, 1], lr=1.0,
           clip=1.0, sigma=0.8, batch=64, microbatch=16)


def _mia_train_fn(model, dev, *, private: bool):
    """``lira_attack``'s ``train_fn(x, y, seed)``: plain or DP-SGD steps of
    ``model`` on the card (the port's ``core.dp`` clipped sum and noise),
    from ``model.init_fn(seed)``, as ``benchmarks/mia.py`` trains."""
    case = MIA
    batch_loss = batch_loss_fn(model)
    mean_grad = torch.func.grad(lambda p, b: torch.mean(batch_loss(p, b)))

    def train_fn(x, y, seed):
        params = model.init_fn(seed)
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        n, bs = len(x), min(case["batch"], len(x))
        rng = np.random.default_rng(seed)
        for t in range(case["steps"]):
            idx = torch.from_numpy(rng.choice(n, bs, replace=False)).to(dev)
            batch = {"x": xd[idx], "y": yd[idx]}
            if private:
                g, _ = dp_lib.per_example_clipped_grad_sum(
                    model.loss_fn, params, batch, clip_norm=case["clip"],
                    microbatch_size=case["microbatch"])
                gen = torch.Generator(device=dev)
                gen.manual_seed(dp_lib.noise_seed(seed, t))
                g = dp_lib.tree_add_noise(
                    g, gen, clip_norm=case["clip"],
                    noise_multiplier=case["sigma"])
                g = tree_map(lambda v: v / bs, g)
            else:
                g = mean_grad(params, batch)
            params = tree_map(lambda p_, g_: p_ - case["lr"] * g_, params, g)
        return params

    return train_fn


def mia_path(dev, smi) -> None:
    """Phase 17: LiRA (``core.mia.lira_attack``) against an FL-trained and
    a DP-trained target, every shadow and target trained on the card."""
    case = MIA
    silos = make_gemini_like(seed=SEED, n_total=case["n"])
    x = np.concatenate([p.x for p in silos])[: case["n"]]
    y = np.concatenate([p.y for p in silos])[: case["n"]]
    x = ((x - x.mean(0)) / (x.std(0) + 1e-8)).astype(np.float32)
    model = tabular.make_mlp_classifier(case["sizes"], "binary",
                                        device=str(dev))

    def confidence(params, xq, yq):
        with torch.no_grad():
            p = model.predict_fn(params, torch.from_numpy(xq).to(dev))
        p = p.cpu().numpy()
        return np.where(yq > 0.5, p, 1 - p)

    results = {}
    for arm, private in (("fl", False), ("decaph", True)):
        train = _mia_train_fn(model, dev, private=private)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = mia_lib.lira_attack(train, confidence, x, y,
                                  n_shadows=case["shadows"], seed=SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fpr, tpr = mia_lib.roc_curve(res.scores, res.membership)
        ok = (0.0 <= res.auroc <= 1.0 and 0.0 <= res.tpr_at_1pct_fpr <= 1.0
              and bool(np.isfinite(res.scores).all())
              and bool((np.diff(fpr) >= 0).all())
              and bool((np.diff(tpr) >= 0).all()))
        say(f"mia {arm}: LiRA, {case['shadows']} shadows + 1 target, "
            f"n {case['n']}, {case['steps']} steps of MLP "
            f"{'-'.join(map(str, case['sizes']))}, lr {case['lr']}"
            + (f", DP C {case['clip']} sigma {case['sigma']}" if private
               else "") + f", on {smi}: AUROC {res.auroc:.4f}, TPR at 1% "
            f"FPR {res.tpr_at_1pct_fpr:.4f}, {int(res.membership.sum())} "
            f"members, wall {wall:.2f} s "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError(f"mia {arm}: AUROC {res.auroc}, TPR "
                                 f"{res.tpr_at_1pct_fpr}, or a decreasing "
                                 "ROC curve")
        results[arm] = res.auroc
    say(f"mia gap: AUROC FL - DP = {results['fl'] - results['decaph']:+.4f} "
        f"(printed only: {case['shadows']} shadows are too few to decide it)")


# -- 18. the scenario suite: presets at full size, capacity-lm, the CLI -----------

SCENARIO_PRESETS = ("lm-full", "gemini-full", "gemini-5hospital",
                    "gemini-5hospital-churn")


def _ghost_per_participant(model_size: str) -> int:
    """``ghost_norm`` launches per participant and round of an "lm" preset:
    one per dense layer (q, k, v, o, gate, up, down) and one for the head,
    as phase 6 counts 225 = 7 x 32 + 1."""
    return 7 * presets_lib.lm_model_config(model_size).n_layers + 1


def _fresh_epsilon(spec, silos, rounds: int) -> float:
    """ε of a fresh ``RDPAccountant`` at the arm's rate · q after
    ``rounds`` steps."""
    acct = RDPAccountant(
        sampling_rate=spec.batch_size / sum(len(p) for p in silos)
        * spec.participation_rate,
        noise_multiplier=spec.noise_multiplier, delta=DPConfig().delta)
    acct.step(rounds)
    return acct.epsilon()


def _span_ms(events, name: str) -> list[float]:
    return [round(1e3 * e["dur"], 1) for e in events
            if e["type"] == "span" and e["name"] == name]


def scenario_presets(dev, smi) -> tuple[int, float]:
    """Phase 18, first part: ``run_spec`` on the four presets at full size
    on ``sim``; ``ghost_norm`` held against its plain version on the inputs
    ``lm-full`` gave it.  Returns ``lm-full``'s ghost_norm launches and the
    largest |kernel - plain| on them."""
    lm_launches, lm_err = 0, 0.0
    for name in SCENARIO_PRESETS:
        spec = scenario_lib.get_preset(name)
        seen = []
        real_forward = tf.forward

        def forward(cfg, params, batch):
            out = real_forward(cfg, params, batch)
            seen.append((out[0].device.type, out[0].shape[0]))
            return out

        ghost_ops.reset_launches()
        reset_jit_dispatches()
        with obs.recording() as rec, recording_ghost_inputs() as inputs, \
                mock.patch.object(tf, "forward", forward):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row = scenario_lib.run_spec(spec, device=str(dev))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            events = rec.events()
        launches, calls = ghost_ops.launches(), jit_dispatches()
        silos = presets_lib.build_silos(spec)
        eps = _fresh_epsilon(spec, silos, row["rounds_completed"])
        rounds_ms = _span_ms(events, "round")
        say(f"scenario {name}: task {spec.task}, {spec.model_size} "
            f"({row['model_params']:,} parameters), {spec.hospitals} "
            f"hospitals, {spec.examples:,} examples, batch "
            f"{spec.batch_size}, sigma {spec.noise_multiplier}, SecAgg "
            f"{spec.use_secagg}, {spec.arm} on {spec.backend}, on {smi}: "
            f"{row['rounds_completed']} rounds, ε {row['epsilon']:.6f} "
            f"(accountant {eps:.6f}), accuracy {row['accuracy']:.4f}, mean "
            f"loss {row['mean_loss']}, sim wall {row['wall_clock']:.6f} s, "
            f"{row['bytes_on_wire']:,.0f} bytes on the wire, "
            f"{row['dropout_events']} dropouts, {row['recoveries']} "
            f"recoveries, {row['lost_rounds']} lost rounds, "
            f"{row['events']} events, {row['noise_topups']} top-ups; "
            f"{calls} program calls, ghost_norm launches {launches}; round "
            f"host ms {rounds_ms}; host s {row['host_seconds']:.3f} "
            f"(with the metric {wall:.3f})")
        if row["epsilon"] != eps:
            raise AssertionError(f"{name}: ε {row['epsilon']} != {eps}")
        if not 0.0 <= row["accuracy"] <= 1.0 or row["rounds_completed"] < 1:
            raise AssertionError(f"{name}: {row}")
        if spec.task == "lm":
            expected = (_ghost_per_participant(spec.model_size)
                        * spec.hospitals * spec.rounds)
            if calls != spec.rounds or launches != expected:
                raise AssertionError(
                    f"{name}: {calls} program calls, ghost_norm launched "
                    f"{launches} times, expected {spec.rounds} and "
                    f"{expected}")
            n_seq = spec.examples // spec.hospitals * spec.hospitals
            if (dev.type, n_seq) not in seen or any(d != dev.type
                                                    for d, _ in seen):
                raise AssertionError(f"{name}: the pooled metric's forward "
                                     f"did not run on the card: {seen[-3:]}")
            shapes = {key[:4] for key in inputs}
            if not shapes <= set(GHOST_LM_SHAPES):
                raise AssertionError(
                    f"{name}: ghost_norm shapes {sorted(shapes)} outside "
                    f"phase 3's GHOST_LM_SHAPES")
            lm_launches = launches
            lm_err = path_ghost_vs_plain(inputs, name)
        elif launches:
            raise AssertionError(f"{name}: ghost_norm launched {launches}")
    return lm_launches, lm_err


# a ghost cell of capacity-lm against its per-example twin: the same noise
# and batches, clipped by norms that differ only in float32 rounding
SWEEP_TWIN_LOSS_ATOL = 1e-5   # the CPU test's limit (test_torch_scenarios)
SWEEP_TWIN_ACC_ATOL = 1e-3   # a few of the pooled metric's tokens


def scenario_sweep(dev, smi, tmp: Path) -> float:
    """Phase 18, second part: the ``capacity-lm`` sweep (6 cells on
    ``ideal``) into a fresh cache, each ghost cell's ε, mean loss and
    accuracy against its per-example twin, ``ghost_norm`` against its
    plain version on the inputs the ghost cells gave it, the replay served
    wholly from the cache, and ``python -m repro_torch.scenarios --run
    gemini-small``.  Returns the largest |kernel - plain|."""
    specs = scenario_lib.get_sweep("capacity-lm").specs()
    cache = scenario_lib.ResultCache(tmp / "cache")
    launches, inputs = {}, {}

    def counting(spec):
        ghost_ops.reset_launches()
        with recording_ghost_inputs() as seen:
            row = scenario_lib.run_spec(spec, device=str(dev))
            torch.cuda.synchronize()
        launches[spec.name] = ghost_ops.launches()
        inputs[spec.name] = seen
        return row

    first = scenario_lib.run_sweep(specs, cache, runner=counting)
    for spec, row in zip(specs, first.results):
        expected = (_ghost_per_participant(spec.model_size) * spec.hospitals
                    * spec.rounds if spec.clipping == "ghost" else 0)
        say(f"sweep capacity-lm {spec.model_size} {spec.clipping}, on {smi}:"
            f" {row['model_params']:,} parameters, ε {row['epsilon']:.6f}, "
            f"accuracy {row['accuracy']:.4f}, mean loss "
            f"{row['mean_loss']:.4f}, host s {row['host_seconds']:.3f}, "
            f"ghost_norm launches {launches[spec.name]} (expected "
            f"{expected})")
        if launches[spec.name] != expected:
            raise AssertionError(f"{spec.name}: {launches[spec.name]} "
                                 f"ghost_norm launches, expected {expected}")
    rows = {(spec.model_size, spec.clipping): row
            for spec, row in zip(specs, first.results)}
    worst = 0.0
    for spec in specs:
        if spec.clipping != "ghost":
            continue
        g, f = rows[(spec.model_size, "ghost")], \
            rows[(spec.model_size, "per-example")]
        d_loss = abs(g["mean_loss"] - f["mean_loss"])
        d_acc = abs(g["accuracy"] - f["accuracy"])
        say(f"sweep capacity-lm {spec.model_size}: ghost vs per-example, "
            f"on {smi}: ε {g['epsilon']!r} / {f['epsilon']!r}, mean loss "
            f"{g['mean_loss']!r} / {f['mean_loss']!r} (|diff| {d_loss:.3e},"
            f" atol {SWEEP_TWIN_LOSS_ATOL:g}), accuracy {g['accuracy']!r} / "
            f"{f['accuracy']!r} (|diff| {d_acc:.3e}, atol "
            f"{SWEEP_TWIN_ACC_ATOL:g})")
        if g["epsilon"] != f["epsilon"] or \
                g["model_params"] != f["model_params"] or \
                not d_loss <= SWEEP_TWIN_LOSS_ATOL or \
                not d_acc <= SWEEP_TWIN_ACC_ATOL:
            raise AssertionError(f"capacity-lm {spec.model_size}: the ghost "
                                 f"cell disagrees with its per-example twin")
        worst = max(worst, path_ghost_vs_plain(
            inputs[spec.name], f"capacity-lm {spec.model_size}"))

    def refuse(spec):
        raise AssertionError(f"{spec.name} missed the cache")

    again = scenario_lib.run_sweep(specs, cache, runner=refuse)
    say(f"sweep capacity-lm replay: {again.hits} hits, {again.misses} "
        f"misses, rows equal to the first run's: "
        f"{again.results == first.results}")
    if (first.misses, again.hits, again.misses) != (6, 6, 0) or \
            again.results != first.results:
        raise AssertionError("the capacity-lm replay was not served from "
                             "the cache")
    out = tmp / "run.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "--run",
         "gemini-small", "--cache-dir", str(tmp / "cli-cache"), "--out",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    cell = (json.loads(out.read_text())["cells"][0] if proc.returncode == 0
            else {})
    say(f"scenarios CLI --run gemini-small: exit {proc.returncode}, "
        f"{time.perf_counter() - t0:.1f} s; {cell.get('rounds_completed')} "
        f"rounds, ε {cell.get('epsilon')}, accuracy {cell.get('accuracy')}")
    if proc.returncode != 0 or not cell:
        raise AssertionError(f"the scenarios CLI failed:\n{proc.stderr}")
    return worst


# -- 19. the population backend: 1000 hospitals, trace then solve --------------

POPULATION_CELL = dict(model_size="full", features=None, examples=40114,
                       hospitals=1000, arm="decaph", noise_multiplier=0.8,
                       rounds=5, seed=0)
PROFILED_HOSPITALS = 10


def population_cli(smi, tmp: Path) -> None:
    """``python -m repro_torch.population`` over the reference's
    ``population-scaling`` cells at seed 0, re-traced for determinism."""
    out = tmp / "population.json"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.population", "--hospitals",
         "50,200,1000", "--seeds", "0", "--check-determinism", "--out",
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=400,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode != 0:
        raise AssertionError(f"the population CLI failed:\n{proc.stderr}")
    cells = json.loads(out.read_text())["cells"]
    for c in cells:
        say(f"population {c['arm']} H={c['hospitals']}: linear model, 16 "
            f"features, 6,000 examples, q {c['participation_rate']}, "
            f"k-regular degree 8, 5% flaky, on {smi}: "
            f"{c['rounds_completed']} rounds, sim {c['wall_clock']:.6f} s, "
            f"host {c['host_seconds']:.3f} s (solve "
            f"{c['solve_wall_seconds']:.3f}), {c['graph_nodes']} graph "
            f"nodes, graph {c['graph_hash']}, empirical q "
            f"{c['empirical_q']:.4f}, mean cohort {c['mean_cohort']:.1f}, "
            f"ε {c['epsilon']:.6f}, accuracy {c['accuracy']:.4f}, "
            f"re-trace identical {c.get('determinism_checked')}")
    say(f"population CLI: {len(cells)} cells in "
        f"{time.perf_counter() - t0:.1f} s")
    if len(cells) != 6 or not all(c.get("determinism_checked")
                                  for c in cells):
        raise AssertionError("the population CLI's cells or re-traces")


def population_paper_width(dev, smi) -> None:
    """The paper's GEMINI width over 1000 hospitals on ``population``: ε at
    rate · q, one program call per executed round, cohorts below H."""
    spec = scenario_lib.get_sweep("population-scaling").base.replace(
        name="population/paper-width", **POPULATION_CELL)
    model, silos, cfg, nodes, topo = scenario_lib.build_scenario(
        spec, device=str(dev))
    arm = arms.get("decaph")(model, silos, cfg)
    runner = PopulationRunner(nodes, topo)
    reset_jit_dispatches()
    with obs.recording() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = runner.run(arm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = rec.events()
    calls = jit_dispatches()
    trace, solved = runner.last_trace, runner.last_solve
    executed = [p for p in trace.rounds if not p.lost]
    eps = _fresh_epsilon(spec, silos, report.rounds_completed)
    acc = presets_lib.pooled_metric(spec, model, report.params, silos)
    t = report.timing
    say(f"population paper width: MLP 436-300-100-50-10-1 "
        f"({n_params(report.params):,} parameters), "
        f"{spec.hospitals} hospitals, {spec.examples:,} admissions, q "
        f"{spec.participation_rate}, decaph sigma {spec.noise_multiplier}, "
        f"batch {spec.batch_size}, on {smi}: {report.rounds_completed} "
        f"rounds of {len(trace.rounds)}, cohorts "
        f"{[len(p.cohort) for p in trace.rounds]} (mean "
        f"{solved.mean_cohort:.1f}, empirical q {solved.empirical_q:.4f}), "
        f"ε {report.epsilon:.6f} (accountant at rate·q {eps:.6f}), "
        f"{calls} program calls for {len(executed)} executed rounds, "
        f"{solved.graph_nodes} graph nodes, graph {solved.graph_hash}, sim "
        f"{t.wall_clock:.6f} s, {t.bytes_on_wire:,.0f} bytes, "
        f"{t.dropout_events} dropouts, {t.lost_rounds} lost rounds, "
        f"{t.noise_topups} top-ups; host ms: trace "
        f"{_span_ms(events, 'population.trace')}, round "
        f"{_span_ms(events, 'round')}, fused_round "
        f"{_span_ms(events, 'fused_round')}, aggregate "
        f"{_span_ms(events, 'aggregate')}; solve {solved.wall_seconds:.3f} "
        f"s, run {wall:.3f} s; pooled accuracy {acc:.4f}")
    if report.epsilon != eps or calls != len(executed) or \
            not solved.mean_cohort < spec.hospitals or \
            report.rounds_completed < 1:
        raise AssertionError(f"population: ε {report.epsilon} vs {eps}, "
                             f"{calls} calls for {len(executed)} rounds, "
                             f"mean cohort {solved.mean_cohort}")
    # where the trace's host time goes: one re-trace on fresh nodes and
    # topology under cProfile (which slows it), byte-identical to the first
    pop = PopulationSpec.from_dict({"hospitals": spec.hospitals,
                                    "seed": spec.seed, **spec.population})
    retracer = PopulationRunner(nodes_from_trace(pop.build_nodes()),
                                Topology.from_trace(pop.build_topology()))
    prof = cProfile.Profile()
    again = prof.runcall(retracer.trace, arm)
    stats = pstats.Stats(prof).stats
    total = sum(tt for _, _, tt, _, _ in stats.values())
    neighbors = sum(ct for (_, _, fn), (_, _, _, ct, _) in stats.items()
                    if fn == "neighbors")
    same = again.graph.to_json_bytes() == trace.graph.to_json_bytes()
    say(f"population trace profile: a re-trace under cProfile, {total:.3f} "
        f"s of host time, Topology.neighbors {neighbors / total:.1%} of it "
        f"(a scan of every directed link per call); graph identical: {same}")
    if not same:
        raise AssertionError("the re-trace differs from the trace")
    # the first hospitals of the largest cohort: the step loops over them,
    # and a profile of all of them (600 kernels each) takes a minute to read
    largest = max(executed, key=lambda p: len(p.cohort))
    _profile_cohort_step(smi, f"population round profile: paper width, "
                         f"round {largest.t}'s cohort of "
                         f"{len(largest.cohort)} cut to "
                         f"{PROFILED_HOSPITALS}", arm, report.params,
                         list(largest.cohort[:PROFILED_HOSPITALS]),
                         largest.t)


def _profile_cohort_step(smi, what: str, arm, params, cohort, t) -> None:
    """One fused cohort step of round ``t``'s ``cohort`` under
    ``torch.profiler`` (outside the run: its counts are read already):
    host wall, device busy time and idle share, and the device kernels."""
    rng = np.random.default_rng(SEED)
    busy_us, _, prof_ms, spans = _device_profile(
        lambda: arm.fused_round(params, cohort, t, rng, len(cohort)))
    say(f"{what}: one fused cohort step of {len(cohort)} hospitals, on "
        f"{smi}: wall {prof_ms:.1f} ms with the profiler on, device busy "
        f"{busy_us / 1e3:.1f} ms, idle {1 - busy_us / 1e3 / prof_ms:.1%}; "
        f"{len(spans)} device kernels ({len(spans) / len(cohort):.0f} per "
        f"hospital)")


def population_vs_ideal(dev, smi) -> float:
    """q = 1: ``lm-full``'s model and silos under decaph at sigma 0 on
    ``population`` (full topology) bit for bit ``ideal``, through
    ``ghost_norm`` the same number of times; the kernel held against its
    plain version on the inputs ``population`` gave it.  Returns the
    largest |kernel - plain|."""
    spec = scenario_lib.get_preset("lm-full").replace(
        backend="ideal", noise_multiplier=0.0, rounds=3)
    model, silos, cfg, _, _ = scenario_lib.build_scenario(spec,
                                                          device=str(dev))
    runs = {}
    for backend, kw in (("ideal", {}),
                        ("population", {"topo": Topology.full(len(silos))})):
        ghost_ops.reset_launches()
        with recording_ghost_inputs() as inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = arms.run("decaph", model, silos, cfg, backend=backend,
                              **kw)
            torch.cuda.synchronize()
        runs[backend] = (report, ghost_ops.launches(),
                         time.perf_counter() - t0)
    (ideal, n_ideal, w_ideal), (popl, n_pop, w_pop) = runs["ideal"], \
        runs["population"]
    same = ideal.rounds_completed == popl.rounds_completed and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(ideal.params),
                                          tree_leaves(popl.params)))
    expected = _ghost_per_participant("full") * len(silos) * spec.rounds
    say(f"population q=1: lm-full's model and silos, decaph sigma 0, "
        f"{spec.rounds} rounds, on {smi}: parameters bit-identical to "
        f"ideal's: {same}; ghost_norm launches {n_pop} (ideal {n_ideal}, "
        f"expected {expected}); wall s {w_pop:.3f} (ideal {w_ideal:.3f})")
    if not same or n_pop != n_ideal or n_pop != expected:
        raise AssertionError("population at q = 1 is not ideal's")
    worst = path_ghost_vs_plain(inputs, "population q=1")
    _profile_cohort_step(smi, "lm-full round profile",
                         arms.get("decaph")(model, silos, cfg), popl.params,
                         list(range(len(silos))), 0)
    return worst


# -- 20. the model zoo served at full width ----------------------------------------

QWEN3 = "qwen3-moe-30b-a3b"
# free bytes on the card before Qwen3-30B-A3B's init: its 61.06 GB of bf16
# weights, the 402 MB cache and the decode step's buffers; and the most its
# init may hold at once (the weights plus one layer's float32 draw)
QWEN3_FREE = 64e9
QWEN3_INIT_PEAK = 64e9
# the open-loop trace (prompts and outputs of 8-32 tokens; cut: its length)
ZOO_TRACE = dict(rate=4, n_requests=16)
# (arch, layers kept): full width; Nemotron-4-340B at 2 of its 96 layers
# (16.3 B parameters, 32.7 GB), the depth one card takes
ZOO_SERVE = [("gemma-7b", None), ("qwen2-vl-2b", None), ("olmo-1b", None),
             ("nemotron-4-340b", 2)]
ZOO_PROMPTS, ZOO_PROMPT_LEN, ZOO_GEN = 8, 8, 16
# the archs that also evaluate with use_flash (head dims 256 and 192): their
# sequences of 2048 tokens
ZOO_FLASH = {"gemma-7b": 2, "nemotron-4-340b": 1}
ZOO_FLASH_LEN = 2048


def _free_card() -> int:
    """Release what earlier phases left to the allocator; the card's free
    bytes."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def _uncounted(cfg) -> int:
    """The parameters the reference's ``param_count`` leaves out: the
    norms' parameters (a scale under RMSNorm, a scale and a bias under
    LayerNorm, none under ln_nonparam: two per layer, a third in a
    cross-attention layer, two per encoder layer, the final norm and the
    encoder's); MLA's two latent norms' scales; of a Mamba layer's three
    [DI] vectors (conv_b, dt_bias, d_skip) it counts two; of an RWKV6
    layer's decay_w0 [D], bonus_u [NH, HS] and token_mix [5, D], 7 D in
    all, it counts 2 D.  (The MTP subtree, which it also leaves out, is
    counted apart.)"""
    per_norm = {"rmsnorm": 1, "layernorm": 2, "ln_nonparam": 0}[cfg.norm] \
        * cfg.d_model
    norms = 2 * cfg.n_layers + 1
    if cfg.is_encoder_decoder:
        norms += 2 * cfg.encoder_layers + 1
    n = 0
    for repeat, pattern in cfg.stack:
        for spec in pattern:
            norms += repeat * spec.cross_attn
            if spec.mixer == "mamba":
                n += repeat * cfg.mamba_expand * cfg.d_model
            elif spec.mixer == "rwkv6":
                n += repeat * 5 * cfg.d_model
            elif spec.mixer == "mla":
                n += repeat * (cfg.q_lora_rank + cfg.kv_lora_rank)
    return n + norms * per_norm


def _init_counted(cfg, dev, what: str):
    """Seeded parameters on the card; checks their count against
    ``param_count`` and prints the init's seconds and peak memory."""
    free = _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init(cfg, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = sum(t.numel() for t in tree_leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    mtp = sum(t.numel() for t in tree_leaves(params.get("mtp", {})))
    if n - mtp != param_count(cfg) + _uncounted(cfg):
        raise AssertionError(f"{what}: {n - mtp} parameters, param_count "
                             f"{param_count(cfg)} + {_uncounted(cfg)} it "
                             "leaves out")
    say(f"zoo init: {what}, {n:,} parameters"
        f"{f' ({mtp:,} of them MTP)' if mtp else ''} ({nbytes / 1e9:.2f} "
        f"GB), free before {free / 1e9:.2f} GB, init {init_s:.2f} s, peak "
        f"allocated {peak / 1e9:.2f} GB")
    return params, free, peak


def _moe_without_host_sync(engine, params) -> None:
    """One MoE layer at the decode step's shape (a row per group) under
    ``set_sync_debug_mode("error")``: anything that waits for the host
    raises."""
    mcfg, dev, slots = engine.model_cfg, engine.device, engine.cfg.slots
    x = torch.randn((slots, 1, mcfg.d_model), device=dev).to(mcfg.cdtype)
    layer = next(p for spec, p in tf.layers_of(mcfg, params)
                 if spec.ffn == "moe")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe_lib.moe_apply(layer, x, mcfg, groups=slots)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("non-finite MoE output")


def serve_qwen3(dev, smi) -> int:
    """Phase 20, first part: Qwen3-30B-A3B at full width, bf16, seeded on
    the card, served over a seeded open-loop trace; returns its
    decode_attention launches."""
    cfg = get_config(QWEN3)
    free = _free_card()
    if free < QWEN3_FREE:
        raise AssertionError(f"{free / 1e9:.2f} GB free before {QWEN3}'s "
                             f"init, need {QWEN3_FREE / 1e9:g}")
    params, _, peak = _init_counted(
        cfg, dev, f"{QWEN3} full width bf16 ({active_param_count(cfg):,} "
        "active per token)")
    if peak >= QWEN3_INIT_PEAK:
        raise AssertionError(f"{QWEN3}'s init peaked at {peak / 1e9:.2f} GB")
    engine = ServeEngine(ServeConfig(
        arch=QWEN3, smoke=False, slots=8, max_len=512, temperature=1.0,
        seed=SEED, device=str(dev)), model_cfg=cfg, params=params)
    mcfg = engine.model_cfg
    batch_generate(engine, np.arange(1, 9, dtype=np.int32)[None], 2)
    requests = generate_requests(TrafficConfig(
        vocab_size=cfg.vocab_size, seed=SEED, **ZOO_TRACE))
    prefill_positions = sum(len(r.prompt) for r in requests)
    decode_ops.reset_launches()
    reset_jit_dispatches()
    result = run_open_loop(engine, requests)
    launches = decode_ops.launches()
    calls = jit_dispatches()
    steps = _check_open_loop(mcfg, requests, result, calls, launches)
    row = summarize(result, slots=8, rate=ZOO_TRACE["rate"])
    say(f"zoo serve: {QWEN3} full width bf16, 8 slots x 512, "
        f"{ZOO_TRACE['n_requests']} requests @ {ZOO_TRACE['rate']} q/s on "
        f"{smi}: {row['throughput_tok_s']} tok/s, TTFT p50/p99 "
        f"{row['ttft_p50_ms']}/{row['ttft_p99_ms']} ms, TPOT p50/p99 "
        f"{row['tpot_p50_ms']}/{row['tpot_p99_ms']} ms; {steps} decode steps "
        f"+ {prefill_positions} prefill positions, {calls} program calls, "
        f"decode_attention launches {launches} "
        f"({launches // (steps + prefill_positions)} per position)")
    say("zoo serve row: " + json.dumps(row, sort_keys=True))
    time_decode_step(engine, smi)
    _moe_without_host_sync(engine, params)

    # the MoE decode step twice on the same cache and inputs, and two greedy
    # runs of 4 prompts: equal bit for bit
    tokens = torch.arange(1, 9, dtype=torch.int32, device=dev)[:, None]
    positions = torch.tensor([0, 5, 17, 64, 100, 200, 300, 511],
                             dtype=torch.int32, device=dev)
    first, _ = tf.decode_step_positions(mcfg, params, engine.cache, tokens,
                                        positions)
    second, _ = tf.decode_step_positions(mcfg, params, engine.cache, tokens,
                                         positions)
    same_step = torch.equal(first, second)
    del engine, first, second
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (4, 4)).astype(np.int32)
    greedy = []
    for _ in range(2):
        engine = ServeEngine(ServeConfig(
            arch=QWEN3, smoke=False, slots=4, max_len=16, temperature=0.0,
            seed=SEED, device=str(dev)), model_cfg=cfg, params=params)
        greedy.append(batch_generate(engine, prompts, 6))
        del engine
    same_tokens = np.array_equal(*greedy)
    ok = same_step and same_tokens
    say(f"zoo serve: {QWEN3} moe_apply at the decode shape (8 groups of 1) "
        f"under set_sync_debug_mode('error'): no host sync; decode step twice"
        f" {'bit-identical' if same_step else 'DIFFERS'}; two greedy runs of "
        f"4 prompts x 6 tokens {'equal' if same_tokens else 'DIFFER'} "
        f"{greedy[0].tolist()} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{QWEN3}'s decode does not repeat bit for bit")
    del params
    return launches


@contextlib.contextmanager
def capturing_decode_step(slots: int, n_layers: int, skip: int = 0):
    """Keep the inputs and output of the first ``n_layers`` decode kernel
    calls with ``slots`` rows (one batched decode step; prefills have one
    row) after the first ``skip`` such calls, the caches cloned; the
    kernel runs and counts as before.  Yields the list of (q, k, v, index,
    window, out)."""
    seen = []
    real = attn_lib.decode_attention
    passed = [0]

    def capture(q, k, v, index, *, window=None):
        out = real(q, k, v, index, window=window)
        if q.shape[0] == slots:
            passed[0] += 1
        if q.shape[0] == slots and skip < passed[0] and \
                len(seen) < n_layers:
            seen.append((q.clone(), k.clone(), v.clone(), index.clone(),
                         window, out.clone()))
        return out

    with mock.patch.object(attn_lib, "decode_attention", capture):
        yield seen


def _layers_vs_plain(seen: list, what: str) -> float:
    """Each captured layer's kernel output against ``decode_attention_plain``
    on that layer's own q, k, v at phase 3's bf16 limit; returns the largest
    |kernel - plain|."""
    atol, rtol = DECODE_TOL[torch.bfloat16]
    errs, bad = [], []
    for i, (q, k, v, index, window, out) in enumerate(seen):
        ref = decode_attention_plain(q, k, v, index, window=window).float()
        err = (out.float() - ref).abs()
        errs.append(float(err.max()))
        if not bool(torch.all(err <= atol + rtol * ref.abs())):
            bad.append(i)
    say(f"zoo serve: {what}, first decode step, each layer's kernel output vs"
        f" decode_attention_plain on its own q, k, v: max|err| "
        f"{max(errs):.3e} (atol {atol:g}, rtol {rtol:g}) at "
        f"{len(seen) - len(bad)} of {len(seen)} layers "
        f"{'ok' if not bad else 'FAIL'}")
    if bad or not seen:
        raise AssertionError(f"{what}: the decode kernel disagrees with its "
                             f"plain version on real activations at layers "
                             f"{bad}")
    return max(errs)


def _zoo_flash_batch(cfg, dev) -> dict:
    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (ZOO_FLASH[cfg.name], ZOO_FLASH_LEN))
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev)}


def _zoo_flash_float32(cfg, params, dev, what: str) -> int:
    """Phase 9's float32 check at a zoo arch: the ``use_flash`` forward (the
    SIMT kernel, one launch per layer) against the plain ``_sdpa`` within
    atol 1e-3.  Returns the launches."""
    batch = _zoo_flash_batch(cfg, dev)
    before = flash_ops.launches("simt_fp32")
    with torch.no_grad():
        kernel, _ = tf.forward(cfg.replace(use_flash=True), params, batch)
        launches = flash_ops.launches("simt_fp32") - before
        plain, _ = tf.forward(cfg, params, batch)
    err = float((kernel - plain).abs().max())
    ok = launches == cfg.n_layers and err <= 1e-3 and math.isfinite(err)
    say(f"zoo eval: {what} in float32, use_flash, {ZOO_FLASH[cfg.name]} x "
        f"{ZOO_FLASH_LEN} tokens, D={cfg.head_dim}: {launches} "
        f"flash_attention launches, logits max|kernel - plain _sdpa| "
        f"{err:.3e} (atol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the float32 flash kernel disagrees "
                             "with the plain attention")
    return launches


def _zoo_float32_path(cfg, dev, what: str) -> int:
    """Phase 5's check at the arch's width in float32: greedy tokens with
    the kernel and with the plain attention equal, teacher-forced logits
    within atol 1e-3; for ``ZOO_FLASH``'s archs also the ``use_flash``
    forward.  Returns the flash kernel's launches."""
    cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    params = tf.init(cfg, SEED, dev)
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, ZOO_PROMPT_LEN)).astype(np.int32)
    gen = 8
    tokens = {}
    for kernel in (True, False):
        engine = ServeEngine(ServeConfig(
            arch=cfg.name, slots=1, max_len=ZOO_PROMPT_LEN + gen,
            temperature=0.0, decode_kernel=kernel, device=str(dev)),
            model_cfg=cfg, params=params)
        tokens[kernel] = batch_generate(engine, prompt, gen)[0]
        del engine
    seq = np.concatenate([prompt[0], tokens[True][:-1]]).astype(np.int32)
    logits = {}
    for kernel in (True, False):
        c = cfg.replace(use_decode_kernel=kernel)
        cache = tf.init_cache(c, 1, seq.size, dev)
        rows = []
        for i in range(seq.size):
            step = torch.from_numpy(seq[None, i:i + 1]).to(dev)
            rows.append(tf.decode_step(c, params, cache, step, i)[0].float())
        logits[kernel] = torch.cat(rows[ZOO_PROMPT_LEN - 1:], dim=1)
    worst = float((logits[True] - logits[False]).abs().max())
    same = np.array_equal(tokens[True], tokens[False])
    ok = same and worst <= 1e-3 and bool(torch.isfinite(logits[True]).all())
    say(f"zoo serve: {what} in float32, {ZOO_PROMPT_LEN}-token prompt + {gen}"
        f" greedy tokens, kernel vs plain attention: tokens "
        f"{'identical' if same else 'DIFFER'}, teacher-forced logits "
        f"max|diff| {worst:.3e} (atol 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the decode kernel and the plain "
                             "attention disagree over the float32 path")
    return (_zoo_flash_float32(cfg, params, dev, what)
            if cfg.name in ZOO_FLASH else 0)


def serve_zoo_dense(dev, smi) -> dict:
    """Phase 20, second part: each dense arch at full width (Nemotron at 2
    layers): greedy ``batch_generate`` in bf16 with the decode kernel and
    with the model's plain attention, the kernel held against its plain
    version on every layer of a decode step's real activations, and the
    float32 path's tokens and logits; Gemma-7B and Nemotron-4-340B also
    evaluate with ``use_flash`` in both dtypes.  Returns each kernel's
    launches and the largest |kernel - plain| on real activations."""
    total, worst = 0, 0.0
    flash, flash_worst = 0, 0.0
    for arch, layers in ZOO_SERVE:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(n_layers=layers, stack=dense_stack(layers))
        what = f"{arch}" + (f" ({layers} layers)" if layers else "")
        params, _, _ = _init_counted(
            cfg, dev, f"{arch} full width bf16"
            + (f", {layers} of 96 layers" if layers else ""))
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (ZOO_PROMPTS, ZOO_PROMPT_LEN)).astype(np.int32)
        out, ms, launches = {}, {}, {}
        positions = 0
        for kernel in (True, False):
            engine = ServeEngine(ServeConfig(
                arch=arch, smoke=False, slots=ZOO_PROMPTS,
                max_len=ZOO_PROMPT_LEN + ZOO_GEN, temperature=0.0,
                decode_kernel=kernel, seed=SEED, device=str(dev)),
                model_cfg=cfg, params=params)
            batch_generate(engine, prompts[:1, :2], 1)       # warm-up
            steps0 = engine.decode_steps
            decode_ops.reset_launches()
            with capturing_decode_step(ZOO_PROMPTS, cfg.n_layers) as seen:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[kernel] = batch_generate(engine, prompts, ZOO_GEN)
                torch.cuda.synchronize()
                ms[kernel] = (time.perf_counter() - t0) * 1e3
                launches[kernel] = decode_ops.launches()
                layer_io = list(seen)
            positions = engine.decode_steps - steps0 + prompts.size
            ms[kernel] /= positions
            del engine
            if kernel:
                kernel_io = layer_io
        if launches != {True: cfg.n_layers * positions, False: 0}:
            raise AssertionError(f"{arch}: decode_attention launched "
                                 f"{launches}, expected {cfg.n_layers} per "
                                 f"position with the kernel, 0 without")
        total += launches[True]
        worst = max(worst, _layers_vs_plain(kernel_io, f"{what} bf16"))
        del kernel_io
        rows_equal = int((out[True] == out[False]).all(axis=1).sum())
        say(f"zoo serve: {what} full width bf16, D={cfg.head_dim}, "
            f"{cfg.n_heads} query heads on {cfg.n_kv_heads}, batch_generate "
            f"{ZOO_PROMPTS} prompts x {ZOO_PROMPT_LEN} + {ZOO_GEN} greedy "
            f"tokens on {smi}: ms per step (prefill positions and decode "
            f"steps) kernel {ms[True]:.2f}, plain {ms[False]:.2f}; "
            f"decode_attention {launches[True] // positions} launches per "
            f"position; {rows_equal} of {ZOO_PROMPTS} rows' tokens equal "
            f"(bf16 near-ties may split the rest)")
        if arch in ZOO_FLASH:
            n, err = bf16_forward_layers(
                cfg.replace(use_flash=True), params,
                _zoo_flash_batch(cfg, dev),
                f"zoo eval: {what} full width bfloat16, D={cfg.head_dim}, "
                f"{ZOO_FLASH[arch]} x {ZOO_FLASH_LEN} tokens")
            flash += n
            flash_worst = max(flash_worst, err)
        del params
        _free_card()
        flash += _zoo_float32_path(cfg, dev, what)
        _free_card()
    return {"decode_attention": (total, worst),
            "flash_attention": (flash, flash_worst)}


# -- 21. DeCaPH on the zoo's families ------------------------------------------------

# OLMo-1B at full width (untied head): 4 hospitals x 32 sequences of 256
# tokens, batch 16, sigma 1.0, 2 rounds, ghost clipping
OLMO = "olmo-1b"
OLMO_TRAIN = dict(hospitals=4, n_per=32, seq_len=256, rounds=2, batch_size=16,
                  lr=0.05, clip=1.0, sigma=1.0)
# the ghost_norm shapes that are new on this path: d 2048 -> 8192 (up,
# gate), 8192 -> 2048 (down), 2048 -> 50304 (the head)
OLMO_GHOST_WIDTHS = {(2048, 8192), (8192, 2048), (2048, 50304)}


def train_olmo(dev, smi) -> tuple[int, float]:
    """Phase 21, first part: DeCaPH with ghost clipping on OLMo-1B; returns
    the ghost_norm launches and the largest |kernel - plain| on the inputs
    the path gave the kernel."""
    _free_card()
    t = OLMO_TRAIN
    mcfg = get_config(OLMO).replace(tie_embeddings=False)
    model = transformer_model(mcfg, device=str(dev))
    if model.ghost is None:
        raise AssertionError(f"{OLMO}: no ghost-clipping capability")
    silos = token_silos(mcfg, hospitals=t["hospitals"], n_per=t["n_per"],
                        seq_len=t["seq_len"], seed=SEED)
    cfg = arms.ArmConfig(
        rounds=t["rounds"], batch_size=t["batch_size"], lr=t["lr"],
        seed=SEED, use_secagg=False,
        dp=DPConfig(clip_norm=t["clip"], noise_multiplier=t["sigma"]))
    marks = []

    def on_round(_, params):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    ghost_ops.reset_launches()
    reset_jit_dispatches()
    with recording_ghost_inputs() as seen:
        t0 = time.perf_counter()
        report = arms.run("decaph", model, silos, cfg, backend="ideal",
                          on_round=on_round)
        launches = ghost_ops.launches()
        calls = jit_dispatches()
    # the rule phase 6 holds, read from the code: one launch per dense
    # weight of a layer (its "w..." leaves), per layer, and one for the head
    dense = sum(1 for name in report.params["layers"] if name.startswith("w"))
    per_participant = dense * mcfg.n_layers + 1
    expected = per_participant * t["hospitals"] * t["rounds"]
    if launches != expected:
        raise AssertionError(f"ghost_norm launched {launches} times, expected "
                             f"{per_participant} x {t['hospitals']} x "
                             f"{t['rounds']} = {expected}")
    if report.rounds_completed != t["rounds"] or calls != t["rounds"]:
        raise AssertionError(f"{report.rounds_completed} rounds in {calls} "
                             "program calls")
    losses = [l.loss for l in report.logs]
    if not all(math.isfinite(x) for x in losses) or not all(
            bool(torch.isfinite(p).all()) for p in tree_leaves(report.params)):
        raise AssertionError(f"non-finite losses {losses} or parameters")
    acct = RDPAccountant(sampling_rate=t["batch_size"]
                         / (t["hospitals"] * t["n_per"]),
                         noise_multiplier=t["sigma"], delta=cfg.dp.delta)
    acct.step(t["rounds"])
    if report.epsilon != acct.epsilon():
        raise AssertionError(f"ε {report.epsilon} != the accountant's "
                             f"{acct.epsilon()}")
    widths = {(k[2], k[3]) for k in seen}
    if not OLMO_GHOST_WIDTHS <= widths:
        raise AssertionError(f"ghost_norm never saw {OLMO_GHOST_WIDTHS - widths}")
    round_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    say(f"zoo train: {OLMO} untied head, ln_nonparam, "
        f"{param_count(mcfg):,} parameters, full width, {t['hospitals']} "
        f"hospitals x {t['n_per']} x {t['seq_len']} tokens, batch "
        f"{t['batch_size']}, sigma {t['sigma']}, ghost clipping, on {smi}: "
        f"{report.rounds_completed} rounds, losses "
        f"{[round(x, 4) for x in losses]}, ε {report.epsilon:.6f} (accountant"
        f" {acct.epsilon():.6f}), {calls} program calls, ghost_norm launches "
        f"{launches} ({per_participant} = {dense} x {mcfg.n_layers} + 1 per "
        f"participant and round), round wall s "
        f"{[round(x, 4) for x in round_s]}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del report, model
    worst = path_ghost_vs_plain(seen, f"{OLMO} decaph")
    seen.clear()
    return launches, worst


def train_qwen3_smoke(dev, smi) -> None:
    """Phase 21, second part: Qwen3-30B-A3B's smoke config, 2 rounds of
    faithful DeCaPH (MoE: per-example gradients through the dispatch) at
    sigma 0, twice: the same parameters and losses bit for bit."""
    mcfg = get_smoke_config(QWEN3)
    model = transformer_model(mcfg, device=str(dev))
    if model.ghost is not None:
        raise AssertionError(f"{QWEN3} must take the per-example path")
    silos = token_silos(mcfg, hospitals=3, n_per=16, seq_len=12, seed=SEED)
    cfg = arms.ArmConfig(rounds=2, batch_size=8, lr=0.05, seed=SEED,
                         use_secagg=False,
                         dp=DPConfig(clip_norm=1.0, noise_multiplier=0.0,
                                     microbatch_size=8))
    runs = [arms.run("decaph", model, silos, cfg, backend="ideal")
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[0].params), tree_leaves(runs[1].params)))
    losses = [[l.loss for l in r.logs] for r in runs]
    ok = same and losses[0] == losses[1] and all(
        math.isfinite(x) for x in losses[0])
    say(f"zoo train: {QWEN3} smoke config, faithful DeCaPH, sigma 0, 2 rounds"
        f" on {smi}, run twice: parameters "
        f"{'bit-identical' if same else 'DIFFER'}, losses {losses[0]} and "
        f"{losses[1]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{QWEN3}'s faithful rounds do not repeat")


# -- 22. the recurrent mixers served ---------------------------------------------

RWKV = "rwkv6-3b"
JAMBA = "jamba-v0.1-52b"
# Jamba's blocks of 8 layers kept: 2 of 4 in bf16 (26.05 B parameters, 52.1
# GB; 3 would take 77.6 GB and leave no room for the rest), 1 in float32
# (13.30 B parameters, 53.2 GB)
JAMBA_BLOCKS, JAMBA_F32_BLOCKS = 2, 1
RECURRENT_TRACE = dict(rate=16, n_requests=16)   # phase 4's trace


def _jamba(blocks: int):
    cfg = get_config(JAMBA)
    return cfg.replace(stack=((blocks, cfg.stack[0][1]),),
                       n_layers=blocks * len(cfg.stack[0][1]))


def _step_twice(mcfg, params, cache, tokens, positions) -> bool:
    """``decode_step_positions`` twice from copies of one cache, the second
    under ``set_sync_debug_mode("error")`` (anything that waits for the
    host raises): logits and every cache leaf bit for bit."""
    caches = [tree_map(torch.clone, cache) for _ in range(2)]
    first, _ = tf.decode_step_positions(mcfg, params, caches[0], tokens,
                                        positions)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second, _ = tf.decode_step_positions(mcfg, params, caches[1], tokens,
                                             positions)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return torch.equal(first, second) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(caches[0]),
                                          tree_leaves(caches[1])))


def serve_rwkv(dev, smi) -> None:
    """Phase 22, first part: RWKV6-3B whole at full width in bf16, served
    over phase 4's open-loop trace; no attention layer, so no decode kernel
    launch."""
    cfg = get_config(RWKV)
    params, _, _ = _init_counted(cfg, dev, f"{RWKV} full width bf16, whole")
    engine = ServeEngine(ServeConfig(
        arch=RWKV, smoke=False, slots=8, max_len=512, temperature=1.0,
        seed=SEED, device=str(dev)), model_cfg=cfg, params=params)
    mcfg = engine.model_cfg
    batch_generate(engine, np.arange(1, 9, dtype=np.int32)[None], 2)
    requests = generate_requests(TrafficConfig(
        vocab_size=cfg.vocab_size, seed=SEED, **RECURRENT_TRACE))
    prefill_positions = sum(len(r.prompt) for r in requests)
    decode_ops.reset_launches()
    reset_jit_dispatches()
    result = run_open_loop(engine, requests)
    launches = decode_ops.launches()
    calls = jit_dispatches()
    steps = _check_open_loop(mcfg, requests, result, calls, launches)
    row = summarize(result, slots=8, rate=RECURRENT_TRACE["rate"])
    # slot 0's share of every layer's state, each leaf [slots, ...]
    per_slot = {}
    for c in tf.layer_caches(mcfg, engine.cache):
        for name, t in c["ssm"].items():
            per_slot[name] = (per_slot.get(name, 0)
                              + t[0].numel() * t.element_size())
    say(f"recurrent serve: {RWKV} full width bf16, 8 slots x 512, "
        f"{RECURRENT_TRACE['n_requests']} requests @ "
        f"{RECURRENT_TRACE['rate']} q/s on {smi}: {row['throughput_tok_s']} "
        f"tok/s, TTFT p50/p99 {row['ttft_p50_ms']}/{row['ttft_p99_ms']} ms, "
        f"TPOT p50/p99 {row['tpot_p50_ms']}/{row['tpot_p99_ms']} ms; {steps} "
        f"decode steps + {prefill_positions} prefill positions, {calls} "
        f"program calls, decode_attention launches {launches}; recurrent "
        f"state per slot: WKV {per_slot['wkv'] / 1e6:.2f} MB ({cfg.n_layers} "
        f"layers x {cfg.d_model // cfg.rwkv_head_size} heads x "
        f"{cfg.rwkv_head_size} x {cfg.rwkv_head_size} x 4 B) + token shift "
        f"{per_slot['x_prev'] / 1e6:.3f} MB")
    say("recurrent serve row: " + json.dumps(row, sort_keys=True))
    time_decode_step(engine, smi)
    tokens = torch.arange(1, 9, dtype=torch.int32, device=dev)[:, None]
    positions = torch.tensor([0, 5, 17, 64, 100, 200, 300, 511],
                             dtype=torch.int32, device=dev)
    same = _step_twice(mcfg, params, engine.cache, tokens, positions)
    say(f"recurrent serve: {RWKV} decode step twice from one state, the "
        f"second under set_sync_debug_mode('error'): no host sync, logits and"
        f" states {'bit-identical' if same else 'DIFFER'} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{RWKV}'s decode step does not repeat")


def serve_jamba(dev, smi) -> tuple[int, float]:
    """Phase 22, second part: Jamba at full width with JAMBA_BLOCKS of its
    4 blocks in bf16: ``batch_generate`` with the decode kernel (its
    attention layers, one launch each per position) and with the plain
    attention, the kernel against its plain version on every attention
    layer of a decode step's real activations, a decode step's host and
    device ms, the step twice bit for bit and with no host sync.  Returns
    the kernel's launches and the largest |kernel - plain|."""
    cfg = _jamba(JAMBA_BLOCKS)
    n_attn = _n_attention(cfg)
    what = f"{JAMBA} ({JAMBA_BLOCKS} of 4 blocks, {cfg.n_layers} layers)"
    params, _, _ = _init_counted(cfg, dev, f"{what} full width bf16 "
                                 f"({active_param_count(cfg):,} active per "
                                 "token)")
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (ZOO_PROMPTS, ZOO_PROMPT_LEN)).astype(np.int32)
    out, ms, launches = {}, {}, {}
    positions = 0
    for kernel in (True, False):
        engine = ServeEngine(ServeConfig(
            arch=JAMBA, smoke=False, slots=ZOO_PROMPTS,
            max_len=ZOO_PROMPT_LEN + ZOO_GEN, temperature=0.0,
            decode_kernel=kernel, seed=SEED, device=str(dev)),
            model_cfg=cfg, params=params)
        # warm-up, a decode step of every slot included
        batch_generate(engine, prompts[:, :2], 2)
        steps0 = engine.decode_steps
        decode_ops.reset_launches()
        with capturing_decode_step(ZOO_PROMPTS, n_attn) as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[kernel] = batch_generate(engine, prompts, ZOO_GEN)
            torch.cuda.synchronize()
            ms[kernel] = (time.perf_counter() - t0) * 1e3
            launches[kernel] = decode_ops.launches()
            layer_io = list(seen)
        positions = engine.decode_steps - steps0 + prompts.size
        ms[kernel] /= positions
        if kernel:
            kernel_io = layer_io
            step = time_decode_step(engine, smi,
                                    position=ZOO_PROMPT_LEN + ZOO_GEN // 2)
        del engine
    if launches != {True: n_attn * positions, False: 0}:
        raise AssertionError(f"{JAMBA}: decode_attention launched "
                             f"{launches}, expected {n_attn} per position "
                             f"with the kernel, 0 without")
    worst = _layers_vs_plain(kernel_io, f"{what} bf16")
    del kernel_io
    differ = out[True] != out[False]
    rows_equal = int((~differ).all(axis=1).sum())
    # each row's first generated token that differs (ZOO_GEN: none)
    first = [int(np.argmax(row)) if row.any() else ZOO_GEN for row in differ]
    say(f"recurrent serve: {what} full width bf16, Mamba-1 + attention (D="
        f"{cfg.head_dim}, {cfg.n_heads} query heads on {cfg.n_kv_heads}) + "
        f"MoE ({cfg.n_experts} experts top-{cfg.moe_top_k}), batch_generate "
        f"{ZOO_PROMPTS} prompts x {ZOO_PROMPT_LEN} + {ZOO_GEN} greedy tokens "
        f"on {smi}: ms per step (prefill positions and decode steps) kernel "
        f"{ms[True]:.2f}, plain {ms[False]:.2f}; decode step host "
        f"{step['host_ms']:.2f} ms, device {step['step_ms']:.2f} ms; "
        f"decode_attention {launches[True] // positions} launches per "
        f"position; {rows_equal} of {ZOO_PROMPTS} rows' tokens equal, each "
        f"row's first differing token of {ZOO_GEN} {first} (bf16 near-ties,"
        f" in MoE routing too, split rows; the layers are held one by one "
        f"above, the tokens in float32 below)")
    # where the very first token differs, the prefill's logits (one row,
    # as an admission runs it) with and without the kernel: their top two
    # lie closer than the two paths' logits differ
    ties = []
    for row in [i for i, f in enumerate(first) if f == 0]:
        last = {}
        for kernel in (True, False):
            c = cfg.replace(use_decode_kernel=kernel)
            last[kernel] = tf.prefill(
                c, params, tf.init_cache(c, 1, ZOO_PROMPT_LEN, dev),
                torch.from_numpy(prompts[row:row + 1]).to(dev))[0].float()
        top2 = torch.topk(last[False].flatten(), 2).values
        ties.append((row, float(top2[0] - top2[1]),
                     float((last[True] - last[False]).abs().max())))
    if ties:
        gaps = [(r, float(f"{g:.3e}"), float(f"{d:.3e}")) for r, g, d in ties]
        say(f"recurrent serve: {what} rows whose first token differs, (row, "
            f"plain top-2 logit gap, max|kernel - plain| logit): {gaps}")
    kcfg = cfg.replace(use_decode_kernel=True)
    cache = tf.init_cache(kcfg, ZOO_PROMPTS, ZOO_PROMPT_LEN + ZOO_GEN, dev)
    tf.prefill(kcfg, params, cache, torch.from_numpy(prompts).to(dev))
    tokens = torch.from_numpy(prompts[:, :1]).to(dev)
    positions = torch.arange(ZOO_PROMPTS, dtype=torch.int32,
                             device=dev) + ZOO_PROMPT_LEN
    same = _step_twice(kcfg, params, cache, tokens, positions)
    say(f"recurrent serve: {what} decode step twice from one cache, the "
        f"second under set_sync_debug_mode('error'): no host sync, logits and"
        f" caches {'bit-identical' if same else 'DIFFER'} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{JAMBA}'s decode step does not repeat")
    del params, cache
    return launches[True], worst


def _recurrent_float32_path(cfg, dev, what: str) -> None:
    """The width in float32, at a capacity factor of one slot per expert
    and choice (so neither the forward nor a decode step drops a choice):
    greedy tokens with the decode kernel and with the plain attention
    identical, and teacher-forced decode logits against ``forward``'s
    within atol 1e-3 (the scans against the one-step recurrences)."""
    cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                      capacity_factor=float(max(cfg.n_experts, 1)))
    params, _, _ = _init_counted(cfg, dev, f"{what} full width float32")
    prompt = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, ZOO_PROMPT_LEN)).astype(np.int32)
    gen = 8
    tokens = {}
    for kernel in (True, False):
        engine = ServeEngine(ServeConfig(
            arch=cfg.name, slots=1, max_len=ZOO_PROMPT_LEN + gen,
            temperature=0.0, decode_kernel=kernel, device=str(dev)),
            model_cfg=cfg, params=params)
        tokens[kernel] = batch_generate(engine, prompt, gen)[0]
        del engine
    seq = torch.from_numpy(np.concatenate(
        [prompt[0], tokens[True][:-1]]).astype(np.int32)).to(dev)[None]
    kcfg = cfg.replace(use_decode_kernel=True)
    cache = tf.init_cache(kcfg, 1, seq.shape[1], dev)
    with torch.no_grad():
        steps = torch.cat([tf.decode_step(kcfg, params, cache,
                                          seq[:, i:i + 1], i)[0].float()
                           for i in range(seq.shape[1])], dim=1)
        full, _ = tf.forward(cfg, params, {"tokens": seq})
    worst = float((steps - full.float()).abs().max())
    same = np.array_equal(tokens[True], tokens[False])
    ok = same and worst <= 1e-3 and math.isfinite(worst)
    say(f"recurrent serve: {what} in float32, {ZOO_PROMPT_LEN}-token prompt "
        f"+ {gen} greedy tokens, kernel vs plain attention: tokens "
        f"{'identical' if same else 'DIFFER'}; teacher-forced decode logits "
        f"vs forward max|diff| {worst:.3e} (atol 1e-3) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: decode and forward disagree over the "
                             "float32 path")
    del params, cache


def serve_recurrent(dev, smi) -> tuple[int, float]:
    """Phase 22: RWKV6-3B and Jamba served, then their float32 checks.
    Returns the decode kernel's launches and largest error of Jamba's
    run."""
    _free_card()
    serve_rwkv(dev, smi)
    _free_card()
    _recurrent_float32_path(get_config(RWKV), dev, f"{RWKV} whole")
    _free_card()
    launches, worst = serve_jamba(dev, smi)
    _free_card()
    _recurrent_float32_path(_jamba(JAMBA_F32_BLOCKS), dev,
                            f"{JAMBA} ({JAMBA_F32_BLOCKS} of 4 blocks)")
    _free_card()
    return launches, worst


# -- 23. the zoo's last two architectures: DeepSeek-V3, Whisper-small ----------

DEEPSEEK = "deepseek-v3-671b"
WHISPER = "whisper-small"
# DeepSeek-V3's MoE layers kept beside its 3 dense ones: 2 in bf16 (26.62 B
# parameters, 53.24 GB), 1 in float32 (15.11 B, 60.44 GB) and for MTP (its
# block is one more MoE layer)
DEEPSEEK_MOE, DEEPSEEK_F32_MOE = 2, 1
# the open-loop trace: 8 requests at 2 q/s, prompts and outputs of 8-16
# tokens (cut: the trace's length; a prefill position reads every expert)
DEEPSEEK_TRACE = dict(rate=2, n_requests=8, prompt_lens=(8, 16),
                      gen_lens=(8, 16))
DEEPSEEK_F32_POSITIONS = 16
DEEPSEEK_F32_GAP = 5e-4      # tests/test_models_smoke.py's decode bar
MTP_BATCH = (2, 256)
# Whisper-small whole: 8 sets of stub frames [1500, 768], the decoder at
# 448 tokens for the forwards; 8 prompt tokens and 16 greedy ones decoded
WHISPER_B, WHISPER_LEN, WHISPER_PROMPT, WHISPER_GEN = 8, 448, 8, 16
WHISPER_F32_LOGITS = 1e-4    # use_flash against the plain forward


def _deepseek(moe_layers: int, **kw):
    cfg = get_config(DEEPSEEK)
    return cfg.replace(n_layers=3 + moe_layers, stack=(
        cfg.stack[0], (moe_layers, cfg.stack[1][1])), **kw)


@contextlib.contextmanager
def capturing_mla_decode():
    """Keep every ``mla_decode`` call's layer parameters, input and output
    (the model runs as before).  Yields the list of (p, x, index, y)."""
    seen = []
    real = tf.mla_decode

    def capture(p, x, cache, index, cfg, *, window=None):
        y, cache = real(p, x, cache, index, cfg, window=window)
        seen.append((p, x.clone(), index.clone(), y.clone()))
        return y, cache

    with mock.patch.object(tf, "mla_decode", capture):
        yield seen


def _mla_layers_vs_apply(cfg, params, dev, smi, what: str) -> None:
    """A 16-token prefill of 2 rows in bf16, each MLA layer's absorbed
    decode outputs over the 16 positions held against ``mla_apply`` on
    the same layer inputs, within test_kernels.py's bf16 3e-2 (the two
    orders round different bf16 intermediates: q through W_uk against c
    through W_uk, the latent context against per-head V)."""
    b, s = 2, 16
    n = cfg.n_layers
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
    with capturing_mla_decode() as seen, torch.no_grad():
        tf.prefill(cfg, params, tf.init_cache(cfg, b, s, dev), prompt)
    if len(seen) != n * s:
        raise AssertionError(f"{len(seen)} mla_decode calls, expected "
                             f"{n} layers x {s} positions")
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    errs = []
    for layer in range(n):
        calls = seen[layer::n]
        p = calls[0][0]
        x = torch.cat([c[1] for c in calls], dim=1)
        y = torch.cat([c[3] for c in calls], dim=1).float()
        with torch.no_grad():
            ref = attn_lib.mla_apply(p, x, positions, cfg).float()
        errs.append(float((y - ref).abs().max()))
    seen.clear()
    ok = max(errs) <= TOL[torch.bfloat16] and all(map(math.isfinite, errs))
    say(f"deepseek numerics: {what} bf16, {b} rows x {s} positions, on "
        f"{smi}, each layer's absorbed decode vs mla_apply on the same "
        f"inputs: max|err| "
        f"per layer {[float(f'{e:.3e}') for e in errs]} (atol "
        f"{TOL[torch.bfloat16]:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the absorbed MLA decode disagrees with "
                             "mla_apply")


def serve_deepseek(dev, smi) -> None:
    """Phase 23, first part: DeepSeek-V3 at full width with its 3 dense
    layers and DEEPSEEK_MOE of its 58 MoE layers, bf16, seeded on the
    card, served over a seeded open-loop trace: MLA has no kernel, so no
    decode_attention launch."""
    cfg = _deepseek(DEEPSEEK_MOE)
    what = f"{DEEPSEEK} (3 dense + {DEEPSEEK_MOE} of 58 MoE layers)"
    params, _, _ = _init_counted(cfg, dev, f"{what} full width bf16 "
                                 f"({active_param_count(cfg):,} active per "
                                 f"token) on {smi}")
    engine = ServeEngine(ServeConfig(
        arch=DEEPSEEK, smoke=False, slots=8, max_len=512, temperature=1.0,
        seed=SEED, device=str(dev)), model_cfg=cfg, params=params)
    mcfg = engine.model_cfg
    batch_generate(engine, np.arange(1, 9, dtype=np.int32)[None], 2)
    requests = generate_requests(TrafficConfig(
        vocab_size=cfg.vocab_size, seed=SEED, **DEEPSEEK_TRACE))
    prefill_positions = sum(len(r.prompt) for r in requests)
    decode_ops.reset_launches()
    reset_jit_dispatches()
    result = run_open_loop(engine, requests)
    launches = decode_ops.launches()
    calls = jit_dispatches()
    steps = _check_open_loop(mcfg, requests, result, calls, launches)
    row = summarize(result, slots=8, rate=DEEPSEEK_TRACE["rate"])
    per_slot = sum(t[:, 0].numel() * t.element_size()
                   for t in tree_leaves(engine.cache))
    say(f"deepseek serve: {what} full width bf16, 8 slots x 512, "
        f"{DEEPSEEK_TRACE['n_requests']} requests @ {DEEPSEEK_TRACE['rate']}"
        f" q/s on {smi}: {row['throughput_tok_s']} tok/s, TTFT p50/p99 "
        f"{row['ttft_p50_ms']}/{row['ttft_p99_ms']} ms, TPOT p50/p99 "
        f"{row['tpot_p50_ms']}/{row['tpot_p99_ms']} ms; {steps} decode steps "
        f"+ {prefill_positions} prefill positions, {calls} program calls, "
        f"decode_attention launches {launches}; MLA cache per slot "
        f"{per_slot / 1e6:.2f} MB ({cfg.n_layers} layers x 512 x "
        f"{cfg.kv_lora_rank + cfg.qk_rope_dim} values x 2 B)")
    say("deepseek serve row: " + json.dumps(row, sort_keys=True))
    # a step reads every weight but the embedding (8 of its rows) once, the
    # experts' whatever the tokens chose, and each slot's cache to its row
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params)) - \
        params["embed"].numel() * params["embed"].element_size()
    expert_bytes = sum(p[name].numel() * p[name].element_size()
                       for spec, p in tf.layers_of(cfg, params)
                       if spec.ffn == "moe"
                       for name in ("w_gate", "w_up", "w_down"))
    step = time_decode_step(engine, smi)
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    say(f"deepseek serve: {what} decode step on {smi}: host "
        f"{step['host_ms']:.2f} ms, device {step['step_ms']:.2f} ms; bytes a "
        f"step {weight_bytes / 1e9:.2f} GB ({expert_bytes / 1e9:.2f} GB "
        f"experts), least time at {HBM_BYTES_PER_S / 1e12:g} TB/s "
        f"{bound_ms:.2f} ms ({100 * bound_ms / step['step_ms']:.1f}% of the "
        f"device step)")
    _moe_without_host_sync(engine, params)
    del engine
    _mla_layers_vs_apply(cfg, params, dev, smi, what)
    del params


def deepseek_float32(dev, smi) -> None:
    """Phase 23: DeepSeek-V3 at full width, 3 dense + DEEPSEEK_F32_MOE MoE
    layers in float32 at capacity factor 256 (no choice dropped):
    teacher-forced ``decode_step`` over 16 positions against ``forward``
    below the reference's 5e-4."""
    cfg = _deepseek(DEEPSEEK_F32_MOE, param_dtype="float32",
                    compute_dtype="float32", capacity_factor=256.0)
    what = f"{DEEPSEEK} (3 dense + {DEEPSEEK_F32_MOE} MoE layers)"
    params, _, _ = _init_counted(cfg, dev,
                                 f"{what} full width float32 on {smi}")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, DEEPSEEK_F32_POSITIONS)).astype(np.int32)
                              ).to(dev)
    with torch.no_grad():
        full, _ = tf.forward(cfg, params, {"tokens": tokens})
        cache = tf.init_cache(cfg, 1, DEEPSEEK_F32_POSITIONS, dev)
        steps = torch.cat([tf.decode_step(cfg, params, cache,
                                          tokens[:, i:i + 1], i)[0]
                           for i in range(DEEPSEEK_F32_POSITIONS)], dim=1)
    gap = float((steps - full).abs().max())
    ok = gap < DEEPSEEK_F32_GAP and math.isfinite(gap)
    say(f"deepseek numerics: {what} full width float32, capacity factor "
        f"256, on {smi}: decode_step over {DEEPSEEK_F32_POSITIONS} positions "
        f"vs forward max|diff| {gap:.3e} (< {DEEPSEEK_F32_GAP:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: decode and forward disagree")
    del params, cache, full, steps


def deepseek_mtp(dev, smi) -> None:
    """Phase 23: ``loss_fn`` with ``mtp_depth=1`` at full width (3 dense +
    1 MoE layer and the MTP block, bf16) under ``no_grad`` on 2 x 256
    tokens: finite, and above the loss without the MTP term."""
    cfg = _deepseek(1, mtp_depth=1)
    what = f"{DEEPSEEK} (3 dense + 1 MoE layer, mtp_depth=1)"
    params, _, _ = _init_counted(cfg, dev, f"{what} full width bf16 on {smi}")
    b, s = MTP_BATCH
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                 .astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    plain = {k: v for k, v in params.items() if k != "mtp"}
    with torch.no_grad():
        tf.loss_fn(cfg, params, batch)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(tf.loss_fn(cfg, params, batch))
        wall_ms = (time.perf_counter() - t0) * 1e3
        base = float(tf.loss_fn(cfg.replace(mtp_depth=0), plain, batch))
    ok = math.isfinite(loss) and loss > base
    say(f"deepseek mtp: {what} full width bf16, loss_fn on {b} x {s} tokens "
        f"under no_grad, on {smi}: loss {loss:.4f} with MTP > {base:.4f} "
        f"without ({cfg.mtp_loss_weight:g} x the MTP term), wall "
        f"{wall_ms:.1f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the MTP loss is not finite or adds nothing")
    del params, plain


def _whisper_frames(cfg, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(SEED)
    return 0.05 * torch.randn((WHISPER_B, cfg.n_audio_ctx, cfg.d_model),
                              generator=g, device=dev)


def _whisper_forwards(cfg, params, frames, dev, smi) -> tuple[int, float]:
    """``use_flash`` forwards at decoder length WHISPER_LEN: in bf16 each
    decoder layer's kernel output against ``attention_plain`` on its own
    inputs (``bf16_forward_layers``), none launched for the encoder; in
    float32 the logits against the forward without ``use_flash``.
    Returns the launches and the largest |kernel - plain|."""
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (WHISPER_B, WHISPER_LEN)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens, "frames": frames}
    launches, worst = bf16_forward_layers(
        cfg.replace(use_flash=True), params, batch,
        f"whisper eval: {WHISPER} whole bf16, {WHISPER_B} x "
        f"{cfg.n_audio_ctx} frames, decoder {WHISPER_LEN} tokens, D="
        f"{cfg.head_dim} group 1, on {smi}")
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    before = flash_ops.launches("simt_fp32")
    with torch.no_grad():
        kernel, _ = tf.forward(f32.replace(use_flash=True), p32, batch)
        n = flash_ops.launches("simt_fp32") - before
        plain, _ = tf.forward(f32, p32, batch)
    err = float((kernel - plain).abs().max())
    ok = n == cfg.n_layers and err <= WHISPER_F32_LOGITS and math.isfinite(err)
    say(f"whisper eval: {WHISPER} whole float32 on {smi}, use_flash "
        f"(decoder: kernel, encoder: _sdpa_blocked) vs plain: {n} "
        f"flash_attention launches, "
        f"logits max|diff| {err:.3e} (atol {WHISPER_F32_LOGITS:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("Whisper's use_flash forward disagrees with "
                             "the plain one or launched the kernel other "
                             "than once per decoder layer")
    del p32, kernel, plain
    return launches + n, worst


def _whisper_generate(cfg, params, frames, prompt, kernel: bool):
    """``_encode`` once, each decoder layer's ``cross_kv_cache`` written
    into the cache, a prefill of the prompt and WHISPER_GEN - 1 greedy
    ``decode_step_positions``; returns the tokens [B, WHISPER_GEN] and the
    cache."""
    c = cfg.replace(use_decode_kernel=kernel)
    b, p = prompt.shape
    cache = tf.init_cache(c, b, p + WHISPER_GEN, frames.device)
    with torch.no_grad():
        enc = tf._encode(c, params, frames)
        for (_, lp), lc in zip(tf.layers_of(c, params),
                               tf.layer_caches(c, cache)):
            for key, t in attn_lib.cross_kv_cache(lp, enc, c).items():
                lc["cross"][key].copy_(t)
        logits, _ = tf.prefill(c, params, cache, prompt)
        tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
        out = [tok]
        for i in range(WHISPER_GEN - 1):
            pos = torch.full((b,), p + i, dtype=torch.int32,
                             device=prompt.device)
            logits, _ = tf.decode_step_positions(c, params, cache,
                                                 tok[:, None], pos)
            tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
            out.append(tok)
    return torch.stack(out, dim=1), cache


def _whisper_decode(cfg, params, frames, dev, smi, what: str
                    ) -> tuple[int, float]:
    """Greedy decode with the decode kernel (12 launches a position, the
    first decode step's layers held against the plain version on their own
    inputs in bf16) and, in float32, without it (tokens identical) and
    teacher-forced against the forward (below 5e-4).  Returns the
    launches and the largest |kernel - plain| on real activations."""
    prompt = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (WHISPER_B, WHISPER_PROMPT)).astype(np.int32)
                              ).to(dev)
    positions = WHISPER_PROMPT + WHISPER_GEN - 1
    decode_ops.reset_launches()
    # the first decode step after the prefill (every row at position P)
    with capturing_decode_step(WHISPER_B, cfg.n_layers,
                               skip=WHISPER_PROMPT * cfg.n_layers) as seen:
        tokens, cache = _whisper_generate(cfg, params, frames, prompt, True)
        torch.cuda.synchronize()
        launches = decode_ops.launches()
        layer_io = list(seen)
    if launches != cfg.n_layers * positions:
        raise AssertionError(f"{WHISPER}: decode_attention launched "
                             f"{launches}, expected {cfg.n_layers} x "
                             f"{positions} positions")
    worst = _layers_vs_plain(layer_io, f"{what} bf16 on {smi}")
    del layer_io
    step = time_step(cfg.replace(use_decode_kernel=True), params, cache, smi,
                     WHISPER_PROMPT + WHISPER_GEN // 2,
                     WHISPER_PROMPT + WHISPER_GEN)
    del cache
    say(f"whisper decode: {what} bf16, {WHISPER_B} rows x "
        f"{WHISPER_PROMPT}-token prompts + {WHISPER_GEN} greedy tokens over "
        f"the cross caches on {smi}: decode_attention {launches // positions}"
        f" launches per position (H = KV = {cfg.n_heads}, D={cfg.head_dim}); "
        f"step host {step['host_ms']:.2f} ms, device {step['step_ms']:.2f} ms")
    f32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    toks = {k: _whisper_generate(f32, p32, frames, prompt, k)[0]
            for k in (True, False)}
    same = torch.equal(toks[True], toks[False])
    seq = torch.cat([prompt, toks[True][:, :-1]], dim=1)
    kcfg = f32.replace(use_decode_kernel=True)
    cache = tf.init_cache(kcfg, WHISPER_B, seq.shape[1], dev)
    with torch.no_grad():
        enc = tf._encode(kcfg, p32, frames)
        for (_, lp), lc in zip(tf.layers_of(kcfg, p32),
                               tf.layer_caches(kcfg, cache)):
            for key, t in attn_lib.cross_kv_cache(lp, enc, kcfg).items():
                lc["cross"][key].copy_(t)
        steps = torch.cat([tf.decode_step(kcfg, p32, cache, seq[:, i:i + 1],
                                          i)[0]
                           for i in range(seq.shape[1])], dim=1)
        full, _ = tf.forward(f32, p32, {"tokens": seq, "frames": frames})
    gap = float((steps - full).abs().max())
    ok = same and gap < DEEPSEEK_F32_GAP and math.isfinite(gap)
    say(f"whisper decode: {what} float32 on {smi}, greedy tokens with and "
        f"without the kernel {'identical' if same else 'DIFFER'}; "
        f"teacher-forced decode "
        f"vs forward max|diff| {gap:.3e} (< {DEEPSEEK_F32_GAP:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{WHISPER}: the float32 decode disagrees")
    del p32, cache, steps, full
    return launches, worst


def whisper_path(dev, smi) -> dict:
    """Phase 23, second part: Whisper-small whole (encoder and decoder)
    on seeded stub frames: the ``use_flash`` forwards, the decode through
    the cross caches, and ``ServeEngine`` refusing the arch.  Returns each
    attention kernel's launches and largest |kernel - plain|."""
    cfg = get_config(WHISPER)
    what = f"{WHISPER} whole"
    params, _, _ = _init_counted(cfg, dev, f"{what} bf16 on {smi}")
    frames = _whisper_frames(cfg, dev)
    flash, flash_err = _whisper_forwards(cfg, params, frames, dev, smi)
    dec, dec_err = _whisper_decode(cfg, params, frames, dev, smi, what)
    try:
        ServeEngine(ServeConfig(arch=WHISPER, smoke=False, device=str(dev)))
    except ValueError as e:
        refused = "encoder-decoder" in str(e)
    else:
        refused = False
    said = ("raises the encoder-decoder ValueError" if refused
            else "DID NOT RAISE")
    say(f"whisper serve: ServeEngine(arch={WHISPER!r}) {said} "
        f"{'ok' if refused else 'FAIL'}")
    if not refused:
        raise AssertionError("the engine took an encoder-decoder arch")
    del params, frames
    return {"decode_attention": (dec, dec_err),
            "flash_attention": (flash, flash_err)}


def last_archs(dev, smi) -> dict:
    """Phase 23: DeepSeek-V3 served, its float32 and MTP checks, then
    Whisper-small; the card freed between models."""
    _free_card()
    serve_deepseek(dev, smi)
    _free_card()
    deepseek_float32(dev, smi)
    _free_card()
    deepseek_mtp(dev, smi)
    _free_card()
    out = whisper_path(dev, smi)
    _free_card()
    return out


# -- 24. the launch layer --------------------------------------------------------

# train_4k's 256 x 4096 batch cut to 16 x 256 for the runs (the ghost
# activations of 256 x 4096 tokens need far more than the card's 80 GB);
# prefill_32k and decode_32k cut to 8 sequences of 2048
LAUNCH_TRAIN_CUT = (16, 256)
LAUNCH_SERVE_CUT = (8, 2048)
# SmolLM-360M's dense collector sites: q, k, v, o, up, gate, down a layer
# and the head, each one ghost_norm launch a ghost step (one chunk)
LAUNCH_GHOST_SITES = 7 * 32 + 1


def _spec_signature(tree) -> dict:
    """Each leaf's (shape, dtype) in the tree's nesting."""
    return tree_map(lambda t: (tuple(t.shape), t.dtype), tree)


def _all_meta(tree) -> bool:
    return all(t.is_meta for t in tree_leaves(tree))


def _build_without_allocating(dev, cfg, shape_name: str, **kw):
    """``build_program`` at full width: the card's allocated bytes must not
    move, and every spec must be a meta tensor."""
    before = torch.cuda.memory_allocated(dev)
    prog = launch_steps.build_program(cfg, shape_name, dev, **kw)
    moved = torch.cuda.memory_allocated(dev) - before
    specs = [prog.args[1].mu, prog.args[1].nu, prog.args[1].count,
             *prog.args[::2]] if prog.kind == "train" else list(prog.args)
    if moved or not all(_all_meta(t) for t in specs):
        raise AssertionError(f"launch: {shape_name}'s program allocated "
                             f"{moved} B on the card or holds a real tensor")
    return prog


def _lm_batch(cfg, dev, shape: tuple, step: int, seed: int = 1) -> dict:
    rows, seq = shape
    batch = make_lm_stream(cfg.vocab_size, seq, seed=seed).batch(step, rows)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _noise_generator(dev, step: int) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(dp_lib.noise_seed(0, 1000 + step))
    return gen


def launch_train_programs(dev, smi) -> int:
    """The train_4k programs at full width, their specs, 2 steps each on the
    cut batch; returns the ghost program's ghost_norm launches."""
    cfg = get_config(ARCH)
    progs = {mode: _build_without_allocating(dev, cfg, "train_4k",
                                             dp_mode=mode)
             for mode in launch_steps.DP_MODES}
    shape = INPUT_SHAPES["train_4k"]
    want = (shape["global_batch"], shape["seq_len"])
    params = tf.init(progs["ghost"].cfg, SEED, dev)
    opt = get_optimizer(cfg.optimizer, cfg.lr)
    state0 = opt.init(params)
    for mode, prog in progs.items():
        _, opt_specs, batch_specs = prog.args
        ok = (_spec_signature(prog.args[0]) == _spec_signature(params)
              and _spec_signature(opt_specs.mu) == _spec_signature(state0.mu)
              and _spec_signature(opt_specs.nu) == _spec_signature(state0.nu)
              and opt_specs.count.dtype == torch.int32
              and _spec_signature(batch_specs) == {
                  "tokens": (want, torch.int32),
                  "labels": (want, torch.int32)})
        if not ok:
            raise AssertionError(f"launch: the {mode} program's specs are "
                                 "not train_4k's batch, tf.init's tree and "
                                 "AdamW's state")
    say(f"launch specs: {ARCH} train_4k programs (ghost, per_example, none):"
        f" batch {want[0]} x {want[1]}, {len(tree_leaves(params))} parameter"
        f" leaves as tf.init's, AdamW state as opt.init's, all meta, 0 B "
        f"allocated on {smi}")
    del state0
    batches = [_lm_batch(cfg, dev, LAUNCH_TRAIN_CUT, i) for i in range(3)]
    ghost_launches = 0
    for mode, prog in progs.items():
        _free_card()
        p, state = params, opt.init(params)
        torch.cuda.reset_peak_memory_stats(dev)
        before = ghost_ops.launches()
        walls, losses = [], []
        for i in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            p, state, m = prog.fn(p, state, batches[i],
                                  _noise_generator(dev, i))
            losses.append(float(m["loss"]))
            walls.append(1e3 * (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated(dev)
        launches = ghost_ops.launches() - before
        want_launches = 2 * LAUNCH_GHOST_SITES if mode == "ghost" else 0
        if launches != want_launches or not all(map(math.isfinite, losses)):
            raise AssertionError(f"launch: the {mode} program launched "
                                 f"ghost_norm {launches} times (expected "
                                 f"{want_launches}) or lost {losses}")
        clipping = "ghost" if mode == "ghost" else "per_example"
        roof = roofline_lib.dp_round_roofline(
            prog.cfg, cohort=1, batch_per_silo=LAUNCH_TRAIN_CUT[0],
            seq_len=LAUNCH_TRAIN_CUT[1], wall_seconds=walls[1] / 1e3,
            clipping=clipping)
        say(f"launch {mode} step: {ARCH} full width "
            f"{str(prog.cfg.cdtype)[6:]}, AdamW, "
            f"{LAUNCH_TRAIN_CUT[0]} x {LAUNCH_TRAIN_CUT[1]} tokens (cut from "
            f"train_4k's {want[0]} x {want[1]}), step walls "
            f"{walls[0]:.1f} / {walls[1]:.1f} ms, losses "
            f"{losses[0]:.4f} / {losses[1]:.4f}, ghost_norm launches "
            f"{launches} ({launches // 2} a step), peak allocated "
            f"{peak / 1e9:.2f} GB; dp_round_roofline ({clipping}, H100 "
            f"989 TFLOP/s, 3.35 TB/s): {roof['round_flops']:.4e} FLOP, "
            f"bound {1e3 * roof['roofline_round_s']:.3f} ms "
            f"({roof['roofline_bottleneck']}), {roof['pct_of_roofline']:.2f}"
            f"% of the bf16 peak on {smi}")
        before = ghost_ops.launches()
        busy_us, by_kernel, prof_ms, _ = _device_profile(
            lambda: prog.fn(p, state, batches[2], _noise_generator(dev, 2)))
        launches += ghost_ops.launches() - before
        if launches != 3 * want_launches // 2:
            raise AssertionError(f"launch: the profiled {mode} step launched "
                                 f"ghost_norm {launches} times in all")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:4]
        idle = 100 * (1 - busy_us / 1e3 / prof_ms)
        say(f"launch {mode} step profile: host {prof_ms:.1f} ms, device busy "
            f"{busy_us / 1e3:.1f} ms, idle {idle:.1f}%; top device ops: "
            + "; ".join(f"{name[:60]} {us / 1e3:.2f} ms" for name, us in top))
        if mode == "ghost":
            ghost_launches += launches
            before = ghost_ops.launches()
            report = roofline_lib.analyze_program(
                prog.fn, p, state, batches[2], _noise_generator(dev, 2))
            launches = ghost_ops.launches() - before
            if launches != LAUNCH_GHOST_SITES:
                raise AssertionError(f"launch: the analyzed ghost step "
                                     f"launched ghost_norm {launches} times")
            ghost_launches += launches
            rows, seq = LAUNCH_TRAIN_CUT
            grams = sum(roofline_lib.ghost_norm_flops(rows, seq, di, do)
                        for di, do in
                        roofline_lib._ghost_collector_sites(prog.cfg))
            analytic = roofline_lib.dp_round_flops(
                prog.cfg, cohort=1, batch_per_silo=rows, seq_len=seq)
            top = ", ".join(f"{op} {n:.3e}" for op, n in
                            list(report["flops_by_op"].items())[:3])
            say(f"launch ghost analyze_program: {report['flops']:.4e} ATen "
                f"FLOP ({top}) + {grams:.4e} FLOP of Grams in "
                f"{launches} ghost_norm launches (ghost_norm_flops; the "
                f"counter does not see the kernel) = "
                f"{report['flops'] + grams:.4e}, against dp_round_flops "
                f"{analytic:.4e}; peak allocated "
                f"{report['peak_memory_bytes'] / 1e9:.2f} GB")
            del report
        del p, state
    return ghost_launches


def launch_ghost_vs_per_example(dev, smi) -> None:
    """At sigma 0 the ghost program's SGD update against the per-example
    program's from the same parameters and batch, in float32 with an
    untied head (see phase 7 for the bound: a relative norm error e moves
    each clipped gradient by at most C e, the update by lr C e)."""
    _free_card()
    cfg = get_config(ARCH).replace(
        optimizer="sgd", lr=TRAIN["lr"], dp_sigma=0.0, dp_clip=TRAIN["clip"],
        tie_embeddings=False, param_dtype="float32", compute_dtype="float32")
    params = tf.init(cfg, SEED, dev)
    batch = _lm_batch(cfg, dev, LAUNCH_TRAIN_CUT, 0)
    updated = {}
    for mode in ("ghost", "per_example"):
        prog = launch_steps.build_program(cfg, "train_4k", dev, dp_mode=mode)
        updated[mode] = prog.fn(params, (), batch,
                                _noise_generator(dev, 0))[0]
        _free_card()
    diff, upd = _update_l2(params, updated["ghost"], updated["per_example"])
    limit = 2 * TRAIN["lr"] * TRAIN["clip"] * 1e-4
    ok = diff <= limit and upd > 0
    say(f"launch ghost vs per_example: {ARCH} untied head, full width "
        f"float32, SGD lr {TRAIN['lr']}, sigma 0, "
        f"{LAUNCH_TRAIN_CUT[0]} x {LAUNCH_TRAIN_CUT[1]}: one step's update, "
        f"L2 over the tree: per_example {upd:.6e}, |ghost - per_example| "
        f"{diff:.3e} (limit {limit:g}) {'ok' if ok else 'FAIL'} on {smi}")
    if not ok:
        raise AssertionError("the ghost program's update and the "
                             "per-example program's disagree")


def launch_train_cli(dev, smi, tmp: Path) -> None:
    """``python -m repro_torch.launch.train`` at full width on the card."""
    _free_card()
    path = str(tmp / "launch-train.ckpt")
    t0 = time.perf_counter()
    report = train_cli.main(["--arch", ARCH, "--scale", "full", "--steps",
                             "3", "--batch", "8", "--seq", "256",
                             "--checkpoint", path])
    wall = time.perf_counter() - t0
    acct = RDPAccountant(sampling_rate=min(1.0, 8 / (8 * 50)),
                         noise_multiplier=0.8, delta=1e-5)
    for _ in range(3):      # as launch.train steps it
        acct.step()
    tree, step, _ = load_checkpoint(path)
    want = tree_map(lambda t: t.cpu(), params_to_tree(report["params"]))
    same = step == 3 and _identical(tree_map(lambda t: t.cpu(), tree), want)
    ok = (report["steps"] == 3 and all(map(math.isfinite, report["losses"]))
          and report["epsilon"] == acct.epsilon() and same)
    say(f"launch train CLI: {ARCH} --scale full --steps 3 --batch 8 --seq "
        f"256 (AdamW, per-example, microbatch 4) on {smi}: losses "
        f"{[round(x, 4) for x in report['losses']]}, eps {report['epsilon']}"
        f" (a fresh RDPAccountant: {acct.epsilon()}), checkpoint "
        f"{os.path.getsize(path)} B read back "
        f"{'leaf for leaf' if same else 'WRONG'}, {wall:.2f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the train CLI's run is wrong")
    del report, tree, want


def launch_serve_programs(dev, smi) -> None:
    """The prefill_32k and decode_32k programs at full width: specs, then
    a cut of 8 x 2048 against tf.forward and tf.decode_step bit for bit."""
    _free_card()
    cfg = get_config(ARCH)
    pre = _build_without_allocating(dev, cfg, "prefill_32k")
    dec = _build_without_allocating(dev, cfg, "decode_32k")
    params = tf.init(pre.cfg, SEED, dev)
    b, s = (INPUT_SHAPES[n]["global_batch"] for n in ("prefill_32k",
                                                       "decode_32k"))
    seq = INPUT_SHAPES["decode_32k"]["seq_len"]
    kv = (cfg.n_layers, s, seq, cfg.n_kv_heads, cfg.head_dim)
    ok = (_spec_signature(pre.args[0]) == _spec_signature(params)
          and _spec_signature(dec.args[0]) == _spec_signature(params)
          and _spec_signature(pre.args[1]) == {
              "tokens": ((b, INPUT_SHAPES["prefill_32k"]["seq_len"]),
                         torch.int32)}
          and _spec_signature(dec.args[1]) == {"k": (kv, cfg.cdtype),
                                               "v": (kv, cfg.cdtype)}
          and _spec_signature(dec.args[2]) == ((s, 1), torch.int32)
          and _spec_signature(dec.args[3]) == ((), torch.int32))
    if not ok:
        raise AssertionError("launch: the prefill or decode program's specs "
                             "are not their shapes'")
    batch = _lm_batch(cfg, dev, LAUNCH_SERVE_CUT, 0, seed=2)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits = pre.fn(params, {"tokens": batch["tokens"]})
    torch.cuda.synchronize(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        ref = tf.forward(pre.cfg, params, {"tokens": batch["tokens"]})[0]
    same = torch.equal(logits, ref) and bool(torch.isfinite(logits).all())
    del logits, ref
    rows, length = LAUNCH_SERVE_CUT
    caches = [tf.init_cache(dec.cfg, rows, length, dev) for _ in range(2)]
    walls = []
    for index in range(4):
        tokens = batch["tokens"][:, index:index + 1]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ours, caches[0] = dec.fn(params, caches[0], tokens, index)
        torch.cuda.synchronize(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        with torch.no_grad():
            ref, caches[1] = tf.decode_step(dec.cfg, params, caches[1],
                                            tokens, index)
        same = same and torch.equal(ours, ref)
    same = same and all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(caches[0]), tree_leaves(caches[1])))
    say(f"launch prefill/decode programs: {ARCH} full width, specs "
        f"prefill {b} x {INPUT_SHAPES['prefill_32k']['seq_len']}, decode "
        f"cache {list(kv)} {str(cfg.cdtype)[6:]}, all meta, 0 B allocated; "
        f"on {rows} x "
        f"{length} (cut): prefill {prefill_ms:.1f} ms, decode steps "
        f"{', '.join(f'{w:.2f}' for w in walls)} ms; logits and cache "
        f"{'bit for bit' if same else 'NOT'} tf.forward's and "
        f"tf.decode_step's on {smi}")
    if not same:
        raise AssertionError("a launch program's logits are not the model's")


def launch_serve_cli(dev, smi) -> int:
    """``python -m repro_torch.launch.serve`` at its defaults on the card;
    returns its decode_attention launches."""
    _free_card()
    decode_ops.reset_launches()
    out = serve_cli.main([])
    launches = decode_ops.launches()
    engine, prompts, tokens = out["engine"], out["prompts"], out["tokens"]
    steps = engine.decode_steps
    positions = steps + prompts.size
    n_attn = _n_attention(engine.model_cfg)
    again = batch_generate(engine, prompts, tokens.shape[1])
    # the same weights and prompts through the model's plain attention
    plain = ServeEngine(
        dataclasses.replace(engine.cfg, decode_kernel=False),
        model_cfg=engine.model_cfg.replace(use_decode_kernel=False),
        params=engine.params)
    before = decode_ops.launches()
    plain_tokens = batch_generate(plain, prompts, tokens.shape[1])
    plain_launches = decode_ops.launches() - before
    same = np.array_equal(again, tokens)
    same_plain = np.array_equal(plain_tokens, tokens)
    ok = (launches == n_attn * positions and plain_launches == 0 and same
          and same_plain)
    say(f"launch serve CLI: defaults ({engine.model_cfg.name} smoke "
        f"{str(engine.model_cfg.cdtype)[6:]}, {prompts.shape[0]} x "
        f"{prompts.shape[1]} prompts + {tokens.shape[1]} greedy tokens): "
        f"decode_attention launches {launches} = {n_attn} x ({steps} decode "
        f"steps + {prompts.size} prefill positions), batch_generate's tokens "
        f"again {'identical' if same else 'DIFFERENT'}, the plain attention's"
        f" ({plain_launches} launches) "
        f"{'identical' if same_plain else 'DIFFERENT'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the serve CLI's run is wrong")
    return launches


def launch_layer(dev, smi) -> dict:
    """Phase 24: the launch layer's programs and CLIs; each kernel's
    launches on its main path."""
    launches = {"ghost_norm": launch_train_programs(dev, smi)}
    launch_ghost_vs_per_example(dev, smi)
    with tempfile.TemporaryDirectory(prefix="launch-",
                                     dir=ROOT / "build") as tmp:
        launch_train_cli(dev, smi, Path(tmp))
    launch_serve_programs(dev, smi)
    launches["decode_attention"] = launch_serve_cli(dev, smi)
    _free_card()
    return launches


# -- 25. the last one-card modules: PATE, the deprecated shims, the obs CLI -----

# benchmarks/pate_ablation.py at paper scale (its fast=False data), with its
# 400 rounds cut to 60
PATE = dict(n_total=40114, test_frac=0.2, sizes=[436, 64, 16, 1], batch=128,
            lr=0.5, target_eps=4.0, clip=1.0, microbatch=16, rounds=60,
            paper_rounds=400, gnmax_sigmas=(2.0, 8.0))
SHIM_LM = dict(TRAIN, rounds=2)   # phase 6's model, silos, batch and sigma
LEGACY_TIMING = ("wall_clock", "bytes_on_wire", "dropout_events",
                 "recoveries", "lost_rounds", "events", "noise_topups")
# python -m repro_torch.run's defaults: decaph on 5 GEMINI-like hospitals
# (1200 admissions asked for, 32 features), batch 64, sigma 0.8, 10 rounds
OBS_RUN = dict(hospitals=5, examples=1200, features=32, batch=64, sigma=0.8,
               rounds=10)


def _quiet(fn, *args, **kw):
    """Call a deprecated shim without its DeprecationWarning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def _auroc(model, params, x, y) -> float:
    with torch.no_grad():
        s = model.predict_fn(params, torch.from_numpy(x).to(
            tree_device(params)))
    return mia_lib.auroc(s.cpu().numpy(), y.astype(np.int32))


def _same_run(a, b) -> bool:
    """ε, logs, rounds and every parameter leaf bit for bit."""
    return a.epsilon == b.epsilon and \
        a.rounds_completed == b.rounds_completed and \
        [dataclasses.astuple(l) for l in a.logs] == \
        [dataclasses.astuple(l) for l in b.logs] and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                              tree_leaves(b.params)))


def pate_vs_decaph(dev, smi) -> None:
    """Phase 25a: ``run_pate`` at GNMax sigma 2 and 8 against DeCaPH at
    ``benchmarks/pate_ablation.py``'s settings."""
    case = PATE
    silos = arms.normalize_participants(
        make_gemini_like(seed=SEED, n_total=case["n_total"]))
    train, tx, ty = train_test_split_silos(silos, case["test_frac"], seed=SEED)
    n_pub = len(tx) // 4   # the public pool: a quarter of the test split
    pub_x, tx_eval, ty_eval = tx[:n_pub], tx[n_pub:], ty[n_pub:]
    model = tabular.make_mlp_classifier(case["sizes"], "binary",
                                        device=str(dev))
    n_train = sum(len(p) for p in train)
    rate = case["batch"] / n_train
    sigma = sigma_for_epsilon(rate, case["rounds"], case["target_eps"], 1e-5)
    cfg = arms.ArmConfig(
        rounds=case["rounds"], batch_size=case["batch"], lr=case["lr"],
        seed=SEED, use_secagg=False, epsilon_budget=case["target_eps"],
        dp=DPConfig(clip_norm=case["clip"], noise_multiplier=sigma,
                    microbatch_size=case["microbatch"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dc = _quiet(federation.run_decaph, model, train, cfg)
    torch.cuda.synchronize()
    dc_wall = time.perf_counter() - t0
    acct = RDPAccountant(sampling_rate=rate, noise_multiplier=sigma,
                         delta=cfg.dp.delta)
    acct.step(case["rounds"])
    if dc.rounds_completed != case["rounds"] or dc.epsilon != acct.epsilon() \
            or not all(bool(torch.isfinite(p).all())
                       for p in tree_leaves(dc.params)):
        raise AssertionError(f"decaph: {dc.rounds_completed} rounds, ε "
                             f"{dc.epsilon} (accountant {acct.epsilon()})")
    auc_dc = _auroc(model, dc.params, tx_eval, ty_eval)
    say(f"pate vs decaph: GEMINI-like, {case['n_total']} admissions, "
        f"{len(train)} hospitals, 80/20 split ({n_train} train; public pool "
        f"{n_pub} = a quarter of the test split, {len(tx_eval)} held out), "
        f"MLP {'-'.join(map(str, case['sizes']))}, batch {case['batch']}, lr "
        f"{case['lr']}, sigma {sigma:.4f} for ε {case['target_eps']}, "
        f"{case['rounds']} rounds (cut from {case['paper_rounds']}), no "
        f"SecAgg, on {smi}")
    say(f"pate vs decaph: decaph (run_decaph): AUROC {auc_dc:.4f}, ε "
        f"{dc.epsilon:.4f} (accountant {acct.epsilon():.4f}), wall "
        f"{dc_wall:.2f} s")
    orders = np.asarray(DEFAULT_ORDERS)
    pates = []
    for gsigma in case["gnmax_sigmas"]:
        with obs.recording() as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = federation.run_pate(model, train, cfg, public_x=pub_x,
                                      n_classes=2, gnmax_sigma=gsigma)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            spans = rec.span_totals()
        eps, _ = rdp_to_eps_delta(n_pub * orders / (2.0 * gsigma**2), orders,
                                  cfg.dp.delta)
        if res.epsilon != eps or (res.arm, res.backend) != ("pate", "ideal") \
                or res.rounds_completed != case["rounds"] or not all(
                    bool(torch.isfinite(p).all())
                    for p in tree_leaves(res.params)):
            raise AssertionError(f"pate sigma {gsigma}: ε {res.epsilon} != "
                                 f"{eps}, or {res.arm}/{res.backend}/"
                                 f"{res.rounds_completed}, or non-finite")
        auc = _auroc(model, res.params, tx_eval, ty_eval)
        ms = {k: 1e3 * spans[f"pate.{k}"][1]
              for k in ("teachers", "label", "student")}
        pates.append((auc, res.epsilon))
        say(f"pate vs decaph: pate GNMax sigma {gsigma:g}: AUROC {auc:.4f}, ε "
            f"{res.epsilon:.4f} (= rdp_to_eps_delta of {n_pub} x α / "
            f"(2 x {gsigma:g}^2), bit for bit), wall {wall:.2f} s: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items()))
    supported = all(auc_dc > a or e > dc.epsilon for a, e in pates)
    say(f"pate vs decaph: the paper's argument (DeCaPH's AUROC above PATE's "
        f"or PATE's ε above DeCaPH's, at each sigma): {supported} (printed "
        f"only)")


def shim_decaph_lm(dev, smi) -> int:
    """Phase 25b: the deprecated ``run_decaph`` through ``ghost_norm`` on
    phase 6's SmolLM-360M, bit for bit ``arms.run`` per participant and
    fused; returns the three runs' ``ghost_norm`` launches."""
    mcfg = get_config(ARCH).replace(tie_embeddings=False)
    model = transformer_model(mcfg, device=str(dev))
    silos = _silos(mcfg)
    cfg = _train_cfg(SHIM_LM["rounds"], SHIM_LM["sigma"])
    per_participant = 7 * mcfg.n_layers + 1
    expected = per_participant * SHIM_LM["hospitals"] * SHIM_LM["rounds"]
    runs = [
        ("run_decaph", lambda: _quiet(federation.run_decaph, model, silos,
                                      cfg)),
        ("arms.run fused_rounds=False", lambda: arms.run(
            "decaph", model, silos,
            dataclasses.replace(cfg, fused_rounds=False))),
        ("arms.run fused", lambda: arms.run("decaph", model, silos, cfg)),
    ]
    reports, total, parts = [], 0, []
    for what, fn in runs:
        ghost_ops.reset_launches()
        reset_jit_dispatches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, calls = ghost_ops.launches(), jit_dispatches()
        if n != expected:
            raise AssertionError(f"{what}: ghost_norm launched {n} times, "
                                 f"expected {per_participant} x "
                                 f"{SHIM_LM['hospitals']} x "
                                 f"{SHIM_LM['rounds']} = {expected}")
        reports.append(rep)
        total += n
        parts.append(f"{what}: {n} launches, {calls} program calls, wall "
                     f"{wall:.2f} s")
    acct = RDPAccountant(sampling_rate=SHIM_LM["batch_size"]
                         / (SHIM_LM["hospitals"] * SHIM_LM["n_per"]),
                         noise_multiplier=SHIM_LM["sigma"],
                         delta=cfg.dp.delta)
    acct.step(SHIM_LM["rounds"])
    same = [_same_run(reports[0], r) for r in reports[1:]]
    say(f"shim run_decaph: {ARCH} untied head, full width, "
        f"{SHIM_LM['hospitals']} hospitals x {SHIM_LM['n_per']} x "
        f"{SHIM_LM['seq_len']} tokens, batch {SHIM_LM['batch_size']}, sigma "
        f"{SHIM_LM['sigma']}, ghost clipping, {SHIM_LM['rounds']} rounds, on "
        f"{smi}: losses {[round(l.loss, 4) for l in reports[0].logs]}, ε "
        f"{reports[0].epsilon:.6f} (accountant {acct.epsilon():.6f}); "
        + "; ".join(parts) + f"; bit for bit the per-participant and the "
        f"fused arms.run: {same}")
    if not all(same) or reports[0].epsilon != acct.epsilon() or \
            reports[0].rounds_completed != SHIM_LM["rounds"]:
        raise AssertionError("the run_decaph shim is not arms.run bit for "
                             "bit, or its ε is not the accountant's")
    return total


def shim_simulate_decaph(smi, dropout: dict) -> None:
    """Phase 25c: ``simulate_decaph`` on phase 16's pancreas and dropout
    trace through ``scenario_from_trace``, bit for bit phase 16's
    ``arms.run(..., backend="sim")``, ``SimTiming`` included."""
    nodes, topo = protocols.scenario_from_trace(
        {"nodes": dropout["trace"], "topology": {"kind": "full"}})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = _quiet(protocols.simulate_decaph, dropout["model"],
                 dropout["silos"], nodes, topo, dropout["cfg"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = dropout["report"]
    legacy = {k: getattr(rep, k) for k in LEGACY_TIMING}
    same = _same_run(rep, ref) and rep.timing == ref.timing
    say(f"shim simulate_decaph: pancreas MLP, {len(dropout['silos'])} "
        f"hospitals, dropout-robust SecAgg, phase 16's dropout trace through "
        f"scenario_from_trace (topology {topo.name}), on {smi}: "
        f"{_timing(rep)}; bit for bit phase 16's arms.run(backend='sim'), "
        f"SimTiming included: {same}; legacy properties {legacy}; host wall "
        f"{wall:.2f} s")
    if not same or legacy != {k: getattr(rep.timing, k)
                              for k in LEGACY_TIMING}:
        raise AssertionError("simulate_decaph is not arms.run on sim bit for "
                             "bit, or a legacy property is not its timing")


def _python(*argv, **kw) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600, **kw)


def obs_cli_path(smi, tmp: Path) -> None:
    """Phase 25d: ``python -m repro_torch.run --obs DIR`` on the card, then
    ``python -m repro_torch.obs`` on its export: ``--validate`` 0, a
    tampered copy 1, ``--to-chrome`` a valid trace, the summary's ε the
    run's."""
    out = tmp / "obs"
    t0 = time.perf_counter()
    run = _python("-m", "repro_torch.run", "--arm", "decaph", "--obs",
                  str(out))
    run_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"python -m repro_torch.run --obs: rc "
                             f"{run.returncode}\n{run.stderr[-2000:]}")
    n = sum(len(p) for p in make_gemini_like(
        seed=SEED, n_total=OBS_RUN["examples"], n_silos=OBS_RUN["hospitals"],
        n_features=OBS_RUN["features"]))
    acct = RDPAccountant(sampling_rate=OBS_RUN["batch"] / n,
                         noise_multiplier=OBS_RUN["sigma"], delta=1e-5)
    acct.step(OBS_RUN["rounds"])
    line = [ln for ln in run.stdout.splitlines() if ln.startswith("decaph")]
    entries = obs.read_entries(out / obs.LEDGER_FILE)
    if obs.per_hospital_epsilon(entries) != {
            h: acct.epsilon() for h in range(OBS_RUN["hospitals"])} or \
            f"eps={acct.epsilon():8.3f}" not in line[0]:
        raise AssertionError(f"the ledger's ε {obs.per_hospital_epsilon(entries)}"
                             f" or the run's line {line} is not the "
                             f"accountant's {acct.epsilon()}")
    t0 = time.perf_counter()
    valid = _python("-m", "repro_torch.obs", "--validate", str(out))
    summary = _python("-m", "repro_torch.obs", str(out))
    bad = tmp / "tampered"
    shutil.copytree(out, bad)
    rows = (bad / obs.LEDGER_FILE).read_text().splitlines()
    row = json.loads(rows[3])
    row["eps"] = row["eps"] / 2          # under-report one hospital's ε
    rows[3] = json.dumps(row, sort_keys=True)
    (bad / obs.LEDGER_FILE).write_text("\n".join(rows) + "\n")
    tampered = _python("-m", "repro_torch.obs", "--validate", str(bad))
    chrome = _python("-m", "repro_torch.obs", "--to-chrome",
                     str(out / obs.EVENTS_FILE), "--out",
                     str(tmp / "chrome.json"))
    cli_s = time.perf_counter() - t0
    trace = validate_chrome_trace(tmp / "chrome.json")
    want = [f"hospital {h:<4} eps={acct.epsilon():10.4f}"
            for h in range(OBS_RUN["hospitals"])]
    say(f"obs cli: python -m repro_torch.run --arm decaph --obs on {smi}: "
        f"{line[0].strip()} ({run_s:.1f} s); python -m repro_torch.obs "
        f"--validate rc {valid.returncode} ({valid.stdout.count(': OK')} "
        f"artifacts OK), tampered copy rc {tampered.returncode} "
        f"({tampered.stderr.strip().splitlines()[-1][-80:]}), --to-chrome rc "
        f"{chrome.returncode} ({trace['trace_events']} trace events), summary "
        f"rc {summary.returncode}, per-hospital ε {acct.epsilon():.4f} the "
        f"run's: {all(w in summary.stdout for w in want)} ({cli_s:.1f} s for "
        f"the four CLI calls)")
    if (valid.returncode, tampered.returncode, chrome.returncode,
            summary.returncode) != (0, 1, 0, 0) or \
            valid.stdout.count(": OK") != 3 or \
            not all(w in summary.stdout for w in want):
        raise AssertionError(f"obs cli: validate {valid.returncode}, "
                             f"tampered {tampered.returncode}, chrome "
                             f"{chrome.returncode}, summary "
                             f"{summary.returncode}\n{summary.stdout}")


def last_modules(dev, smi, dropout: dict) -> dict:
    """Phase 25: PATE against DeCaPH, the deprecated shims, the obs CLI;
    each kernel's launches on its main path."""
    pate_vs_decaph(dev, smi)
    torch.cuda.empty_cache()
    launches = {"ghost_norm": shim_decaph_lm(dev, smi)}
    torch.cuda.empty_cache()
    shim_simulate_decaph(smi, dropout)
    with tempfile.TemporaryDirectory(prefix="obs-", dir=ROOT / "build") as tmp:
        obs_cli_path(smi, Path(tmp))
    return launches


# -- 26. the multi-card layer: the shard backend on ranks sharing the card ----

SHARD_GEMINI_RANKS = 2            # ("data",)
SHARD_LM_MESH = ((1, 2, 2), ("pod", "data", "model"))
# phase 6's model at full width, silos, batch and sigma, cut to 4 of its 32
# layers (a round on the four ranks took 133 s at 32 layers and 32-54 s at
# 8, most of it DTensor's dispatch and host-staged collectives), in float32
# as phase 7's round: PR 12's bound on the update holds for float32 sums,
# and bf16 products summed over the model axis in another order missed it
# (9.0e-5 at 8 layers, run 1, PR 25)
SHARD_LM = dict(TRAIN, rounds=2, n_layers=4)
# the dry run on the card's machine's torch, one process a cell, started
# with the phase and run beside (a) and (b): the reference's first two
# train cells (per_example, the paper-faithful default), the GQA decode
# over a split KV cache, and the (16, 16) production mesh's prefill
SHARD_DRY = (("smollm-360m", "train_4k", "4,2"),
             ("olmo-1b", "train_4k", "2,2,2"),
             ("smollm-360m", "decode_32k", "4,2"),
             ("smollm-360m", "prefill_32k", None))
SHARD_TIMEOUT_S = 400


@contextlib.contextmanager
def recording_local_ghost_inputs():
    """Keep the first (a, g) of every shape that reaches the kernel itself:
    under the model axis ``ghost_norm`` gets DTensors and runs the kernel
    on each rank's local shards (``ghost_ops._ghost_norm_sharded``)."""
    seen: dict = {}
    real = ghost_ops.ghost_norm

    def recording(a, g, **kw):
        if not hasattr(a, "placements") and not hasattr(g, "placements"):
            key = (*a.shape, g.shape[-1], a.dtype, g.dtype)
            if key not in seen:
                seen[key] = (a.detach().clone(), g.detach().clone())
        return real(a, g, **kw)

    with mock.patch.object(ghost_ops, "ghost_norm", recording):
        yield seen


def _comm_stats(runner) -> dict:
    """A rank's collective bytes and seconds by kind: the backend's own
    collectives (data and model groups) and DTensor's, staged."""
    ex = runner.executor
    out: dict = {}
    for group, comm in (("data", ex.data), ("model", ex.model)):
        if comm is None:
            continue
        for kind, n in comm.bytes.items():
            out[f"{group}.{kind}"] = [n, comm.seconds[kind]]
        out[f"{group}.staged_bytes"] = [comm.staged_bytes, 0.0]
    staged = federated_lib.staged_stats()
    if staged is not None:
        for kind, n in staged["bytes"].items():
            out[f"dtensor.{kind}"] = [n, staged["seconds"][kind]]
    return out


def _shard_gemini():
    silos = arms.normalize_participants(make_gemini_like(**GEMINI["data"]))
    model = tabular.make_mlp_classifier(GEMINI["sizes"], GEMINI["task"],
                                        device="cuda")
    return model, silos, _tabular_cfg(GEMINI, use_secagg=False)


def _shard_lm():
    layers = SHARD_LM["n_layers"]
    mcfg = get_config(ARCH).replace(tie_embeddings=False, n_layers=layers,
                                    stack=dense_stack(layers),
                                    param_dtype="float32",
                                    compute_dtype="float32")
    cfg = dataclasses.replace(_train_cfg(SHARD_LM["rounds"], TRAIN["sigma"]),
                              clipping="ghost")
    return transformer_model(mcfg, device="cuda"), _silos(mcfg), cfg


def shard_rank(cell: str, out: str) -> int:
    """One rank of a phase-26 cell (``python3 chip_smoke.py --shard-rank
    CELL OUT``): joins the ``gloo`` group it was spawned into, runs the
    cell on the card and writes its numbers to ``OUT.<rank>``."""
    rank, world = init_rank("gloo")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    walls: list = []
    last = [time.perf_counter()]

    def on_round(t, params):
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls.append(now - last[0])
        last[0] = now
        say(f"round {t}: {walls[-1]:.2f} s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

    if cell == "gemini":
        mesh = make_host_data_mesh(device_type="cuda")
        model, silos, cfg = _shard_gemini()
    else:
        mesh = make_mesh(*SHARD_LM_MESH, "cuda")
        model, silos, cfg = _shard_lm()
    runner = federated_lib.ShardedRunner(mesh=mesh, on_round=on_round)
    arm = arms.get("decaph")(model, silos, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ghost_ops.reset_launches()
    last[0] = time.perf_counter()
    with recording_local_ghost_inputs() as seen:
        report = runner.run(arm)
    torch.cuda.synchronize()
    result = {
        "rank": rank, "epsilon": report.epsilon,
        "rounds": report.rounds_completed,
        "launches": ghost_ops.launches(),
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "round_walls": walls,
        "sharded_puts": runner.executor.sharded_puts,
        "participant_shards": runner.executor.participant_shards,
        "param_shards": runner.executor.param_shards,
        "comm": _comm_stats(runner),
        "backend": runner.executor.data.backend,
    }
    if cell == "lm" and rank == 0:
        result["local_err"] = path_ghost_vs_plain(
            seen, "phase 26 rank 0's local shards")
    if rank == 0:
        torch.save(dict(enumerate(t.detach().cpu()
                                  for t in tree_leaves(report.params))),
                   out + ".params")
    Path(f"{out}.{rank}").write_text(json.dumps(result))
    return 0


def _shard_ranks(cell: str, world: int, tmp: Path) -> list:
    """Spawn ``world`` ranks of ``cell`` on the card; their results."""
    out = str(tmp / cell)
    # four ranks' allocators share 80 GB: no reserved-but-free segments
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = spawn([sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank",
                   cell, out], world, str(tmp / f"init_{cell}"),
                  timeout=SHARD_TIMEOUT_S, env=env)
    failed = []
    for rank, p in enumerate(procs):
        for line in p.stdout.splitlines():
            say(f"  [{cell} rank {rank}] {line}")
        if p.returncode != 0:
            failed.append(f"rank {rank} exited {p.returncode}:\n"
                          f"{p.stderr[-3000:]}")
    if failed:
        raise AssertionError(f"phase 26 {cell}: " + "\n".join(failed))
    return [json.loads(Path(f"{out}.{r}").read_text()) for r in range(world)]


def _shard_params(tmp: Path, cell: str) -> dict:
    """Rank 0's trained parameters, {leaf index: tensor}."""
    return torch.load(str(tmp / cell) + ".params")


def _say_ranks(cell: str, ranks: list, smi: str) -> None:
    for r in ranks:
        comm = ", ".join(f"{k} {v[0]} B {v[1]:.3f} s"
                         for k, v in sorted(r["comm"].items()))
        say(f"phase 26 {cell} rank {r['rank']}: peak "
            f"{r['peak_bytes'] / 1e9:.3f} GB, round walls "
            f"{[round(w, 4) for w in r['round_walls']]} s, ghost_norm "
            f"launches {r['launches']}; collectives ({r['backend']}, "
            f"host-staged, not NVLink): {comm} on {smi}")


def _dry_run_procs(tmp: Path) -> list:
    """One ``python -m repro_torch.launch.dryrun`` a cell of ``SHARD_DRY``,
    started at once (stdout and stderr to files: nothing waits on a
    pipe)."""
    procs = []
    for i, (arch, shape, mesh) in enumerate(SHARD_DRY):
        out = tmp / f"dryrun{i}"
        out.mkdir()
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--out", str(out)]
        if mesh:
            argv += ["--mesh", mesh]
        if shape == "train_4k":
            argv += ["--dp-mode", "per_example"]
        with open(out / "log", "w") as log:
            procs.append((out, subprocess.Popen(
                argv, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                stdout=log, stderr=subprocess.STDOUT)))
    return procs


def _dry_run_results(procs: list) -> None:
    """Wait for each dry-run cell, print its record, and fail the phase if
    one exited non-zero (every process is ended first)."""
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    failed = []
    for (arch, shape, _), (out, proc) in zip(SHARD_DRY, procs):
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            failed.append(f"{arch} x {shape} exited {proc.returncode}:\n"
                          + (out / "log").read_text()[-2000:])
            continue
        rec = json.loads(next(out.glob("*.json")).read_text())
        terms = rec["roofline"]
        say(f"phase 26 dry run {arch} x {shape} on {rec['mesh']} "
            f"({rec['n_chips']} fake ranks, CPU, torch {torch.__version__},"
            f" nothing allocated, dp_mode "
            f"{rec['meta'].get('dp_mode', '-')}): flops {rec['flops']:.4e}, "
            f"collective bytes {rec['collective_bytes']:.4e}, bottleneck "
            f"{terms['bottleneck']}, traced in {rec['trace_s']:.1f} s")
    if failed:
        raise AssertionError("phase 26 dry run: " + "\n".join(failed))


def shard_path(dev, smi) -> dict:
    """Phase 26: the shard backend on ranks that share the card over gloo
    (NCCL refuses two ranks on one device), against the port's ideal;
    the dry run of ``SHARD_DRY``'s cells on fake meshes, beside it."""
    say("phase 26: ranks share the one card, so the group is gloo (NCCL "
        "refuses two ranks on one device); every collective is staged "
        "through host memory, so its bytes and seconds are the host's, "
        "not NVLink's")
    with tempfile.TemporaryDirectory(prefix="shard-", dir=ROOT / "build") as d:
        tmp = Path(d)
        dry = _dry_run_procs(tmp)
        try:
            launches = _shard_cells(tmp, dry, smi)
        finally:
            for _, proc in dry:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {"ghost_norm": launches}


def _shard_cells(tmp: Path, dry: list, smi) -> int:
    """Phase 26's cells (a) and (b), then the dry runs' results; -> the
    ghost_norm launches of (b)."""
    # ideal's runs in this process first: (a) GEMINI DeCaPH, (b)
    # SmolLM-360M; then both cells' ranks at once ((a)'s are light)
    model, silos, cfg = _shard_gemini()
    ideal = arms.run("decaph", model, silos, cfg)
    gemini_params = [t.detach().cpu() for t in tree_leaves(ideal.params)]
    gemini_eps = ideal.epsilon
    model, silos, cfg = _shard_lm()
    initial = dict(enumerate(t.detach().cpu() for t in
                             tree_leaves(model.init_fn(SEED))))
    t0 = time.perf_counter()
    ideal = arms.run("decaph", model, silos, cfg)
    ideal_s = time.perf_counter() - t0
    ideal_params = dict(enumerate(t.detach().cpu()
                                  for t in tree_leaves(ideal.params)))
    del model, ideal
    torch.cuda.empty_cache()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cell_a = pool.submit(_shard_ranks, "gemini", SHARD_GEMINI_RANKS,
                             tmp)
        cell_b = pool.submit(_shard_ranks, "lm",
                             math.prod(SHARD_LM_MESH[0]), tmp)
        ranks = cell_a.result()
        lm_ranks = cell_b.result()
    # (a) on 2 ranks ("data",), against ideal
    got = _shard_params(tmp, "gemini")
    diff = max(float((a - b).abs().max())
               for a, b in zip(gemini_params, got.values()))
    eps = {r["epsilon"] for r in ranks}
    ok = (diff <= 1e-5 and eps == {gemini_eps}
          and all(r["sharded_puts"] > 0 for r in ranks))
    _say_ranks("gemini", ranks, smi)
    say(f"phase 26 (a) GEMINI DeCaPH, 8 hospitals, 2 ranks ('data',): "
        f"max|shard - ideal| {diff:.3e} (limit 1e-5), eps {eps} vs "
        f"ideal {gemini_eps}, sharded_puts "
        f"{[r['sharded_puts'] for r in ranks]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 26 (a): shard disagrees with ideal")
    # (b) SmolLM-360M at full width on (1, 2, 2), against ideal
    ranks = lm_ranks
    got = _shard_params(tmp, "lm")
    l2, upd = _update_l2(initial, got, ideal_params)
    bound = 2 * TRAIN["lr"] * TRAIN["clip"] * 1e-4
    launches = sum(r["launches"] for r in ranks)
    peak = sum(r["peak_bytes"] for r in ranks)
    ok = (l2 <= bound and all(r["participant_shards"] > 0
                              and r["param_shards"] > 0 for r in ranks)
          and launches > 0 and peak < 80e9
          and len({r["epsilon"] for r in ranks}) == 1)
    _say_ranks("lm", ranks, smi)
    say(f"phase 26 (b) SmolLM-360M full width, {SHARD_LM['n_layers']} "
        f"layers, float32 (untied, 4 hospitals x "
        f"{TRAIN['n_per']} x {TRAIN['seq_len']}, ghost, "
        f"{SHARD_LM['rounds']} rounds) on {SHARD_LM_MESH[0]} "
        f"{SHARD_LM_MESH[1]}: |update - ideal's update| {l2:.3e} "
        f"(bound 2 lr C 1e-4 = {bound:.1e}; ideal's update {upd:.3e}, "
        f"ideal's run {ideal_s:.1f} s in one process), "
        f"participant_shards {[r['participant_shards'] for r in ranks]}, "
        f"param_shards {[r['param_shards'] for r in ranks]}, ghost_norm "
        f"launches {[r['launches'] for r in ranks]} (sum {launches}), "
        f"local-shard kernel vs plain max|err| {ranks[0]['local_err']:.3e},"
        f" summed peak {peak / 1e9:.3f} GB of 80 "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 26 (b): shard outside its bound, or "
                             "a counter or the memory is off")
    _dry_run_results(dry)
    return launches


# -- main -----------------------------------------------------------------------


def main() -> int:
    if sys.argv[1:2] == ["--shard-rank"]:
        return shard_rank(sys.argv[2], sys.argv[3])
    smi = card()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build()
    lap(t0, "phase 2")
    worst = {"decode_attention": kernel_vs_plain(dev),
             "ghost_norm": ghost_vs_plain(dev),
             "flash_attention": flash_vs_plain(dev)}
    lap(t0, "phase 3")
    engine, launches = main_path(dev, smi)
    time_decode_step(engine, smi)
    del engine
    whole_path(dev)
    lap(t0, "phases 4-5")
    torch.cuda.empty_cache()
    ckpt = tempfile.TemporaryDirectory(prefix="ckpt-", dir=ROOT / "build")
    train = train_main_path(dev, smi, ckpt.name)
    launches["ghost_norm"] = train["launches"]
    train_whole_path(dev, train["silos"])
    lap(t0, "phases 6-7")
    torch.cuda.empty_cache()
    launches["flash_attention"] = eval_main_path(dev, smi, train["params"])
    torch.cuda.empty_cache()
    eval_whole_path(dev)
    torch.cuda.empty_cache()
    worst["flash_attention"] = max(worst["flash_attention"],
                                   eval_layers_bf16(dev))
    torch.cuda.empty_cache()
    blocked_train_path(dev)
    lap(t0, "phases 8-10")
    torch.cuda.empty_cache()
    times = {"decode_attention": time_decode(SERVE_SHAPE, dev, smi)}
    time_decode(SERVE_SHAPE, dev, smi, position=SERVE_POSITION)
    time_decode(LONG_SHAPE, dev, smi)
    for shape in ZOO_DECODE_SHAPES + [WHISPER_DECODE_SHAPE]:
        time_decode(shape, dev, smi)
    ghost = time_ghost(dev, smi)
    times["ghost_norm"] = ghost["row"]
    profile_round(dev, smi, train, ghost)
    del ghost
    torch.cuda.empty_cache()
    times["flash_attention"] = time_flash(dev, smi)
    for shape in ZOO_FLASH_SHAPES + [WHISPER_FLASH_SHAPE]:
        time_flash(dev, smi, shape)
    time_eval_forward(dev, smi, times["flash_attention"]["ms"])
    lap(t0, "phase 11")
    torch.cuda.empty_cache()
    launches["decode_attention"] += hot_swap_path(dev, smi, train, ckpt.name)
    ckpt.cleanup()
    lap(t0, "phase 12")
    del train
    torch.cuda.empty_cache()
    pancreas = tabular_main_path(dev, smi)
    torch.cuda.empty_cache()
    tabular_whole_path(dev, smi, pancreas)
    lap(t0, "phases 13-14")
    torch.cuda.empty_cache()
    launches["ghost_norm"] += comparison_arms_path(dev, smi,
                                                   pancreas["gemini"])
    lap(t0, "phase 15")
    torch.cuda.empty_cache()
    dropout = sim_path(dev, smi, pancreas)
    lap(t0, "phase 16")
    del pancreas
    torch.cuda.empty_cache()
    mia_path(dev, smi)
    lap(t0, "phase 17")
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    lm_launches, lm_err = scenario_presets(dev, smi)
    launches["ghost_norm"] += lm_launches
    with tempfile.TemporaryDirectory(prefix="scenarios-",
                                     dir=ROOT / "build") as tmp:
        sweep_err = scenario_sweep(dev, smi, Path(tmp))
        t19 = time.perf_counter()
        population_cli(smi, Path(tmp))
    population_paper_width(dev, smi)
    torch.cuda.empty_cache()
    worst["ghost_norm"] = max(worst["ghost_norm"], lm_err, sweep_err,
                              population_vs_ideal(dev, smi))
    say(f"phases 18-19: {time.perf_counter() - t18:.1f} s (phase 18 "
        f"{t19 - t18:.1f} s, phase 19 {time.perf_counter() - t19:.1f} s)")
    t20 = time.perf_counter()
    launches["decode_attention"] += serve_qwen3(dev, smi)
    for name, (n, err) in serve_zoo_dense(dev, smi).items():
        launches[name] += n
        worst[name] = max(worst[name], err)
    t21 = time.perf_counter()
    olmo_launches, olmo_err = train_olmo(dev, smi)
    launches["ghost_norm"] += olmo_launches
    worst["ghost_norm"] = max(worst["ghost_norm"], olmo_err)
    train_qwen3_smoke(dev, smi)
    say(f"phases 20-21: {time.perf_counter() - t20:.1f} s (phase 20 "
        f"{t21 - t20:.1f} s, phase 21 {time.perf_counter() - t21:.1f} s)")
    t22 = time.perf_counter()
    jamba_launches, jamba_err = serve_recurrent(dev, smi)
    launches["decode_attention"] += jamba_launches
    worst["decode_attention"] = max(worst["decode_attention"], jamba_err)
    say(f"phase 22: {time.perf_counter() - t22:.1f} s")
    t23 = time.perf_counter()
    for name, (n, err) in last_archs(dev, smi).items():
        launches[name] += n
        worst[name] = max(worst[name], err)
    say(f"phase 23: {time.perf_counter() - t23:.1f} s")
    t24 = time.perf_counter()
    for name, n in launch_layer(dev, smi).items():
        launches[name] += n
    say(f"phase 24: {time.perf_counter() - t24:.1f} s")
    t25 = time.perf_counter()
    for name, n in last_modules(dev, smi, dropout).items():
        launches[name] += n
    del dropout
    say(f"phase 25: {time.perf_counter() - t25:.1f} s")
    t26 = time.perf_counter()
    for name, n in shard_path(dev, smi).items():
        launches[name] += n
    say(f"phase 26: {time.perf_counter() - t26:.1f} s")
    lines = [{**k, "launches": launches[k["name"]],
              "max_abs_err": worst[k["name"]], **times[k["name"]]}
             for k in KERNELS]
    if any(k["launches"] < 1 for k in lines):
        raise AssertionError("a kernel of the main paths never launched")
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s "
        f"on {smi}")
    say(json.dumps({"kernels": lines}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
