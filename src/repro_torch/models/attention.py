"""Attention: GQA, DeepSeek's MLA and Whisper's cross attention, over full
sequences and decoding per row.

Counterpart of ``repro.models.attention``.

  * ``gqa_apply`` — full-sequence attention.  By default the float32
    ``_sdpa`` with an additive ``_causal_mask``: plain products that the
    reference leaves to XLA.  With ``cfg.use_flash``, the reference's
    routing with "tpu" read as "cuda": causal attention on CUDA tensors
    goes to the ``flash_attention`` kernel (forward only, as the
    reference's Pallas kernel has no VJP) at any sequence length,
    everything else (CPU tensors, ``causal=False``) to ``_sdpa_blocked``,
    FlashAttention's algorithm in plain PyTorch.
  * ``gqa_decode`` — one token per row.  The reference's ``gqa_decode``
    takes one scalar ``index`` and gets per-slot positions from
    ``jax.vmap`` (``transformer.decode_step_positions``); the port writes
    that batch dimension out: ``index`` is an int32 ``[B]`` tensor on the
    device, and the rope angle, the cache write and the mask of row b all
    use ``index[b]`` without a host sync.

Both rotate q and k with standard RoPE or, for ``rope_type="mrope"``,
Qwen2-VL's M-RoPE.

  * ``mla_apply`` / ``mla_decode`` — DeepSeek's multi-head latent
    attention.  The full-sequence form materialises per-head K and V from
    the compressed latent; the decode is absorbed: ``w_uk`` is folded into
    the query and ``w_uv`` applied after the softmax, so a step attends
    over the cache of ``kv_lora_rank`` latents plus one ``qk_rope_dim``
    rope key a token (576 values for V3), shared by every head, and never
    forms per-head K or V.  As ``gqa_decode``, ``index`` is int32 [B]: row
    b writes and masks at ``index[b]``.  Plain products, as the
    reference's are (no kernel of the reference lies on this path).
  * ``cross_apply`` / ``cross_kv_cache`` / ``cross_decode`` — Whisper's
    decoder attending over the encoder's output with no mask, plain
    ``_sdpa``.  Its projections live in the layer's dict as ``cross_wq``,
    ``cross_wk``, ``cross_wv`` and ``cross_wo`` beside the self-attention's.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    init_device,
    matmul,
    mrope_angles,
    rmsnorm,
    rope_angles,
    rotate,
    shard,
    sin_cos,
    split_dim,
    split_last,
)
from repro_torch.models.placement import (
    einsum,
    from_block,
    local_block,
    merge_dims,
    placements_of,
    write_rows,
)

NEG_INF = -1e30


def gqa_init(cfg, dtype: torch.dtype, generator: torch.Generator | None,
             out: dict | None = None) -> dict:
    """q, k, v and o projections; ``out`` (name -> tensor) receives the
    draws in place."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    o = out or {}
    return {
        "wq": dense_init(d, (d, h * hd), dtype, generator, o.get("wq")),
        "wk": dense_init(d, (d, kv * hd), dtype, generator, o.get("wk")),
        "wv": dense_init(d, (d, kv * hd), dtype, generator, o.get("wv")),
        "wo": dense_init(h * hd, (h * hd, d), dtype, generator, o.get("wo")),
    }


def gqa_init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, hd), dtype=dtype, device=device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return split_last(x, n, hd)


def _sdpa(q, k, v, mask):
    """q: [B,S,H,D]; k,v: [B,L,KV,D]; mask: [B,1,S,L] additive or None.

    The model's own plain attention, in float32 (``decode_kernel=False``).
    DTensors take ``_ShardedAttention``: the same products on each rank's
    own rows and heads; a decode over a cache split along its sequence
    (the keys split where q's rows are not) takes DTensor's own
    propagation.
    """
    if placements_of(q) is not None and not _keys_split_alone(q, k):
        return _ShardedAttention.apply(q, k, v, mask)[0]
    return _attend(q, k, v, mask)[0]


# ---------------------------------------------------------------------------
# Attention on DTensors, rank by rank
# ---------------------------------------------------------------------------
#
# DTensor propagates an einsum through the bmm it decomposes into, and the
# bmm's batch dim is (batch x kv heads) flattened: with the batch split
# over ("pod", "data") and the heads over "model" that flattened dim is a
# strided shard, and torch's redistribute planner searches a graph of
# placements for every candidate strategy (minutes for one op on a 3-D
# mesh).  Attention needs no communication once each rank holds its rows'
# keys and its heads' keys, so ``_ShardedAttention`` places q, k, v that
# way (the reference's hints name it: batch over its axes, heads over
# "model") and runs ``_attend``/``_attend_grad`` on the local shards.  It
# is an ``autograd.Function`` with ``vmap`` rules, so the faithful
# per-example path (``torch.func.vmap`` of ``grad``) runs it as well.
# ``placement.einsum`` (the MLA's route) cannot place this: q's heads
# reach the products through the view h -> (kv heads, group), whose split
# DTensor keeps only on the kv heads, so where the kv heads do not divide
# the "model" extent (32/4, 96/8, 32/8 heads over 16) the heads are made
# whole and every "model" rank would run all of them; here each rank
# picks its heads' keys out of whole ones instead.  Under the per-example
# rules the sequence is split over "data" (a microbatch's few examples
# stay whole): each rank then takes its block of q's rows, attends over
# keys and values made whole along the sequence (an all-gather), and
# hands their gradients back to its own block (a reduce-scatter).


def _keys_split_alone(q, k) -> bool:
    """Whether a mesh dim splits the keys' sequence (dim 1) but not q's
    rows: a decode over a cache split along its sequence."""
    pq, pk = placements_of(q), placements_of(k) or ()
    return any(p.is_shard(1) and not (pq and pq[md].is_shard(1))
               for md, p in enumerate(pk))


def _attend(q, k, v, mask):
    """``_sdpa``'s products, with its float32 probabilities [B, KV, G, S,
    L]: on plain tensors (a rank's blocks), or on DTensors whose keys are
    split along the sequence, through DTensor's own propagation."""
    h, d = q.shape[2], q.shape[3]
    kvh = k.shape[2]
    qg = split_dim(q, 2, kvh, h // kvh)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(),
                          k.float()) / math.sqrt(d)
    if mask is not None:
        scores = scores + mask[:, :, None]  # mask: [B, KV->1, S, L]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, v.float())
    return merge_dims(out, 2).to(q.dtype), probs


def _attend_grad(q, k, v, probs, dout):
    """The gradients of ``_attend``'s output for q, k and v (plain
    tensors): the products autograd takes through its einsums."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    do = dout.float().reshape(b, s, kvh, g, d)
    dv = torch.einsum("bkgsl,bskgd->blkd", probs, do)
    dp = torch.einsum("bskgd,blkd->bkgsl", do, v.float())
    ds = probs * (dp - torch.sum(dp * probs, dim=-1, keepdim=True))
    ds = ds / math.sqrt(d)
    dq = torch.einsum("bkgsl,blkd->bskgd", ds, k.float())
    dk = torch.einsum("bkgsl,bskgd->blkd", ds,
                      q.reshape(b, s, kvh, g, d).float())
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Layout:
    """Where each rank's attention lives.  A mesh dim that splits q's rows
    (dim 1: the per-example rules' sequence) keeps them split, and the
    keys are whole there.  Every other mesh dim keeps the split the keys
    have (the larger operand: a decode's cache), else q's, if it is of the
    batch (dim 0) or of the heads (dim 2, where the heads divide): q and
    the output are split there, and the keys too, by their KV heads where
    those divide as well (else each rank picks its heads' keys out of
    whole ones).  Everything else is made whole."""

    def __init__(self, q, k):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        mesh = q.device_mesh
        h, kvh = q.shape[2], k.shape[2]
        self.mesh = mesh
        order = (k, q) if k.numel() >= q.numel() else (q, k)
        self.pq, heads, head_dims, self.row_dims = [], 1, [], []
        for md in range(mesh.ndim):
            if q.placements[md].is_shard(1):
                self.row_dims.append(md)
                self.pq.append(Shard(1))
                continue
            dims = [p.dim for p in (x.placements[md] for x in order
                                    if hasattr(x, "placements"))
                    if type(p) is Shard and p.dim in (0, 2)]
            if dims and dims[0] == 2 and h % (heads * mesh.size(md)):
                dims = [d for d in dims if d == 0]
            if not dims:
                self.pq.append(Replicate())
            elif dims[0] == 0:
                self.pq.append(Shard(0))
            else:
                heads *= mesh.size(md)
                head_dims.append(md)
                self.pq.append(Shard(2))
        self.kv_split = kvh % heads == 0
        self.pk = [Replicate() if md in self.row_dims or
                   (md in head_dims and not self.kv_split) else p
                   for md, p in enumerate(self.pq)]
        self.head_dims = head_dims
        # the probabilities [B, H, S, L]: q's splits, heads at dim 1 and
        # rows at dim 2
        self.pp = [Shard({1: 2, 2: 1}.get(p.dim, p.dim)) if p.is_shard()
                   else p for p in self.pq]
        shape, off = compute_local_shape_and_global_offset(
            tuple(q.shape), mesh, self.pq)
        self.rows = (off[0], shape[0])
        self.q_rows = (off[1], shape[1])
        # the KV head of each local q head, where the keys stay whole
        self.kv_of = None if self.kv_split else \
            (off[2] + torch.arange(shape[2])) // (h // kvh)

    def local_mask(self, mask):
        if mask is None:
            return None
        from torch.distributed.tensor import Replicate

        mask = local_block(mask, self.mesh, [Replicate()] * self.mesh.ndim)
        if mask.shape[0] > 1:
            mask = mask[self.rows[0]:self.rows[0] + self.rows[1]]
        if self.row_dims:
            mask = mask[:, :, self.q_rows[0]:self.q_rows[0] + self.q_rows[1]]
        return mask

    def local_qkv(self, q, k, v):
        q = local_block(q, self.mesh, self.pq)
        k, v = (local_block(x, self.mesh, self.pk) for x in (k, v))
        if self.kv_of is not None:
            idx = self.kv_of.to(k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return q, k, v

    def key_grad(self, g, k):
        """A key's gradient [B, L, KV, D] from this rank's block: pending
        sums over the mesh dims where each rank picked its heads' keys or
        attended from its own rows; the rows' sums are reduce-scattered
        back to the keys' own split of the sequence."""
        from torch.distributed.tensor import Partial

        pk = [Partial() if md in self.row_dims or
              (md in self.head_dims and self.kv_of is not None) else p
              for md, p in enumerate(self.pk)]
        g = from_block(g, self.mesh, pk, k.shape)
        back = [k.placements[md] if md in self.row_dims and
                k.placements[md].is_shard(1) else p
                for md, p in enumerate(pk)]
        return g if back == pk else g.redistribute(self.mesh, back)


class _ShardedAttention(torch.autograd.Function):
    """``_sdpa`` of DTensors on each rank's own shards (the comment
    above): -> (the output in q's layout, the probabilities [B,H,S,L],
    kept for the backward)."""

    @staticmethod
    def forward(q, k, v, mask):
        lay = _Layout(q, k)
        ql, kl, vl = lay.local_qkv(q, k, v)
        out, probs = _attend(ql, kl, vl, lay.local_mask(mask))
        b, kvh, g, s, l = probs.shape
        return (from_block(out, lay.mesh, lay.pq, q.shape),
                from_block(probs.reshape(b, kvh * g, s, l), lay.mesh,
                           lay.pp, (q.shape[0], q.shape[2], q.shape[1], l)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, _ = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(q, k, v, output[1])

    @staticmethod
    def backward(ctx, dout, _dprobs):
        q, k, v, probs = ctx.saved_tensors
        return (*_ShardedAttentionGrad.apply(q, k, v, probs, dout), None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, mask):
        n = info.batch_size
        qb, kb, vb = (_batch_front(x, d, n) for x, d in
                      zip((q, k, v), in_dims[:3]))
        b = qb.shape[1]
        if mask is not None and (in_dims[3] is not None
                                 or mask.shape[0] > 1):
            mask = _batch_front(mask, in_dims[3], n)
            mask = _merge(mask.expand(n, b, *mask.shape[2:]))
        out, probs = _ShardedAttention.apply(_merge(qb), _merge(kb),
                                             _merge(vb), mask)
        return ((out.reshape(n, b, *out.shape[1:]),
                 probs.reshape(n, b, *probs.shape[1:])), (0, 0))


class _ShardedAttentionGrad(torch.autograd.Function):
    """``_attend_grad`` of DTensors on each rank's own shards: dq in q's
    layout; dk and dv in the keys' (``_Layout.key_grad``)."""

    @staticmethod
    def forward(q, k, v, probs, dout):
        lay = _Layout(q, k)
        ql, kl, vl = lay.local_qkv(q, k, v)
        pl = local_block(probs, lay.mesh, lay.pp)
        b, hl, s, l = pl.shape
        kvh = kl.shape[2]
        dq, dk, dv = _attend_grad(ql, kl, vl,
                                  pl.reshape(b, kvh, hl // kvh, s, l),
                                  local_block(dout, lay.mesh, lay.pq))
        if lay.kv_of is not None:
            # each local head's key gradient back onto its KV head
            idx = lay.kv_of.to(dk.device)
            shape = (b, l, k.shape[2], k.shape[3])
            dk = dk.new_zeros(shape).index_add_(2, idx, dk)
            dv = dv.new_zeros(shape).index_add_(2, idx, dv)
        return (from_block(dq, lay.mesh, lay.pq, q.shape),
                lay.key_grad(dk, k), lay.key_grad(dv, v))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("attention's gradient is not differentiated "
                           "again")

    @staticmethod
    def vmap(info, in_dims, q, k, v, probs, dout):
        n = info.batch_size
        xs = [_batch_front(x, d, n) for x, d in
              zip((q, k, v, probs, dout), in_dims)]
        b = xs[0].shape[1]
        grads = _ShardedAttentionGrad.apply(*(_merge(x) for x in xs))
        return tuple(g.reshape(n, b, *g.shape[1:]) for g in grads), \
            (0, 0, 0)


def _batch_front(x, dim, n):
    """``x`` with ``vmap``'s batch dim first (broadcast when it has
    none)."""
    return x.expand(n, *x.shape) if dim is None else x.movedim(dim, 0)


def _merge(x):
    """[N, B, ...] -> [N * B, ...]: ``vmap``'s examples as more rows."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _blocked_step(qg, k_blk, v_blk, m_run, l_run, acc, *, start: int,
                  l_orig: int, causal: bool, window: int | None):
    """One KV block of ``_sdpa_blocked``'s online softmax."""
    s, block_k = qg.shape[1], k_blk.shape[1]
    scores = torch.einsum("bskgd,blkd->bkgsl", qg, k_blk.float())
    q_pos = torch.arange(s, device=qg.device)
    k_pos = start + torch.arange(block_k, device=qg.device)
    ok = (k_pos < l_orig)[None, :].expand(s, block_k)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(ok, scores, NEG_INF)
    m_cur = torch.amax(scores, dim=-1, keepdim=True)
    m_new = torch.maximum(m_run, m_cur)
    p = torch.where(ok, torch.exp(scores - m_new), 0.0)
    alpha = torch.exp(m_run - m_new)
    l_new = alpha * l_run + torch.sum(p, dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bkgsl,blkd->bkgsd", p, v_blk.float())
    return m_new, l_new, acc


def _sdpa_blocked(q, k, v, *, causal: bool = True, window: int | None = None,
                  block_k: int = 512):
    """FlashAttention's algorithm in plain PyTorch: a loop over KV blocks
    with an online softmax, each block's body under ``torch.utils.checkpoint``
    so the backward recomputes its probabilities instead of keeping the
    full [.., S, L] scores (the reference ``jax.checkpoint``s its scan body).

    q: [B,S,H,D]; k,v: [B,L,KV,D] -> [B,S,H,D].  L is padded to a multiple
    of ``block_k`` and the pad masked.  The checkpoint is skipped where it
    saves nothing (no gradient is being recorded) and inside ``torch.func``
    transforms, which refuse its saved-tensor hooks (the faithful
    per-example DP path vmaps ``grad``); the values are the same.
    """
    b, s, h, d = q.shape
    l, kvh = k.shape[1], k.shape[2]
    l_orig = l
    group = h // kvh
    block_k = min(block_k, l)
    if l % block_k:
        pad = block_k - l % block_k
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        l = k.shape[1]
    qg = split_dim(q, 2, kvh, group).float() / math.sqrt(d)
    stats = (torch.full((b, kvh, group, s, 1), NEG_INF, device=q.device),
             torch.zeros((b, kvh, group, s, 1), device=q.device),
             torch.zeros((b, kvh, group, s, d), device=q.device))
    recompute = (torch.is_grad_enabled()
                 and not torch._C._are_functorch_transforms_active())
    for start in range(0, l, block_k):
        step = functools.partial(_blocked_step, start=start, l_orig=l_orig,
                                 causal=causal, window=window)
        blk = (qg, k[:, start:start + block_k], v[:, start:start + block_k],
               *stats)
        stats = checkpoint(step, *blk, use_reentrant=False) if recompute \
            else step(*blk)
    _, l_run, acc = stats
    out = acc / torch.clamp(l_run, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _causal_mask(s: int, l: int, offset: int = 0, window: int | None = None,
                 device=None) -> torch.Tensor:
    """Additive float32 [1,1,S,L] mask: query i attends keys j <= i+offset,
    and j > i+offset-window when a window is set."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(l, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > qi - window
    return torch.where(ok, 0.0, NEG_INF)[None, None]


def gqa_apply(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg, *,
              window: int | None = None, causal: bool = True,
              mrope_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence GQA.  x: [B,S,D]; positions: [B,S] (and
    ``mrope_positions`` [B,S,3] under M-RoPE) -> [B,S,D]."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(matmul(x, p["wq"]), h, hd)
    k = _split_heads(matmul(x, p["wk"]), kv, hd)
    v = _split_heads(matmul(x, p["wv"]), kv, hd)
    q, k = rope(q, k, positions, cfg, mrope_positions)
    # the reference's hints, and the rules' sequence split, which only
    # the per-example rules give (``_ShardedAttention`` keeps q's rows
    # split and makes the keys whole)
    q = shard(q, "attn_batch", "seq", "heads", None)
    k = shard(k, "attn_batch", "seq", None, None)
    v = shard(v, "attn_batch", "seq", None, None)
    if cfg.use_flash:
        if causal and q.device.type == "cuda":
            # blocks of the whole sequence: the kernel's own tiles mask
            # ragged edges, so any S runs (the reference's Pallas call
            # needs S a multiple of its 128-row block; Whisper's 448 is not)
            out = flash_attention(q, k, v, causal=True, window=window,
                                  block_q=s, block_k=s)
        else:
            out = _sdpa_blocked(q, k, v, causal=causal, window=window)
    else:
        mask = _causal_mask(s, s, 0, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask)
    return matmul(merge_dims(out), p["wo"])


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, cfg,
         mrope_positions: torch.Tensor | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary embedding of q and k: M-RoPE at ``mrope_positions`` [B,S,3]
    when the config asks for it and they are given, else standard RoPE at
    ``positions`` (none for ``"none"``), as the reference routes it.  The
    angles are computed once for both."""
    d = q.shape[-1]
    if cfg.rope_type == "mrope" and mrope_positions is not None:
        ang = mrope_angles(mrope_positions, d, cfg.rope_theta,
                           cfg.mrope_sections)
    elif cfg.rope_type == "none":
        return q, k
    else:
        ang = rope_angles(positions, d, cfg.rope_theta)
    sin, cos = sin_cos(ang)
    return rotate(q, sin, cos), rotate(k, sin, cos)


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, index: torch.Tensor,
               cfg, *, window: int | None = None
               ) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: [B,1,D]; cache k/v: [B,L,KV,hd]; index: int32 [B].

    Writes row b's new K and V at cache position ``index[b]`` IN PLACE (the
    reference donates the cache buffer to the same effect) and returns
    ``(y, cache)`` with the same cache tensors.  An index outside
    [0, L) is not clamped as JAX's ``dynamic_update_slice`` would clamp
    it; the engine never produces one.
    """
    b = x.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    q = _split_heads(matmul(x, p["wq"]), h, hd)
    k_new = _split_heads(matmul(x, p["wk"]), kv, hd)
    v_new = _split_heads(matmul(x, p["wv"]), kv, hd)
    pos = index[:, None]                                       # [B,1]
    # M-RoPE decodes text: the position drives t, h and w alike
    q, k_new = rope(q, k_new, pos, cfg, pos[..., None].expand(b, 1, 3))
    # attention runs in the cache's dtype (the kernel takes one dtype):
    # a no-op unless float32 parameters promoted the products above a
    # bfloat16 compute dtype, a pair the reference refuses to decode
    q = q.to(k_cache.dtype)
    write_rows(k_cache, index, k_new[:, 0].to(k_cache.dtype))
    write_rows(v_cache, index, v_new[:, 0].to(v_cache.dtype))
    if cfg.use_decode_kernel:
        out = decode_attention(q, k_cache, v_cache, index, window=window)
    else:
        kj = torch.arange(k_cache.shape[1], device=x.device)[None, :]
        pos = index.long()[:, None]
        ok = kj <= pos
        if window is not None:
            ok &= kj > pos - window
        mask = torch.where(ok, 0.0, NEG_INF)[:, None, None, :]  # [B,1,1,L]
        out = _sdpa(q, k_cache, v_cache, mask)
    y = matmul(merge_dims(out), p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_init(cfg, dtype: torch.dtype, generator: torch.Generator | None,
             out: dict | None = None) -> dict:
    """The down- and up-projections of q and of the KV latent, their
    RMSNorm scales (ones), the shared rope key's projection and ``wo``;
    ``out`` (name -> tensor) receives the draws in place."""
    d, h = cfg.d_model, cfg.n_heads
    qr, dc = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    o = out or {}
    dev = init_device(generator)
    return {
        "w_dq": dense_init(d, (d, qr), dtype, generator, o.get("w_dq")),
        "q_norm_scale": torch.ones(qr, dtype=dtype, device=dev),
        "w_uq": dense_init(qr, (qr, h * (dn + dr)), dtype, generator,
                           o.get("w_uq")),
        "w_dkv": dense_init(d, (d, dc), dtype, generator, o.get("w_dkv")),
        "kv_norm_scale": torch.ones(dc, dtype=dtype, device=dev),
        "w_uk": dense_init(dc, (dc, h * dn), dtype, generator, o.get("w_uk")),
        "w_uv": dense_init(dc, (dc, h * dv), dtype, generator, o.get("w_uv")),
        "w_kr": dense_init(d, (d, dr), dtype, generator, o.get("w_kr")),
        "wo": dense_init(h * dv, (h * dv, d), dtype, generator, o.get("wo")),
    }


def _mla_q(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The queries' no-rope and rope parts [B,S,H,dn], [B,S,H,dr]."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rmsnorm(matmul(x, p["w_dq"]), p["q_norm_scale"])
    q = split_last(matmul(ql, p["w_uq"]), cfg.n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_latents(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The normed KV latent c [B,S,dc] and the rope key kr [B,S,dr], one
    for all heads, rotated at ``positions``."""
    c = rmsnorm(matmul(x, p["w_dkv"]), p["kv_norm_scale"])
    kr = matmul(x, p["w_kr"])
    kr = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, kr


def mla_apply(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg, *,
              window: int | None = None) -> torch.Tensor:
    """Full-sequence causal MLA (training / prefill), per-head K and V
    materialised.  x: [B,S,D]; positions: [B,S] -> [B,S,D]."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c, kr = _mla_latents(p, x, positions, cfg)
    k_nope = split_last(matmul(c, p["w_uk"]), h, dn)
    v = split_last(matmul(c, p["w_uv"]), h, dv)
    scores = (einsum("bshd,bthd->bhst", q_nope.float(), k_nope.float())
              + einsum("bshd,btd->bhst", q_rope.float(), kr.float())
              ) * (1.0 / math.sqrt(dn + dr))
    scores = scores + _causal_mask(s, s, 0, window, x.device)[:, 0]
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bhst,bthd->bshd", probs, v.float()).to(x.dtype)
    return matmul(merge_dims(out), p["wo"])


def mla_init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> dict:
    """The compressed cache: latents ``c`` [B,L,dc] and rope keys ``kr``
    [B,L,dr]."""
    return {
        "c": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                          device=device),
    }


def mla_decode(p: dict, x: torch.Tensor, cache: dict, index: torch.Tensor,
               cfg, *, window: int | None = None
               ) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token MLA decode.  x: [B,1,D]; cache ``c`` [B,L,dc]
    and ``kr`` [B,L,dr]; index: int32 [B].

    Writes row b's latent and rope key at ``index[b]`` IN PLACE and attends
    row b over positions up to it (within ``window``), with no host sync.
    The query's no-rope part is taken into the latent space through
    ``w_uk`` and the context out of it through ``w_uv``: scores and
    probabilities in float32 over the compressed cache, the context cast
    to x's dtype before the ``w_uv`` product, as the reference's."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv, dc = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                      cfg.kv_lora_rank)
    c, kr = cache["c"], cache["kr"]
    pos = index[:, None]                                       # [B,1]
    q_nope, q_rope = _mla_q(p, x, pos, cfg)                    # [B,1,H,dn/dr]
    c_new, kr_new = _mla_latents(p, x, pos, cfg)               # [B,1,dc/dr]
    write_rows(c, index, c_new[:, 0].to(c.dtype))
    write_rows(kr, index, kr_new[:, 0].to(kr.dtype))
    w_uk = p["w_uk"].reshape(dc, h, dn)
    w_uv = p["w_uv"].reshape(dc, h, dv)
    dt = torch.promote_types(q_nope.dtype, w_uk.dtype)
    q_abs = einsum("bshn,dhn->bshd", q_nope.to(dt), w_uk.to(dt))
    scores = (einsum("bshd,bld->bhsl", q_abs.float(), c.float())
              + einsum("bshr,blr->bhsl", q_rope.float(), kr.float())
              ) * (1.0 / math.sqrt(dn + dr))
    kj = torch.arange(c.shape[1], device=x.device)[None, :]
    at = index.long()[:, None]
    ok = kj <= at
    if window is not None:
        ok &= kj > at - window
    scores = torch.where(ok[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = einsum("bhsl,bld->bshd", probs, c.float())     # [B,1,H,dc]
    dt = torch.promote_types(x.dtype, w_uv.dtype)
    out = einsum("bshd,dhv->bshv", ctx.to(x.dtype).to(dt), w_uv.to(dt))
    return matmul(merge_dims(out), p["wo"]), cache


# ---------------------------------------------------------------------------
# Cross attention (Whisper's decoder)
# ---------------------------------------------------------------------------

CROSS = ("cross_wq", "cross_wk", "cross_wv", "cross_wo")


def cross_init(cfg, dtype: torch.dtype, generator: torch.Generator | None,
               out: dict | None = None) -> dict:
    """GQA's q, k, v and o projections under the ``cross_`` names."""
    o = out or {}
    p = gqa_init(cfg, dtype, generator,
                 {name[6:]: o.get(name) for name in CROSS})
    return {f"cross_{name}": t for name, t in p.items()}


def cross_kv_cache(p: dict, enc: torch.Tensor, cfg) -> dict:
    """The encoder's K and V [B,T,KV,hd] for one layer, computed once per
    request for the decode."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": _split_heads(matmul(enc, p["cross_wk"]), kv, hd),
            "v": _split_heads(matmul(enc, p["cross_wv"]), kv, hd)}


def cross_apply(p: dict, x: torch.Tensor, enc: torch.Tensor, cfg
                ) -> torch.Tensor:
    """x: [B,S,D] decoder states; enc: [B,T,D] encoder output; no mask."""
    return cross_decode(p, x, cross_kv_cache(p, enc, cfg), cfg)


def cross_decode(p: dict, x: torch.Tensor, ckv: dict, cfg) -> torch.Tensor:
    """x: [B,S,D] over the precomputed ``ckv`` (``cross_kv_cache``)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = _split_heads(matmul(x, p["cross_wq"]), h, hd)
    out = _sdpa(q, ckv["k"], ckv["v"], None)
    return matmul(merge_dims(out), p["cross_wo"])
