"""Ghost clipping for dense decoder stacks: exact per-example gradient norms
in one batched backward, without per-example gradients.

Counterpart of ``repro.core.ghost``.  Every parameterised op of the ghost
forward threads a collector ``coll`` ([B] float32) through an
``autograd.Function``:

  * its forward passes ``coll`` on unchanged (as a new tensor);
  * its backward ADDS the op's per-example squared gradient norm to the
    collector's cotangent — for a dense layer the ghost identity
    ||A_i^T G_i||_F^2 = sum_{s,t}(a_s.a_t)(g_s.g_t), computed by the
    ``ghost_norm`` kernel on the card; for RMSNorm scales and the embedding
    the cheap exact forms below;
  * one ``torch.autograd.grad`` with cotangents (1.0, ones(B)) therefore
    yields every per-example norm^2 plus the seed 1.

A second backward over the clip-weighted loss gives the clipped-sum
gradient.  Supported: dense decoder stacks with RMSNorm and standard RoPE
(``transformer.check_supported``); the head may be tied (then the norm is
an upper bound, which is why ``serve.federation.transformer_model``
attaches the capability to untied models only).

Differences from the reference: ``cfg.remat`` is not honoured (every
activation is kept for the backward; the card's shapes fit without it),
and the embedding norm groups repeated tokens by sorting and differencing
float64 cumulative sums instead of a float32 segment-sum, so no scatter
(atomics on the card) decides a norm.
"""

from __future__ import annotations

import torch

from repro_torch.core.dp import clip_factor, ghost_norms_2d
from repro_torch.kernels.ghost_norm.ops import ghost_norm
from repro_torch.models import transformer as tf
from repro_torch.models.attention import _causal_mask, _sdpa, rope
from repro_torch.models.layers import _act, matmul
from repro_torch.tree import Tree, tree_leaves, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# Collector ops
# ---------------------------------------------------------------------------

def _ghost_norm_pairs(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-example ||A^T G||_F^2; 2-D inputs in closed form, 3-D through the
    ``ghost_norm`` kernel (which wants contiguous inputs)."""
    if a.dim() == 2:
        return ghost_norms_2d(a, g)
    return ghost_norm(a.contiguous(), g.contiguous())


class _DPDense(torch.autograd.Function):
    """y = a @ w (promoted) with the collector threaded through."""

    @staticmethod
    def forward(ctx, a, w, coll, with_norms):
        ctx.save_for_backward(a, w)
        ctx.with_norms = with_norms
        return matmul(a, w), coll.clone()

    @staticmethod
    def backward(ctx, ybar, collbar):
        a, w = ctx.saved_tensors
        abar = wbar = None
        if ctx.needs_input_grad[0]:
            abar = matmul(ybar, w.T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            wbar = matmul(a.reshape(-1, a.shape[-1]).T,
                          ybar.reshape(-1, ybar.shape[-1])).to(w.dtype)
        if ctx.with_norms:
            collbar = collbar + _ghost_norm_pairs(a, ybar).to(collbar.dtype)
        return abar, wbar, collbar, None


def dp_dense(a, w, coll, with_norms: bool = True):
    return _DPDense.apply(a, w, coll, with_norms)


def _rmsnorm_raw(scale, x, eps=1e-6):
    # variance in float32; xhat in the input dtype, as the reference's
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    xhat = x * inv
    return xhat * scale.to(x.dtype), xhat


class _DPRMSNorm(torch.autograd.Function):
    """RMSNorm with the collector; the per-example scale gradient is
    sum over the sequence of ybar * xhat."""

    @staticmethod
    def forward(ctx, scale, x, coll, with_norms):
        ctx.save_for_backward(scale, x)
        ctx.with_norms = with_norms
        return _rmsnorm_raw(scale, x)[0], coll.clone()

    @staticmethod
    def backward(ctx, ybar, collbar):
        scale, x = ctx.saved_tensors
        with torch.enable_grad():
            s_ = scale.detach().requires_grad_(True)
            x_ = x.detach().requires_grad_(True)
            y, xhat = _rmsnorm_raw(s_, x_)
            sbar, xbar = torch.autograd.grad(y, (s_, x_), ybar)
        if ctx.with_norms:
            prod = ybar.float() * xhat.detach().float()
            g_scale = prod.sum(dim=tuple(range(1, x.dim() - 1))) \
                if x.dim() == 3 else prod
            collbar = collbar + torch.sum(torch.square(g_scale), dim=-1
                                          ).to(collbar.dtype)
        return sbar.to(scale.dtype), xbar.to(x.dtype), collbar, None


def dp_rmsnorm(scale, x, coll, with_norms: bool = True):
    return _DPRMSNorm.apply(scale, x, coll, with_norms)


def _per_example_embed_norm(tokens: torch.Tensor, g: torch.Tensor
                            ) -> torch.Tensor:
    """sum over vocab rows r of ||sum_{s: tok_s = r} g_s||^2, per example.

    Rows repeat when a token repeats, so equal tokens are grouped: sort
    each example's tokens, take float64 cumulative sums of the sorted
    cotangents and difference them at the segment ends — O(S log S + S D),
    no [V, D] buffer.  tokens: [B,S]; g: [B,S,D] -> [B] float32.
    """
    b, s, d = g.shape
    dev = g.device
    order = torch.argsort(tokens, dim=1, stable=True)
    tok = torch.gather(tokens, 1, order)
    cs = torch.cumsum(torch.gather(g.double(), 1,
                                   order[..., None].expand(b, s, d)), dim=1)
    end = torch.ones_like(tok, dtype=torch.bool)
    end[:, :-1] = tok[:, 1:] != tok[:, :-1]
    # the previous segment's last position (-1 before the first segment)
    last_end = torch.cummax(
        torch.where(end, torch.arange(s, device=dev), -1), dim=1).values
    prev = torch.cat([torch.full((b, 1), -1, dtype=torch.long, device=dev),
                      last_end[:, :-1]], dim=1)
    cs0 = torch.cat([torch.zeros((b, 1, d), dtype=cs.dtype, device=dev), cs],
                    dim=1)
    before = torch.gather(cs0, 1, (prev + 1)[..., None].expand(b, s, d))
    seg = (cs - before) * end[..., None]
    return torch.sum(seg * seg, dim=(1, 2)).float()


class _DPEmbed(torch.autograd.Function):
    """y = emb[tokens] with exact per-example grad norms in the backward."""

    @staticmethod
    def forward(ctx, emb, tokens, coll):
        ctx.save_for_backward(tokens)
        ctx.emb_shape, ctx.emb_dtype = emb.shape, emb.dtype
        return emb[tokens], coll.clone()

    @staticmethod
    def backward(ctx, ybar, collbar):
        (tokens,) = ctx.saved_tensors
        embbar = None
        if ctx.needs_input_grad[0]:
            embbar = torch.zeros(ctx.emb_shape, dtype=torch.float32,
                                 device=ybar.device).index_add_(
                0, tokens.reshape(-1),
                ybar.reshape(-1, ybar.shape[-1]).float()).to(ctx.emb_dtype)
        if ctx.needs_input_grad[2]:
            collbar = collbar + _per_example_embed_norm(tokens, ybar).to(
                collbar.dtype)
        return embbar, None, collbar


def dp_embed(emb, tokens, coll):
    return _DPEmbed.apply(emb, tokens, coll)


# ---------------------------------------------------------------------------
# Ghost forward for dense decoder stacks (loss-identical to transformer.py)
# ---------------------------------------------------------------------------

def _attn_g(cfg, p, x, positions, coll, with_norms):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, coll = dp_dense(x, p["wq"], coll, with_norms)
    k, coll = dp_dense(x, p["wk"], coll, with_norms)
    v, coll = dp_dense(x, p["wv"], coll, with_norms)
    q, k = rope(q.reshape(b, s, h, hd), k.reshape(b, s, kv, hd), positions,
                cfg)
    mask = _causal_mask(s, s, 0, cfg.sliding_window, x.device)
    out = _sdpa(q, k, v.reshape(b, s, kv, hd), mask)
    return dp_dense(out.reshape(b, s, h * hd), p["wo"], coll, with_norms)


def _ffn_g(cfg, p, x, coll, with_norms):
    up, coll = dp_dense(x, p["w_up"], coll, with_norms)
    if cfg.ffn_kind in ("swiglu", "geglu"):
        gate, coll = dp_dense(x, p["w_gate"], coll, with_norms)
        hid = _act(cfg.ffn_kind, gate) * up
    else:
        hid = _act(cfg.ffn_kind, up)
    return dp_dense(hid, p["w_down"], coll, with_norms)


def forward_ghost(cfg, params: dict, batch: dict, coll: torch.Tensor, *,
                  with_norms: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Loss-identical ghost forward -> (per-example mean CE [B], coll)."""
    tf.check_supported(cfg)
    if cfg.use_flash:
        raise NotImplementedError("use_flash needs the flash_attention "
                                  "kernel, which is not ported yet")
    x, coll = dp_embed(params["embed"], batch["tokens"].long(), coll)
    x = x.to(cfg.cdtype)
    b, s, _ = x.shape
    positions = tf.positions_of(batch, b, s, x.device)
    for p in tf.layer_params(params["layers"]):
        h, coll = dp_rmsnorm(p["norm1"], x, coll, with_norms)
        h, coll = _attn_g(cfg, p, h, positions, coll, with_norms)
        x = x + h
        h, coll = dp_rmsnorm(p["norm2"], x, coll, with_norms)
        h, coll = _ffn_g(cfg, p, h, coll, with_norms)
        x = x + h
    x, coll = dp_rmsnorm(params["final_norm"], x, coll, with_norms)
    logits, coll = dp_dense(x, tf.head_of(cfg, params).to(cfg.cdtype), coll,
                            with_norms)
    return tf.per_example_ce(logits, batch["labels"]), coll


def _norms_of_chunk(cfg, params, bchunk, mchunk):
    """Per-example norms [n] and the masked loss sum of one chunk.

    Masking the loss zeroes the pad rows' cotangents, so their collector
    gets nothing and their norm comes out exactly 0 (the pure seed); real
    rows see cotangent 1.0, identical to unmasked.
    """
    n = mchunk.shape[0]
    coll0 = torch.zeros((n,), dtype=torch.float32, device=mchunk.device,
                        requires_grad=True)
    with torch.enable_grad():
        per_ex, coll_out = forward_ghost(cfg, params, bchunk, coll0,
                                         with_norms=True)
        loss_sum = torch.sum(per_ex * mchunk)
        (collbar,) = torch.autograd.grad(
            (loss_sum, coll_out), (coll0,),
            grad_outputs=(torch.ones_like(loss_sum), torch.ones_like(coll0)))
    norms = torch.sqrt(torch.clamp(collbar - 1.0, min=0.0))  # seed rides along
    return norms, loss_sum.detach()


def _grads_of_chunk(cfg, params, bchunk, factors) -> Tree:
    """Gradient of sum(per_ex * factors): the clip-weighted backward."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    coll = torch.zeros(factors.shape, dtype=torch.float32,
                       device=factors.device)
    with torch.enable_grad():
        per_ex, _ = forward_ghost(cfg, live, bchunk, coll, with_norms=False)
        grads = torch.autograd.grad(torch.sum(per_ex * factors),
                                    tree_leaves(live))
    return tree_unflatten(live, grads)


def ghost_clipped_grad_sum(cfg, params: dict, batch: dict, *,
                           clip_norm: float, chunk_size: int | None = None,
                           mask: torch.Tensor | None = None
                           ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """Exact clipped-sum gradients in 2 batched passes (no per-example grads).

    ``chunk_size`` bounds residual-activation memory: the batch runs in
    ``B / chunk_size`` chunks (a chunk that does not divide B falls back to
    one full-batch chunk).  ``mask`` ([B] of {0,1}) drops padding rows:
    their clip factors are zeroed and the returned loss is the
    mask-weighted mean, Σ(per_ex·mask) / max(Σmask, 1) — the semantics of
    ``dp.per_example_clipped_grad_sum``.

    Returns (grad_sum tree, mask-weighted mean loss, per-example norms).
    """
    tokens = batch["tokens"]
    b = tokens.shape[0]
    chunk = min(chunk_size or b, b)
    if b % chunk:
        chunk = b
    if mask is None:
        mask = torch.ones((b,), dtype=torch.float32, device=tokens.device)
    mask = mask.float()
    denom = torch.clamp(torch.sum(mask), min=1.0)
    frozen = tree_map(torch.Tensor.detach, params)

    def part(t, c):
        return t[c * chunk:(c + 1) * chunk]

    norms, loss_sum, grads = [], None, None
    for c in range(b // chunk):
        n, l = _norms_of_chunk(cfg, frozen, {k: part(v, c)
                                             for k, v in batch.items()},
                               part(mask, c))
        norms.append(n)
        loss_sum = l if loss_sum is None else loss_sum + l
    norms = torch.cat(norms)
    factors = clip_factor(norms, clip_norm) * mask
    for c in range(b // chunk):
        g = _grads_of_chunk(cfg, frozen, {k: part(v, c)
                                          for k, v in batch.items()},
                            part(factors, c))
        if b == chunk:
            grads = g
        else:  # chunks accumulate in float32, as the reference's scan does
            grads = tree_map(lambda a, x: a + x.float(), grads, g) \
                if grads is not None else tree_map(lambda x: x.float(), g)
    return grads, loss_sum / denom, norms
