"""The decoder stack: init, forward and loss, KV cache and decode.

Counterpart of ``repro.models.transformer`` for stacks of one group whose
pattern is one ``LayerSpec("attn", "dense" | "moe")``: GQA attention with
standard RoPE, M-RoPE or none, a dense FFN or a Mixture-of-Experts
(``models.moe``), and RMSNorm or OLMo's non-parametric LayerNorm.  Any
other mixer, cross attention, encoder-decoder models, multi-group stacks
and the parametric ``layernorm`` raise (ROADMAP.md).

  init(cfg, seed, device)                      -> params
  forward(cfg, params, batch)                  -> (logits [B,S,V], aux)
  loss_fn(cfg, params, batch)                  -> scalar (token-mean CE
                                                  + router_aux_coef * aux)
  per_example_loss_fn(cfg, params, example)    -> scalar (one example, DP)
  init_cache(cfg, batch, max_len, device)      -> cache
  decode_step(cfg, params, cache, tokens, index)           -> (logits, cache)
  decode_step_positions(cfg, params, cache, tokens, positions)
                                               -> (logits, cache)  [per-row]
  prefill(cfg, params, cache, tokens)          -> (last_logits, cache)

Parameters are a plain dict: ``embed`` [V,D], ``final_norm`` [D] (RMSNorm
only), ``head`` [D,V] when embeddings are untied, and ``layers``, a dict
of tensors each with a leading layers axis: ``norm1``/``norm2`` (RMSNorm
only), ``wq`` [n_layers, D, H*hd], ``wk``, ``wv``, ``wo``, then the FFN's
``w_gate``/``w_up``/``w_down`` — for MoE layers the experts' [n_layers,
E, ...] and the float32 ``w_router`` [n_layers, D, E].  The forward is a
Python loop over that axis.  The cache is ``{"k", "v"}`` of shape
[n_layers, B, L, KV, hd] and is updated in place.

A batch of a VLM (``arch_type="vlm"``) may carry ``vision_embeds``
[B, S_v, D], the stubbed vision tower's patch embeddings, which prefix
the text; ``mrope_positions`` [B, S, 3] is taken from the batch or
broadcast from the positions, and the loss covers the text only.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import gqa_apply, gqa_decode, gqa_init
from repro_torch.models.layers import (
    NORMS,
    apply_norm,
    ffn_apply,
    ffn_init,
    make_norm,
    matmul,
    trunc_normal,
)
from repro_torch.models.moe import moe_apply, moe_init


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` is a stack the port can run."""
    cfg.validate()
    specs = [spec for _, pattern in cfg.stack for spec in pattern]
    ok = (len(cfg.stack) == 1 and len(specs) == 1
          and specs[0].mixer == "attn" and specs[0].ffn in ("dense", "moe")
          and not specs[0].cross_attn and not cfg.is_encoder_decoder
          and not cfg.mtp_depth and cfg.norm in NORMS
          and cfg.rope_type in ("standard", "mrope", "none"))
    if ok and specs[0].ffn == "moe":
        ok = cfg.n_experts > 0 and 0 < cfg.moe_top_k <= cfg.n_experts
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs stacks of one attention layer "
            "kind (dense FFN or MoE) with RMSNorm or non-parametric "
            "LayerNorm and standard RoPE, M-RoPE or none; other mixers (MLA, "
            "Mamba, RWKV6), cross attention, encoder-decoder models, "
            "multi-group stacks, MTP and parametric LayerNorm are still to "
            "port (ROADMAP.md)"
        )


def is_moe(cfg) -> bool:
    return cfg.stack[0][1][0].ffn == "moe"


def _layer_init(cfg, g: torch.Generator, out: dict | None = None) -> dict:
    """One layer's parameters, drawn in a fixed order; ``out`` (name ->
    tensor) receives the draws in place (the norms are returned new)."""
    p = {}
    norm = make_norm(cfg.norm, cfg.d_model, cfg.pdtype, g.device)
    if norm is not None:
        p["norm1"] = norm
    p.update(gqa_init(cfg, cfg.pdtype, g, out))
    if norm is not None:
        p["norm2"] = norm.clone()
    if is_moe(cfg):
        p.update(moe_init(cfg, cfg.pdtype, g, out))
    else:
        p.update(ffn_init(cfg.d_model, cfg.d_ff, cfg.ffn_kind, cfg.pdtype, g,
                          out))
    return p


def init(cfg, seed: int, device) -> dict:
    """Seeded random parameters on ``device`` (a ``torch.Generator`` there).

    Each leaf is drawn in float32 and cast.  The layers' stacks are
    allocated once, after layer 0 gives their shapes, and every later
    layer is drawn leaf by leaf straight into its row, so the peak is the
    model plus one layer's float32 leaf: a list of layers stacked at the
    end would hold the model twice.  The draws come in the same order
    either way.
    """
    check_supported(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = {"embed": trunc_normal((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                    0.02, g)}
    final_norm = make_norm(cfg.norm, cfg.d_model, cfg.pdtype, device)
    if final_norm is not None:
        params["final_norm"] = final_norm
    if not cfg.tie_embeddings:
        params["head"] = trunc_normal((cfg.d_model, cfg.vocab_size),
                                      cfg.pdtype, 0.02, g)
    first = _layer_init(cfg, g)
    layers = {name: torch.empty((cfg.n_layers, *t.shape), dtype=t.dtype,
                                device=t.device)
              for name, t in first.items()}
    for name, t in first.items():
        layers[name][0].copy_(t)
    del first
    for i in range(1, cfg.n_layers):
        rows = {name: t[i] for name, t in layers.items()}
        for name, t in _layer_init(cfg, g, rows).items():
            if t is not rows[name]:     # the norms
                rows[name].copy_(t)
    params["layers"] = layers
    return params


def layer_params(stacked: dict) -> list[dict]:
    """Per-layer parameter dicts from the stacked ``params["layers"]``.

    ``unbind`` once, not ``t[i]`` per layer: the backward of ``unbind`` is
    one stack of the layer gradients, where 32 selects would each write a
    full-size zero gradient.
    """
    names = list(stacked)
    return [dict(zip(names, vals))
            for vals in zip(*(stacked[n].unbind(0) for n in names))]


def prefix_vision(cfg, x: torch.Tensor, batch: dict) -> torch.Tensor:
    """The VLM stub: ``batch["vision_embeds"]`` [B,S_v,D] before the text
    embeddings x [B,S,D]; x itself for other archs or text-only batches."""
    if cfg.arch_type == "vlm" and "vision_embeds" in batch:
        return torch.cat([batch["vision_embeds"].to(cfg.cdtype), x], dim=1)
    return x


def positions_of(cfg, batch: dict, b: int, s: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The batch's [B,S] positions (0..S-1 per row unless it carries them)
    and, under M-RoPE, its [B,S,3] (t, h, w) ids (the positions on all
    three unless it carries them); None otherwise."""
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)
    mrope_positions = batch.get("mrope_positions")
    if cfg.rope_type == "mrope" and mrope_positions is None:
        mrope_positions = positions[..., None].expand(b, s, 3)
    return positions, mrope_positions


def text_logits(cfg, logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """The logits of the text segment (the labels' length) when vision
    embeddings prefix it."""
    if cfg.arch_type == "vlm" and "vision_embeds" in batch:
        return logits[:, -batch["labels"].shape[1]:]
    return logits


def head_of(cfg, params: dict) -> torch.Tensor:
    """The [D,V] output projection (the embedding's transpose when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _ffn(cfg, p: dict, h: torch.Tensor, moe_groups: int | None = None,
         with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    if is_moe(cfg):
        return moe_apply(p, h, cfg, groups=moe_groups, with_aux=with_aux)
    return ffn_apply(p, h, cfg.ffn_kind), None


def forward(cfg, params: dict, batch: dict) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Full-sequence forward -> (logits [B,S,V], aux_loss).

    ``batch["tokens"]`` is [B,S] integer.  Products promote as the
    reference's do (``layers.matmul``); the aux loss is the MoE layers'
    summed load-balance loss, 0 for dense stacks.
    """
    tokens = batch["tokens"].long()
    x = prefix_vision(cfg, params["embed"][tokens].to(cfg.cdtype), batch)
    b, s, _ = x.shape
    positions, mrope_positions = positions_of(cfg, batch, b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layer_params(params["layers"]):
        h = apply_norm(cfg.norm, p.get("norm1"), x)
        x = x + gqa_apply(p, h, positions, cfg, window=cfg.sliding_window,
                          mrope_positions=mrope_positions)
        h = apply_norm(cfg.norm, p.get("norm2"), x)
        h, a = _ffn(cfg, p, h)
        x = x + h
        if a is not None:
            aux = aux + a
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    logits = matmul(x, head_of(cfg, params).to(cfg.cdtype))
    return logits, aux


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token negative log-likelihood in float32, zero where labels < 0,
    and the float mask of real tokens."""
    mask = (labels >= 0).float()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return (logz - gold) * mask, mask


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy over the whole batch; labels < 0 are masked."""
    nll, mask = _masked_nll(logits, labels)
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def per_example_ce(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """[B] token-mean cross entropy per row; labels < 0 are masked."""
    nll, mask = _masked_nll(logits, labels)
    return torch.sum(nll, dim=-1) / torch.clamp(torch.sum(mask, dim=-1),
                                                min=1.0)


def loss_fn(cfg, params: dict, batch: dict) -> torch.Tensor:
    logits, aux = forward(cfg, params, batch)
    return (_ce(text_logits(cfg, logits, batch), batch["labels"])
            + cfg.router_aux_coef * aux)


def per_example_loss_fn(cfg, params: dict, example: dict) -> torch.Tensor:
    """One-example loss for per-example (DP) gradients."""
    return loss_fn(cfg, params, {k: v[None] for k, v in example.items()})


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def _decode(cfg, params: dict, cache: dict, tokens: torch.Tensor,
            positions: torch.Tensor, moe_groups: int
            ) -> tuple[torch.Tensor, dict]:
    emb = params["embed"]
    x = emb[tokens].to(cfg.cdtype)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        p = {name: t[i] for name, t in stacked.items()}
        h = apply_norm(cfg.norm, p.get("norm1"), x)
        h, _ = gqa_decode(p, h, {"k": cache["k"][i], "v": cache["v"][i]},
                          positions, cfg, window=cfg.sliding_window)
        x = x + h
        h = apply_norm(cfg.norm, p.get("norm2"), x)
        x = x + _ffn(cfg, p, h, moe_groups, with_aux=False)[0]
    x = apply_norm(cfg.norm, params.get("final_norm"), x)
    return matmul(x, head_of(cfg, params).to(cfg.cdtype)), cache


def decode_step_positions(cfg, params: dict, cache: dict,
                          tokens: torch.Tensor, positions: torch.Tensor
                          ) -> tuple[torch.Tensor, dict]:
    """Per-slot decode: row b of ``tokens`` [B,1] is written at cache
    position ``positions[b]`` (int32 [B]) and attends to positions up to
    it — the continuous-batching step (DESIGN.md §9).  The reference vmaps
    a one-row decode step over the rows, so its MoE layers dispatch each
    row on its own; here each row is one MoE group, which gives the same
    capacity.  Products promote as ``forward``'s do.  Returns logits
    [B,1,V] (in the compute dtype unless the parameters are wider) and the
    cache, updated in place."""
    return _decode(cfg, params, cache, tokens, positions,
                   moe_groups=tokens.shape[0])


def decode_step(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                index: int) -> tuple[torch.Tensor, dict]:
    """One-token decode with every row at position ``index``.  As in the
    reference, the MoE layers dispatch the B rows as one group, so a row
    may lose a choice to capacity where the per-row step would not."""
    positions = torch.full((tokens.shape[0],), index, dtype=torch.int32,
                           device=tokens.device)
    return _decode(cfg, params, cache, tokens, positions, moe_groups=1)


def prefill(cfg, params: dict, cache: dict, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, dict]:
    """Prefill a prompt by decode-stepping every position in order.
    ``tokens``: [B,S].  Returns the last position's logits [B,1,V] and the
    cache filled through position S-1.

    The reference's ``prefill`` scans its decode step over the prompt on
    purpose, so the port does the same: each position runs the decode
    kernel with the prompt's batch.  Neither package has a batched
    full-sequence prefill.
    """
    b, s = tokens.shape
    logits = torch.zeros((b, 1, cfg.vocab_size), dtype=cfg.cdtype,
                         device=tokens.device)
    for t in range(s):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
    return logits, cache
