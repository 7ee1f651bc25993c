"""The dense decoder stack: init, forward and loss, KV cache and decode.

Counterpart of ``repro.models.transformer`` for dense attention stacks
(every layer ``LayerSpec("attn", "dense")``, RMSNorm); any other mixer,
MoE, cross attention or encoder-decoder raises.

  init(cfg, seed, device)                      -> params
  forward(cfg, params, batch)                  -> (logits [B,S,V], aux)
  loss_fn(cfg, params, batch)                  -> scalar (token-mean CE)
  per_example_loss_fn(cfg, params, example)    -> scalar (one example, DP)
  init_cache(cfg, batch, max_len, device)      -> cache
  decode_step(cfg, params, cache, tokens, index)           -> (logits, cache)
  decode_step_positions(cfg, params, cache, tokens, positions)
                                               -> (logits, cache)  [per-row]
  prefill(cfg, params, cache, tokens)          -> (last_logits, cache)

Parameters are a plain dict: ``embed`` [V,D], ``final_norm`` [D], ``head``
[D,V] when embeddings are untied, and ``layers``, a dict of tensors each
with a leading layers axis (``wq`` [n_layers, D, H*hd], ...).  The forward
is a Python loop over that axis.  The cache is ``{"k", "v"}`` of shape
[n_layers, B, L, KV, hd] and is updated in place.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import dense_stack
from repro_torch.models.attention import gqa_apply, gqa_decode, gqa_init
from repro_torch.models.layers import (
    ffn_apply,
    ffn_init,
    matmul,
    rmsnorm,
    trunc_normal,
)


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` is a stack the port can run."""
    cfg.validate()
    if (cfg.stack != dense_stack(cfg.n_layers) or cfg.is_encoder_decoder
            or cfg.norm != "rmsnorm" or cfg.rope_type not in ("standard",
                                                              "none")):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs dense attention stacks with "
            "RMSNorm and standard RoPE only; other mixers, MoE, M-RoPE and "
            "encoder-decoder models are still to port (ROADMAP.md)"
        )


def _layer_init(cfg, g: torch.Generator) -> dict:
    ones = torch.ones(cfg.d_model, dtype=cfg.pdtype, device=g.device)
    return {
        "norm1": ones,
        **gqa_init(cfg, cfg.pdtype, g),
        "norm2": ones.clone(),
        **ffn_init(cfg.d_model, cfg.d_ff, cfg.ffn_kind, cfg.pdtype, g),
    }


def init(cfg, seed: int, device) -> dict:
    """Seeded random parameters on ``device`` (a ``torch.Generator`` there)."""
    check_supported(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = {
        "embed": trunc_normal((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                              0.02, g),
        "final_norm": torch.ones(cfg.d_model, dtype=cfg.pdtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = trunc_normal((cfg.d_model, cfg.vocab_size),
                                      cfg.pdtype, 0.02, g)
    layers = [_layer_init(cfg, g) for _ in range(cfg.n_layers)]
    params["layers"] = {k: torch.stack([lp[k] for lp in layers])
                        for k in layers[0]}
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


def positions_of(batch: dict, b: int, s: int, device) -> torch.Tensor:
    """The batch's [B,S] positions, 0..S-1 per row unless it carries them."""
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=device)[None].expand(b, s)
    return positions


def head_of(cfg, params: dict) -> torch.Tensor:
    """The [D,V] output projection (the embedding's transpose when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def forward(cfg, params: dict, batch: dict) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Full-sequence forward -> (logits [B,S,V], aux_loss).

    ``batch["tokens"]`` is [B,S] integer.  Products promote as the
    reference's do (``layers.matmul``); the aux loss is 0 for dense stacks.
    """
    tokens = batch["tokens"].long()
    x = params["embed"][tokens].to(cfg.cdtype)
    b, s, _ = x.shape
    positions = positions_of(batch, b, s, x.device)
    for p in layer_params(params["layers"]):
        h = rmsnorm(x, p["norm1"])
        x = x + gqa_apply(p, h, positions, cfg, window=cfg.sliding_window)
        h = rmsnorm(x, p["norm2"])
        x = x + ffn_apply(p, h, cfg.ffn_kind)
    x = rmsnorm(x, params["final_norm"])
    logits = matmul(x, head_of(cfg, params).to(cfg.cdtype))
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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
    logits, _ = forward(cfg, params, batch)
    return _ce(logits, batch["labels"])


def per_example_loss_fn(cfg, params: dict, example: dict) -> torch.Tensor:
    """One-example loss for per-example (DP) gradients."""
    return loss_fn(cfg, params, {k: v[None] for k, v in example.items()})


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def decode_step_positions(cfg, params: dict, cache: dict,
                          tokens: torch.Tensor, positions: torch.Tensor
                          ) -> tuple[torch.Tensor, dict]:
    """Per-slot decode: row b of ``tokens`` [B,1] is written at cache
    position ``positions[b]`` (int32 [B]) and attends to positions up to
    it — the continuous-batching step (DESIGN.md §9).  Products promote as
    ``forward``'s do.  Returns logits [B,1,V] (in the compute dtype unless
    the parameters are wider) and the cache, updated in place."""
    emb = params["embed"]
    x = emb[tokens].to(cfg.cdtype)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        p = {name: t[i] for name, t in stacked.items()}
        h = rmsnorm(x, p["norm1"])
        h, _ = gqa_decode(p, h, {"k": cache["k"][i], "v": cache["v"][i]},
                          positions, cfg, window=cfg.sliding_window)
        x = x + h
        h = rmsnorm(x, p["norm2"])
        x = x + ffn_apply(p, h, cfg.ffn_kind)
    x = rmsnorm(x, params["final_norm"])
    return matmul(x, head_of(cfg, params).to(cfg.cdtype)), cache


def decode_step(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                index: int) -> tuple[torch.Tensor, dict]:
    """One-token decode with every row at position ``index``."""
    positions = torch.full((tokens.shape[0],), index, dtype=torch.int32,
                           device=tokens.device)
    return decode_step_positions(cfg, params, cache, tokens, positions)


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
