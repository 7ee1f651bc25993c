"""The decoder stack: init, forward and loss, KV cache and decode.

Counterpart of ``repro.models.transformer`` for decoder-only stacks of any
groups and patterns of ``LayerSpec``s whose mixer is GQA attention
(standard RoPE, M-RoPE or none), Mamba-1 or RWKV6 (``models.ssm``) and
whose FFN is dense or a Mixture-of-Experts (``models.moe``), with RMSNorm
or OLMo's non-parametric LayerNorm.  MLA, MTP, cross attention,
encoder-decoder models and the parametric ``layernorm`` raise
(ROADMAP.md).

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
only), ``head`` [D,V] when embeddings are untied, and the layers.  A
stack of one group of one ``LayerSpec`` (``is_flat``) keeps them in
``layers``, a dict of tensors each with a leading layers axis:
``norm1``/``norm2`` (RMSNorm only), the mixer's — ``wq`` [n_layers, D,
H*hd], ``wk``, ``wv``, ``wo`` for attention, ``ssm.mamba_init``'s or
``ssm.rwkv6_init``'s leaves —, then the FFN's ``w_gate``/``w_up``/
``w_down``, for MoE layers the experts' [n_layers, E, ...] and the
float32 ``w_router`` [n_layers, D, E].  Other stacks nest them as the
reference does: ``group{gi}`` / ``e{j}`` (the pattern's j-th spec) / the
same names, with a leading axis of the group's repeat.  The forward is a
Python loop over the layers in order.

The cache of a flat stack is its one mixer's state with a leading layers
axis: ``{"k", "v"}`` of shape [n_layers, B, L, KV, hd] for attention, the
Mamba-1 or RWKV6 state leaves for a recurrent mixer.  Any other stack's is
the reference's tree (``cache_tree``), ``group{gi}`` / ``e{j}`` / ``attn``
({"k", "v"}) or ``ssm`` (the mixer's state), each leaf with a leading
repeat axis.  Every leaf has the batch at axis 1.  Decoding updates it in
place.

A batch of a VLM (``arch_type="vlm"``) may carry ``vision_embeds``
[B, S_v, D], the stubbed vision tower's patch embeddings, which prefix
the text; ``mrope_positions`` [B, S, 3] is taken from the batch or
broadcast from the positions, and the loss covers the text only.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import (
    gqa_apply,
    gqa_decode,
    gqa_init,
    gqa_init_cache,
)
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
from repro_torch.models.ssm import (
    mamba_apply,
    mamba_decode,
    mamba_init,
    mamba_init_cache,
    rwkv6_apply,
    rwkv6_decode,
    rwkv6_init,
    rwkv6_init_cache,
)
from repro_torch.tree import tree_map

MIXERS = ("attn", "mamba", "rwkv6")


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` is a stack the port can run."""
    cfg.validate()
    specs = [spec for _, pattern in cfg.stack for spec in pattern]
    ok = (all(spec.mixer in MIXERS and spec.ffn in ("dense", "moe")
              and not spec.cross_attn for spec in specs)
          and not cfg.is_encoder_decoder and not cfg.mtp_depth
          and cfg.norm in NORMS
          and cfg.rope_type in ("standard", "mrope", "none"))
    if ok and any(spec.ffn == "moe" for spec in specs):
        ok = cfg.n_experts > 0 and 0 < cfg.moe_top_k <= cfg.n_experts
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs decoder stacks of GQA attention, "
            "Mamba-1 and RWKV6 mixers with dense or MoE FFNs, RMSNorm or "
            "non-parametric LayerNorm and standard RoPE, M-RoPE or none; "
            "MLA, MTP, cross attention, encoder-decoder models and "
            "parametric LayerNorm are still to port (ROADMAP.md)"
        )


def is_flat(cfg) -> bool:
    """Whether the stack is one group of one ``LayerSpec``, whose layers
    are kept flat: the parameters in ``params["layers"]``, the cache as
    that spec's mixer state with a leading layers axis."""
    return len(cfg.stack) == 1 and len(cfg.stack[0][1]) == 1


_MIXER_INIT = {"attn": gqa_init, "mamba": mamba_init, "rwkv6": rwkv6_init}


def _layer_init(cfg, spec, g: torch.Generator, out: dict | None = None
                ) -> dict:
    """One layer's parameters, drawn in a fixed order; ``out`` (name ->
    tensor) receives the draws in place (the norms are returned new)."""
    p = {}
    norm = make_norm(cfg.norm, cfg.d_model, cfg.pdtype, g.device)
    if norm is not None:
        p["norm1"] = norm
    p.update(_MIXER_INIT[spec.mixer](cfg, cfg.pdtype, g, out))
    if norm is not None:
        p["norm2"] = norm.clone()
    if spec.ffn == "moe":
        p.update(moe_init(cfg, cfg.pdtype, g, out))
    else:
        p.update(ffn_init(cfg.d_model, cfg.d_ff, cfg.ffn_kind, cfg.pdtype, g,
                          out))
    return p


def _group_init(cfg, repeat: int, pattern, g: torch.Generator
                ) -> list[dict]:
    """One group's stacked parameters, a dict per spec of the pattern, in
    the network's layer order.  Each stack is allocated once, after its
    first layer gives the shapes, and each of that layer's leaves is freed
    as soon as its row 0 holds it; every later layer is drawn leaf by leaf
    straight into its row."""
    stacks = []
    for spec in pattern:
        first = _layer_init(cfg, spec, g)
        stack = {}
        for name in list(first):
            t = first.pop(name)
            stack[name] = torch.empty((repeat, *t.shape), dtype=t.dtype,
                                      device=t.device)
            stack[name][0].copy_(t)
            del t
        stacks.append(stack)
    for r in range(1, repeat):
        for spec, stack in zip(pattern, stacks):
            rows = {name: t[r] for name, t in stack.items()}
            for name, t in _layer_init(cfg, spec, g, rows).items():
                if t is not rows[name]:     # the norms
                    rows[name].copy_(t)
    return stacks


def init(cfg, seed: int, device) -> dict:
    """Seeded random parameters on ``device`` (a ``torch.Generator`` there).

    Each leaf is drawn in float32 and cast.  The layers' stacks are
    allocated once and every later layer is drawn straight into its row
    (``_group_init``), so the peak is the model plus one layer's float32
    leaf: a list of layers stacked at the end would hold the model twice.
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
    for gi, (repeat, pattern) in enumerate(cfg.stack):
        stacks = _group_init(cfg, repeat, pattern, g)
        if is_flat(cfg):
            params["layers"] = stacks[0]
        else:
            params[f"group{gi}"] = {f"e{j}": st for j, st in enumerate(stacks)}
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


def layers_of(cfg, params: dict) -> list[tuple]:
    """Every layer in the network's order, as (its ``LayerSpec``, its
    parameter dict), from either layout."""
    out = []
    for gi, (repeat, pattern) in enumerate(cfg.stack):
        stacks = ([params["layers"]] if is_flat(cfg) else
                  [params[f"group{gi}"][f"e{j}"] for j in range(len(pattern))])
        rows = [layer_params(st) for st in stacks]
        for r in range(repeat):
            out.extend((spec, rows[j][r]) for j, spec in enumerate(pattern))
    return out


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


def _ffn(cfg, spec, p: dict, h: torch.Tensor, moe_groups: int | None = None,
         with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    if spec.ffn == "moe":
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
    for spec, p in layers_of(cfg, params):
        h = apply_norm(cfg.norm, p.get("norm1"), x)
        if spec.mixer == "attn":
            h = gqa_apply(p, h, positions, cfg, window=cfg.sliding_window,
                          mrope_positions=mrope_positions)
        elif spec.mixer == "mamba":
            h = mamba_apply(p, h, cfg)
        else:
            h = rwkv6_apply(p, h, cfg)
        x = x + h
        h = apply_norm(cfg.norm, p.get("norm2"), x)
        h, a = _ffn(cfg, spec, p, h)
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


def _state_key(spec) -> str:
    """The key of a layer's cache in the reference's tree."""
    return "attn" if spec.mixer == "attn" else "ssm"


def _layer_cache(cfg, spec, batch: int, max_len: int, device) -> dict:
    if spec.mixer == "attn":
        state = gqa_init_cache(cfg, batch, max_len, cfg.cdtype, device)
    else:
        init_state = mamba_init_cache if spec.mixer == "mamba" else \
            rwkv6_init_cache
        state = init_state(cfg, batch, cfg.cdtype, device)
    return {_state_key(spec): state}


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zeros in the cache's layout (module docstring): K and V in the
    compute dtype, the recurrent states in float32."""
    check_supported(cfg)
    tree = {
        f"group{gi}": {
            f"e{j}": tree_map(
                lambda t: t.new_zeros((repeat, *t.shape)),
                _layer_cache(cfg, spec, batch, max_len, device))
            for j, spec in enumerate(pattern)}
        for gi, (repeat, pattern) in enumerate(cfg.stack)}
    if is_flat(cfg):
        return tree["group0"]["e0"][_state_key(cfg.stack[0][1][0])]
    return tree


def cache_tree(cfg, cache: dict) -> dict:
    """The cache in the reference's nested layout, ``group{gi}`` /
    ``e{j}`` / ``attn`` or ``ssm``, its tensors shared (a flat cache is
    wrapped, a nested one returned as it is)."""
    if is_flat(cfg):
        return {"group0": {"e0": {_state_key(cfg.stack[0][1][0]): cache}}}
    return cache


def layer_caches(cfg, cache: dict) -> list[dict]:
    """Each layer's cache, in the network's order, as views of ``cache``
    (``{"attn": {"k", "v"}}`` or ``{"ssm": ...}``)."""
    tree = cache_tree(cfg, cache)
    return [tree_map(lambda t, r=r: t[r], tree[f"group{gi}"][f"e{j}"])
            for gi, (repeat, pattern) in enumerate(cfg.stack)
            for r in range(repeat) for j in range(len(pattern))]


def _decode(cfg, params: dict, cache: dict, tokens: torch.Tensor,
            positions: torch.Tensor, moe_groups: int
            ) -> tuple[torch.Tensor, dict]:
    emb = params["embed"]
    x = emb[tokens].to(cfg.cdtype)
    for (spec, p), c in zip(layers_of(cfg, params), layer_caches(cfg, cache)):
        h = apply_norm(cfg.norm, p.get("norm1"), x)
        if spec.mixer == "attn":
            h, _ = gqa_decode(p, h, c["attn"], positions, cfg,
                              window=cfg.sliding_window)
        elif spec.mixer == "mamba":
            h, _ = mamba_decode(p, h, c["ssm"], cfg)
        else:
            h, _ = rwkv6_decode(p, h, c["ssm"], cfg)
        x = x + h
        h = apply_norm(cfg.norm, p.get("norm2"), x)
        x = x + _ffn(cfg, spec, p, h, moe_groups, with_aux=False)[0]
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
    kernel with the prompt's batch, and a recurrent mixer's state advances
    token by token over exactly S positions (right-padding the prompt would
    run the state over the pad).  Neither package has a batched
    full-sequence prefill.
    """
    b, s = tokens.shape
    logits = torch.zeros((b, 1, cfg.vocab_size), dtype=cfg.cdtype,
                         device=tokens.device)
    for t in range(s):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
    return logits, cache
