"""The transformer stack: init, forward and loss, KV cache and decode.

Counterpart of ``repro.models.transformer`` for every architecture of the
reference's zoo: stacks of any groups and patterns of ``LayerSpec``s whose
mixer is GQA attention (standard RoPE, M-RoPE or none), DeepSeek's MLA,
Mamba-1 or RWKV6 (``models.ssm``) and whose FFN is dense or a
Mixture-of-Experts (``models.moe``), with RMSNorm, LayerNorm (scale and
bias) or OLMo's non-parametric LayerNorm; DeepSeek-V3's multi-token
prediction (``mtp_depth``); and Whisper's encoder-decoder (an encoder over
stub frame embeddings, cross attention in every decoder layer).

  init(cfg, seed, device)                      -> params
  param_specs(cfg)                             -> params on the meta device
  forward(cfg, params, batch)                  -> (logits [B,S,V], aux)
  loss_fn(cfg, params, batch)                  -> scalar (token-mean CE
                                                  + router_aux_coef * aux
                                                  + mtp_loss_weight * MTP)
  per_example_loss_fn(cfg, params, example)    -> scalar (one example, DP)
  init_cache(cfg, batch, max_len, device)      -> cache
  decode_step(cfg, params, cache, tokens, index)           -> (logits, cache)
  decode_step_positions(cfg, params, cache, tokens, positions)
                                               -> (logits, cache)  [per-row]
  prefill(cfg, params, cache, tokens)          -> (last_logits, cache)

Parameters are a plain dict: ``embed`` [V,D], ``final_norm`` [D] (none
under ``ln_nonparam``), ``head`` [D,V] when embeddings are untied, and the
layers.  A norm's scale is kept under its name and, under ``layernorm``,
its bias under the name + ``_bias`` (``final_norm_bias``, ``norm1_bias``).
A stack of one group of one ``LayerSpec`` without cross attention
(``is_flat``) keeps its layers in ``layers``, a dict of tensors each with
a leading layers axis: ``norm1``/``norm2``, the mixer's — ``wq`` [n_layers,
D, H*hd], ``wk``, ``wv``, ``wo`` for attention, ``attention.mla_init``'s,
``ssm.mamba_init``'s or ``ssm.rwkv6_init``'s leaves —, then the FFN's
``w_gate``/``w_up``/``w_down``, for MoE layers the experts' [n_layers, E,
...] and the float32 ``w_router`` [n_layers, D, E].  Other stacks nest them
as the reference does: ``group{gi}`` / ``e{j}`` (the pattern's j-th spec) /
the same names, with a leading axis of the group's repeat.  Whisper's one
spec carries cross attention and so two caches a layer (``attn`` and
``cross``): it nests as well, as in the reference, and its layers add
``cross_wq``/``cross_wk``/``cross_wv``/``cross_wo`` and ``norm_cross``.  An
encoder-decoder also has ``encoder`` (``{"e0": ...}``, a dense attention
layer's names with a leading axis of ``encoder_layers``) and
``enc_final_norm``; with ``mtp_depth`` the params hold ``mtp``: ``proj``
[2D, D], ``norm_h``, ``norm_e`` and ``block``, a layer of the stack's last
spec with a leading axis of 1.  The forward is a Python loop over the
layers in order.

The cache of a flat stack is its one mixer's state with a leading layers
axis: ``{"k", "v"}`` of shape [n_layers, B, L, KV, hd] for attention, the
Mamba-1 or RWKV6 state leaves for a recurrent mixer.  Any other stack's is
the reference's tree (``cache_tree``), ``group{gi}`` / ``e{j}`` / ``attn``
({"k", "v"}, or MLA's compressed {"c", "kr"}) or ``ssm`` (the mixer's
state), and ``cross`` ({"k", "v"} of [B, n_audio_ctx, KV, hd], zeros
until the caller writes ``attention.cross_kv_cache`` of ``_encode``'s
output into it), each leaf with a leading repeat axis.  Every leaf has the
batch at axis 1.  Decoding updates it in place.

A batch of a VLM (``arch_type="vlm"``) may carry ``vision_embeds``
[B, S_v, D], the stubbed vision tower's patch embeddings, which prefix
the text; ``mrope_positions`` [B, S, 3] is taken from the batch or
broadcast from the positions, and the loss covers the text only.  A batch
of an encoder-decoder carries ``frames`` [B, n_audio_ctx, D], the stubbed
conv frontend's frame embeddings.  Whisper's decoder adds no positions to
its token embeddings (``rope_type="none"``, as the reference's code, not
its config's docstring, has it).
"""

from __future__ import annotations

import torch

import repro_torch.obs as obs
from repro_torch.configs.base import LayerSpec
from repro_torch.models.attention import (
    cross_apply,
    cross_decode,
    cross_init,
    gqa_apply,
    gqa_decode,
    gqa_init,
    gqa_init_cache,
    mla_apply,
    mla_decode,
    mla_init,
    mla_init_cache,
)
from repro_torch.models.layers import (
    NORMS,
    apply_norm,
    dense_init,
    ffn_apply,
    ffn_init,
    init_device,
    make_norm,
    make_norm_bias,
    matmul,
    shard,
    sinusoidal_positions,
    trunc_normal,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.placement import (
    add_residual,
    as_param,
    placements_of,
    summed,
    take_rows,
)
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

MIXERS = ("attn", "mla", "mamba", "rwkv6")
# the encoder's one layer kind
ENCODER_SPEC = LayerSpec("attn", "dense")


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` is a stack the port can run."""
    cfg.validate()
    specs = [spec for _, pattern in cfg.stack for spec in pattern]
    ok = (all(spec.mixer in MIXERS and spec.ffn in ("dense", "moe")
              for spec in specs)
          and cfg.norm in NORMS
          and cfg.rope_type in ("standard", "mrope", "none"))
    if ok and any(spec.ffn == "moe" for spec in specs):
        ok = cfg.n_experts > 0 and 0 < cfg.moe_top_k <= cfg.n_experts
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs stacks of GQA attention, MLA, "
            "Mamba-1 and RWKV6 mixers with dense or MoE FFNs, RMSNorm, "
            "LayerNorm or non-parametric LayerNorm and standard RoPE, "
            "M-RoPE or none"
        )


def is_flat(cfg) -> bool:
    """Whether the stack is one group of one ``LayerSpec`` without cross
    attention, whose layers are kept flat: the parameters in
    ``params["layers"]``, the cache as that spec's mixer state with a
    leading layers axis.  (A cross-attention layer holds two caches, so
    Whisper nests as the reference does.)"""
    return (len(cfg.stack) == 1 and len(cfg.stack[0][1]) == 1
            and not cfg.stack[0][1][0].cross_attn)


_MIXER_INIT = {"attn": gqa_init, "mla": mla_init, "mamba": mamba_init,
               "rwkv6": rwkv6_init}


def _norm_init(cfg, name: str, device) -> dict:
    """A norm's parameters under ``name``: the scale, and under
    ``layernorm`` the bias as ``name + "_bias"``; none for
    ``ln_nonparam``."""
    p = {}
    scale = make_norm(cfg.norm, cfg.d_model, cfg.pdtype, device)
    if scale is not None:
        p[name] = scale
    bias = make_norm_bias(cfg.norm, cfg.d_model, cfg.pdtype, device)
    if bias is not None:
        p[f"{name}_bias"] = bias
    return p


def _norm(cfg, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """The configured norm of x with ``p``'s parameters under ``name``."""
    return apply_norm(cfg.norm, p.get(name), x, p.get(f"{name}_bias"))


def _layer_init(cfg, spec, g: torch.Generator | None,
                out: dict | None = None) -> dict:
    """One layer's parameters, drawn in a fixed order; ``out`` (name ->
    tensor) receives the draws in place (the norms and the constant
    leaves are returned new)."""
    p = _norm_init(cfg, "norm1", init_device(g))
    p.update(_MIXER_INIT[spec.mixer](cfg, cfg.pdtype, g, out))
    p.update(_norm_init(cfg, "norm2", init_device(g)))
    if spec.ffn == "moe":
        p.update(moe_init(cfg, cfg.pdtype, g, out))
    else:
        p.update(ffn_init(cfg.d_model, cfg.d_ff, cfg.ffn_kind, cfg.pdtype, g,
                          out))
    if spec.cross_attn:
        p.update(cross_init(cfg, cfg.pdtype, g, out))
        p.update(_norm_init(cfg, "norm_cross", init_device(g)))
    return p


def _group_init(cfg, repeat: int, pattern, g: torch.Generator | None
                ) -> list[dict]:
    """One group's stacked parameters, a dict per spec of the pattern, in
    the network's layer order.  Each stack is allocated once, after its
    first layer gives the shapes, and each of that layer's leaves is freed
    as soon as its row 0 holds it (a group of one layer keeps the drawn
    leaves, viewed with the leading axis); every later layer is drawn leaf
    by leaf straight into its row."""
    stacks = []
    for spec in pattern:
        first = _layer_init(cfg, spec, g)
        stack = {}
        for name in list(first):
            t = first.pop(name)
            if repeat == 1:
                stack[name] = t[None]
                continue
            stack[name] = torch.empty((repeat, *t.shape), dtype=t.dtype,
                                      device=t.device)
            stack[name][0].copy_(t)
            del t
        stacks.append(stack)
    for r in range(1, repeat):
        for spec, stack in zip(pattern, stacks):
            rows = {name: t[r] for name, t in stack.items()}
            for name, t in _layer_init(cfg, spec, g, rows).items():
                if t is not rows[name]:     # the norms, the constants
                    rows[name].copy_(t)
    return stacks


def init(cfg, seed: int, device) -> dict:
    """Seeded random parameters on ``device`` (a ``torch.Generator`` there).

    Each leaf is drawn in float32 and cast.  The layers' stacks are
    allocated once and every later layer is drawn straight into its row
    (``_group_init``), so the peak is the model plus one layer's float32
    leaf: a list of layers stacked at the end would hold the model twice.
    """
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return _init(cfg, g)


def param_specs(cfg) -> dict:
    """``init``'s tree on the meta device, the counterpart of the
    reference's ``jax.eval_shape(init)``: the same code with no generator
    (``layers.init_device``), so every leaf has ``init``'s shape and dtype
    and nothing is drawn or allocated, at any width."""
    return _init(cfg, None)


def _init(cfg, g: torch.Generator | None) -> dict:
    check_supported(cfg)
    device = init_device(g)
    params = {"embed": trunc_normal((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                    0.02, g)}
    params.update(_norm_init(cfg, "final_norm", device))
    if not cfg.tie_embeddings:
        params["head"] = trunc_normal((cfg.d_model, cfg.vocab_size),
                                      cfg.pdtype, 0.02, g)
    for gi, (repeat, pattern) in enumerate(cfg.stack):
        stacks = _group_init(cfg, repeat, pattern, g)
        if is_flat(cfg):
            params["layers"] = stacks[0]
        else:
            params[f"group{gi}"] = {f"e{j}": st for j, st in enumerate(stacks)}
    if cfg.mtp_depth:
        d = cfg.d_model
        # the MTP block mirrors the stack's last spec
        block = _layer_init(cfg, cfg.stack[-1][1][0], g)
        params["mtp"] = {
            "proj": dense_init(2 * d, (2 * d, d), cfg.pdtype, g),
            **_norm_init(cfg, "norm_h", device),
            **_norm_init(cfg, "norm_e", device),
            "block": {name: t[None] for name, t in block.items()},
        }
    if cfg.is_encoder_decoder:
        params["encoder"] = {"e0": _group_init(
            cfg, cfg.encoder_layers, (ENCODER_SPEC,), g)[0]}
        params.update(_norm_init(cfg, "enc_final_norm", device))
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
        return torch.cat([batch["vision_embeds"].to(cfg.cdtype), summed(x)],
                         dim=1)
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


def embed_of(cfg, params: dict) -> torch.Tensor:
    """The [V,D] embedding table.  Tied to the head it has two uses, whose
    gradients each come back in the table's own placements on DTensors
    under ``torch.func`` (``placement.as_param``)."""
    return as_param(params["embed"]) if cfg.tie_embeddings \
        else params["embed"]


def head_of(cfg, params: dict) -> torch.Tensor:
    """The [D,V] output projection (the embedding's transpose when tied)."""
    return embed_of(cfg, params).T if cfg.tie_embeddings else params["head"]


def _ffn(cfg, spec, p: dict, h: torch.Tensor, moe_groups: int | None = None,
         with_aux: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    if spec.ffn == "moe":
        return moe_apply(p, h, cfg, groups=moe_groups, with_aux=with_aux)
    return ffn_apply(p, h, cfg.ffn_kind), None


def _layer_apply(cfg, spec, p: dict, x: torch.Tensor, positions,
                 mrope_positions, enc_out: torch.Tensor | None,
                 with_aux: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One full-sequence layer: the mixer, cross attention over
    ``enc_out`` where the spec has it, the FFN; returns x and the MoE
    aux loss (None for a dense FFN or without ``with_aux``)."""
    with obs.span("model.mixer", cat="model", mixer=spec.mixer):
        h = _norm(cfg, p, "norm1", x)
        if spec.mixer == "attn":
            h = gqa_apply(p, h, positions, cfg, window=cfg.sliding_window,
                          mrope_positions=mrope_positions)
        elif spec.mixer == "mla":
            h = mla_apply(p, h, positions, cfg, window=cfg.sliding_window)
        elif spec.mixer == "mamba":
            h = mamba_apply(p, h, cfg)
        else:
            h = rwkv6_apply(p, h, cfg)
        x = x + h
    if spec.cross_attn and enc_out is not None:
        x = x + cross_apply(p, _norm(cfg, p, "norm_cross", x), enc_out, cfg)
    with obs.span("model.ffn", cat="model", ffn=spec.ffn):
        h, aux = _ffn(cfg, spec, p, _norm(cfg, p, "norm2", x),
                      with_aux=with_aux)
        return add_residual(x, h), aux


def _encode(cfg, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings [B,T,D]: sinusoidal
    positions added, non-causal attention (``_sdpa_blocked`` under
    ``use_flash``, on any device: the flash kernel is causal only) and a
    dense FFN a layer, then ``enc_final_norm``.  -> [B,T,D]."""
    b, t, _ = frames.shape
    x = (frames.to(cfg.cdtype)
         + sinusoidal_positions(t, cfg.d_model, frames.device).to(cfg.cdtype))
    positions = torch.arange(t, device=frames.device)[None].expand(b, t)
    for p in layer_params(params["encoder"]["e0"]):
        x = x + gqa_apply(p, _norm(cfg, p, "norm1", x), positions, cfg,
                          causal=False)
        x = x + ffn_apply(p, _norm(cfg, p, "norm2", x), cfg.ffn_kind)
    return _norm(cfg, params, "enc_final_norm", x)


def _hidden(cfg, params: dict, batch: dict) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The normed hidden states before the head [B,S,D] and the aux
    loss."""
    enc_out = (_encode(cfg, params, batch["frames"])
               if cfg.is_encoder_decoder else None)
    with obs.span("model.embed", cat="model"):
        tokens = batch["tokens"].long()
        x = take_rows(embed_of(cfg, params), tokens).to(cfg.cdtype)
        x = prefix_vision(cfg, x, batch)
        x = shard(x, "batch", "seq", None)
    b, s, _ = x.shape
    positions, mrope_positions = positions_of(cfg, batch, b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (spec, p) in enumerate(layers_of(cfg, params)):
        with obs.span("model.block", cat="model", layer=layer):
            x, a = _layer_apply(cfg, spec, p, x, positions, mrope_positions,
                                enc_out)
            x = shard(x, "batch", "seq", None)
        if a is not None:
            aux = aux + a
    return _norm(cfg, params, "final_norm", x), aux


def forward(cfg, params: dict, batch: dict) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Full-sequence forward -> (logits [B,S,V], aux_loss).

    ``batch["tokens"]`` is [B,S] integer (and ``batch["frames"]`` [B,T,D]
    for an encoder-decoder).  Products promote as the reference's do
    (``layers.matmul``); the aux loss is the MoE layers' summed
    load-balance loss, 0 for dense stacks.
    """
    x, aux = _hidden(cfg, params, batch)
    logits = matmul(x, head_of(cfg, params).to(cfg.cdtype))
    return shard(logits, "batch", "seq", "vocab"), aux


def _masked_nll(logits: torch.Tensor, labels: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token negative log-likelihood in float32, zero where labels < 0,
    and the float mask of real tokens."""
    mask = (labels >= 0).float()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    # subtracted before the gathered axis is dropped: a vocab-sharded
    # DTensor's gather is a pending masked sum that DTensor can only
    # reduce in the gathered shape (the same numbers on a plain tensor)
    idx = labels.clamp(min=0).long()[..., None]
    if placements_of(lf) is not None and not hasattr(lf, "placements"):
        # a DTensor under torch.func: torch 2.11's masked gather of a
        # vocab shard fails under vmap (its mask buffer); the label's
        # logit summed with zeros is the same number
        hot = idx == torch.arange(lf.shape[-1], device=lf.device)
        gold = torch.sum(torch.where(hot, lf, 0.0), dim=-1, keepdim=True)
    else:
        gold = torch.gather(lf, -1, idx)
    return (logz[..., None] - gold)[..., 0] * mask, mask


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
    with obs.span("model.loss_fn", cat="model", device_time=True):
        x, aux = _hidden(cfg, params, batch)
        with obs.span("model.head", cat="model", device_time=True):
            logits = matmul(x, head_of(cfg, params).to(cfg.cdtype))
        with obs.span("model.loss", cat="model", device_time=True):
            loss = (_ce(text_logits(cfg, logits, batch), batch["labels"])
                    + cfg.router_aux_coef * aux)
        if cfg.mtp_depth:
            loss = loss + cfg.mtp_loss_weight * _mtp_loss(cfg, params, batch,
                                                          x)
        return loss


def _mtp_loss(cfg, params: dict, batch: dict, hidden: torch.Tensor
              ) -> torch.Tensor:
    """DeepSeek-V3's depth-1 multi-token prediction: one more block of the
    stack's last spec predicts token t+2 from [h_t ; emb(tok_{t+1})], with
    the embedding, final norm and head shared.  ``hidden`` is the
    backbone's normed output (the reference runs the backbone again for
    it; the values are the same).  The block's router aux is dropped, as
    the reference drops it."""
    emb = params["embed"]
    tokens = batch["tokens"].long()
    b, s = tokens.shape
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    e_next = take_rows(emb, nxt).to(cfg.cdtype)
    mtp = params["mtp"]
    h = matmul(torch.cat([_norm(cfg, mtp, "norm_h", hidden),
                          _norm(cfg, mtp, "norm_e", e_next)], dim=-1),
               mtp["proj"])
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    block = {name: t[0] for name, t in mtp["block"].items()}
    h, _ = _layer_apply(cfg, cfg.stack[-1][1][0], block, h, positions, None,
                        None, with_aux=False)
    h = _norm(cfg, params, "final_norm", h)
    logits2 = matmul(h, head_of(cfg, params).to(cfg.cdtype))
    labels = batch["labels"]
    # position t predicts labels_{t+1} (token t+2); the tail is masked
    labels2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, -1:], -1)],
                        dim=1)
    return _ce(logits2, labels2)


def per_example_loss_fn(cfg, params: dict, example: dict) -> torch.Tensor:
    """One-example loss for per-example (DP) gradients."""
    return loss_fn(cfg, params, {k: v[None] for k, v in example.items()})


def _state_key(spec) -> str:
    """The key of a layer's mixer state in the reference's tree."""
    return "attn" if spec.mixer in ("attn", "mla") else "ssm"


def _layer_cache(cfg, spec, batch: int, max_len: int, device) -> dict:
    if spec.mixer == "attn":
        state = gqa_init_cache(cfg, batch, max_len, cfg.cdtype, device)
    elif spec.mixer == "mla":
        state = mla_init_cache(cfg, batch, max_len, cfg.cdtype, device)
    else:
        init_state = mamba_init_cache if spec.mixer == "mamba" else \
            rwkv6_init_cache
        state = init_state(cfg, batch, cfg.cdtype, device)
    c = {_state_key(spec): state}
    if spec.cross_attn:
        shape = (batch, cfg.n_audio_ctx, cfg.n_kv_heads, cfg.head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
                      "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
    return c


def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Zeros in the cache's layout (module docstring): K and V (MLA's
    latents and rope keys, the cross K and V) in the compute dtype, the
    recurrent states in float32."""
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
    ``e{j}`` / ``attn`` or ``ssm`` (and ``cross``), its tensors shared (a
    flat cache is wrapped, a nested one returned as it is)."""
    if is_flat(cfg):
        return {"group0": {"e0": {_state_key(cfg.stack[0][1][0]): cache}}}
    return cache


def layer_caches(cfg, cache: dict) -> list[dict]:
    """Each layer's cache, in the network's order, as views of ``cache``
    (``{"attn": {"k", "v"} or {"c", "kr"}}`` or ``{"ssm": ...}``, with
    ``"cross"`` beside it in a cross-attention layer)."""
    tree = cache_tree(cfg, cache)
    return [tree_map(lambda t, r=r: t[r], tree[f"group{gi}"][f"e{j}"])
            for gi, (repeat, pattern) in enumerate(cfg.stack)
            for r in range(repeat) for j in range(len(pattern))]


def _layer_decode(cfg, spec, p: dict, x: torch.Tensor, c: dict,
                  positions: torch.Tensor, moe_groups: int) -> torch.Tensor:
    h = _norm(cfg, p, "norm1", x)
    if spec.mixer == "attn":
        h, _ = gqa_decode(p, h, c["attn"], positions, cfg,
                          window=cfg.sliding_window)
    elif spec.mixer == "mla":
        h, _ = mla_decode(p, h, c["attn"], positions, cfg,
                          window=cfg.sliding_window)
    elif spec.mixer == "mamba":
        h, _ = mamba_decode(p, h, c["ssm"], cfg)
    else:
        h, _ = rwkv6_decode(p, h, c["ssm"], cfg)
    x = x + h
    if spec.cross_attn:
        x = x + cross_decode(p, _norm(cfg, p, "norm_cross", x), c["cross"],
                             cfg)
    h = _norm(cfg, p, "norm2", x)
    return add_residual(x, _ffn(cfg, spec, p, h, moe_groups,
                                with_aux=False)[0])


def _decode(cfg, params: dict, cache: dict, tokens: torch.Tensor,
            positions: torch.Tensor, moe_groups: int
            ) -> tuple[torch.Tensor, dict]:
    x = take_rows(params["embed"], tokens).to(cfg.cdtype)
    for (spec, p), c in zip(layers_of(cfg, params), layer_caches(cfg, cache)):
        x = _layer_decode(cfg, spec, p, x, c, positions, moe_groups)
    x = _norm(cfg, params, "final_norm", x)
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
