"""Mixture-of-Experts with capacity dispatch, sorted by expert id.

Counterpart of ``repro.models.moe``: a float32 router and softmax, top-k
with the top-k renormalised, the Switch load-balance auxiliary loss, the
tokens cut into ``groups`` with ``capacity = max(1, int(capacity_factor *
tg * k / e))`` slots per expert and group, a stable sort of each group's
(token, choice) pairs by expert id, SiLU experts over the [G, E, C, D]
buffer (whatever ``cfg.ffn_kind`` says, as the reference), pairs past an
expert's capacity contributing 0, and shared experts.

The reference vmaps its per-group dispatch and combine; the port writes
the group axis out ([G, ...]) and builds both from gathers:

  * dispatch: each token's K copies are permuted into expert order, and
    slot (e, c) takes the pair at ``starts[e] + c`` when ``c < counts[e]``;
  * combine: pair i reads its slot's output (0 if it was dropped), scaled
    by its router probability; the pairs go back to token order, and each
    token sums its K outputs over a [T, K, D] axis, in a fixed order.

Nothing is scattered with atomics, forward or backward (a gather's
backward either writes each row once or adds only zeros beside it, and
the one scatter, which inverts the sort, writes each index once), so a
step, and its gradient, repeat bit for bit on the card.  The counts come
from a comparison with ``arange(E)``, not ``bincount``: nothing waits for
the host, and ``torch.func.vmap`` batches every op (the faithful
per-example DP path vmaps ``grad`` through this layer).

The expert products are batched matrix products over the whole buffer,
the reference's einsums, which it computes outside any kernel: every
expert's weights are read once per call, whichever experts the tokens
chose.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, matmul, shard, split_dim


def moe_init(cfg, dtype: torch.dtype, generator: torch.Generator | None,
             out: dict | None = None) -> dict:
    """The router (always float32, as the reference's) and the experts'
    stacked weights [E, ...]; shared experts when the config has them.
    ``out`` (name -> tensor) receives the draws in place."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    o = out or {}
    p = {
        "w_router": dense_init(d, (d, e), torch.float32, generator,
                               o.get("w_router")),
        "w_gate": dense_init(d, (e, d, f), dtype, generator, o.get("w_gate")),
        "w_up": dense_init(d, (e, d, f), dtype, generator, o.get("w_up")),
        "w_down": dense_init(f, (e, f, d), dtype, generator, o.get("w_down")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        for name, shape, fan_in in (("w_shared_gate", (d, fs), d),
                                    ("w_shared_up", (d, fs), d),
                                    ("w_shared_down", (fs, d), fs)):
            p[name] = dense_init(fan_in, shape, dtype, generator, o.get(name))
    return p


def _rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x [G, N, D] at rows index [G, M] -> [G, M, D]."""
    return torch.gather(x, 1, index[..., None].expand(*index.shape,
                                                      x.shape[-1]))


def _dispatch_group(x: torch.Tensor, top_ids: torch.Tensor, n_experts: int,
                    capacity: int) -> tuple[torch.Tensor, tuple]:
    """Sort-based dispatch of each group.

    x: [G, T, D]; top_ids: [G, T, K].  Returns (buffer [G, E, C, D], the
    metadata ``_combine_group`` needs).  Pair i = t * K + j is token t's
    j-th choice; a stable sort orders the pairs by expert, so within an
    expert earlier tokens take the earlier slots.
    """
    g, t, k = top_ids.shape
    d = x.shape[-1]
    dev = x.device
    flat_ids = top_ids.reshape(g, t * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.sum(flat_ids[..., None]
                       == torch.arange(n_experts, device=dev), dim=1)  # [G,E]
    starts = torch.cumsum(counts, dim=1) - counts         # exclusive cumsum
    pos = torch.arange(t * k, device=dev) - torch.gather(starts, 1,
                                                         sorted_ids)
    keep = pos < capacity
    pos_c = pos.clamp(max=capacity - 1)          # the reference's where()
    # token t's K copies ([G, T*K, D]: the expand's backward sums them in
    # order), permuted into expert order (each row read once)
    copies = x[:, :, None, :].expand(g, t, k, d).reshape(g, t * k, d)
    x_sorted = _rows(copies, order)
    slot = torch.arange(capacity, device=dev)
    src = (starts[..., None] + slot).clamp(max=t * k - 1)            # [G,E,C]
    filled = (slot < counts[..., None])[..., None]                   # [G,E,C,1]
    buf = _rows(x_sorted, src.reshape(g, n_experts * capacity))
    buf = torch.where(filled, buf.reshape(g, n_experts, capacity, d),
                      torch.zeros((), dtype=x.dtype, device=dev))
    return buf, (sorted_ids, pos_c, keep, order)


def _combine_group(h: torch.Tensor, meta: tuple, top_probs: torch.Tensor,
                   t: int, k: int) -> torch.Tensor:
    """Each token's K expert outputs weighted by its router probabilities
    and summed.  h: [G, E, C, D]; top_probs: [G, T, K] -> [G, T, D]."""
    sorted_ids, pos_c, keep, order = meta
    g, e, c, d = h.shape
    out_sorted = _rows(h.reshape(g, e * c, d), sorted_ids * c + pos_c)
    out_sorted = torch.where(keep[..., None], out_sorted,
                             torch.zeros((), dtype=h.dtype, device=h.device))
    probs_sorted = torch.gather(top_probs.reshape(g, t * k), 1, order)
    weighted = out_sorted * probs_sorted[..., None].to(h.dtype)
    # back to token order: order is a permutation, and scattering the
    # positions through it inverts it (each index written once)
    ranks = torch.arange(t * k, device=h.device).expand_as(order)
    inverse = torch.scatter(torch.zeros_like(order), 1, order, ranks)
    per_pair = _rows(weighted, inverse)
    return torch.sum(per_pair.reshape(g, t, k, d), dim=2)


def _experts(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """SiLU experts over the dispatch buffer: [G, E, C, D] -> [G, E, C, D].

    The reference's einsums ``gecd,edf->gecf`` and ``gecf,efd->gecd`` as
    three batched products over the experts ([E, G*C, D] against each
    expert's [D, F] and [F, D]), in the promoted dtype, as ``jnp.einsum``
    computes them.
    """
    buf = shard(buf, "batch", "experts", None, None)
    g, e, c, d = buf.shape
    dt = functools.reduce(torch.promote_types, (
        buf.dtype, p["w_gate"].dtype, p["w_up"].dtype, p["w_down"].dtype))
    rows = buf.to(dt).transpose(0, 1).reshape(e, g * c, d)
    gate = torch.bmm(rows, p["w_gate"].to(dt))
    up = torch.bmm(rows, p["w_up"].to(dt))
    # the reference's [G, E, C, F] hint on the rows' [E, G*C, F] layout
    h = shard(F.silu(gate) * up, "experts", None, None)
    y = torch.bmm(h, p["w_down"].to(dt))
    return shard(y.reshape(e, g, c, d).transpose(0, 1), "batch", "experts",
                 None, None)


def moe_apply(p: dict, x: torch.Tensor, cfg, *, groups: int | None = None,
              with_aux: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss float32 scalar).

    ``groups`` (default ``cfg.moe_groups``) cuts the B * S tokens, in
    order, into groups that each dispatch on their own; the decode step
    passes one group per row, which is the reference's per-row vmap.
    ``with_aux=False`` skips the auxiliary loss (None), which a decode
    step would throw away.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    groups = max(1, cfg.moe_groups if groups is None else groups)
    t_all = b * s
    if t_all % groups:
        raise ValueError(f"{t_all} tokens do not divide into {groups} "
                         "groups")
    tg = t_all // groups
    # slots per expert and group, in the reference's Python floats
    capacity = max(1, int(cfg.capacity_factor * tg * k / e))

    xf = x.reshape(t_all, d)
    logits = xf.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)                       # [T, E]
    top_probs, top_ids = torch.topk(probs, k, dim=-1)           # [T, K]
    top_probs = top_probs / torch.sum(top_probs, dim=-1, keepdim=True)

    aux = None
    if with_aux:   # Switch-transformer load-balance aux loss
        me = torch.mean(probs, dim=0)
        chosen = (top_ids[..., None]
                  == torch.arange(e, device=x.device)).float()
        ce = torch.mean(torch.sum(chosen, dim=1), dim=0) / k
        aux = e * torch.sum(me * ce)

    # the grouped views: where the tokens are split over more ranks than
    # the groups take (16 groups over ("pod", "data"), 32 ways), the
    # extra mesh dims are made whole first (``split_dim``)
    buf, meta = _dispatch_group(split_dim(xf, 0, groups, tg),
                                split_dim(top_ids, 0, groups, tg), e,
                                capacity)
    y = _combine_group(_experts(buf, p), meta,
                       split_dim(top_probs, 0, groups, tg), tg, k)
    y = y.reshape(b, s, d)
    if cfg.n_shared_experts:
        gate_s = F.silu(matmul(x, p["w_shared_gate"]))
        up_s = matmul(x, p["w_shared_up"])
        y = y + matmul(gate_s * up_s, p["w_shared_down"])
    return y.to(x.dtype), aux
