"""A decoder-only transformer in plain PyTorch, as the configurations
state it: pre-norm blocks of causal grouped-query attention with
rotate-half RoPE and a SwiGLU feed-forward, RMSNorm with a scale or
non-parametric LayerNorm, an untied head, and a token-mean cross entropy
over the labels that are not -1.

Everything is float32 (the caller turns TF32 off) but where the
configuration's ``compute_dtype`` holds a value: the embedding's output
and the first block's attention norm taken of it are rounded to it, with
their gradients, and so are the head's weights (not their gradient).
While the weights are bf16 that changes little; in float32 training
rounds it is the precision stated.  ``mm`` multiplies every product,
attention's two included, so a control can put a lower precision in its
place.  The parameter tree has the port's names
(``perfbench.harness.generate``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def norm(mc: dict, x: torch.Tensor, scale: torch.Tensor | None,
         low: str | None = None) -> torch.Tensor:
    """The configuration's norm; of an input held in ``low`` (the compute
    dtype), the result is in ``low`` too: the variance in float32, and an
    RMSNorm's inverse, normalised input and scale each rounded to ``low``
    as they are multiplied."""
    eps = mc["norm_eps"]
    rnd = (lambda t: cast(t, low)) if low else (lambda t: t)
    if mc["norm"] == "rmsnorm":
        inv = rnd(torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))
        return rnd(rnd(x * inv) * rnd(scale))
    if mc["norm"] == "ln_nonparam":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return rnd((x - mu) * torch.rsqrt(var + eps))
    raise ValueError(f"norm {mc['norm']!r}")


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x [B, S, H, D] at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = ang.sin()[None, :, None, :], ang.cos()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mm=torch.matmul) -> torch.Tensor:
    """Causal softmax attention; q [B,S,H,D], k and v [B,S,KV,D], query
    head i reading key head i // (H / KV)."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    q = q.transpose(1, 2)                                    # [B,H,S,D]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return mm(torch.softmax(scores, -1), v).transpose(1, 2)  # [B,S,H,D]


def cast(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back to float32; its gradient is
    rounded the same way."""
    return x.to(getattr(torch, dtype)).float()


def logits(mc: dict, params: dict, tokens: torch.Tensor, mm=torch.matmul
           ) -> torch.Tensor:
    """[B, S] tokens -> [B, S, V] float32 logits."""
    b, s = tokens.shape
    h, kv, hd = mc["n_heads"], mc["n_kv_heads"], mc["head_dim"]
    cdt = mc["compute_dtype"]
    x = cast(params["embed"][tokens.long()], cdt)
    lay = {k: t.unbind(0) for k, t in params["layers"].items()}
    for i in range(mc["n_layers"]):
        # the embedding's output is held in the compute dtype up to the
        # first residual add, so the first norm is taken in it
        a = norm(mc, x, lay["norm1"][i] if "norm1" in lay else None,
                 low=cdt if i == 0 else None)
        q = rope(mm(a, lay["wq"][i]).view(b, s, h, hd), mc["rope_theta"])
        k = rope(mm(a, lay["wk"][i]).view(b, s, kv, hd), mc["rope_theta"])
        v = mm(a, lay["wv"][i]).view(b, s, kv, hd)
        x = x + mm(attention(q, k, v, mm).reshape(b, s, h * hd),
                   lay["wo"][i])
        a = norm(mc, x, lay["norm2"][i] if "norm2" in lay else None)
        hid = F.silu(mm(a, lay["w_gate"][i])) * mm(a, lay["w_up"][i])
        x = x + mm(hid, lay["w_down"][i])
    x = norm(mc, x, params.get("final_norm"))
    # the head's gradient is the batch's sum, rounded once in the program:
    # rounding each example's here would add an error it does not make
    head = params["head"]
    return mm(x, _straight(head, cast(head.detach(), cdt)))


def row_losses(mc: dict, params: dict, tokens: torch.Tensor,
               labels: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """[B] token-mean cross entropy of each row over labels >= 0."""
    lg = logits(mc, params, tokens, mm)
    labels = labels.long()
    real = labels >= 0
    nll = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, labels.clamp(min=0)[..., None])[..., 0]
    return (nll * real).sum(-1) / real.sum(-1).clamp(min=1)


def _straight(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q``'s values with the gradient passing straight to ``x``."""
    return x + (q - x).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient by ``rnd``."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rnd(g), None


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 bits of mantissa, to nearest even)."""
    i = x.detach().float().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in float32."""
    return x.detach().bfloat16().float()


def rounded_mm(rnd):
    """Products as a tensor core multiplies in a lower precision: both
    operands rounded by ``rnd`` forward, and the gradient rounded by it
    before each backward product; float32 accumulation."""
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = _straight(a, rnd(a)) @ _straight(b, rnd(b))
        return _RoundGrad.apply(out, rnd)
    return mm


tf32_mm = rounded_mm(tf32)
bf16_mm = rounded_mm(bf16)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), back in float32; the gradient passes
    straight through."""
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return _straight(x, q)


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product whose two operands are float8, accumulated in float32."""
    return fp8(a) @ fp8(b)
