"""The paper's case-study models: MLP, logistic regression, SVC, mini-DenseNet.

Counterpart of ``repro.models.tabular``: the architectures DeCaPH's
experiments train (GEMINI MLP 436-300-100-50-10-1, pancreas MLP
15558-1000-100-4, a BN-free DenseNet on X-rays) as ``arms.Model`` triples,
and the ghost-clipping fast path for dense stacks
(``ghost_clipped_grad_sum_mlp``).

Parameters keep the reference's layout, so weights and checkpoints cross
without transposes (``convert.tabular_params_from_jax``): dense ``w`` is
[d_in, d_out], conv weights are HWIO and images NHWC; the NCHW/OIHW
permutes happen at the ``F.conv2d`` call.  ``init_fn(seed)`` draws
He-normal weights from the port's own ``torch.Generator`` on the model's
device, so seeded weights differ from the reference's (parity goes
through carried weights).

Every ``loss_fn(params, ex)`` is one example's loss, as
``core.dp.per_example_clipped_grad_sum`` calls it under
``torch.func.vmap``: the one-hot is a comparison with ``arange`` and the
gold score a ``gather``, both of which batch under ``vmap``.  Gradients
at ties are the reference's: ``max(x, 0)`` splits it in half in both
frameworks (``torch.maximum``, ``jnp.maximum``), ``relu`` gives 0 at 0 in
both, and ``|x|`` gives +1 at 0 (``_abs``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.arms.base import Model
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import tree_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _relu0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the reference's tie rule (half the gradient at 0)."""
    return torch.maximum(x, torch.zeros_like(x))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's gradient: +1 at 0 (``jnp.abs`` selects on
    x >= 0), where ``torch.abs`` gives 0 — the zero-initialised linear
    model meets exactly that tie on its first step."""
    return torch.where(x >= 0, x, -x)


def _bce_with_logits(logit, y):
    return _relu0(logit) - logit * y + torch.log1p(torch.exp(-_abs(logit)))


def linear_model(d: int, *, device=DEFAULT_DEVICE) -> Model:
    """Flat-tree logistic regression — small enough for smoke runs, real
    enough to learn.  The canonical tiny model for the CLI
    (``repro_torch.run``); zero-initialised, so the same on every seed."""
    dev = resolve_device(device)

    def init_fn(seed):
        return {"w": torch.zeros((d,), device=dev),
                "b": torch.zeros((), device=dev)}

    def loss(params, ex):
        logit = ex["x"] @ params["w"] + params["b"]
        return torch.mean(_bce_with_logits(logit, ex["y"]))

    def predict(params, x):
        return torch.sigmoid(x @ params["w"] + params["b"])

    return Model(init_fn, loss, predict)


def pooled_accuracy(model: Model, params, silos) -> float:
    """Binary accuracy of ``params`` over every silo's examples pooled."""
    x = np.concatenate([p.x for p in silos])
    y = np.concatenate([p.y for p in silos])
    with torch.no_grad():
        scores = model.predict_fn(params, torch.from_numpy(x).to(
            tree_device(params)))
    pred = scores.cpu().numpy() > 0.5
    return float((pred == y).mean())


def _dense_init(gen, d_in, d_out, device):
    w = torch.randn((d_in, d_out), generator=gen, device=device) \
        * math.sqrt(2.0 / d_in)
    return {"w": w, "b": torch.zeros((d_out,), device=device)}


def mlp_init(seed: int, sizes: Sequence[int], *, device=DEFAULT_DEVICE):
    """He-normal dense layers ``l0 .. l{n-1}`` on ``device``."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    return {f"l{i}": _dense_init(gen, sizes[i], sizes[i + 1], dev)
            for i in range(len(sizes) - 1)}


def mlp_forward(params, x, n_layers: int):
    h = x
    for i in range(n_layers):
        h = h @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def _one_hot(y: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot by comparison with ``arange`` (batches under vmap)."""
    return (y.long()[..., None] == torch.arange(n, device=y.device)).float()


def make_mlp_classifier(sizes: Sequence[int], task: str = "binary", *,
                        device=DEFAULT_DEVICE) -> Model:
    """task: binary (GEMINI, 1 output) | multiclass (pancreas, C outputs)."""
    n_layers = len(sizes) - 1
    dev = resolve_device(device)

    def init_fn(seed):
        return mlp_init(seed, sizes, device=dev)

    def loss_fn(params, ex):
        logit = mlp_forward(params, ex["x"], n_layers)
        if task == "binary":
            return torch.mean(_bce_with_logits(logit[..., 0], ex["y"]))
        logp = torch.log_softmax(logit, dim=-1)
        onehot = _one_hot(ex["y"], sizes[-1])
        return -torch.mean(torch.sum(onehot * logp, dim=-1))

    def predict_fn(params, x):
        logit = mlp_forward(params, x, n_layers)
        if task == "binary":
            return torch.sigmoid(logit[..., 0])
        return torch.softmax(logit, dim=-1)

    return Model(init_fn, loss_fn, predict_fn)


def make_logistic(d_in: int, *, device=DEFAULT_DEVICE) -> Model:
    return make_mlp_classifier([d_in, 1], task="binary", device=device)


def make_svc(d_in: int, n_classes: int, *, device=DEFAULT_DEVICE) -> Model:
    """One-layer SVC via multi-margin loss (paper: MLP + MultiMarginLoss)."""
    dev = resolve_device(device)

    def init_fn(seed):
        return mlp_init(seed, [d_in, n_classes], device=dev)

    def loss_fn(params, ex):
        scores = mlp_forward(params, ex["x"], 1)
        y = ex["y"].long()
        gold = torch.gather(scores, -1, y[..., None])[..., 0]
        margins = _relu0(1.0 + scores - gold[..., None])
        # subtract the gold term (margin vs itself is exactly 1.0)
        return torch.mean(torch.sum(margins, dim=-1) - 1.0)

    def predict_fn(params, x):
        return mlp_forward(params, x, 1)

    return Model(init_fn, loss_fn, predict_fn)


# ---------------------------------------------------------------------------
# Mini-DenseNet (chest-radiology stand-in for DenseNet121; BN-free as the
# paper requires for DP-SGD — norm layers are replaced by fixed scaling).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseNetConfig:
    growth: int = 12
    blocks: tuple[int, ...] = (2, 2, 2)
    init_channels: int = 16
    n_outputs: int = 4          # Atelectasis, Effusion, Cardiomegaly, NoFinding
    image_size: int = 32


def _conv_init(gen, kh, kw, cin, cout, device):
    fan_in = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen, device=device) \
        * math.sqrt(2.0 / fan_in)


def densenet_init(seed: int, cfg: DenseNetConfig, *, device=DEFAULT_DEVICE):
    """He-normal HWIO convs and the dense head, in the reference's keys."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    params = {"stem": _conv_init(gen, 3, 3, 1, cfg.init_channels, dev)}
    ch = cfg.init_channels
    for bi, n in enumerate(cfg.blocks):
        for li in range(n):
            params[f"b{bi}_l{li}"] = _conv_init(gen, 3, 3, ch, cfg.growth, dev)
            ch += cfg.growth
        if bi < len(cfg.blocks) - 1:  # transition 1x1 conv, halve channels
            params[f"t{bi}"] = _conv_init(gen, 1, 1, ch, ch // 2, dev)
            ch = ch // 2
    params["head"] = _dense_init(gen, ch, cfg.n_outputs, dev)
    return params


def _conv(x, w):
    """NHWC x HWIO -> NHWC, stride 1, "SAME" (odd kernels: pad k // 2)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding=w.shape[0] // 2)
    return out.permute(0, 2, 3, 1)


def _avg_pool2(h):
    """2x2 mean, stride 2, "VALID" (an odd last row or column is dropped)."""
    b, hh, ww, c = h.shape
    h = h[:, :hh // 2 * 2, :ww // 2 * 2]
    return h.reshape(b, hh // 2, 2, ww // 2, 2, c).sum(dim=(2, 4)) / 4.0


def densenet_forward(params, x, cfg: DenseNetConfig):
    """x: [B, H, W, 1] -> logits [B, n_outputs]."""
    h = torch.relu(_conv(x, params["stem"]))
    for bi, n in enumerate(cfg.blocks):
        for li in range(n):
            new = torch.relu(_conv(h, params[f"b{bi}_l{li}"]))
            h = torch.cat([h, new], dim=-1)
        if bi < len(cfg.blocks) - 1:
            h = _avg_pool2(_conv(h, params[f"t{bi}"]))
    h = torch.mean(h, dim=(1, 2))  # global average pool
    return h @ params["head"]["w"] + params["head"]["b"]


def make_densenet(cfg: DenseNetConfig = DenseNetConfig(), *,
                  device=DEFAULT_DEVICE) -> Model:
    dev = resolve_device(device)

    def init_fn(seed):
        return densenet_init(seed, cfg, device=dev)

    def loss_fn(params, ex):
        x = ex["x"][None] if ex["x"].ndim == 3 else ex["x"]
        y = ex["y"][None] if ex["y"].ndim == 1 else ex["y"]
        return torch.mean(_bce_with_logits(densenet_forward(params, x, cfg),
                                           y))

    def predict_fn(params, x):
        return torch.sigmoid(densenet_forward(params, x, cfg))

    return Model(init_fn, loss_fn, predict_fn)


# ---------------------------------------------------------------------------
# Ghost-clipped DP-SGD for MLP stacks (exact, no per-example grads).
# ---------------------------------------------------------------------------

def ghost_clipped_grad_sum_mlp(params, batch, sizes, task, clip_norm):
    """Exact sum of per-example-clipped grads via ghost norms.

    Two cheap passes: (1) forward capturing activations + manual backward for
    per-layer cotangents -> per-example norm^2 = sum_l |a_l|^2|g_l|^2 + |g_l|^2
    (weights + biases); (2) the clipped-weighted gradient is  a_l^T diag(c) g_l
    — one matmul per layer.  Returns (grads, per-example norms).
    """
    n_layers = len(sizes) - 1
    x, y = batch["x"], batch["y"]

    # pass 1: forward with caches
    acts, pre = [x], []
    h = x
    for i in range(n_layers):
        z = h @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        pre.append(z)
        h = torch.relu(z) if i < n_layers - 1 else z
        acts.append(h)

    logits = acts[-1]
    # d loss_i / d logits  (loss_i is one example's loss)
    if task == "binary":
        g = (torch.sigmoid(logits[..., 0]) - y)[..., None]
    else:
        g = torch.softmax(logits, dim=-1) - _one_hot(y, sizes[-1])

    # manual backward collecting per-layer cotangents
    cots = [None] * n_layers
    cots[n_layers - 1] = g
    for i in range(n_layers - 2, -1, -1):
        g = (g @ params[f"l{i + 1}"]["w"].T) * (pre[i] > 0)
        cots[i] = g

    norm_sq = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for a, g in zip(acts, cots):
        norm_sq = norm_sq + torch.sum(a ** 2, -1) * torch.sum(g ** 2, -1)
        norm_sq = norm_sq + torch.sum(g ** 2, -1)          # bias

    norms = torch.sqrt(torch.clamp(norm_sq, min=1e-24))
    c = torch.clamp(clip_norm / norms, max=1.0)             # [B]

    grads = {}
    for i, (a, g) in enumerate(zip(acts, cots)):
        cg = c[:, None] * g
        grads[f"l{i}"] = {"w": a.T @ cg, "b": torch.sum(cg, dim=0)}
    return grads, norms
