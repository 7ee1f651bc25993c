"""Inputs and weights made from ``--seed``: the same seed, the same inputs.

``token_silos`` is the benchmark's own copy of the port's generator
(``repro_torch.serve.federation.token_silos``): each hospital draws its
tokens from its own permutation of one Zipf law over the vocabulary, and
its labels are the tokens shifted left with the last position masked
(-1).  ``make_params`` draws the transformer's weights on the device with
one ``torch.Generator`` call, in the dtype they are served in, laid out as
the port keeps them (``repro_torch.models.transformer``'s tree and leaf
order, which is the order the noise is drawn in).
"""

from __future__ import annotations

import math

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# sub-streams of one seed
DATA_STREAM, WEIGHT_STREAM, HELD_OUT_STREAM = 1, 2, 3


def substream(seed: int, stream: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed), stream])


def token_silos(vocab: int, *, hospitals: int, n_per: int, seq_len: int,
                seed: np.random.SeedSequence | int, skew: float = 2.0
                ) -> list[tuple[np.ndarray, np.ndarray]]:
    """``hospitals`` silos of (tokens [n_per, seq_len] int32, labels)."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab + 1) ** skew
    silos = []
    for _ in range(hospitals):
        perm = rng.permutation(vocab)
        probs = base[perm] / base.sum()
        x = rng.choice(vocab, size=(n_per, seq_len), p=probs).astype(np.int32)
        y = np.full_like(x, -1)
        y[:, :-1] = x[:, 1:]
        silos.append((x, y))
    return silos


def leaf_specs(mc: dict) -> list[tuple[tuple[str, ...], tuple[int, ...],
                                       float | None]]:
    """(path, shape, std) of every parameter in the port's order; std None
    for a norm's scale (ones)."""
    d, n, h, kv, hd = (mc["d_model"], mc["n_layers"], mc["n_heads"],
                       mc["n_kv_heads"], mc["head_dim"])
    f, v = mc["d_ff"], mc["vocab_size"]
    scaled = mc["norm"] == "rmsnorm"
    specs = [(("embed",), (v, d), 0.02)]
    if scaled:
        specs.append((("final_norm",), (d,), None))
    specs.append((("head",), (d, v), 0.02))
    layer = []
    if scaled:
        layer.append(("norm1", (n, d), None))
    layer += [("wq", (n, d, h * hd), d), ("wk", (n, d, kv * hd), d),
              ("wv", (n, d, kv * hd), d), ("wo", (n, h * hd, d), h * hd)]
    if scaled:
        layer.append(("norm2", (n, d), None))
    layer += [("w_gate", (n, d, f), d), ("w_up", (n, d, f), d),
              ("w_down", (n, f, d), f)]
    specs += [(("layers", name), shape, None if fan is None
               else 1.0 / math.sqrt(fan)) for name, shape, fan in layer]
    return specs


def make_params(mc: dict, seed: int, device) -> dict:
    """The weights, drawn in one call of a generator on ``device`` into one
    buffer of the parameters' dtype; every leaf is a view of it, scaled
    in place (a normal of std 0.02 for the embedding and the head, of
    1/sqrt(fan in) for the dense layers), and a norm's scale is ones."""
    dt = DTYPES[mc["param_dtype"]]
    specs = leaf_specs(mc)
    total = sum(math.prod(shape) for _, shape, std in specs if std)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(substream(seed, WEIGHT_STREAM).generate_state(
        1, np.uint64)[0]))
    buf = torch.randn(total, generator=gen, dtype=dt, device=device)
    params: dict = {}
    off = 0
    for path, shape, std in specs:
        if std is None:
            leaf = torch.ones(shape, dtype=dt, device=device)
        else:
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape).mul_(std)
            off += n
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def leaves(tree: dict) -> list[torch.Tensor]:
    """A tree's leaves in insertion order (the port's order)."""
    out = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out



def like(tree: dict, flat: list[torch.Tensor]) -> dict:
    """``tree``'s structure holding ``flat``, leaf for leaf in its order."""
    it = iter(flat)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(tree)
