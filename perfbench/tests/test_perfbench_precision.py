"""The reference's lower precisions, which its controls put in the
program's place: TF32 and bf16 rounding of every product's operands and of
the gradient before each backward product."""

import numpy as np
import torch

from perfbench.reference import transformer as plain


def _tf32_numpy(x: np.ndarray) -> np.ndarray:
    """Round to 10 bits of mantissa, to nearest, ties to even, in float64."""
    m, e = np.frexp(x.astype(np.float64))          # x = m 2^e, 0.5 <= |m| < 1
    return np.ldexp(np.round(m * 2.0**11) / 2.0**11, e)


def test_tf32_rounds_to_nearest_even():
    x = torch.randn(10_000, generator=torch.Generator().manual_seed(3)) * 7
    got = plain.tf32(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert np.array_equal(got.double().numpy(), _tf32_numpy(x.numpy()))
    tie = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11])
    assert plain.tf32(tie).tolist() == [1.0, 1.0 + 4 * 2.0**-11]


def test_rounded_products_round_operands_and_gradients():
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(3, 4, 8, generator=gen, requires_grad=True)
    b = torch.randn(8, 5, generator=gen, requires_grad=True)
    g = torch.randn(3, 4, 5, generator=gen)
    for rnd, mm in ((plain.tf32, plain.tf32_mm), (plain.bf16, plain.bf16_mm)):
        out = mm(a, b)
        assert torch.equal(out, rnd(a) @ rnd(b))
        ga, gb = torch.autograd.grad(out, (a, b), g)
        assert torch.allclose(ga, rnd(g) @ rnd(b).T, rtol=1e-6, atol=1e-6)
        assert torch.allclose(
            gb, (rnd(a).reshape(-1, 8).T @ rnd(g).reshape(-1, 5)),
            rtol=1e-6, atol=1e-6)
        assert not torch.allclose(ga, g @ b.T, rtol=1e-6, atol=1e-6)


def test_compute_dtype_rounds_the_embedding_the_first_norm_and_the_head():
    """Where the configuration holds a value in its compute dtype, the
    reference rounds it: the embedding's output and its gradient, the first
    block's attention norm, and the head's weights (not their gradient,
    which the program rounds once for the whole batch)."""
    mc = dict(d_model=16, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=8,
              d_ff=32, vocab_size=40, norm="rmsnorm", norm_eps=1e-6,
              rope_theta=10000.0, compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(7)
    w = lambda *s: (torch.randn(*s, generator=gen) * 0.2).requires_grad_()
    params = {"embed": w(40, 16), "final_norm": torch.ones(16),
              "head": w(16, 40),
              "layers": {"norm1": torch.ones(2, 16), "wq": w(2, 16, 16),
                         "wk": w(2, 16, 8), "wv": w(2, 16, 8),
                         "wo": w(2, 16, 16), "norm2": torch.ones(2, 16),
                         "w_gate": w(2, 16, 32), "w_up": w(2, 16, 32),
                         "w_down": w(2, 32, 16)}}
    tok = torch.randint(0, 40, (2, 6), generator=gen)
    low = plain.logits(mc, params, tok)
    f32 = plain.logits({**mc, "compute_dtype": "float32"}, params, tok)
    assert not torch.equal(low, f32)
    assert torch.allclose(low, f32, rtol=0.05, atol=0.05)
    g_embed, g_head = torch.autograd.grad(low.square().sum(),
                                          (params["embed"], params["head"]))
    assert torch.equal(g_embed, plain.bf16(g_embed))
    assert not torch.equal(g_head, plain.bf16(g_head))
