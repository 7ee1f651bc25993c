"""The chip's published peaks, and the operations and bytes each metric
divides by them.  Counted from the configuration's widths and the cell's
shapes, never from the program's arguments, so a count reads the same
whatever implements the work.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates): 989 TFLOP/s bf16 on the tensor cores, 495 TFLOP/s TF32, a third
of that for float32 operands multiplied as 3xTF32 (the ghost-norm
kernel's method), 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32_3xtf32": 495e12 / 3}
PEAK_BYTES_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def dense_widths(mc: dict) -> list[tuple[int, int]]:
    """(d_in, d_out) of every dense product of the stack, the head last."""
    d, h, kv, hd, f = (mc["d_model"], mc["n_heads"], mc["n_kv_heads"],
                       mc["head_dim"], mc["d_ff"])
    layer = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d), (d, f),
             (d, f), (f, d)]
    return layer * mc["n_layers"] + [(d, mc["vocab_size"])]


def product_params(mc: dict) -> int:
    """N: the weights of every dense product, the head included (the
    embedding table is a lookup, not a product)."""
    return sum(a * b for a, b in dense_widths(mc))


def attention_flops_per_token(mc: dict, seq: int) -> int:
    """One forward's causal attention per token, QK^T and PV: 2 L S h hd."""
    return 2 * mc["n_layers"] * seq * mc["n_heads"] * mc["head_dim"]


def train_flops(mc: dict, tokens: int, seq: int) -> int:
    """Model FLOPs of training on ``tokens``: 6 N T plus 3x the forward's
    causal attention (6 L S h hd a token)."""
    return tokens * (6 * product_params(mc)
                     + 3 * attention_flops_per_token(mc, seq))


def eval_flops(mc: dict, tokens: int, seq: int) -> int:
    """One forward over ``tokens``: 2 N T plus 2 L S h hd a token."""
    return tokens * (2 * product_params(mc)
                     + attention_flops_per_token(mc, seq))


def ghost_gram_work(mc: dict, rows: int, seq: int, dtype: str
                    ) -> tuple[float, float]:
    """(operations, bytes) of the ghost norms of ``rows`` examples: for
    every dense product, the Gram of its inputs and of its output
    cotangents, S(S+1)/2 pairs each of 2d operations (d = d_in, d_out),
    and each operand read once."""
    per_row = sum(din + dout for din, dout in dense_widths(mc))
    return (float(rows) * seq * (seq + 1) * per_row,
            float(rows) * seq * per_row * ELEM_BYTES[dtype])


def ghost_gram_seconds(mc: dict, rows: int, seq: int, dtype: str) -> float:
    """The least time the chip could take for ``ghost_gram_work``: float32
    operands at the 3xTF32 rate, bf16 at the tensor cores' peak."""
    ops, nbytes = ghost_gram_work(mc, rows, seq, dtype)
    peak = PEAK_FLOPS["bfloat16" if dtype == "bfloat16" else "float32_3xtf32"]
    return max(ops / peak, nbytes / PEAK_BYTES_S)


def flash_work(batch: int, seq: int, heads: int, kv_heads: int, head_dim: int,
               dtype: str) -> tuple[float, float]:
    """(operations, bytes) of causal attention over one batch: S(S+1)/2
    pairs a head of 4 D operations (QK^T and PV), and q, k, v and the
    output each moved once."""
    ops = 2.0 * batch * heads * seq * (seq + 1) * head_dim
    nbytes = float(batch) * seq * head_dim * (2 * heads + 2 * kv_heads) * \
        ELEM_BYTES[dtype]
    return ops, nbytes


def flash_seconds(batch: int, seq: int, heads: int, kv_heads: int,
                  head_dim: int, dtype: str) -> float:
    ops, nbytes = flash_work(batch, seq, heads, kv_heads, head_dim, dtype)
    return max(ops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES_S)
