"""``flash_attention_roofline`` (%): the least time the chip could take for
the causal attention of the traced window's forwards (every layer of every
batch: causal pairs x 4 head_dim operations at the bf16 peak, or q, k, v
and the output moved once, whichever is longer), over the device time of
the flash-attention kernels."""

from perfbench.harness.work import flash_seconds

KERNELS = ("flash_attention_mma_kernel", "flash_attention_simt_kernel")


def read(ctx: dict) -> float | None:
    trace = ctx.get("trace")
    if trace is None:
        return None
    device_s = trace.device_seconds(*KERNELS)
    if device_s <= 0:
        return None
    mc = ctx["mc"]
    least = ctx["batches"] * mc["n_layers"] * flash_seconds(
        ctx["batch_size"], ctx["seq_len"], mc["n_heads"], mc["n_kv_heads"],
        mc["head_dim"], mc["compute_dtype"])
    return 100.0 * least / device_s
