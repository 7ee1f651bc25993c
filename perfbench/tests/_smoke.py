"""Small widths for running a cell on the CPU: every width cut, the
shapes' kinds kept (groups of heads, the norm, the gated feed-forward)."""

SMOKE_CONFIG = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=128, vocab_size=512,
                    param_dtype="float32", compute_dtype="float32")
SMOKE_MIX = {"decaph_train": dict(n_per=64, seq_len=16, batch_size=8),
             "eval": dict(n_per=4, seq_len=64)}


def smoke_config(cell_config: dict) -> dict:
    """The smoke widths; OLMo's heads are not grouped."""
    cfg = dict(SMOKE_CONFIG)
    if cell_config["n_kv_heads"] == cell_config["n_heads"]:
        cfg["n_kv_heads"] = cfg["n_heads"]
    return cfg
