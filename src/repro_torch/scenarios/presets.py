"""Named, paper-grounded scenario presets.

Counterpart of ``repro.scenarios.presets``: the same presets (so the same
spec hashes), the same traces and the same model/data ladders, built by
the port on the device the caller names (``device=``, CUDA unless the
caller asks for the CPU).

One preset per (case study x model size) — GEMINI-like mortality, pancreas
single-cell typing, chest X-ray multilabel — plus the canonical 5-hospital
heterogeneous deployment trace that ``benchmarks/sim_report.py`` and
``examples/heterogeneous_hospitals.py`` previously each hard-coded.  That
trace now exists exactly once, here.

Model/data builders live here too, lazily importing the torch-backed
modules, so the executor stays a thin orchestration layer and importing
this module (preset listing, sweep expansion) never builds a model or a
cohort.
"""

from __future__ import annotations

from repro_torch.scenarios.spec import ScenarioSpec

# ---------------------------------------------------------------------------
# The canonical 5-hospital deployment trace (single source of truth).
# A fast research centre down to a community-hospital straggler
# (examples/sec), the straggler also riding the slowest WAN links, and a
# flaky mid-tier site that drops off mid-run and rejoins — the dropout lands
# mid-round, which is what exercises SecAgg's Shamir mask recovery.
# ---------------------------------------------------------------------------

FIVE_HOSPITAL_NODES: list[dict] = [
    {"throughput": 500.0, "overhead": 0.02},
    {"throughput": 300.0, "overhead": 0.02},
    {"throughput": 180.0, "overhead": 0.03},
    {"throughput": 110.0, "overhead": 0.04,
     "dropouts": [[0.35, 2.5]]},          # flaky: drops mid-run, rejoins
    {"throughput": 60.0, "overhead": 0.05},
]

FIVE_HOSPITAL_TOPOLOGY: dict = {
    "kind": "full",
    "default": {"bandwidth": 12.5e6, "latency": 0.02},
    "links": {"0-4": {"bandwidth": 1.25e6, "latency": 0.08},
              "1-4": {"bandwidth": 1.25e6, "latency": 0.08}},
}

FIVE_HOSPITAL_TRACE: dict = {
    "nodes": FIVE_HOSPITAL_NODES,
    "topology": FIVE_HOSPITAL_TOPOLOGY,
}

# WAN churn on top of the same trace: the straggler's main link degrades,
# then fails outright, then is restored — a LinkSchedule consumed through
# Topology.from_trace.
FIVE_HOSPITAL_CHURN_SCHEDULE: list[dict] = [
    {"t": 0.8, "link": "0-4", "bandwidth": 1.25e5, "latency": 0.4},
    {"t": 1.6, "link": "0-4", "down": True},
    {"t": 4.0, "link": "0-4", "bandwidth": 1.25e6, "latency": 0.08},
]


def _five_hospital_churn_topology() -> dict:
    topo = dict(FIVE_HOSPITAL_TOPOLOGY)
    topo["schedule"] = list(FIVE_HOSPITAL_CHURN_SCHEDULE)
    return topo


# ---------------------------------------------------------------------------
# Model-size ladders per case study.
# ---------------------------------------------------------------------------

_FEATURES: dict[tuple[str, str], int] = {
    # GEMINI EHR: 436 one-hot+numeric features at full paper scale
    ("gemini", "small"): 32,
    ("gemini", "medium"): 128,
    ("gemini", "full"): 436,
    # pancreas scRNA: 15,558 genes at full paper scale
    ("pancreas", "small"): 128,
    ("pancreas", "medium"): 1024,
    ("pancreas", "full"): 15558,
    # X-ray: feature = image side length
    ("xray", "small"): 16,
    ("xray", "medium"): 24,
    ("xray", "full"): 32,
    # LM: feature = sequence length
    ("lm", "small"): 16,
    ("lm", "medium"): 32,
    ("lm", "full"): 64,
}

N_PANCREAS_TYPES = 4
N_XRAY_LABELS = 4

# Transformer ladder for the "lm" task: dense decoder stacks (smollm-family
# smoke config rescaled), untied embeddings so the ghost clipping path is
# exact and the GhostCapability attaches (DESIGN.md §12): DP arms reach
# the ghost_norm kernel on the card.  The reference's dims, unchanged.
_LM_DIMS: dict[str, dict] = {
    "small": dict(d_model=64, n_layers=2, n_heads=2, n_kv_heads=1,
                  head_dim=32, d_ff=128, vocab_size=256),
    "medium": dict(d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256, vocab_size=512),
    "full": dict(d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
                 head_dim=32, d_ff=512, vocab_size=1024),
}


def lm_model_config(model_size: str):
    """The transformer ModelConfig behind an "lm" preset size."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import dense_stack

    dims = dict(_LM_DIMS[model_size])
    n_layers = dims.pop("n_layers")
    return get_smoke_config("smollm-360m").replace(
        n_layers=n_layers, stack=dense_stack(n_layers),
        tie_embeddings=False, **dims,
    )


def lm_seq_len(model_size: str) -> int:
    """The "lm" preset's sequence length for a model size (feature ladder)."""
    return _FEATURES[("lm", model_size)]


def normalizes(task: str) -> bool:
    """Whether the task's silos go through ``normalize_participants``.

    Token ids are categorical — feature-standardising them would destroy
    the data — so the "lm" task opts out.
    """
    return task != "lm"


def default_features(task: str, model_size: str) -> int:
    return _FEATURES[(task, model_size)]


def resolved_features(spec: ScenarioSpec) -> int:
    return spec.features or default_features(spec.task, spec.model_size)


def build_model(spec: ScenarioSpec, *, device="cuda"):
    """The preset model for ``spec`` on ``device`` (paper architectures at
    three scales)."""
    from repro_torch.models import tabular

    if spec.task == "lm":
        from repro_torch.serve.federation import transformer_model

        return transformer_model(lm_model_config(spec.model_size),
                                 device=device)
    f = resolved_features(spec)
    if spec.task == "gemini":
        if spec.model_size == "small":
            return tabular.linear_model(f, device=device)
        if spec.model_size == "medium":
            return tabular.make_mlp_classifier([f, 64, 1], task="binary",
                                               device=device)
        # paper: MLP 436-300-100-50-10-1
        return tabular.make_mlp_classifier([f, 300, 100, 50, 10, 1],
                                           task="binary", device=device)
    if spec.task == "pancreas":
        sizes = {
            "small": [f, 32, N_PANCREAS_TYPES],
            "medium": [f, 256, 32, N_PANCREAS_TYPES],
            # paper: MLP 15558-1000-100-4
            "full": [f, 1000, 100, N_PANCREAS_TYPES],
        }[spec.model_size]
        return tabular.make_mlp_classifier(sizes, task="multiclass",
                                           device=device)
    # xray: BN-free mini-DenseNet ladder (paper uses DenseNet121)
    cfg = {
        "small": tabular.DenseNetConfig(growth=4, blocks=(1, 1),
                                        init_channels=8, image_size=f),
        "medium": tabular.DenseNetConfig(growth=8, blocks=(2, 2),
                                         init_channels=12, image_size=f),
        "full": tabular.DenseNetConfig(image_size=f),
    }[spec.model_size]
    return tabular.make_densenet(cfg, device=device)


def build_silos(spec: ScenarioSpec):
    """The preset cohort for ``spec`` (synthetic, paper-statistics-matched;
    host numpy, the reference's draws)."""
    from repro_torch.data import synthetic

    f = resolved_features(spec)
    if spec.task == "lm":
        from repro_torch.serve.federation import token_silos

        return token_silos(
            lm_model_config(spec.model_size), hospitals=spec.hospitals,
            n_per=max(1, spec.examples // spec.hospitals), seq_len=f,
            seed=spec.seed,
        )
    if spec.task == "gemini":
        return synthetic.make_gemini_like(
            seed=spec.seed, n_total=spec.examples, n_silos=spec.hospitals,
            n_features=f,
        )
    if spec.task == "pancreas":
        return synthetic.make_pancreas_like(
            seed=spec.seed, n_total=spec.examples, n_silos=spec.hospitals,
            n_genes=f, n_types=N_PANCREAS_TYPES,
        )
    return synthetic.make_xray_like(
        seed=spec.seed, n_total=spec.examples, n_silos=spec.hospitals,
        image_size=f,
    )


def _correct_fraction(correct, counted) -> float:
    """``correct.sum() / counted.sum()`` with one device-to-host copy: the
    two counts are exact integers, so the quotient is the reference's
    numpy mean of the same booleans."""
    import torch

    n_correct, n = torch.stack([correct.sum(), counted.sum()]).tolist()
    return n_correct / n


def pooled_metric(spec: ScenarioSpec, model, params, silos) -> float:
    """Task-appropriate pooled utility in [0, 1], computed on the device
    the parameters live on (only the fraction comes back to the host)."""
    import numpy as np
    import torch

    from repro_torch.tree import tree_device

    dev = tree_device(params)
    x = torch.from_numpy(np.concatenate([p.x for p in silos])).to(dev)
    y = torch.from_numpy(np.concatenate([p.y for p in silos])).to(dev)
    if spec.task == "lm":              # pooled next-token accuracy
        from repro_torch.models import transformer as tf

        cfg = lm_model_config(spec.model_size)
        with torch.no_grad():
            logits, _aux = tf.forward(cfg, params,
                                      {"tokens": x.to(torch.int32)})
        mask = y >= 0
        return _correct_fraction((torch.argmax(logits, dim=-1) == y) & mask,
                                 mask)
    if spec.task == "pancreas":        # multiclass: argmax accuracy
        with torch.no_grad():
            pred = model.predict_fn(params, x).argmax(-1)
        return _correct_fraction(pred == y, torch.ones_like(y, dtype=bool))
    # gemini (binary) and xray (multilabel, elementwise) share the
    # thresholded pooled accuracy — one implementation, in the model zoo
    from repro_torch.models.tabular import pooled_accuracy

    return pooled_accuracy(model, params, silos)


def default_nodes(spec: ScenarioSpec) -> list[dict]:
    """Derived node trace when the spec gives none: uniform cohort with a
    configurable straggler fraction (each straggler 8x slower)."""
    if spec.nodes is not None:
        return spec.nodes
    n_strag = int(round(spec.straggler_ratio * spec.hospitals))
    return [
        {"throughput": spec.throughput / (8.0 if i >= spec.hospitals - n_strag
                                          else 1.0),
         "overhead": 0.02}
        for i in range(spec.hospitals)
    ]


# ---------------------------------------------------------------------------
# The preset registry.
# ---------------------------------------------------------------------------

_EXAMPLES = {
    # total cohort examples per (task, size): big enough to learn, small
    # enough that `--run` finishes in seconds at "small"
    ("gemini", "small"): 1200,
    ("gemini", "medium"): 2400,
    ("gemini", "full"): 5000,
    ("pancreas", "small"): 600,
    ("pancreas", "medium"): 1200,
    ("pancreas", "full"): 2600,
    ("xray", "small"): 300,
    ("xray", "medium"): 600,
    ("xray", "full"): 1800,
    ("lm", "small"): 96,
    ("lm", "medium"): 128,
    ("lm", "full"): 192,
}

# paper silo counts; lm = 4 (the reference's)
_HOSPITALS = {"gemini": 8, "pancreas": 5, "xray": 3, "lm": 4}


def _case_study_presets() -> dict[str, ScenarioSpec]:
    out: dict[str, ScenarioSpec] = {}
    for task in ("gemini", "pancreas", "xray"):
        for size in ("small", "medium", "full"):
            name = f"{task}-{size}"
            out[name] = ScenarioSpec(
                name=name, task=task, model_size=size,
                hospitals=_HOSPITALS[task],
                examples=_EXAMPLES[(task, size)],
                rounds=12, batch_size=64, lr=0.4,
                tags=("case-study", task, size),
            )
    return out


def all_presets() -> dict[str, ScenarioSpec]:
    """All named presets (fresh spec objects each call)."""
    out = _case_study_presets()
    for size in ("small", "medium", "full"):
        name = f"lm-{size}"
        out[name] = ScenarioSpec(
            name=name, task="lm", model_size=size,
            hospitals=_HOSPITALS["lm"], examples=_EXAMPLES[("lm", size)],
            rounds=8, batch_size=16, lr=0.1, use_secagg=False,
            tags=("case-study", "lm", size, "transformer"),
        )
    out["gemini-5hospital"] = ScenarioSpec(
        name="gemini-5hospital", task="gemini", model_size="small",
        hospitals=5, examples=1200, rounds=12, batch_size=64, lr=0.4,
        nodes=[dict(n) for n in FIVE_HOSPITAL_NODES],
        topology=dict(FIVE_HOSPITAL_TOPOLOGY),
        tags=("deployment", "heterogeneous"),
    )
    out["gemini-5hospital-churn"] = ScenarioSpec(
        name="gemini-5hospital-churn", task="gemini", model_size="small",
        hospitals=5, examples=1200, rounds=12, batch_size=64, lr=0.4,
        nodes=[dict(n) for n in FIVE_HOSPITAL_NODES],
        topology=_five_hospital_churn_topology(),
        tags=("deployment", "heterogeneous", "churn"),
    )
    return out


def get_preset(name: str) -> ScenarioSpec:
    catalogue = all_presets()
    try:
        return catalogue[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: "
            f"{', '.join(sorted(catalogue))}"
        ) from None
