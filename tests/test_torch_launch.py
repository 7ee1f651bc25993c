"""repro_torch's input shapes, programs' specs, prefill and decode
programs, roofline, and train and serve CLIs against the reference,
on the CPU.

  * specs: for each of the 10 architectures x 4 input shapes at full
    width, ``configs.shapes.input_specs`` and the program's ``args``
    against the reference's ``input_specs``, ``jax.eval_shape(tf.init)``
    and ``jax.eval_shape(opt.init)``: every leaf's path (through
    ``convert``'s layout and ``transformer.cache_tree``), shape and dtype,
    the overrides and ``ShapeSkip`` where the reference raises it; every
    leaf a meta tensor (nothing allocated);
  * prefill and decode programs at smoke size against the reference's on
    a one-device ``Auto`` mesh: logits within 1e-4;
  * the roofline arithmetic for every arch: FLOPs and bytes bit for bit,
    times by the ratio of the two cards' constants (rtol 1e-12);
  * ``python -m repro_torch.launch.train`` at smoke size: the reference's
    log lines (the device where it prints its mesh), ε bit for bit a
    fresh ``repro.core.accountant.RDPAccountant``'s, the privacy budget's
    stop, and the checkpoint read back by both packages;
  * ``python -m repro_torch.launch.serve``: greedy tokens equal the
    reference engine's from the same weights and prompts;
  * the launch layer loads neither ``jax`` nor ``repro``, and its entry
    points want the card unless the CPU is asked for.
"""

import dataclasses
import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_launch import auto_mesh
from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import shapes as jshapes
from repro.core.accountant import RDPAccountant as JRDPAccountant
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import get_optimizer as jax_optimizer
from repro.serve import engine as jengine
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs import get_smoke_config
from repro_torch.configs import shapes
from repro_torch.convert import params_from_jax, params_to_numpy, \
    params_to_tree
from repro_torch.launch import roofline, steps
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
LOGIT_ATOL = 1e-4


# -- specs -----------------------------------------------------------------------


def _signature(tree) -> dict:
    """key path -> (shape, dtype name) of every leaf (torch or JAX)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): (tuple(leaf.shape),
                                         str(leaf.dtype).replace("torch.", ""))
            for path, leaf in flat}


def _meta_leaves(tree) -> list:
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return jax.eval_shape(lambda k: jtf.init(jax_config(arch), k),
                          jax.random.key(0))


def test_input_shapes_are_the_references():
    from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES

    assert INPUT_SHAPES == JAX_INPUT_SHAPES


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(arch, shape_name):
    try:
        jcfg, jspecs, jkind = jshapes.input_specs(jax_config(arch),
                                                  shape_name)
    except jshapes.ShapeSkip:
        with pytest.raises(shapes.ShapeSkip, match="long_500k skipped"):
            shapes.input_specs(get_config(arch), shape_name)
        with pytest.raises(shapes.ShapeSkip):
            steps.build_program(get_config(arch), shape_name, "cpu")
        return
    cfg, specs, kind = shapes.input_specs(get_config(arch), shape_name)
    assert kind == jkind
    assert cfg.sliding_window == jcfg.sliding_window
    if kind == "decode":
        assert _signature(tf.cache_tree(cfg, specs["cache"])) == \
            _signature(jspecs["cache"])
        specs = {k: v for k, v in specs.items() if k != "cache"}
        jspecs = {k: v for k, v in jspecs.items() if k != "cache"}
    assert _signature(specs) == _signature(jspecs)

    prog = steps.build_program(get_config(arch), shape_name, "cpu")
    assert prog.kind == kind
    assert all(t.is_meta for t in _meta_leaves(prog.args)), "allocated"
    jparams = _reference_params(arch)
    assert _signature(params_to_tree(prog.args[0])) == _signature(jparams)
    if kind == "train":
        jopt = jax.eval_shape(
            jax_optimizer(jcfg.optimizer, jcfg.lr).init, jparams)
        opt = prog.args[1]
        assert type(opt).__name__ == type(jopt).__name__
        for ours, ref in zip(opt, jopt):
            ours = params_to_tree(ours) if isinstance(ours, dict) else ours
            assert _signature(ours) == _signature(ref)
        assert _signature(prog.args[2]) == _signature(jspecs)


def test_param_specs_are_inits_tree_without_a_draw():
    """``param_specs`` runs ``init``'s code with no generator: the same
    tree, shapes and dtypes as a real init, on the meta device."""
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        real = tf.init(cfg, 0, "cpu")
        spec = tf.param_specs(cfg)
        assert _signature(real) == _signature(spec), arch
        assert all(t.is_meta for t in _meta_leaves(spec))


# -- prefill and decode programs -------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b"])
def test_prefill_and_decode_programs_match_reference(arch):
    mesh = auto_mesh()
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jtf.init(jcfg, jax.random.key(4))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             tcfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)

    jprog = jsteps.build_program(jcfg, "prefill_32k", mesh)
    prog = steps.build_program(tcfg, "prefill_32k", "cpu")
    assert prog.meta == jprog.meta
    with mesh:
        ref = jprog.fn(jparams, {"tokens": jnp.asarray(tokens)})
    ours = prog.fn(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL, rtol=0)

    jprog = jsteps.build_program(jcfg, "decode_32k", mesh)
    prog = steps.build_program(tcfg, "decode_32k", "cpu")
    assert prog.meta == jprog.meta
    jcache = jtf.init_cache(jprog.cfg, 2, 12)
    cache = tf.init_cache(prog.cfg, 2, 12, "cpu")
    for index in range(3):
        step_tokens = tokens[:, index:index + 1]
        with mesh:
            ref, jcache = jprog.fn(jparams, jcache, jnp.asarray(step_tokens),
                                   jnp.int32(index))
        ours, cache = prog.fn(params, cache, torch.from_numpy(step_tokens),
                              torch.tensor(index, dtype=torch.int32))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=LOGIT_ATOL, rtol=0)


# -- roofline --------------------------------------------------------------------


def _scaled(port: float, ref: float, port_rate: float, ref_rate: float):
    """A time on the port's constants against one on the reference's."""
    np.testing.assert_allclose(port * port_rate, ref * ref_rate, rtol=1e-12)


@pytest.mark.parametrize("arch", list_archs())
def test_roofline_arithmetic_is_the_references(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert roofline._ghost_collector_sites(cfg) == \
        jroofline._ghost_collector_sites(jcfg)
    for di, do in roofline._ghost_collector_sites(cfg)[:8]:
        assert roofline.ghost_norm_flops(16, 256, di, do) == \
            jroofline.ghost_norm_flops(16, 256, di, do)
    for shape in INPUT_SHAPES.values():
        assert roofline.model_flops(cfg, shape, shape["kind"]) == \
            jroofline.model_flops(jcfg, shape, shape["kind"])
    for clipping in ("ghost", "per_example"):
        kw = dict(cohort=4, batch_per_silo=16, seq_len=256,
                  clipping=clipping)
        assert roofline.dp_round_flops(cfg, **kw) == \
            jroofline.dp_round_flops(jcfg, **kw)
        ours = roofline.dp_round_roofline(cfg, wall_seconds=2.5, n_chips=2,
                                          **kw)
        ref = jroofline.dp_round_roofline(jcfg, wall_seconds=2.5, n_chips=2,
                                          **kw)
        for key in ("round_flops", "per_example_grad_bytes",
                    "achieved_flops_per_s", "clipping"):
            assert ours[key] == ref[key], key
        _scaled(ours["pct_of_roofline"], ref["pct_of_roofline"],
                roofline.PEAK_FLOPS, jroofline.PEAK_FLOPS)
    terms = dict(flops=3e15, hbm_bytes=2e12, coll_bytes=5e10, n_chips=4)
    ours, ref = roofline.roofline_terms(**terms), \
        jroofline.roofline_terms(**terms)
    _scaled(ours["compute_s"], ref["compute_s"], roofline.PEAK_FLOPS,
            jroofline.PEAK_FLOPS)
    _scaled(ours["memory_s"], ref["memory_s"], roofline.HBM_BW,
            jroofline.HBM_BW)
    _scaled(ours["collective_s"], ref["collective_s"], roofline.LINK_BW,
            jroofline.LINK_BW)


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


def test_analyze_program_counts_the_products():
    cfg = get_smoke_config("smollm-360m")
    prog = steps.build_program(cfg, "prefill_32k", "cpu")
    params = tf.init(prog.cfg, 0, "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    report = roofline.analyze_program(prog.fn, params, {"tokens": tokens})
    # every dense product of the forward: 2 * tokens * (the dense layers'
    # weights + the tied head), plus attention's q.k and p.v products
    d, layers = cfg.d_model, cfg.n_layers
    dense = layers * (2 * d * cfg.n_heads * cfg.head_dim
                      + 2 * d * cfg.n_kv_heads * cfg.head_dim
                      + 3 * d * cfg.d_ff) + d * cfg.vocab_size
    attention = layers * 2 * (2 * 8 * 8 * cfg.n_heads * cfg.head_dim)
    assert report["flops"] == 2 * 16 * dense + 2 * attention
    assert report["peak_memory_bytes"] is None and report["device"] == "cpu"
    torch.testing.assert_close(report["out"],
                               tf.forward(prog.cfg, params,
                                          {"tokens": tokens})[0])


# -- the train CLI ---------------------------------------------------------------


STEP_LINE = re.compile(r"^step +\d+ loss \d+\.\d{4} eps \d+\.\d{3} "
                       r"\(\d+\.\ds\)$")


def test_train_cli_logs_like_the_reference(tmp_path, capsys):
    path = str(tmp_path / "final.ckpt")
    report = train_cli.main(["--device", "cpu", "--steps", "3", "--batch",
                             "4", "--seq", "16", "--log-every", "2",
                             "--checkpoint", path])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu arch=smollm-360m scale=smoke dp=on"
    assert re.fullmatch(r"params: \d+\.\dM", lines[1])
    assert [line.split()[1] for line in lines[2:4]] == ["0", "2"]
    assert all(STEP_LINE.match(line) for line in lines[2:4]), lines
    assert lines[4] == f"checkpoint written: {path}"
    assert report["steps"] == 3 and np.all(np.isfinite(report["losses"]))
    acct = JRDPAccountant(sampling_rate=min(1.0, 4 / (4 * 50)),
                          noise_multiplier=0.8, delta=1e-5)
    acct.step()
    acct.step()
    acct.step()
    assert report["epsilon"] == acct.epsilon()
    assert f"eps {acct.epsilon():.3f}" in lines[3]

    tree, step, _ = load_checkpoint(path)
    assert step == 3
    want = params_to_tree(report["params"])
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jtree, jstep, _ = jax_load_checkpoint(path)
    assert jstep == 3
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_train_cli_stops_at_the_privacy_budget(capsys):
    report = train_cli.main(["--device", "cpu", "--steps", "5", "--batch",
                             "4", "--seq", "8", "--log-every", "1",
                             "--eps-budget", "2.5"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "privacy budget 2.5 reached at step 1"
    assert report["steps"] == 2 and len(report["losses"]) == 2


def test_train_cli_without_dp(capsys):
    report = train_cli.main(["--device", "cpu", "--steps", "2", "--batch",
                             "4", "--seq", "8", "--no-dp", "--scale",
                             "smoke", "--arch", "olmo-1b", "--lr", "0.01"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu arch=olmo-1b scale=smoke dp=off"
    assert all(" eps 0.000 " in line for line in lines[2:])
    assert report["epsilon"] == 0.0


def test_scaled_config_is_the_references():
    from repro.launch.train import scaled_config as jax_scaled_config

    for scale in ("full", "smoke", "100m"):
        ours = train_cli.scaled_config("olmo-1b", scale)
        ref = jax_scaled_config("olmo-1b", scale)
        for field in ("d_model", "n_layers", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab_size", "optimizer", "lr"):
            assert getattr(ours, field) == getattr(ref, field), field
        assert [(r, [dataclasses.astuple(spec) for spec in pattern])
                for r, pattern in ours.stack] == \
            [(r, [dataclasses.astuple(spec) for spec in pattern])
             for r, pattern in ref.stack]


# -- the serve CLI ---------------------------------------------------------------


def test_serve_cli_tokens_are_the_reference_engines(capsys):
    out = serve_cli.main(["--device", "cpu", "--batch", "2",
                          "--prompt-len", "6", "--gen", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=smollm-360m generated (2, 5) in ")
    assert lines[1] == f"sample tokens: {out['tokens'][0].tolist()}"
    engine = out["engine"]
    assert engine.cfg.temperature == 0.0 and engine.cfg.max_len == 11
    jparams = jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(engine.params, engine.model_cfg))
    ref_engine = jengine.ServeEngine(jengine.ServeConfig(
        slots=2, max_len=11, temperature=0.0), params=jparams)
    np.testing.assert_array_equal(
        out["tokens"], jengine.batch_generate(ref_engine, out["prompts"], 5))


def test_serve_cli_refuses_encoder_decoders():
    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", "--arch", "whisper-small"])


# -- imports and devices ---------------------------------------------------------


def test_launch_layer_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.roofline\n"
        "import repro_torch.optim, repro_torch.configs.shapes\n"
        "import repro_torch.core.decaph_step\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_want_the_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("smollm-360m")
    for shape_name in INPUT_SHAPES:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            steps.build_program(cfg, shape_name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main([])
