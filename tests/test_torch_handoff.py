"""repro_torch.serve.handoff and the hot-swap path against the JAX serving
tier, on the CPU; and the two repairs that the hot-swap depends on.

The handoff cases of ``tests/test_serve.py`` run against the port: a
mid-stream swap keeps in-flight generations, a swap changes the greedy
continuation, the watcher skips a corrupt file and recovers, the publisher
prunes but keeps the newest, and ``train_and_publish`` publishes every
round.  Across packages: a round published by either package is served by
both engines with the same greedy tokens and teacher-forced logits within
1e-4 (float32 sums ordered differently, as in ``test_torch_serve.py``),
and ``run_open_loop`` under one fake clock gives the same freshness
trajectory.  The repairs: the decode step promotes mixed dtypes as the
reference's does (bf16 parameters under a float32 compute dtype, 1e-4),
and the ghost-clipping chunk reaches ``ghost_clipped_grad_sum`` (a sigma = 0
round within 1e-5 of the reference's, ``test_torch_decaph.py``'s limit).
"""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.arms as jarms
import repro_torch.arms as arms
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.dp import DPConfig as JDPConfig
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve import handoff as jhandoff
from repro.serve import traffic as jtraffic
from repro.serve.federation import token_silos as jax_token_silos
from repro.serve.federation import transformer_model as jax_transformer_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (
    params_from_jax,
    params_from_tree,
    params_to_numpy,
    params_to_tree,
)
from repro_torch.core import dp
from repro_torch.core import ghost as ghost_lib
from repro_torch.models import transformer as ttf
from repro_torch.serve import cli
from repro_torch.serve import engine as tengine
from repro_torch.serve import traffic as ttraffic
from repro_torch.serve.federation import (
    token_silos,
    train_and_publish,
    transformer_model,
)
from repro_torch.serve.handoff import (
    CheckpointPublisher,
    CheckpointWatcher,
    checkpoint_path,
    list_rounds,
)

torch.set_num_threads(1)

ARCH = "smollm-360m"
STEP_ATOL = 1e-4     # whole decode steps and prefills (test_torch_serve.py)
ROUND_ATOL = 1e-5    # training rounds (test_torch_decaph.py)


def _port_engine(slots=2, max_len=32, temperature=1.0, **kw):
    return tengine.ServeEngine(tengine.ServeConfig(
        slots=slots, max_len=max_len, temperature=temperature,
        device="cpu"), **kw)


def _jax_engine(slots=2, max_len=32, temperature=1.0, **kw):
    return jengine.ServeEngine(jengine.ServeConfig(
        slots=slots, max_len=max_len, temperature=temperature), **kw)


def _request(mod, rid=0, prompt_len=6, gen=8):
    return mod.Request(rid=rid, arrival=0.0,
                       prompt=np.arange(1, prompt_len + 1, dtype=np.int32),
                       max_new_tokens=gen)


def _prompts(n, length, seed):
    return np.random.default_rng(seed).integers(0, 512, (n, length)
                                                ).astype(np.int32)


def _scaled(params: dict, factor: float) -> dict:
    return {k: (_scaled(v, factor) if isinstance(v, dict) else v * factor)
            for k, v in params.items()}


# -- the handoff cases of tests/test_serve.py ---------------------------------


def test_hot_swap_mid_stream_keeps_inflight_generations(tmp_path):
    engine = _port_engine()
    reqs = [_request(ttraffic, rid=i, prompt_len=4, gen=10) for i in range(2)]
    for r in reqs:
        assert not engine.admit(r)
    for _ in range(3):
        engine.step()
    cache = {k: v.data_ptr() for k, v in engine.cache.items()}
    pub = CheckpointPublisher(str(tmp_path))
    watcher = CheckpointWatcher(str(tmp_path))
    pub.publish(5, _scaled(engine.params, 1.01))
    assert engine.poll_watcher(watcher)
    assert engine.serving_round == 5 and engine.swaps == 1
    assert {k: v.data_ptr() for k, v in engine.cache.items()} == cache
    while engine.busy():
        engine.step()
    for r in reqs:
        assert len(r.tokens) == 10        # full budget, across the swap
        assert r.round_at_first == -1     # first token was pre-swap


def test_swap_changes_the_sampled_continuation():
    def run(swap):
        engine = _port_engine(slots=1, temperature=0.0)
        r = _request(ttraffic, rid=0, prompt_len=6, gen=12)
        engine.admit(r)
        if swap:
            engine.set_params(_scaled(engine.params, 0.5), round_idx=1)
        while engine.busy():
            engine.step()
        return r.tokens

    base, swapped = run(False), run(True)
    assert len(base) == len(swapped) == 12
    assert base != swapped


def test_watcher_skips_corrupt_then_recovers(tmp_path, caplog):
    root = str(tmp_path)
    watcher = CheckpointWatcher(root)
    with open(checkpoint_path(root, 1), "wb") as f:
        f.write(b"torn to shreds")
    assert watcher.poll() is None         # skip, do not raise
    assert watcher.seen_round == -1       # not marked seen: retry allowed
    assert "skipping round 1" in caplog.text
    params = ttf.init(get_smoke_config(ARCH), 0, "cpu")
    CheckpointPublisher(root).publish(2, params)
    got = watcher.poll()
    assert got is not None
    tree, round_idx, meta = got
    assert round_idx == 2 and "published_unix" in meta
    # the reference's layout, each leaf in its own dtype
    back = params_from_tree(tree, "cpu")
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(jax.tree_util.tree_leaves(back),
                               jax.tree_util.tree_leaves(params)))
    assert watcher.poll() is None         # nothing newer


def test_publisher_prunes_but_keeps_newest(tmp_path):
    params = ttf.init(get_smoke_config(ARCH), 0, "cpu")
    pub = CheckpointPublisher(str(tmp_path), keep_last=2)
    for t in range(5):
        pub.publish(t, params)
    assert list_rounds(str(tmp_path)) == [3, 4]
    assert pub.published == [0, 1, 2, 3, 4]


def test_train_and_publish_feeds_the_watcher(tmp_path):
    cfg = get_smoke_config(ARCH).replace(
        d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
        vocab_size=64,
    )
    silos = token_silos(cfg, hospitals=2, n_per=12, seq_len=8, seed=0)
    report, pub = train_and_publish(
        "decaph", cfg, str(tmp_path), rounds=3, batch_size=8, seed=0,
        silos=silos, device="cpu",
    )
    assert report.rounds_completed == 3
    assert pub.published == [0, 1, 2]
    assert list_rounds(str(tmp_path)) == [0, 1, 2]

    engine = _port_engine(slots=1, max_len=16, model_cfg=cfg)
    watcher = CheckpointWatcher(str(tmp_path))
    assert engine.poll_watcher(watcher)
    assert engine.serving_round == 2
    for a, b in zip(jax.tree_util.tree_leaves(engine.params),
                    jax.tree_util.tree_leaves(report.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    r = _request(ttraffic, rid=0, prompt_len=4, gen=5)
    engine.admit(r)
    while engine.busy():
        engine.step()
    assert len(r.tokens) == 5


def test_train_and_publish_refuses_an_arm_the_port_lacks(tmp_path):
    cfg = get_smoke_config(ARCH)
    with pytest.raises(KeyError, match="fl"):
        train_and_publish("fl", cfg, str(tmp_path), rounds=1, device="cpu")


# -- across packages ----------------------------------------------------------------


def _serve_both(j, t, prompts, gen):
    """Greedy tokens of both engines, then the teacher-forced logits of every
    step under each engine's (swapped) params, held at STEP_ATOL."""
    ours = tengine.batch_generate(t, prompts, gen)
    ref = jengine.batch_generate(j, prompts, gen)
    np.testing.assert_array_equal(ours, ref)
    b = prompts.shape[0]
    jcfg, tcfg = j.model_cfg, t.model_cfg
    jl, jc = jtf.prefill(jcfg, j.params, jtf.init_cache(jcfg, b, 32),
                         jnp.asarray(prompts))
    tl, tc = ttf.prefill(tcfg, t.params, ttf.init_cache(tcfg, b, 32, "cpu"),
                         torch.from_numpy(prompts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STEP_ATOL,
                               rtol=0)
    for i in range(gen - 1):
        tok = ours[:, i:i + 1].astype(np.int32)
        pos = np.full((b,), prompts.shape[1] + i, np.int32)
        jl, jc = jtf.decode_step_positions(jcfg, j.params, jc,
                                           jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = ttf.decode_step_positions(tcfg, t.params, tc,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=STEP_ATOL, rtol=0)
    return ours


@pytest.mark.parametrize("publisher", ["reference", "port"])
def test_a_published_round_is_served_alike_by_both_engines(tmp_path,
                                                           publisher):
    """One package publishes a round; both engines, started from their own
    seed weights, swap it in through their own watchers and serve it."""
    jcfg = jax_smoke_config(ARCH)
    if publisher == "reference":
        params = jtf.init(jcfg, jax.random.key(1))
        jhandoff.CheckpointPublisher(str(tmp_path)).publish(3, params)
    else:
        params = ttf.init(get_smoke_config(ARCH), 1, "cpu")
        CheckpointPublisher(str(tmp_path)).publish(3, params)
    j = _jax_engine(temperature=0.0)
    t = _port_engine(temperature=0.0)
    assert j.poll_watcher(jhandoff.CheckpointWatcher(str(tmp_path)))
    assert t.poll_watcher(CheckpointWatcher(str(tmp_path)))
    assert j.serving_round == t.serving_round == 3
    # the swapped trees are the same numbers in the same dtypes
    ours = jax.tree_util.tree_leaves(params_to_tree(t.params))
    ref = jax.tree_util.tree_leaves(j.params)
    assert [str(a.dtype).removeprefix("torch.") for a in ours] == \
        [str(b.dtype) for b in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tokens = _serve_both(j, t, _prompts(2, 6, seed=4), 8)
    assert tokens.shape == (2, 8)


def _fake_clock(dt=0.01):
    ticks = itertools.count()
    return lambda: next(ticks) * dt


def _watched_run(mod, engine, publisher, watcher, publish_at):
    reqs = mod.generate_requests(mod.TrafficConfig(
        rate=100.0, n_requests=6, vocab_size=512, prompt_lens=(4, 8),
        gen_lens=(3, 6), seed=3))

    def on_step(i):
        if i in publish_at:
            publisher(publish_at[i])

    return mod.run_open_loop(engine, reqs, watcher=watcher,
                             poll_interval=0.05, on_step=on_step,
                             clock=_fake_clock())


def test_open_loop_freshness_trajectory_matches_reference(tmp_path):
    publish_at = {1: 0, 4: 1, 5: 2}
    j = _jax_engine()
    jpub = jhandoff.CheckpointPublisher(str(tmp_path / "ref"))
    ref = _watched_run(jtraffic, j,
                       lambda r: jpub.publish(r, _scaled(j.params, 1.0)),
                       jhandoff.CheckpointWatcher(str(tmp_path / "ref")),
                       publish_at)
    t = _port_engine()
    tpub = CheckpointPublisher(str(tmp_path / "port"))
    ours = _watched_run(ttraffic, t, lambda r: tpub.publish(r, t.params),
                        CheckpointWatcher(str(tmp_path / "port")),
                        publish_at)

    def trajectory(res):
        return [(s.t, s.n_active, s.queue_depth, s.serving_round,
                 s.latest_round, s.rounds_behind) for s in res.steps]

    assert trajectory(ours) == trajectory(ref)
    assert ours.swaps == ref.swaps >= 2
    assert ours.steps[0].latest_round == -1
    assert ours.steps[-1].serving_round == ours.steps[-1].latest_round == 2
    assert sorted(r.rid for r in ours.completed) == list(range(6))


# -- the CLI, at smoke scale (the number of swaps depends on timing) --------------


def test_cli_serves_while_a_trainer_thread_publishes(tmp_path, capsys):
    out = str(tmp_path / "row.json")
    assert cli.main(["--device", "cpu", "--rate", "50", "--requests", "3",
                     "--slots", "2", "--max-len", "48", "--train-rounds", "2",
                     "--watch", str(tmp_path / "ckpt"), "--json", out]) == 0
    text = capsys.readouterr().out
    assert "trainer: decaph x 2 rounds" in text
    assert list_rounds(str(tmp_path / "ckpt")) == [0, 1]


def test_cli_watches_a_directory_published_elsewhere(tmp_path, capsys):
    params = ttf.init(get_smoke_config(ARCH), 2, "cpu")
    CheckpointPublisher(str(tmp_path)).publish(4, params)
    out = str(tmp_path / "row.json")
    assert cli.main(["--device", "cpu", "--rate", "50", "--requests", "2",
                     "--slots", "2", "--watch", str(tmp_path),
                     "--json", out]) == 0
    with open(out) as f:
        row = json.load(f)
    assert row["swaps"] == 1


# -- repair: the decode step promotes mixed dtypes ---------------------------------


MIXED = dict(param_dtype="bfloat16", compute_dtype="float32")


@pytest.mark.parametrize("kernel", [False, True])
def test_mixed_dtype_prefill_and_decode_match_reference(kernel):
    jcfg = jax_smoke_config(ARCH).replace(use_decode_kernel=kernel, **MIXED)
    tcfg = get_smoke_config(ARCH).replace(use_decode_kernel=kernel, **MIXED)
    jp = jtf.init(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    prompts = _prompts(2, 5, seed=6)
    jl, jc = jtf.prefill(jcfg, jp, jtf.init_cache(jcfg, 2, 16),
                         jnp.asarray(prompts))
    tl, tc = ttf.prefill(tcfg, tp, ttf.init_cache(tcfg, 2, 16, "cpu"),
                         torch.from_numpy(prompts))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=STEP_ATOL,
                               rtol=0)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for i in range(4):
        pos = np.array([5 + i, 3 + i], np.int32)      # rows at their own places
        jl, jc = jtf.decode_step_positions(jcfg, jp, jc, jnp.asarray(tok),
                                           jnp.asarray(pos))
        tl, tc = ttf.decode_step_positions(tcfg, tp, tc,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=STEP_ATOL, rtol=0)
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_mixed_dtype_engines_emit_the_same_greedy_tokens():
    jcfg = jax_smoke_config(ARCH).replace(**MIXED)
    tcfg = get_smoke_config(ARCH).replace(**MIXED)
    jp = jtf.init(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                         device="cpu")
    j = _jax_engine(temperature=0.0, model_cfg=jcfg, params=jp)
    t = _port_engine(temperature=0.0, model_cfg=tcfg, params=tp)
    prompts = _prompts(2, 6, seed=7)
    np.testing.assert_array_equal(tengine.batch_generate(t, prompts, 10),
                                  jengine.batch_generate(j, prompts, 10))


def test_float32_params_under_bf16_compute_decode_in_the_port_only():
    """The deliberate difference (ROADMAP.md): a DeCaPH round leaves float32
    parameters, and the reference refuses to decode them under a bfloat16
    compute dtype (its layer scan's carry would change dtype).  The port
    decodes them, attention in the cache's bfloat16, the same with and
    without the decode kernel."""
    wide = dict(param_dtype="float32", compute_dtype="bfloat16")
    jcfg = jax_smoke_config(ARCH).replace(**wide)
    prompts = _prompts(2, 5, seed=8)
    with pytest.raises(TypeError, match="carry"):
        jtf.prefill(jcfg, jtf.init(jcfg, jax.random.key(0)),
                    jtf.init_cache(jcfg, 2, 16), jnp.asarray(prompts))
    logits = {}
    for kernel in (False, True):
        tcfg = get_smoke_config(ARCH).replace(use_decode_kernel=kernel,
                                              **wide)
        tp = ttf.init(tcfg, 0, "cpu")
        logits[kernel], cache = ttf.prefill(
            tcfg, tp, ttf.init_cache(tcfg, 2, 16, "cpu"),
            torch.from_numpy(prompts))
        assert cache["k"].dtype == torch.bfloat16
    assert torch.isfinite(logits[True]).all()
    assert torch.equal(logits[True], logits[False])


# -- repair: the ghost-clipping chunk reaches the clipped sum ----------------------


def test_chunked_ghost_round_matches_reference(monkeypatch):
    chunk = 4
    jcfg = jax_smoke_config(ARCH).replace(tie_embeddings=False)
    tcfg = get_smoke_config(ARCH).replace(tie_embeddings=False)
    jmodel = jax_transformer_model(jcfg, ghost_chunk=chunk)
    p0 = jax.tree_util.tree_map(np.asarray, jmodel.init_fn(jax.random.key(0)))
    tmodel = transformer_model(tcfg, ghost_chunk=chunk, device="cpu")
    assert tmodel.ghost.chunk_size == chunk
    tmodel = dataclasses.replace(
        tmodel, init_fn=lambda seed: params_from_jax(p0, tcfg, device="cpu"))

    seen = []
    real = ghost_lib.ghost_clipped_grad_sum

    def spy(cfg, params, batch, **kw):
        seen.append((batch["tokens"].shape[0], kw.get("chunk_size")))
        return real(cfg, params, batch, **kw)

    monkeypatch.setattr(ghost_lib, "ghost_clipped_grad_sum", spy)

    def cfg(mod, dpc):
        return mod.ArmConfig(rounds=2, batch_size=12, lr=0.05,
                             use_secagg=False,
                             dp=dpc(clip_norm=1.0, noise_multiplier=0.0))

    ours = arms.run("decaph", tmodel,
                    token_silos(tcfg, hospitals=3, n_per=16, seq_len=12),
                    cfg(arms, dp.DPConfig))
    ref = jarms.run("decaph", jmodel,
                    jax_token_silos(jcfg, hospitals=3, n_per=16, seq_len=12),
                    cfg(jarms, JDPConfig))
    assert seen and all(c == chunk and b > c and b % c == 0
                        for b, c in seen)
    np.testing.assert_allclose([l.loss for l in ours.logs],
                               [l.loss for l in ref.logs], rtol=1e-5)
    diff = max(float(np.max(np.abs(a - np.asarray(b)))) for a, b in zip(
        jax.tree_util.tree_leaves(params_to_numpy(ours.params, tcfg)),
        jax.tree_util.tree_leaves(ref.params)))
    assert diff <= ROUND_ATOL
