"""repro_torch.serve against the JAX serving tier, on the CPU.

Greedy serving must emit identical tokens from the same parameters and
prompts: the reference's params cross to the port through
``params_from_jax``, both engines decode at temperature 0.  Identical
tokens alone could hide an argmax tie broken by float noise, so the
teacher-forced logits of every step are also held at atol 1e-4 (float32
sums ordered differently, as in ``test_torch_model.py``).  The dispatch
contract mirrors ``tests/test_serve.py``: one counted program call per
steady-state step, two per admission, none per eviction.  The traffic
schedule and the summary row must equal the reference's.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro.serve import metrics as jmetrics
from repro.serve import traffic as jtraffic
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.instrument import jit_dispatches, reset_jit_dispatches
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine
from repro_torch.serve import metrics as tmetrics
from repro_torch.serve import traffic as ttraffic

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine on the same smoke params, greedy, 2 slots.
    Shared by the parity tests: each test leaves every slot free."""
    jcfg = jax_smoke_config("smollm-360m")
    params = jtf.init(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              get_smoke_config("smollm-360m"))
    j = jengine.ServeEngine(jengine.ServeConfig(
        slots=2, max_len=32, temperature=0.0), params=params)
    t = tengine.ServeEngine(tengine.ServeConfig(
        slots=2, max_len=32, temperature=0.0, device="cpu"), params=tparams)
    return j, t


def _prompts(n, length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (n, length)).astype(np.int32)


def _port_engine(slots=2, max_len=32, temperature=1.0):
    return tengine.ServeEngine(tengine.ServeConfig(
        slots=slots, max_len=max_len, temperature=temperature,
        device="cpu"))


def _port_request(rid=0, prompt_len=6, gen=8):
    return ttraffic.Request(rid=rid, arrival=0.0,
                            prompt=np.arange(1, prompt_len + 1,
                                             dtype=np.int32),
                            max_new_tokens=gen)


# -- greedy parity ------------------------------------------------------------


def test_greedy_batch_generate_is_token_identical(engines):
    j, t = engines
    prompts = _prompts(2, 6, seed=0)
    ours = tengine.batch_generate(t, prompts, 10)
    ref = jengine.batch_generate(j, prompts, 10)
    assert ours.shape == (2, 10)
    np.testing.assert_array_equal(ours, ref)


def _churn(engine, mod):
    """Admissions and completions interleave; returns rid -> tokens."""
    prompts = _prompts(4, 6, seed=1)
    reqs = [mod.Request(rid=0, arrival=0.0, prompt=prompts[0, :4],
                        max_new_tokens=3),
            mod.Request(rid=1, arrival=0.0, prompt=prompts[1, :4],
                        max_new_tokens=12)]
    for r in reqs:
        engine.admit(r)
    steps = 0
    while engine.busy():
        done = engine.step()
        steps += 1
        if done and engine.free_slots() and steps < 6:
            r = mod.Request(rid=1 + steps, arrival=0.0, prompt=prompts[2],
                            max_new_tokens=4)
            reqs.append(r)
            engine.admit(r)
    return {r.rid: r.tokens for r in reqs}


def test_churny_admit_step_sequence_is_token_identical(engines):
    j, t = engines
    ours, ref = _churn(t, ttraffic), _churn(j, jtraffic)
    assert len(ours) >= 3
    assert ours == ref


def test_teacher_forced_step_logits_match(engines):
    j, t = engines
    prompts = _prompts(2, 6, seed=2)
    gen = tengine.batch_generate(t, prompts, 6)
    jcfg, tcfg = j.model_cfg, t.model_cfg
    jl, jc = jtf.prefill(jcfg, j.params, jtf.init_cache(jcfg, 2, 32),
                         jnp.asarray(prompts))
    tl, tc = ttf.prefill(tcfg, t.params, ttf.init_cache(tcfg, 2, 32, "cpu"),
                         torch.from_numpy(prompts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for i in range(gen.shape[1] - 1):
        tok = gen[:, i:i + 1].astype(np.int32)
        pos = np.full((2,), prompts.shape[1] + i, np.int32)
        jl, jc = jtf.decode_step_positions(jcfg, j.params, jc,
                                           jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = ttf.decode_step_positions(tcfg, t.params, tc,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        # the greedy token really is the argmax of these logits
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                      gen[:, i + 1])


# -- the dispatch contract ----------------------------------------------------


def test_steady_state_is_one_dispatch_per_step():
    engine = _port_engine(slots=3, max_len=32)
    for i in range(3):
        assert not engine.admit(_port_request(rid=i, prompt_len=4, gen=20))
    reset_jit_dispatches()
    n = 10
    for _ in range(n):
        assert engine.step() == []
    assert jit_dispatches() == n
    assert engine.decode_dispatches == engine.decode_steps == n


def test_admission_costs_exactly_two_dispatches():
    engine = _port_engine(slots=2, max_len=32)
    reset_jit_dispatches()
    engine.admit(_port_request(rid=0, prompt_len=6, gen=8))
    assert jit_dispatches() == 2          # prefill + slot insert
    assert engine.admit_dispatches == 2


def test_eviction_is_dispatch_free():
    engine = _port_engine(slots=1, max_len=32, temperature=0.0)
    engine.admit(_port_request(rid=0, prompt_len=4, gen=2))
    reset_jit_dispatches()
    done = engine.step()                  # budget of 2 reached -> evict
    assert [r.rid for r in done] == [0]
    assert engine.free_slots() == 1
    assert jit_dispatches() == 1          # the decode step itself, nothing more


def test_open_loop_replay_completes_every_budget():
    engine = _port_engine(slots=2, max_len=48)
    reqs = ttraffic.generate_requests(ttraffic.TrafficConfig(
        rate=50.0, n_requests=5, vocab_size=512, prompt_lens=(4, 8),
        gen_lens=(3, 6), seed=3))
    res = ttraffic.run_open_loop(engine, reqs)
    assert sorted(r.rid for r in res.completed) == list(range(5))
    assert all(len(r.tokens) == r.max_new_tokens for r in res.completed)
    assert all(0 <= x < 512 for r in res.completed for x in r.tokens)
    assert res.decode_dispatches == res.decode_steps > 0
    assert res.admit_dispatches == 10


# -- traffic and metrics --------------------------------------------------------


@pytest.mark.parametrize("rate,n,vocab,seed", [(4.0, 5, 512, 0),
                                               (16.0, 16, 49152, 0),
                                               (8.0, 12, 128, 7)])
def test_generate_requests_matches_reference(rate, n, vocab, seed):
    ours = ttraffic.generate_requests(ttraffic.TrafficConfig(
        rate=rate, n_requests=n, vocab_size=vocab, seed=seed))
    ref = jtraffic.generate_requests(jtraffic.TrafficConfig(
        rate=rate, n_requests=n, vocab_size=vocab, seed=seed))
    assert [r.arrival for r in ours] == [r.arrival for r in ref]
    assert [r.max_new_tokens for r in ours] == [r.max_new_tokens for r in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype


def _trace(mod):
    reqs = []
    for i, (arr, first, done, n) in enumerate(
            [(0.0, 0.1, 0.5, 5), (0.2, 0.4, 0.45, 2), (0.3, 0.9, 0.9, 1)]):
        r = mod.Request(rid=i, arrival=arr, prompt=np.zeros(4, np.int32),
                        max_new_tokens=n)
        r.t_admit, r.t_first, r.t_done = first, first, done
        r.tokens = list(range(n))
        reqs.append(r)
    steps = [mod.StepSample(t=0.1 * i, n_active=1 + i % 2, queue_depth=0,
                            serving_round=-1, latest_round=-1)
             for i in range(6)]
    return mod.TraceResult(completed=reqs, steps=steps, wall=1.25, swaps=0,
                           decode_steps=6, decode_dispatches=6,
                           admit_dispatches=6)


def test_summarize_matches_reference():
    ours = tmetrics.summarize(_trace(ttraffic), slots=2, rate=4.0,
                              extra={"arch": "smollm-360m"})
    ref = jmetrics.summarize(_trace(jtraffic), slots=2, rate=4.0,
                             extra={"arch": "smollm-360m"})
    assert ours == ref


# -- devices and imports ----------------------------------------------------------


def test_engine_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.ServeEngine(tengine.ServeConfig())
    assert tengine.ServeEngine(tengine.ServeConfig(device="cpu")).device \
        == torch.device("cpu")


def test_port_imports_no_jax_and_no_reference_module():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.convert\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.arms, repro_torch.core.ghost, repro_torch.core.dp\n"
        "import repro_torch.kernels.ghost_norm, repro_torch.serve.federation\n"
        "import repro_torch.core.accountant, repro_torch.obs.ledger\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
