"""Continuous-batching serving engine (DESIGN.md §9), in PyTorch.

Counterpart of ``repro.serve.engine``: a fixed-slot decode batch with a
per-slot KV-cache lifecycle.

  * **admit**: a request gets a free slot; its prompt is prefilled by one
    program call (``transformer.prefill``, decode-stepping every prompt
    position) that also samples the first generated token, and one more
    call (the insert) overwrites the slot's whole cache row with the
    prefilled one — every leaf, the recurrent mixers' states included;
  * **decode**: one program call per step for the WHOLE batch —
    ``transformer.decode_step_positions`` advances every slot at its own
    position and the next token is sampled on the device, so a steady
    step is 1 counted call + 1 host sync (the ``[slots]`` next-token
    copy);
  * **evict**: EOS / token budget / context exhaustion frees the slot —
    host bookkeeping only.  Free slots decode a dummy token at position 0
    and nothing reads their output; the next admission overwrites the row.

The reference counts jitted program launches; the port runs eagerly, and
``repro_torch.instrument`` counts calls of the three program functions
instead, so the 1-per-step / 2-per-admission / 0-per-eviction contract
reads the same.  Attention goes through the CUDA decode kernel
(``kernels/decode_attention``) when ``decode_kernel`` is on, as the
reference's ``use_decode_kernel`` routes it through its Pallas kernel.

Sampling runs on the last logits in float32: argmax at temperature 0,
else Gumbel-max (what ``jax.random.categorical`` does) with uniforms from
the engine's ``torch.Generator`` on the device.

Params are just an argument to the decode call: hot-swapping a newly
published federation checkpoint (``poll_watcher`` with a
``handoff.CheckpointWatcher``) between steps changes no shapes and never
touches the KV cache — in-flight generations simply continue under the
new weights.  A swapped-in tree keeps its file's dtypes (float32 after a
DeCaPH round), as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_tree
from repro_torch.device import resolve_device
from repro_torch.instrument import instrumented
from repro_torch.models import transformer as tf
from repro_torch.serve.traffic import Request
from repro_torch.tree import tree_map

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (the model itself comes from ``arch``/``model_cfg``)."""

    arch: str = "smollm-360m"
    slots: int = 4                 # fixed decode-batch width
    max_len: int = 96              # per-slot KV capacity (prompt + generation)
    temperature: float = 1.0       # 0 = greedy
    eos_id: int | None = None      # None = budget-only termination
    seed: int = 0
    smoke: bool = True             # smoke-scale model config
    decode_kernel: bool = True     # route attention through decode_attention
    device: str = "cuda"


@dataclasses.dataclass
class _Slot:
    request: Request
    position: int                  # next KV write index
    token: int                     # last sampled token (next step's input)
    emitted: int                   # generated tokens so far


class ServeEngine:
    """Fixed-slot continuous batching over any decoder-only arch the port
    runs (``transformer.check_supported``)."""

    def __init__(self, cfg: ServeConfig, *, model_cfg=None,
                 params: dict | None = None, round_idx: int = -1) -> None:
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        if model_cfg is None:
            model_cfg = (get_smoke_config(cfg.arch) if cfg.smoke
                         else get_config(cfg.arch))
        if model_cfg.is_encoder_decoder:
            raise ValueError(
                f"{model_cfg.name}: encoder-decoder archs need an encoder "
                "pass per request; the serving tier is decoder-only"
            )
        if cfg.decode_kernel:
            model_cfg = model_cfg.replace(use_decode_kernel=True)
        tf.check_supported(model_cfg)
        self.model_cfg = model_cfg
        self.params = (params if params is not None
                       else tf.init(model_cfg, cfg.seed, self.device))
        self.serving_round = round_idx   # -1 = seed weights
        self.swaps = 0

        self.slots: list[_Slot | None] = [None] * cfg.slots
        self.cache = tf.init_cache(model_cfg, cfg.slots, cfg.max_len,
                                   self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed + 1)
        # engine-local dispatch bookkeeping (the process-global counter in
        # ``repro_torch.instrument`` also ticks)
        self.decode_steps = 0
        self.decode_dispatches = 0
        self.admit_dispatches = 0

        mcfg, temp, max_len, dev = model_cfg, cfg.temperature, cfg.max_len, \
            self.device
        gen = self._gen

        def _sample(logits):
            lg = logits[:, -1].float()
            if temp > 0:
                u = torch.rand(lg.shape, generator=gen, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp_(min=_TINY)))
                return torch.argmax(lg / temp + gumbel, dim=-1).to(torch.int32)
            return torch.argmax(lg, dim=-1).to(torch.int32)

        def decode_fn(params, cache, tokens, positions):
            logits, cache = tf.decode_step_positions(mcfg, params, cache,
                                                     tokens, positions)
            return _sample(logits), cache

        def prefill_fn(params, tokens):
            cache = tf.init_cache(mcfg, 1, max_len, dev)
            logits, cache = tf.prefill(mcfg, params, cache, tokens)
            return _sample(logits), cache

        def insert_fn(cache, slot_cache, slot):
            # every leaf of the cache, K and V and recurrent states alike,
            # has the batch at axis 1: the slot's row is overwritten whole,
            # so an admission inherits nothing of a freed slot's state
            def put(leaf, new):
                leaf[:, slot] = new[:, 0]
                return leaf
            return tree_map(put, cache, slot_cache)

        # one counted call per steady-state decode step; admission costs
        # two (prefill + slot insert)
        self._decode = instrumented(decode_fn)
        self._prefill = instrumented(prefill_fn)
        self._insert = instrumented(insert_fn)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # an async copy from pageable memory stages the data at once and
        # does not wait for the device
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    # -- params / handoff -----------------------------------------------------

    def set_params(self, params: dict, round_idx: int) -> None:
        """Hot-swap weights between decode steps.  In-flight generations
        keep their KV cache and continue under the new params."""
        self.params = params
        self.serving_round = round_idx
        self.swaps += 1
        obs.counter("serve.swaps", 1, round=round_idx)

    def poll_watcher(self, watcher) -> bool:
        """Swap in the newest published checkpoint, if any.  True on swap."""
        got = watcher.poll()
        if got is None:
            return False
        tree, round_idx, _meta = got
        self.set_params(params_from_tree(tree, self.model_cfg, self.device), round_idx)
        return True

    # -- slot lifecycle -------------------------------------------------------

    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    def active_count(self) -> int:
        return sum(s is not None for s in self.slots)

    def busy(self) -> bool:
        return any(s is not None for s in self.slots)

    def admit(self, request: Request, now: float = 0.0) -> bool:
        """Prefill ``request`` into a free slot.  Returns True if the
        request already finished at admission (1-token budget or instant
        EOS) — it then never occupies the slot."""
        if len(request.prompt) + 1 > self.cfg.max_len:
            raise ValueError(
                f"request {request.rid}: prompt of {len(request.prompt)} "
                f"tokens leaves no room to generate within max_len="
                f"{self.cfg.max_len}"
            )
        idx = next(i for i, s in enumerate(self.slots) if s is None)
        tokens = self._to_device(np.asarray(request.prompt, np.int32)[None])
        with obs.span("serve.admit", cat="serve", rid=request.rid,
                      prompt=len(request.prompt), slot=idx):
            tok0, slot_cache = self._prefill(self.params, tokens)
            self.cache = self._insert(self.cache, slot_cache, idx)
            tok0 = int(tok0.cpu()[0])
        self.admit_dispatches += 2
        obs.counter("serve.admits", 1)
        request.t_admit = request.t_first = now
        request.round_at_first = self.serving_round
        request.tokens.append(tok0)
        budget = self._budget(request)
        if tok0 == self.cfg.eos_id or len(request.tokens) >= budget:
            request.t_done = now
            return True
        self.slots[idx] = _Slot(request, position=len(request.prompt),
                                token=tok0, emitted=1)
        return False

    def _budget(self, request: Request) -> int:
        """Generation budget: the request's ask, clamped to KV capacity."""
        return min(request.max_new_tokens,
                   self.cfg.max_len - len(request.prompt))

    def step(self, now: float = 0.0) -> list[Request]:
        """One decode step for the whole batch: 1 call + 1 host sync.
        Returns the requests that finished this step (their slots are
        freed — host bookkeeping only)."""
        tokens = np.zeros((self.cfg.slots, 1), np.int32)
        positions = np.zeros((self.cfg.slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i, 0] = s.token
                positions[i] = s.position
        # span covers the call AND the host sync: together they are the
        # per-token latency the metrics layer reports as TPOT
        with obs.span("serve.decode_step", cat="serve",
                      active=self.active_count()):
            nxt, self.cache = self._decode(
                self.params, self.cache, self._to_device(tokens),
                self._to_device(positions))
            nxt = nxt.cpu().numpy()  # the single per-token host sync
        self.decode_steps += 1
        self.decode_dispatches += 1
        obs.counter("serve.decode_steps", 1)
        finished: list[Request] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok = int(nxt[i])
            s.request.tokens.append(tok)
            s.position += 1
            s.token = tok
            s.emitted += 1
            if (tok == self.cfg.eos_id
                    or s.emitted >= self._budget(s.request)
                    or s.position + 1 > self.cfg.max_len):
                s.request.t_done = now
                finished.append(s.request)
                self.slots[i] = None   # evict: host bookkeeping only
        if finished:
            obs.counter("serve.evictions", len(finished))
        return finished


def batch_generate(engine: ServeEngine, prompts: np.ndarray, gen: int
                   ) -> np.ndarray:
    """Static-batch convenience: admit ``B <= slots`` equal-length prompts,
    decode until every request has ``gen`` tokens.  Returns the generated
    tokens [B, gen]."""
    b = prompts.shape[0]
    if b > engine.cfg.slots:
        raise ValueError(f"{b} prompts > {engine.cfg.slots} slots")
    requests = [
        Request(rid=i, arrival=0.0, prompt=np.asarray(prompts[i], np.int32),
                max_new_tokens=gen)
        for i in range(b)
    ]
    pending = [r for r in requests if not engine.admit(r)]
    while pending:
        done = engine.step()
        pending = [r for r in pending if r not in done]
    return np.stack([np.asarray(r.tokens[:gen], np.int64) for r in requests])
