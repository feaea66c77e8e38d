"""Batched LM serving with continuous batching, the counterpart of the JAX
package's ``repro/serve/engine.py``.

Slot-based: the decode cache is allocated once at (max_batch, max_seq) and
each request owns a slot.  Per tick:

  1. admit queued requests into every free slot: one prefill per request
     (prompts are ragged), right-padded into a power-of-two length bucket,
     writing its k/v straight into its slot of the cache (and, for the
     hybrid family, its SSM and conv states; for the xlstm family, whose
     cache is its recurrent state, every block's state).  Every family
     but the hybrid and xlstm ones pads, unless it has a sliding window:
     a ring or a recurrent state would take the pads in, so those prompts
     prefill at their own length, as in the JAX engine;
  2. one decode step over all ``max_batch`` slots;
  3. retire finished requests (eos, ``max_tokens``, or the cache's end).

Sampling is greedy.  The JAX engine's fixed-arity slot scatter and its
split of static buffers exist for ``jit``; the port runs eagerly and has
neither.  Everything runs under ``torch.inference_mode()``.  A codebook
model (the audio family) is refused, as the JAX engine refuses it: its
requests are frames of n_codebooks tokens, served through ``lm.prefill``
and ``lm.decode_step`` directly.

On a model group (``group=``, ``launch.mesh.Mesh.model``) each rank runs
the engine with its slices of the params (``lm.param_specs``) and its
part of the cache (``lm.init_cache(group=)``); every rank gets the whole
logits, so every rank picks the same tokens and keeps the same slots.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.obs.runlog import LatencyHistogram


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_tokens: int = 16
    eos: int | None = None
    # filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    latency_s: float | None = None  # admit -> retire wall time
    _t_admit: float | None = None


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        buffers,
        *,
        max_batch: int = 8,
        max_seq: int = 256,
        runlog=None,
        group=None,
    ):
        if cfg.n_codebooks:
            raise ValueError(f"{cfg.name}: the engine serves one token stream, not "
                             f"{cfg.n_codebooks} codebooks (use lm.prefill and lm.decode_step)")
        self.cfg = cfg
        self.params = params
        self.buffers = buffers
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.group = group
        self.device = params["ln_f"]["scale"].device
        self.cache = lm.init_cache(cfg, max_batch, max_seq, device=self.device, group=group)
        self.pos = np.zeros((max_batch,), np.int64)
        self.last_token = np.zeros((max_batch,), np.int64)
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.ticks = 0
        self.prefills = 0
        # per-request admit->retire latency at constant memory; optionally
        # logged to a RunLog per retired request and as a final histogram
        self.latency = LatencyHistogram()
        self.runlog = runlog
        # padded prefill is only sound when no cache state is a function of
        # the whole padded sequence: the hybrid family's SSM and the xlstm
        # family's recurrences fold pads into their terminal states, a
        # sliding window rotates the ring by S
        self._pad_prompts = cfg.family not in ("xlstm", "hybrid") and not cfg.sliding_window

    # --- public API ---------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_ticks: int = 1000) -> list[Request]:
        finished = []
        while (self.queue or any(self.slots)) and self.ticks < max_ticks:
            finished.extend(self.tick())
        return finished

    # --- engine internals ----------------------------------------------------

    def _bucket_len(self, S: int) -> int:
        """Smallest power of two >= S (min 2, capped at max_seq)."""
        L = 2
        while L < S:
            L *= 2
        return min(L, self.max_seq)

    def _prefill_one(self, slot: int, tokens: np.ndarray, last_idx: int) -> torch.Tensor:
        """Prefill one prompt (1, L), bucketed or not, into ``slot`` of every
        cache leaf, along each leaf's own batch axis (``lm.cache_batch_axis``);
        returns the logits (1, vocab) at ``last_idx``.  The slot is zeroed
        first, so the rest of an attention cache's slot is as a fresh cache
        would be; the xlstm family's prefill writes every leaf whole (its
        fresh m is -inf, not 0)."""
        axes = lm.cache_batch_axis(self.cfg)
        view = {k: c.narrow(axes[k], slot, 1) for k, c in self.cache.items()}
        for c in view.values():
            c.zero_()
        toks = torch.from_numpy(tokens).to(self.device)
        logits, _ = lm.prefill(self.params, self.buffers, self.cfg, toks, view,
                               last_idx=last_idx, group=self.group)
        self.prefills += 1
        return logits

    def _decode(self) -> torch.Tensor:
        """One decode step over every slot; returns the logits (max_batch,
        vocab)."""
        tokens = torch.from_numpy(self.last_token).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, _ = lm.decode_step(self.params, self.buffers, self.cfg, tokens, pos, self.cache,
                                   group=self.group)
        return logits

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            S = len(req.prompt)
            if S >= self.max_seq:
                raise ValueError(f"prompt of {S} tokens does not fit max_seq {self.max_seq}")
            toks = np.zeros((1, self._bucket_len(S) if self._pad_prompts else S), np.int64)
            toks[0, :S] = req.prompt
            logits = self._prefill_one(slot, toks, S - 1)
            self.slots[slot] = req
            self.pos[slot] = S
            self.last_token[slot] = int(torch.argmax(logits[0][: self.cfg.vocab]))
            req.generated.append(int(self.last_token[slot]))
            req._t_admit = time.perf_counter()

    def tick(self) -> list[Request]:
        with torch.inference_mode():
            self._admit()
            self.ticks += 1
            active = [i for i, r in enumerate(self.slots) if r is not None]
            if not active:
                return []
            nxt = torch.argmax(self._decode(), dim=-1).cpu().numpy()
        finished = []
        for i in active:
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            self.pos[i] += 1
            self.last_token[i] = nxt[i]
            if (
                len(req.generated) >= req.max_tokens
                or (req.eos is not None and nxt[i] == req.eos)
                or self.pos[i] >= self.max_seq - 1
            ):
                req.done = True
                self._retire(req)
                finished.append(req)
                self.slots[i] = None
        return finished

    def _retire(self, req: Request) -> None:
        req.latency_s = time.perf_counter() - req._t_admit
        self.latency.observe(req.latency_s)
        if self.runlog is not None:
            self.runlog.append(
                "request", dedupe=False, uid=req.uid,
                n_prompt=len(req.prompt), n_generated=len(req.generated),
                latency_s=req.latency_s,
            )

    def flush_stats(self) -> dict:
        """Write the aggregate latency histogram to the run log (one
        ``latency_hist`` event per call) and return it."""
        hist = self.latency.to_dict() | {"label": "serve-requests"}
        if self.runlog is not None:
            self.runlog.append("latency_hist", dedupe=False, **hist)
        return hist
