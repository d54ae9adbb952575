"""Continuous-batching serve engine.

Counterpart of ``repro.serving.engine``.  Fixed decode slots over one
shared ring cache; every slot advances at its own position (vector-pos
``decode_step``), so new requests join the batch the moment a slot frees
up.  A prompt enters either through the decode path (one token a step) or,
with ``block_prefill=True``, through one block-prefill forward of all but
its last token, whose cache is spliced into the slot (on the card that
forward runs the CUDA flash-attention kernel, or for mamba2 the CUDA
``ssd_scan`` kernel, once per layer).

Slot hygiene: on admission every cache entry of the slot is zeroed — k
and v, the conv history and SSM state of mamba2, and the conv history
and RG-LRU state of recurrentgemma (in its pattern and tail stacks).
Attention does not depend on it (the ring mask k_pos <= pos already hides
unwritten slots); the recurrent states do: a reused slot would otherwise
carry its previous request's state.  The cache is updated in place.

An encoder-decoder model is not served here: a request has no field for
the encoder's input, and the JAX package's engine does not feed one
either (its block prefill has no "enc_media", and without block prefill
it decodes against a zeroed cross_kv; ROADMAP caveats).  Such a model
runs through ``prefill`` with its "enc_media" and then ``decode_step``
over the seeded cache, in lockstep.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.admm import resolve_device
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.models.prefill import prefill


def refuse_encoder_decoder(cfg: ModelConfig, what: str) -> None:
    """Raise ``NotImplementedError`` for an encoder-decoder config: ``what``
    would decode its prompt against a cross_kv that no encoder filled."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{what}: {cfg.name} is an encoder-decoder model, and a request "
            "carries no encoder input (the JAX package's engine and "
            "greedy_generate decode against a zeroed cross_kv); run "
            "prefill({'tokens', 'enc_media'}) and decode_step instead "
            "(ROADMAP caveats)")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class FifoEngine:
    """Shared scheduling surface for the serving endpoints: ``submit``
    enqueues a request, ``step()`` resolves one unit of work, ``run()``
    drains the queue, and ``pending`` / ``utilization`` report load."""

    def __init__(self) -> None:
        self.queue: deque = deque()

    def submit(self, req) -> None:
        self.queue.append(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def step(self) -> None:
        raise NotImplementedError

    @property
    def utilization(self) -> float:
        raise NotImplementedError


class ServeEngine(FifoEngine):
    """Greedy decoding of queued requests over ``max_batch`` slots.

    ``device`` defaults to the card (raises without one; pass
    ``device="cpu"`` for the plain path on the CPU); the parameters are
    moved there.  Greedy argmax is over the padded vocabulary, as in the
    JAX package.  An encoder-decoder config raises NotImplementedError
    (module docstring).
    """

    def __init__(self, cfg: ModelConfig, params: model.LM, *,
                 max_batch: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, block_prefill: bool = False,
                 device="cuda"):
        super().__init__()
        refuse_encoder_decoder(cfg, "ServeEngine")
        self.device = resolve_device(None, device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.block_prefill = block_prefill
        self.cache = model.init_cache(cfg, max_batch, max_len,
                                      device=self.device)
        self.pos = np.zeros(max_batch, np.int64)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.completed: Dict[int, Request] = {}

    # -- public API ---------------------------------------------------------

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while (any(self.slots) or self.queue) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

    # -- engine internals ----------------------------------------------------

    def _decode(self, tokens: torch.Tensor, pos: torch.Tensor):
        """One decode step of every slot: (logits (B, V), cache)."""
        return model.decode_step(self.params, self.cache, tokens, pos,
                                 self.cfg)

    def _reset_slot_state(self, b: int) -> None:
        for t, axis in model.cache_leaves(self.cache):
            t.select(axis, b).zero_()

    def _admit(self) -> None:
        for b in range(self.max_batch):
            if self.slots[b] is None and self.queue:
                req = self.queue.popleft()
                self.slots[b] = req
                self.pos[b] = 0
                self._reset_slot_state(b)
                if self.block_prefill and len(req.prompt) > 1:
                    self._prefill_slot(b, req)

    def _prefill_slot(self, b: int, req: Request) -> None:
        """Run the prompt (minus its last token) in one forward and splice
        the resulting single-request cache into slot b."""
        toks = torch.as_tensor(req.prompt[:-1], device=self.device)[None]
        _, solo, _ = prefill(self.params, {"tokens": toks}, self.cfg,
                             self.max_len)
        for (t, axis), (one, _) in zip(model.cache_leaves(self.cache),
                                       model.cache_leaves(solo)):
            t.select(axis, b).copy_(one.select(axis, 0))
        self.pos[b] = len(req.prompt) - 1

    def _current_tokens(self) -> np.ndarray:
        toks = np.zeros(self.max_batch, np.int64)
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            t = self.pos[b]
            if t < len(req.prompt):
                toks[b] = req.prompt[t]
            else:
                toks[b] = req.generated[-1]
        return toks

    def step(self) -> None:
        self._admit()
        if not any(self.slots):
            return
        toks = torch.as_tensor(self._current_tokens(), device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = self._decode(toks, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            t = int(self.pos[b])
            self.pos[b] = t + 1
            if t >= len(req.prompt) - 1:           # prompt consumed -> sample
                tok = int(nxt[b])
                req.generated.append(tok)
                hit_eos = self.eos_id is not None and tok == self.eos_id
                if len(req.generated) >= req.max_new or hit_eos or \
                        self.pos[b] >= self.max_len:
                    req.done = True
                    self.completed[req.rid] = req
                    self.slots[b] = None

    @property
    def utilization(self) -> float:
        return sum(s is not None for s in self.slots) / self.max_batch
