"""Token serving engine: continuous batched greedy decoding behind the
shared :class:`~repro_torch.serve.scheduler.BatchScheduler`, as in the
reference (``repro.serve.engine``).

Serving architecture (same scheduler -> flush -> dispatch shape as the
graph engine)::

    callers ----- submit(prompt, max_new) -> Future ---.
    generate() -- submit_many (sync wrapper) ----------+--> BatchScheduler
                                                           admission queue
                                                               |
                                flush (size >= batch, or oldest request
                                is max_wait_ms old)
                                                               |
                               _run_round: admit up to ``batch`` requests
                               into decode slots, then step the decode
                               loop; a slot that finishes (eos / max_new)
                               is REFILLED mid-round from the queue via
                               take_ready() — slot-reuse admission
                                                               |
                               item.complete(tokens) resolves each Future

Slot reuse is sound because the decode state tracks a per-slot sequence
start (:func:`repro_torch.models.lm.reset_decode_slot`): the recycled
slot's attention masks every cache position before its admission point,
and its recurrent (mamba) state is zeroed. Batch width, cache length and
the start vector keep one shape for the engine's lifetime.

A round ends when every active slot finished and the queue has nothing
admissible; requests whose prompt no longer fits the remaining KV budget
carry over into a fresh round (new cache) inside the same flush. A
sequence still generating when the cache fills is answered with what it
has (``cache_exhausted`` counts these truncations).

Each step copies the token buffer to the device (a copy of a copy: the
buffer is written for the next step while the device may still read this
one) and brings the greedy tokens back with one ``.cpu()``.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.plan_cache import DeviceLike, resolve_device
from ..models import lm
from ..train.step import make_serve_step
from .scheduler import BatchScheduler, WorkItem

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int
    out: Optional[List[int]] = None
    latency_s: Optional[float] = None  # enqueue -> answer (queue wait incl.)


@dataclasses.dataclass
class _Slot:
    """One occupied decode slot of the running round."""

    item: WorkItem
    prompt: List[int]
    max_new: int
    fed: int = 0                # prompt tokens already fed
    emitted: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous-batching greedy-decode server with slot-reuse admission.

    ``params`` must live on ``device`` (``cuda`` unless named)."""

    def __init__(self, cfg: ArchConfig, params, batch: int, max_seq: int,
                 eos_id: int = 0, *, max_wait_ms: float = 2.0,
                 max_pending: int = 256, device: DeviceLike = None):
        self.cfg, self.params = cfg, params
        self.device = resolve_device(device)
        self.batch, self.max_seq, self.eos = batch, max_seq, eos_id
        self.step_fn = make_serve_step(cfg)
        self.scheduler = BatchScheduler(
            self._run_round, max_batch=batch, max_wait_ms=max_wait_ms,
            max_queue=max_pending, name="lm-serve")
        # round counters (mutated only on the scheduler's flush thread)
        self.rounds = 0
        self.steps = 0              # decode-loop iterations (model calls)
        self.tokens_generated = 0
        self.prompt_tokens = 0
        self.slots_reused = 0       # mid-round admissions into freed slots
        self.cache_exhausted = 0    # sequences truncated by the KV budget
        self.total_round_s = 0.0

    # ------------------------------------------------------------ admission
    def submit(self, prompt: Sequence[int], max_new: int, *,
               block: bool = True) -> Future:
        """Admit one request; returns a ``Future`` of the generated tokens.

        Validation raises synchronously; a full queue blocks
        (backpressure) or raises ``QueueFullError`` with ``block=False``.
        """
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if len(prompt) + 1 > self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit the "
                f"max_seq={self.max_seq} KV budget")
        return self.scheduler.submit((prompt, int(max_new)),
                                     block=block).future

    def generate(self, requests: List[Request]) -> List[Request]:
        """Synchronous wrapper: admit every request and wait for all answers."""
        if len(requests) > self.batch:
            raise ValueError(f"{len(requests)} requests for {self.batch} "
                             f"decode slots")
        for r in requests:
            # validate all before admitting any (matches the graph engine)
            if not r.prompt or r.max_new < 1 \
                    or len(r.prompt) + 1 > self.max_seq:
                raise ValueError(f"invalid request: prompt={len(r.prompt)} "
                                 f"tokens, max_new={r.max_new}")
        items = self.scheduler.submit_many(
            [([int(t) for t in r.prompt], int(r.max_new)) for r in requests])
        for r, item in zip(requests, items):
            r.out = item.future.result()
            r.latency_s = item.latency_s
        return requests

    def close(self) -> None:
        """Stop the background scheduler (drains anything still queued)."""
        self.scheduler.stop()

    # ------------------------------------------------------------ decoding
    def _run_round(self, items: List[WorkItem]) -> None:
        """Scheduler flush callback: decode rounds until every item (and
        every mid-round admission) is answered."""
        pending = list(items)
        while pending:
            pending = self._round(pending)

    def _admit(self, slots: List[Optional[_Slot]], slot_idx: int,
               item: WorkItem, tokens: np.ndarray) -> _Slot:
        prompt, max_new = item.payload
        s = _Slot(item=item, prompt=prompt, max_new=max_new, fed=1)
        slots[slot_idx] = s
        tokens[slot_idx, 0] = prompt[0]
        self.prompt_tokens += len(prompt)
        return s

    def _round(self, initial: List[WorkItem]) -> List[WorkItem]:
        """One decode round over a fresh cache; returns carried-over items
        that arrived mid-round but need a fresh cache of their own."""
        t0 = time.perf_counter()
        B, S = self.batch, self.max_seq
        state = lm.track_slot_starts(
            lm.init_decode_state(self.cfg, B, S, device=self.device), B)
        slots: List[Optional[_Slot]] = [None] * B
        tokens = np.zeros((B, 1), np.int32)
        carry: List[WorkItem] = []

        for i, item in enumerate(initial[:B]):
            self._admit(slots, i, item, tokens)
        carry.extend(initial[B:])   # oversized burst: next round's seed

        pos = 0                     # tokens already in the cache
        while any(s is not None for s in slots):
            if pos >= S:
                # KV budget exhausted: answer active slots with what they
                # have (prefill-complete slots only; admission guarantees
                # every admitted prompt finishes prefilling before this)
                for i, s in enumerate(slots):
                    if s is not None:
                        self.cache_exhausted += 1
                        self._finish(slots, i)
                break
            nxt, _, state = self.step_fn(
                self.params, state,
                torch.from_numpy(tokens.copy()).to(self.device))
            self.steps += 1
            pos += 1
            nxt_np: Optional[np.ndarray] = None
            for i, s in enumerate(slots):
                if s is None:
                    continue
                if s.fed < len(s.prompt):       # still prefilling
                    tokens[i, 0] = s.prompt[s.fed]
                    s.fed += 1
                    continue
                if nxt_np is None:
                    nxt_np = nxt.cpu().numpy()
                tok = int(nxt_np[i, 0])
                s.emitted.append(tok)
                self.tokens_generated += 1
                if len(s.emitted) >= s.max_new or tok == self.eos:
                    self._finish(slots, i)
                else:
                    tokens[i, 0] = tok

            # slot-reuse admission: refill freed slots with queued work
            free = [i for i, s in enumerate(slots) if s is None]
            if free and any(s is not None for s in slots) and pos + 2 <= S:
                for item in self.scheduler.take_ready(len(free)):
                    prompt, _ = item.payload
                    if free and pos + len(prompt) + 1 <= S:
                        i = free.pop(0)
                        self._admit(slots, i, item, tokens)
                        state = lm.reset_decode_slot(self.cfg, state, i)
                        self.slots_reused += 1
                    else:           # needs a fresh cache: next round
                        carry.append(item)

        self.rounds += 1
        self.total_round_s += time.perf_counter() - t0
        return carry

    def _finish(self, slots: List[Optional[_Slot]], i: int) -> None:
        s = slots[i]
        slots[i] = None
        s.item.complete(list(s.emitted))

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        s = {f"sched_{k}": v for k, v in self.scheduler.stats().items()}
        s.update(
            rounds=self.rounds,
            steps=self.steps,
            tokens_generated=self.tokens_generated,
            prompt_tokens=self.prompt_tokens,
            slots_reused=self.slots_reused,
            cache_exhausted=self.cache_exhausted,
            total_round_s=self.total_round_s,
            tokens_per_s=(self.tokens_generated / self.total_round_s
                          if self.total_round_s else 0.0),
            # decode-slot utilization: generated tokens per model step,
            # out of `batch` slots stepping each iteration
            slot_utilization=(self.tokens_generated
                              / (self.steps * self.batch)
                              if self.steps else 0.0),
        )
        return s
