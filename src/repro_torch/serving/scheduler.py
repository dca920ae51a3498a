"""Continuous-batching request scheduler (the port of the JAX package's).

Fixed-slot design: a decode batch of ``num_slots`` sequences steps
together; finished or empty slots are refilled from the queue between
steps (prefill of the incoming request, then a copy of its cache into the
slot's row of the batch cache). The semantics are the JAX scheduler's,
including where they are odd: one shared cache length (the longest active
slot), and the first-token read described in ``_admit``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving.decode import make_serve_step

#: prompts right-pad to multiples of this before prefill, as in the JAX
#: scheduler (where it bounds the number of prefill traces)
PREFILL_BUCKET = 32


def bucket_len(n: int, max_len: Optional[int] = None,
               bucket: int = PREFILL_BUCKET) -> int:
    """Sequence length ``n`` rounded up to a bucket multiple, capped at
    ``max_len`` (but never below ``n`` itself)."""
    b = -(-max(n, 1) // bucket) * bucket
    if max_len is not None:
        b = min(b, max(max_len, n))
    return b


@dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 32
    generated: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0


class SchedulerStalled(RuntimeError):
    """``run_until_drained`` hit ``max_ticks`` with work still live.

    ``drained`` are the requests that did finish this drain, ``stranded``
    the in-flight and queued requests left behind (still owned by the
    batcher: a later drain can finish them).
    """

    def __init__(self, max_ticks: int, drained: List[Request],
                 stranded: List[Request]):
        super().__init__(
            f"continuous batcher not drained after {max_ticks} ticks: "
            f"{len(drained)} finished, {len(stranded)} stranded")
        self.drained = drained
        self.stranded = stranded


class ContinuousBatcher:
    """Single-device scheduler over a fixed decode batch, on ``device``
    (default: the card). ``clock`` stamps ``submitted_at``/``finished_at``
    (default ``time.time``; hosts on a virtual clock inject theirs)."""

    def __init__(self, params, cfg: ModelConfig, num_slots: int = 4,
                 max_len: int = 512, eos_id: int = 2,
                 clock: Callable[[], float] = time.time, *, device=None):
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.clock = clock
        self.device = resolve_device(device)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.cache = api.init_cache(cfg, num_slots, max_len,
                                    device=self.device)
        self.tokens = torch.zeros((num_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self._step = make_serve_step(cfg)
        self._uid = 0
        self.finished: List[Request] = []
        self._slot_len = [0] * num_slots

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  max_new_tokens, submitted_at=self.clock()))
        return self._uid

    # -- internals ---------------------------------------------------------

    def _retire(self, req: Request) -> None:
        req.done = True
        req.finished_at = self.clock()
        self.finished.append(req)

    def _splice(self, one_cache, slot: int) -> None:
        """Copy a single-sequence cache into row ``slot`` of the batch
        cache, in place, leaf by leaf: ``k``/``v`` of an attention layer or
        of a shared-block application (hybrid), ``ssm``/``conv`` of a mamba
        layer, each cast to the batch leaf's dtype (a prefill's conv tail
        is in the compute dtype). Copies the JAX splice's rule: a leaf
        whose shape already equals the batch leaf's is left alone, so with
        one slot the prefill cache is not copied in (reference
        behaviour)."""
        for group, lcs in self.cache.items():
            if not isinstance(lcs, list):
                continue
            for lb, lo in zip(lcs, one_cache[group]):
                for key, batch_leaf in lb.items():
                    one_leaf = lo[key]
                    if one_leaf.shape == batch_leaf.shape:
                        continue
                    batch_leaf[slot].copy_(one_leaf[0])

    def _admit(self):
        """Fill empty slots: prefill each incoming prompt and splice its
        cache into the batch cache at the slot index. A request whose
        first token already terminates it (EOS, or ``max_new_tokens``
        reached) retires here, and the slot goes to the next request."""
        for slot in range(self.num_slots):
            if self.slots[slot] is not None:
                continue
            while self.queue:
                req = self.queue.popleft()
                true_len = len(req.prompt)
                blen = bucket_len(true_len, self.max_len)
                ids = np.zeros((1, blen), np.int64)
                ids[0, :true_len] = req.prompt
                logits, cache1 = api.prefill(
                    self.params, self.cfg, self.max_len,
                    tokens=torch.from_numpy(ids).to(self.device))
                # Copies the JAX scheduler: it reads logits[0, true_len-1],
                # but prefill returns only the last position, (1, 1, V), and
                # JAX clamps the out-of-range index to row 0. So the first
                # token comes from the last *padded* position. Clamping the
                # same way keeps the two packages' tokens identical.
                row = min(true_len - 1, logits.shape[1] - 1)
                tok = int(torch.argmax(logits[0, row]))
                req.generated.append(tok)
                if tok == self.eos_id or \
                        len(req.generated) >= req.max_new_tokens:
                    self._retire(req)
                    continue
                self._splice(cache1, slot)
                self.tokens[slot, 0] = tok
                self.slots[slot] = req
                self._slot_len[slot] = true_len
                break

    def _uniform_len(self) -> int:
        """The batch cache tracks one length: the longest active slot."""
        return max(self._slot_len, default=0)

    def step(self) -> int:
        """One scheduler tick: admit, decode one token for every active
        slot, retire finished requests. Returns #active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        # a fill on the device, not a copy from the host: no stream sync
        self.cache["len"] = torch.full((), self._uniform_len(),
                                       dtype=torch.int32, device=self.device)
        tok, self.cache = self._step(self.params, self.tokens, self.cache)
        self.tokens = tok
        host = tok[:, 0].tolist()
        for i in active:
            self._slot_len[i] += 1
            req = self.slots[i]
            t = int(host[i])
            req.generated.append(t)
            if t == self.eos_id or len(req.generated) >= req.max_new_tokens:
                self._retire(req)
                self.slots[i] = None
                self._slot_len[i] = 0
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Step until queue and slots are empty; return the requests
        completed since the last drain. Raises :class:`SchedulerStalled`
        if ``max_ticks`` elapse with requests still queued or in flight."""
        ticks = 0
        while self.queue or any(r is not None for r in self.slots):
            if ticks >= max_ticks:
                done, self.finished = self.finished, []
                stranded = [r for r in self.slots if r is not None] \
                    + list(self.queue)
                raise SchedulerStalled(max_ticks, done, stranded)
            self.step()
            ticks += 1
        done, self.finished = self.finished, []
        return done
