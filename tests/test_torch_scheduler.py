"""The port's continuous batcher against the JAX package's.

- The stub-model cases of ``tests/test_scheduler.py``, on the port's batcher
  (``api``/``make_serve_step`` monkeypatched), pin its host-side
  bookkeeping: admit-time retirement, stalls, the injected clock, buckets.
- A stub with the real prefill shape, ``(1, 1, V)``, shows that both
  batchers take the first token from the last *padded* position: the JAX
  batcher indexes ``logits[0, true_len - 1]``, which JAX clamps to row 0.
  The port copies that reference behaviour.
- The bridged fp32 reduced llama through both batchers generates the same
  greedy tokens.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import bridged_llama

from repro.serving import scheduler as jax_sched
from repro_torch.serving import scheduler as sched
from repro_torch.serving.scheduler import SchedulerStalled


class _StubApi:
    """Stands in for ``repro_torch.models.api``: prefill emits logits
    peaked at a scripted first token at every position."""

    def __init__(self, first_token: int, vocab: int = 16):
        self.first_token = first_token
        self.vocab = vocab
        self.prefills = 0
        self.prefill_shapes = []

    def init_cache(self, cfg, num_slots, max_len, device=None):
        return {"len": torch.zeros((), dtype=torch.int32)}

    def prefill(self, params, cfg, max_len, tokens):
        self.prefills += 1
        self.prefill_shapes.append(tuple(tokens.shape))
        logits = torch.zeros((1, tokens.shape[1], self.vocab))
        logits[0, :, self.first_token] = 1.0
        return logits, {"len": torch.zeros((), dtype=torch.int32)}


def _stub_step(cfg):
    # decode: next token = previous + 1 (never EOS for eos_id < first)
    def step(params, tokens, cache):
        return tokens + 1, cache
    return step


class _TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


def _batcher(monkeypatch, first_token, *, eos_id=2, num_slots=2, clock=None,
             stub=None):
    stub = stub or _StubApi(first_token)
    monkeypatch.setattr(sched, "api", stub)
    monkeypatch.setattr(sched, "make_serve_step", _stub_step)
    kwargs = {} if clock is None else {"clock": clock}
    return sched.ContinuousBatcher(None, None, num_slots=num_slots,
                                   max_len=32, eos_id=eos_id, device="cpu",
                                   **kwargs), stub


def test_eos_on_prefill_retires_at_admit(monkeypatch):
    b, stub = _batcher(monkeypatch, first_token=2, eos_id=2)
    for _ in range(3):
        b.submit(np.arange(4), max_new_tokens=8)
    assert b.step() == 0
    assert all(s is None for s in b.slots)
    done = b.run_until_drained()
    assert len(done) == 3
    for r in done:
        assert r.done and r.generated == [2]
        assert r.finished_at > 0.0
    assert stub.prefills == 3


def test_max_new_tokens_one_retires_at_admit(monkeypatch):
    b, _ = _batcher(monkeypatch, first_token=5, eos_id=2)
    b.submit(np.arange(3), max_new_tokens=1)
    (r,) = b.run_until_drained()
    assert r.generated == [5]


def test_retired_admit_frees_slot_for_next_request(monkeypatch):
    b, _ = _batcher(monkeypatch, first_token=2, eos_id=2, num_slots=2)
    for _ in range(5):
        b.submit(np.arange(4), max_new_tokens=4)
    assert b.step() == 0
    assert len(b.finished) == 5 and not b.queue


def test_normal_decode_still_stops_at_eos_and_cap(monkeypatch):
    b, _ = _batcher(monkeypatch, first_token=5, eos_id=2)
    b.submit(np.arange(4), max_new_tokens=3)
    (r,) = b.run_until_drained()
    assert r.generated == [5, 6, 7]


def test_run_until_drained_raises_on_stall(monkeypatch):
    b, _ = _batcher(monkeypatch, first_token=5, eos_id=2)
    b.submit(np.arange(4), max_new_tokens=1)    # retires at admit
    b.submit(np.arange(4), max_new_tokens=10)   # needs 9 decode ticks
    with pytest.raises(SchedulerStalled) as ei:
        b.run_until_drained(max_ticks=3)
    err = ei.value
    assert [r.generated for r in err.drained] == [[5]]
    assert len(err.stranded) == 1 and not err.stranded[0].done
    (r,) = b.run_until_drained()
    assert len(r.generated) == 10


def test_injected_clock_stamps_requests(monkeypatch):
    clock = _TickClock()
    b, _ = _batcher(monkeypatch, first_token=5, eos_id=2, clock=clock)
    uid = b.submit(np.arange(4), max_new_tokens=2)
    (r,) = b.run_until_drained()
    assert r.uid == uid
    assert r.submitted_at == 1.0
    assert r.finished_at == clock.t > r.submitted_at


def test_default_clock_is_wall_time(monkeypatch):
    b, _ = _batcher(monkeypatch, first_token=2, eos_id=2)
    b.submit(np.arange(4))
    (r,) = b.run_until_drained()
    assert abs(r.submitted_at - time.time()) < 60.0


def test_prefill_prompts_are_bucketed(monkeypatch):
    b, stub = _batcher(monkeypatch, first_token=5, eos_id=2, num_slots=2)
    for n in (1, 3, 7, 17, 31, 32):
        b.submit(np.arange(n), max_new_tokens=1)
    b.run_until_drained()
    assert stub.prefills == 6
    assert {s[1] for s in stub.prefill_shapes} == {32}


def test_bucket_len_caps_at_max_len():
    assert sched.PREFILL_BUCKET == jax_sched.PREFILL_BUCKET == 32
    for n, max_len in ((1, None), (32, None), (33, None), (40, 48),
                       (50, 48), (70, 108)):
        assert sched.bucket_len(n, max_len) == \
            jax_sched.bucket_len(n, max_len)
    assert sched.bucket_len(40, max_len=48) == 48
    assert sched.bucket_len(50, max_len=48) == 50


def test_full_sequence_stub_reads_true_last_position(monkeypatch):
    """With full-sequence logits (the JAX scheduler test's stub), the row
    read is ``true_len - 1``."""

    class _PositionStub(_StubApi):
        def prefill(self, params, cfg, max_len, tokens):
            logits = torch.zeros((1, tokens.shape[1], self.vocab))
            logits[0, 4, self.first_token] = 1.0  # true_len=5 -> index 4
            return logits, {"len": torch.zeros((), dtype=torch.int32)}

    b, _ = _batcher(monkeypatch, first_token=7, stub=_PositionStub(7))
    b.submit(np.arange(5), max_new_tokens=1)
    (r,) = b.run_until_drained()
    assert r.generated == [7]


def test_real_prefill_shape_reads_padded_end_in_both_packages(monkeypatch):
    """Reference behaviour the port copies: ``transformer.prefill`` returns
    only the last position, ``(1, 1, V)``, so the JAX batcher's
    ``logits[0, true_len - 1]`` is clamped to row 0, the last *padded*
    position. A stub whose logits peak at ``last input token + 10`` shows
    it: a 5-token prompt padded to 32 ends in PAD (0), so the first token
    is 10, not 15 (its true last token, 5, plus 10)."""
    vocab = 64

    def last_logits(tokens):
        logits = np.zeros((1, 1, vocab), np.float32)
        logits[0, 0, (int(tokens[0, -1]) + 10) % vocab] = 1.0
        return logits

    class _TorchLast(_StubApi):
        def prefill(self, params, cfg, max_len, tokens):
            self.prefill_shapes.append(tuple(tokens.shape))
            return (torch.from_numpy(last_logits(tokens.numpy())),
                    {"len": torch.zeros((), dtype=torch.int32)})

    class _JaxLast:
        def init_cache(self, cfg, num_slots, max_len):
            return {"len": jnp.asarray(0, jnp.int32)}

        def prefill(self, params, cfg, max_len, tokens):
            return (jnp.asarray(last_logits(np.asarray(tokens))),
                    {"len": jnp.asarray(0, jnp.int32)})

    def jax_step(cfg):
        def step(params, tokens, cache):
            return tokens + 1, cache
        return step

    stub = _TorchLast(0, vocab)
    b, _ = _batcher(monkeypatch, 0, stub=stub)
    monkeypatch.setattr(jax_sched, "api", _JaxLast())
    monkeypatch.setattr(jax_sched, "make_serve_step", jax_step)
    jb = jax_sched.ContinuousBatcher(None, None, num_slots=2, max_len=32,
                                     eos_id=2)
    prompts = [np.arange(1, 6), np.arange(1, 33)]
    for p in prompts:
        b.submit(p, max_new_tokens=2)
        jb.submit(p, max_new_tokens=2)
    got = [r.generated for r in b.run_until_drained()]
    want = [r.generated for r in jb.run_until_drained()]
    assert got == want == [[10, 11], [42, 43]]
    assert stub.prefill_shapes == [(1, 32), (1, 32)]


@pytest.mark.parametrize("slots", [2, 1])
def test_llama_tokens_identical_in_both_batchers(slots):
    """Bridged fp32 reduced llama: 6 prompts of 5-70 tokens, 4 new tokens
    each, greedy. Every generated token agrees. With one slot the JAX
    splice leaves the batch cache as it is (the prefill cache has the
    batch cache's shape), and the port copies that too."""
    jcfg, jparams, tcfg, tparams = bridged_llama("float32", seed=7)
    rng = np.random.default_rng(7)
    lens = [5, 70, 12, 33, 48, 64]
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_len = 96 + 4 + 8
    tb = sched.ContinuousBatcher(tparams, tcfg, num_slots=slots,
                                 max_len=max_len, eos_id=-1, device="cpu")
    jb = jax_sched.ContinuousBatcher(jparams, jcfg, num_slots=slots,
                                     max_len=max_len, eos_id=-1)
    for p in prompts:
        tb.submit(p, max_new_tokens=4)
        jb.submit(p, max_new_tokens=4)
    got = {r.uid: r.generated for r in tb.run_until_drained()}
    want = {r.uid: r.generated for r in jb.run_until_drained()}
    assert len(got) == len(prompts)
    assert all(len(g) == 4 for g in got.values())
    assert got == want
    # the batch cache ends as JAX's does: same length bookkeeping
    assert tb._slot_len == jb._slot_len
    assert jax.device_get(jb.cache["len"]) == int(tb.cache["len"])
