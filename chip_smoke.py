#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from a checkout: ``python3 chip_smoke.py``. Phases, each of which
raises (and so exits non-zero) on failure:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off so fp32 means fp32;
2. build: compile every CUDA kernel of the serving paths from the sources
   in the checkout (one ``nvcc`` per source, all at once);
3. kernels: hold each kernel against its plain PyTorch version on the card
   over the CPU tests' case tables, the serving shapes of every served
   model and the long cases (for the attention kernels also the coming
   slices' shapes, for ``ssd_scan`` zamba2-2.7b's S=512, for ``moe_ffn``
   the table in bf16 too), show that two runs of ``ssd_scan`` and
   ``moe_ffn`` on the same inputs are bit-identical, and time each kernel
   beside its plain version and one library call (where one PyTorch call
   computes the same function): ``ssd_scan`` at every prefill bucket of
   mamba2-370m and of zamba2-2.7b (with L2 flushed at S=96, and with
   C.B^T recomputed per block beside the plan's clusters), ``moe_ffn`` at
   every capacity and at grok-1's expert width, the attention kernels at
   llama3.2-1b's and zamba2-2.7b's serving shapes, also with L2 flushed,
   and the long cases; the MoE router's tie order on the card;
4. models: each reduced model on the card against the same weights on
   the CPU (logits and greedy tokens); then llama3.2-1b, mamba2-370m,
   granite-moe-1b-a400m and zamba2-2.7b, each at its published width and
   depth with seeded random weights: fp32 prefill and decode logits and
   every cache leaf (zamba2's nine shared-block K/V pairs included)
   through the kernels against the plain path (for the MoE model also
   each layer's expert FFN on the inputs the kernel run dispatched, and
   the count of routing decisions that differ between the two runs), a
   bf16 continuous batcher draining 8 requests, with the launch counters
   (zeroed just before, read just after each drain) proving every prefill
   and decode layer went through its kernels, the prefill and decode-tick
   times (host enqueue beside wall), and a ``torch.profiler`` window of
   where host and card time go;
5. backend: ``TorchBackend`` answers 8 medec-shaped ``map`` requests on
   each of the four models.

The line before the last is a JSON object with one entry per kernel
(``launches`` is the sum over the models' drains, ``launches_by_model``
each model's drain count; ``l2_flushed_ms`` and the ``long`` case where
timed; the attention kernels add ``zamba2`` (its serving shape),
``ssd_scan`` ``recompute_ms``, ``by_seq``, ``zamba2`` (S=512) and
``zamba2_by_seq``, ``moe_ffn`` ``by_capacity`` and ``wide``); the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet (dense): HBM rate and peak rates by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# the CPU tests' case tables (tests/test_kernels.py), with torch dtypes
FLASH_CASES = [
    # b, s, h, kv, hd, window, softcap, dtype
    (2, 64, 4, 2, 32, 0, 0.0, "float32"),
    (1, 128, 4, 4, 64, 16, 0.0, "float32"),
    (2, 96, 8, 2, 80, 0, 50.0, "float32"),
    (1, 200, 4, 1, 128, 64, 30.0, "float32"),
    (1, 64, 2, 2, 48, 0, 0.0, "bfloat16"),
    (3, 33, 6, 3, 16, 7, 0.0, "float32"),
]
DECODE_CASES = [
    # b, s, h, kv, hd, valid_len, softcap
    (2, 256, 8, 2, 64, 200, 0.0),
    (1, 512, 4, 4, 128, 512, 30.0),
    (3, 96, 16, 1, 80, 77, 0.0),
    (2, 64, 4, 2, 48, 1, 0.0),
]
# the coming slices' attention shapes, each in fp32 and bf16: granite-34b's
# G = 48, a G of 7, Hd = 80 with G = 1, gemma2's Hd = 256 with
# window 4096 and softcap 50 (S past the window), gemma3's Hd = 128 with
# window 1024 (S past it), and head dims that are not multiples of 16: 40,
# and an odd 33 whose rows take the narrow copies
FLASH_PORT_CASES = [
    # b, s, h, kv, hd, window, softcap
    (1, 80, 48, 1, 128, 0, 0.0),
    (2, 50, 14, 2, 64, 0, 0.0),
    (1, 96, 32, 32, 80, 0, 0.0),
    (1, 4608, 16, 8, 256, 4096, 50.0),
    (1, 2048, 32, 16, 128, 1024, 0.0),
    (2, 70, 8, 2, 40, 0, 0.0),
    (1, 40, 6, 3, 33, 5, 0.0),
]
DECODE_PORT_CASES = [
    # b, s, h, kv, hd, valid_len, softcap
    (2, 300, 48, 1, 128, 257, 0.0),
    (3, 100, 14, 2, 64, 64, 0.0),
    (2, 200, 32, 32, 80, 150, 0.0),
    (1, 4608, 16, 8, 256, 4500, 50.0),
    (2, 2048, 32, 16, 128, 2000, 0.0),
    (2, 130, 8, 2, 40, 97, 0.0),
    (1, 75, 6, 3, 33, 70, 0.0),
    (2, 1024, 8, 2, 64, 40, 0.0),  # most splits start past valid_len
    (1, 300, 96, 1, 128, 280, 0.0),  # G = 96: two bf16 row tiles, three fp32
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def tolerance(ref, dtype: str) -> float:
    """The JAX tolerance; in bf16 scaled by max|ref| where that is below 1,
    so that a case with small outputs (a long, nearly flat softmax) is not
    passed by an absolute limit as large as its outputs."""
    if dtype == "float32":
        return TOL[dtype]
    return TOL[dtype] * min(1.0, ref.float().abs().max().item())

# serving shapes of llama3.2-1b: prefill of one prompt bucketed to 32/64/96
# tokens, decode of 4 slots against a cache of 96 + 8 + 8 positions
MAIN_PREFILL = dict(b=1, h=32, kv=8, hd=64)
MAIN_PREFILL_S = (32, 64, 96)
MAIN_DECODE = dict(b=4, s=112, h=32, kv=8, hd=64, vlen=100)
# the long cases, timed: a 2048-token prompt and an 8192-position cache
LONG_PREFILL = (1, 2048, 32, 8, 64, 0, 0.0)
LONG_DECODE = (1, 8192, 32, 8, 64, 8000, 0.0)
# serving shapes of zamba2-2.7b's shared block: 32 heads over 32 kv heads
# of 80, prefill of one prompt bucketed to 32/64/96 tokens, decode of 4
# slots against a cache of 112 positions
ZAMBA2_PREFILL = dict(b=1, h=32, kv=32, hd=80)
ZAMBA2_DECODE = dict(b=4, s=112, h=32, kv=32, hd=80, vlen=100)
L2_FLUSH_BYTES = 64 * 2 ** 20  # past the H100's 50 MB L2

# tests/test_kernels.py's SSD table, and the serving shapes of mamba2-370m:
# one prompt bucketed to 32/64/96 tokens, chunk = min(256, S) = S
SSD_CASES = [
    # b, s, h, p, g, n, chunk
    (2, 64, 4, 16, 1, 32, 16),
    (1, 128, 8, 32, 2, 16, 32),
    (2, 48, 4, 8, 4, 8, 16),
    (1, 96, 2, 64, 1, 64, 24),
]
MAIN_SSD = dict(b=1, h=32, p=64, g=1, n=128)
MAIN_SSD_S = (32, 64, 96)
# zamba2-2.7b's SSD (80 heads, P=64, N=64): its serving shapes (chunk =
# min(256, S) = S), a 512-token prompt in chunks of 256, and the long
# cases: a 4096-token prompt in chunks of 256, and two groups
ZAMBA2_SSD_SERVE = dict(b=1, h=80, p=64, g=1, n=64)
LONG_SSD = (1, 4096, 32, 64, 1, 128, 256)
ZAMBA2_SSD = (1, 512, 80, 64, 1, 64, 256)
# an odd split count (P=48) at chunk 256: C.B^T tiles staged one by one and
# computed by every block for itself, the plan's last mode
STREAMED_SSD = (1, 512, 32, 48, 1, 128, 256)
SSD_TOL = 5e-4       # tests/test_kernels.py
SSD_TOL_REACH = 25.0  # outputs of that table reach 7.8-27 (CPU tests)


# tests/test_kernels.py's expert-FFN table (fp32, atol 2e-5), and the
# serving shapes of granite-moe-1b-a400m: one group of E=32 experts, D=1024,
# F=512; capacity ceil(S*8*1.25/32) = 10/20/30 for the 32/64/96-token
# prefill buckets and max(4, ...) = 4 for a decode tick of 4 slots
MOE_CASES = [
    # g, e, c, d, f
    (2, 4, 16, 64, 128),
    (1, 8, 100, 32, 300),
    (1, 2, 8, 16, 48),
]
MAIN_MOE = dict(g=1, e=32, d=1024, f=512)
MAIN_MOE_C = (4, 10, 20, 30)
LONG_MOE = dict(g=8, e=32, c=160, d=1024, f=512)  # 4096 tokens, groups of 512
# expert widths whose h does not fit a block's shared memory, so F is cut
# into slabs summed through an fp32 workspace: ragged last slabs in both
# dtypes, and grok-1-314b's width (D=6144, F=32768) at two experts
WIDE_MOE = [
    ((1, 2, 8, 1024, 2600), "float32"),
    ((1, 2, 8, 1024, 5000), "bfloat16"),
    ((1, 1, 4, 6144, 32768), "float32"),
    ((1, 2, 40, 6144, 32768), "bfloat16"),
]


def ssd_tolerance(*refs) -> float:
    """The JAX tests' 5e-4 absolute, which they set on outputs of up to
    about 25. An fp32 sum's rounding grows with the size of its terms, so
    a case whose outputs are larger (the serving and long cases reach
    41-89 on the card) is held to the same relative limit, 5e-4 / 25 =
    2e-5 of max|ref|, not to a wider one."""
    big = max(r.abs().max().item() for r in refs)
    return SSD_TOL * max(1.0, big / SSD_TOL_REACH)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one ``fn()`` call. The calls are captured in a
    CUDA graph and replayed, so the host's launch overhead is not timed."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def time_flushed_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` call with L2 flushed before it: each
    call follows a write of a 64 MB buffer in the same graph, and the
    write's own time, measured alone, is subtracted."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        fn()

    return time_ms(flushed, iters) - time_ms(flush.zero_, iters)


def check_repeat(what: str, fn) -> None:
    """Two calls of ``fn`` on the same inputs give bit-identical outputs:
    every sum of the kernels runs in a fixed order, with no atomics."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not isinstance(first, tuple):
        first, second = (first,), (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"  {what}: two runs bit-identical: {'yes' if same else 'NO'}")
    if not same:
        raise AssertionError(f"{what}: two runs on the same inputs differ")


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(getattr(torch, dtype))


def check_flash(case, gen):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, s, h, kv, hd, window, cap, dtype = case
    q = _rand(gen, (b, s, h, hd), dtype)
    k = _rand(gen, (b, s, kv, hd), dtype)
    v = _rand(gen, (b, s, kv, hd), dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window or None,
                              softcap=cap)
    ref = attention_ref(q, k, v, causal=True, window=window, softcap=cap)
    import torch
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(ref, dtype)
    ok = math.isfinite(err) and err <= tol
    log(f"  flash_attention b={b} s={s} h={h} kv={kv} hd={hd} "
        f"window={window} softcap={cap} {dtype}: max_abs_err={err:.3e} "
        f"tol={tol:.1e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees: {case} err={err}")
    return err, (q, k, v)


def check_decode(case, dtype, gen):
    import torch
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    b, s, h, kv, hd, vlen, cap = case
    q = _rand(gen, (b, 1, h, hd), dtype)
    k = _rand(gen, (b, s, kv, hd), dtype)
    v = _rand(gen, (b, s, kv, hd), dtype)
    valid = torch.tensor([vlen], dtype=torch.int32, device="cuda")
    out = ops.flash_decode(q, k, v, valid, softcap=cap)
    ref = decode_ref(q.reshape(b, kv, h // kv, hd), k, v, vlen, softcap=cap)
    torch.cuda.synchronize()
    err = (out.reshape(ref.shape).float() - ref.float()).abs().max().item()
    tol = tolerance(ref, dtype)
    ok = math.isfinite(err) and err <= tol
    log(f"  flash_decode b={b} s={s} h={h} kv={kv} hd={hd} valid_len={vlen} "
        f"softcap={cap} {dtype}: max_abs_err={err:.3e} tol={tol:.1e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_decode disagrees: {case} {dtype} "
                             f"err={err}")
    return err, (q, k, v, valid)


def time_flash(q, k, v):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, s, h, hd = q.shape
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: attention_ref(q, k, v, causal=True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    try:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    except TypeError:  # a PyTorch without enable_gqa
        lib = None
    esize = q.element_size()
    n_bytes = esize * (2 * q.numel() + k.numel() + v.numel())
    flops = 4.0 * b * h * hd * s * (s + 1) / 2  # causal QK^T and PV
    dtype = str(q.dtype).replace("torch.", "")
    bnd, by = bound_ms(n_bytes, flops, dtype)
    cuda_core = flops / PEAK_FLOPS["float32"] * 1e3
    flushed = time_flushed_ms(lambda: ops.flash_attention(q, k, v,
                                                         causal=True))
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by, l2_flushed_ms=flushed,
                fp32_cuda_core_bound_ms=cuda_core)


def time_decode(q, k, v, valid, vlen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.kernels.flash_decode.ref import decode_ref
    b, _, h, hd = q.shape
    kv = k.shape[2]
    s = k.shape[1]
    ms = time_ms(lambda: ops.flash_decode(q, k, v, valid))
    qg = q.reshape(b, kv, h // kv, hd)
    plain = time_ms(lambda: decode_ref(qg, k, v, valid))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(s, device="cuda") < vlen)[None, None, None, :]
    try:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
    except TypeError:
        lib = None
    esize = q.element_size()
    n_bytes = esize * (2 * q.numel() + 2 * b * vlen * kv * hd) + 4
    flops = 4.0 * b * h * hd * vlen
    dtype = str(q.dtype).replace("torch.", "")
    bnd, by = bound_ms(n_bytes, flops, dtype)
    flushed = time_flushed_ms(lambda: ops.flash_decode(q, k, v, valid))
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                bound_by=by, l2_flushed_ms=flushed,
                n_split=ops.num_splits(b, kv, s))


def _ssd_inputs(gen, b, s, h, p, g, n, dt_scale=1.0):
    """The JAX test's distributions: dt a softplus, A in (-e, -1), B and C
    of std 0.5, D ones."""
    import torch
    import torch.nn.functional as F
    x = _rand(gen, (b, s, h, p), "float32")
    dt = F.softplus(_rand(gen, (b, s, h), "float32")) * dt_scale
    A = -torch.exp(torch.rand((h,), generator=gen, device="cuda"))
    Bm = _rand(gen, (b, s, g, n), "float32") * 0.5
    Cm = _rand(gen, (b, s, g, n), "float32") * 0.5
    D = torch.ones((h,), device="cuda")
    return x, dt, A, Bm, Cm, D


def _ssd_compare(what, y, hf, refs):
    """Max error of (y, final state) against each (y, state, name) of
    ``refs``; raises past ``ssd_tolerance``."""
    import torch
    torch.cuda.synchronize()
    worst = 0.0
    for ry, rh, name in refs:
        err = max((y - ry).abs().max().item(), (hf - rh).abs().max().item())
        tol = ssd_tolerance(ry, rh)
        big = max(ry.abs().max().item(), rh.abs().max().item())
        ok = math.isfinite(err) and err <= tol
        log(f"  ssd_scan {what} vs {name}: max_abs_err={err:.3e} "
            f"tol={tol:.1e} max|ref|={big:.1f} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ssd_scan disagrees: {what} vs {name} "
                                 f"err={err}")
        worst = max(worst, err)
    return worst


def check_ssd(case, gen, *, oracle=False, h0_std=0.0, dt_scale=1.0):
    """The kernel against ``ssd_chunked`` in fp32, the same function in
    fp64 (which says how much of a difference is the kernel's own
    rounding), and the token-by-token oracle ``ssd_ref`` where ``oracle``.
    With ``h0_std`` a nonzero initial state enters, and dt is scaled by
    ``dt_scale`` so that it lasts through the chunk; the state is then
    shown to move the output."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref
    b, s, h, p, g, n, chunk = case
    ins = _ssd_inputs(gen, b, s, h, p, g, n, dt_scale)
    h0 = _rand(gen, (b, h, p, n), "float32") * h0_std if h0_std else None
    y, hf = ops.ssd(*ins, chunk, initial_state=h0)
    yr, hr = ssd_chunked(*ins, chunk, h0)
    y64, h64 = ssd_chunked(*(t.double() for t in ins), chunk,
                           None if h0 is None else h0.double())
    refs = [(yr, hr, "plain"), (y64, h64, "plain fp64")]
    if oracle:
        x, dt, A, Bm, Cm, D = ins
        zero = torch.zeros((b, h, p, n), device="cuda")
        yo, ho = ssd_ref(x.transpose(1, 2), dt.transpose(1, 2), A,
                         Bm.transpose(1, 2), Cm.transpose(1, 2), D,
                         zero if h0 is None else h0)
        refs.append((yo.transpose(1, 2), ho, "oracle"))
    what = (f"b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk}"
            + (" h0" if h0 is not None else ""))
    err = _ssd_compare(what, y, hf, refs)
    if h0 is not None:
        y0, _ = ops.ssd(*ins, chunk)
        moved = (y - y0).abs().max().item()
        log(f"  ssd_scan {what}: the initial state moves y by {moved:.3e}")
        if not moved > 100 * ssd_tolerance(yr, hr):
            raise AssertionError("ssd_scan: initial state has no effect")
    return err, (ins, chunk)


def check_ssd_split(gen):
    """One pass == two halves with the state carried between them
    (tests/test_kernels.py::test_ssd_initial_state_carries), all on the
    kernel; the second half also against the plain version and the
    oracle."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref
    b, s, h, p, g, n, chunk = 1, 64, 2, 8, 1, 16, 16
    ins = _ssd_inputs(gen, b, s, h, p, g, n)
    half = s // 2
    first = [t[:, :half] if t.dim() > 1 else t for t in ins]
    second = [t[:, half:] if t.dim() > 1 else t for t in ins]
    y_full, h_full = ops.ssd(*ins, chunk)
    _, h1 = ops.ssd(*first, chunk)
    y2, h2 = ops.ssd(*second, chunk, initial_state=h1)
    yr, hr = ssd_chunked(*second, chunk, h1)
    x, dt, A, Bm, Cm, D = second
    yo, ho = ssd_ref(x.transpose(1, 2), dt.transpose(1, 2), A,
                     Bm.transpose(1, 2), Cm.transpose(1, 2), D, h1)
    what = f"b={b} s={s} h={h} p={p} g={g} n={n} chunk={chunk} split"
    return _ssd_compare(what, y2, h2, [
        (y_full[:, half:], h_full, "one pass"), (yr, hr, "plain"),
        (yo.transpose(1, 2), ho, "oracle")])


def time_ssd(ins, chunk, flushed=False):
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    x, dt, A, Bm, Cm, D = ins
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    ms = time_ms(lambda: ops.ssd(*ins, chunk))
    pl = ops.plan(p, n, chunk)
    # the same scan with C.B^T computed by every block for itself
    recompute = ops.plan(p, n, chunk, share=False)
    extra = {"cluster": pl.cluster, "recompute_ms": time_ms(
        lambda: ops._launch(*ins, chunk, None, recompute))}
    if flushed:
        extra["l2_flushed_ms"] = time_flushed_ms(lambda: ops.ssd(*ins, chunk))
    plain = time_ms(lambda: ssd_chunked(*ins, chunk))
    n_bytes = 4 * (sum(t.numel() for t in ins) + x.numel() + b * h * p * n)
    nc = s // chunk
    pairs = nc * chunk * (chunk + 1) / 2  # causal (i, j) pairs
    macs = (b * g * pairs * n                 # C.B^T, once per group
            + b * h * pairs * p               # its product with x
            + b * h * (nc - 1) * chunk * n * p  # C.state^T (zero state
                                                # before the first chunk)
            + b * h * nc * chunk * p * n)     # state updates
    bnd, by = bound_ms(n_bytes, 2.0 * macs, "float32")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, blocks=b * h * pl.splits, **extra)


def _moe_inputs(gen, g, e, c, d, f, dtype, scale=None):
    """x and the three expert weights. ``scale=None``: the model's scales
    (a normalised x, fan-in-scaled weights); else the JAX test's (x * 0.5,
    weights * ``scale``)."""
    import torch
    xs, ws = (1.0, (d ** -0.5, d ** -0.5, (e * f) ** -0.5)) if scale is None \
        else (0.5, (scale,) * 3)
    x = (_rand(gen, (g, e, c, d), "float32") * xs).to(getattr(torch, dtype))
    w = [(_rand(gen, shape, "float32") * sc).to(getattr(torch, dtype))
         for shape, sc in zip(((e, d, f), (e, d, f), (e, f, d)), ws)]
    return (x, *w)


def check_moe(case, dtype, gen, *, scale=None, empty_from=None):
    """The kernel against ``expert_ffn_ref`` on the card; with
    ``empty_from`` the capacity rows from that index on are zero, as
    dropped and empty slots are, and must come out zero."""
    import torch
    from repro_torch.kernels.moe_ffn import ops
    from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref
    g, e, c, d, f = case
    ins = _moe_inputs(gen, g, e, c, d, f, dtype, scale)
    if empty_from is not None:
        ins[0][:, :, empty_from:] = 0
    out = ops.expert_ffn(*ins)
    ref = expert_ffn_ref(*ins)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(ref, dtype)
    ok = math.isfinite(err) and err <= tol and bool(torch.isfinite(
        out.float()).all())
    what = f"g={g} e={e} c={c} d={d} f={f} {dtype}"
    if empty_from is not None:
        zero = not out[:, :, empty_from:].any().item()
        ok = ok and zero
        what += f" rows {empty_from}.. zero: {'yes' if zero else 'NO'}"
    log(f"  moe_ffn {what}: max_abs_err={err:.3e} tol={tol:.1e} "
        f"max|ref|={ref.float().abs().max().item():.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"moe_ffn disagrees: {what} err={err}")
    return err, ins


def time_moe(ins):
    from repro_torch.kernels.moe_ffn import ops
    from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref
    x, wg, wu, wd = ins
    g, e, c, d = x.shape
    f = wg.shape[-1]
    ms = time_ms(lambda: ops.expert_ffn(*ins))
    plain = time_ms(lambda: expert_ffn_ref(*ins))
    n_bytes = (2 * x.numel() * x.element_size()
               + sum(w.numel() * w.element_size() for w in (wg, wu, wd)))
    flops = 6.0 * g * e * c * d * f  # two (D,F) products and one (F,D)
    dtype = str(x.dtype).replace("torch.", "")
    bnd, by = bound_ms(n_bytes, flops, dtype)
    pl = ops.plan(g, e, c, d, f, x.dtype)
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by,
                fp32_cuda_core_bound_ms=flops / PEAK_FLOPS["float32"] * 1e3,
                blocks=e * pl.blocks, cluster=pl.nf, row_tile=pl.bm)


def check_router_ties():
    """``router_topk`` on the card: rows of all-equal probabilities (zero
    rows) pick experts 0..k-1, as ``jax.lax.top_k`` does, and rows with
    exact pairwise ties (an identity router) and random rows pick what the
    same call picks on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    # the router alone matters here: experts one wide keep the init small
    cfg = get_config("granite-moe-1b-a400m").replace(moe_d_ff=1,
                                                     param_dtype="float32")
    e, k, d = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((64, d), generator=gen)
    x[:8] = 0
    x[8:16, :e] = torch.randn((8, e // 2), generator=gen).repeat_interleave(
        2, dim=1)
    rnd = moe.MoE(torch.Generator().manual_seed(0), cfg)
    eye = moe.MoE(torch.Generator().manual_seed(0), cfg)
    eye.router.data = torch.eye(d, e)
    picks = {}
    for dev in ("cpu", "cuda"):
        picks[dev] = [moe.router_topk(p.to(dev), cfg, x.to(dev))[0].cpu()
                      for p in (eye, rnd)]
    ok = (bool((picks["cuda"][0][:8] == torch.arange(k)).all())
          and torch.equal(picks["cuda"][0], picks["cpu"][0])
          and torch.equal(picks["cuda"][1], picks["cpu"][1]))
    log(f"  router_topk on the card: zero rows pick experts "
        f"{picks['cuda'][0][0].tolist()}, tied and random rows as on the "
        f"CPU: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"router tie order differs: {picks}")


def phase_attention(gen, note):
    """The two attention kernels against their plain versions over the CPU
    tests' tables, the coming slices' shapes, llama3.2-1b's and
    zamba2-2.7b's serving shapes and the long cases; then their times.
    Returns (serving times, with zamba2's under ``"zamba2"``, long
    times)."""
    log("  attention: the CPU tests' tables, the coming slices' shapes (fp32 "
        "and bf16), the serving shapes and the long cases")
    for case in FLASH_CASES:
        note("flash_attention", check_flash(case, gen)[0])
    for case in DECODE_CASES:
        for dtype in ("float32", "bfloat16"):
            note("flash_decode", check_decode(case, dtype, gen)[0])
    for dtype in ("float32", "bfloat16"):
        for case in FLASH_PORT_CASES:
            note("flash_attention", check_flash((*case, dtype), gen)[0])
        for case in DECODE_PORT_CASES:
            note("flash_decode", check_decode(case, dtype, gen)[0])
    # per model, the bf16 inputs of its largest prefill bucket and of its
    # decode tick (the last dtype of the loop), timed below
    prefill_in, decode_in = {}, {}
    for dtype in ("float32", "bfloat16"):
        for model, p, d in (("llama", MAIN_PREFILL, MAIN_DECODE),
                            ("zamba2", ZAMBA2_PREFILL, ZAMBA2_DECODE)):
            for s in MAIN_PREFILL_S:
                err, prefill_in[model] = check_flash(
                    (p["b"], s, p["h"], p["kv"], p["hd"], 0, 0.0, dtype),
                    gen)
                note("flash_attention", err)
            err, decode_in[model] = check_decode(
                (d["b"], d["s"], d["h"], d["kv"], d["hd"], d["vlen"], 0.0),
                dtype, gen)
            note("flash_decode", err)
    log("  long cases")
    note("flash_attention", check_flash((*LONG_PREFILL, "float32"),
                                        gen)[0])
    err, long_flash = check_flash((*LONG_PREFILL, "bfloat16"), gen)
    note("flash_attention", err)
    note("flash_decode", check_decode(LONG_DECODE, "float32", gen)[0])
    err, long_decode = check_decode(LONG_DECODE, "bfloat16", gen)
    note("flash_decode", err)

    log("  attention timing, bf16, CUDA graph replay (l2_flushed_ms: each "
        "call after a 64 MB write, whose own time is subtracted)")
    times = {"flash_attention": time_flash(*prefill_in["llama"]),
             "flash_decode": time_decode(*decode_in["llama"],
                                         MAIN_DECODE["vlen"])}
    zamba2 = {"flash_attention": time_flash(*prefill_in["zamba2"]),
              "flash_decode": time_decode(*decode_in["zamba2"],
                                          ZAMBA2_DECODE["vlen"])}
    long_times = {"flash_attention": time_flash(*long_flash),
                  "flash_decode": time_decode(*long_decode, LONG_DECODE[5])}
    log(f"  flash_attention S=96: {json.dumps(times['flash_attention'])}")
    log(f"  flash_decode S=112 valid_len={MAIN_DECODE['vlen']}: "
        f"{json.dumps(times['flash_decode'])}")
    log(f"  flash_attention zamba2-2.7b B=1 S=96 H=32 K=32 Hd=80: "
        f"{json.dumps(zamba2['flash_attention'])}")
    log(f"  flash_decode zamba2-2.7b B=4 S=112 valid_len="
        f"{ZAMBA2_DECODE['vlen']} H=32 K=32 Hd=80: "
        f"{json.dumps(zamba2['flash_decode'])}")
    for name, t in zamba2.items():
        times[name]["zamba2"] = {key: t[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "l2_flushed_ms")}
    log(f"  flash_attention long B=1 S=2048 H=32 K=8 Hd=64: "
        f"{json.dumps(long_times['flash_attention'])}")
    log(f"  flash_decode long B=1 S=8192 valid_len={LONG_DECODE[5]} H=32 K=8 "
        f"Hd=64: {json.dumps(long_times['flash_decode'])}")
    return times, long_times


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"flash_attention": 0.0, "flash_decode": 0.0, "ssd_scan": 0.0,
            "moe_ffn": 0.0}

    def note(name, err):
        errs[name] = max(errs[name], err)

    log("phase 3: kernels vs plain versions on the card")
    t_attn, t_attn_long = phase_attention(gen, note)

    log("  ssd_scan: the CPU tests' table against the plain version and "
        "the oracle")
    for case in SSD_CASES:
        note("ssd_scan", check_ssd(case, gen, oracle=True)[0])
    note("ssd_scan", check_ssd_split(gen))
    m = MAIN_SSD
    note("ssd_scan", check_ssd((m["b"], 96, m["h"], m["p"], m["g"], m["n"],
                                96), gen, h0_std=1.0, dt_scale=0.05)[0])
    main_ssd, zamba2_serve = {}, {}
    z = ZAMBA2_SSD_SERVE
    for s in MAIN_SSD_S:
        err, main_ssd[s] = check_ssd(
            (m["b"], s, m["h"], m["p"], m["g"], m["n"], s), gen)
        note("ssd_scan", err)
        err, zamba2_serve[s] = check_ssd(
            (z["b"], s, z["h"], z["p"], z["g"], z["n"], s), gen)
        note("ssd_scan", err)
    log("  ssd_scan long cases and zamba2-2.7b's S=512")
    err, long_ssd = check_ssd(LONG_SSD, gen)
    note("ssd_scan", err)
    note("ssd_scan", check_ssd((1, 512, m["h"], m["p"], 2, m["n"], 256),
                               gen)[0])
    err, zamba2_ssd = check_ssd(ZAMBA2_SSD, gen)
    note("ssd_scan", err)
    note("ssd_scan", check_ssd(STREAMED_SSD, gen)[0])
    note("ssd_scan", check_ssd(STREAMED_SSD, gen, h0_std=1.0,
                               dt_scale=0.05)[0])
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    for what, (ins, chunk) in (("S=96", main_ssd[96]), ("long", long_ssd)):
        check_repeat(f"ssd_scan {what}",
                     lambda: ssd_ops.ssd(*ins, chunk))

    log("  moe_ffn: the CPU tests' table (fp32), an odd width, the serving "
        "shapes (fp32 and bf16), empty rows, and the long case")
    for dtype in ("float32", "bfloat16"):
        for case in MOE_CASES + [(1, 3, 7, 33, 40)]:
            note("moe_ffn", check_moe(case, dtype, gen, scale=0.1)[0])
    m = MAIN_MOE
    main_moe = {}
    for dtype in ("float32", "bfloat16"):
        for c in MAIN_MOE_C:
            err, ins = check_moe((m["g"], m["e"], c, m["d"], m["f"]), dtype,
                                 gen)
            note("moe_ffn", err)
            if dtype == "bfloat16":
                main_moe[c] = ins
    note("moe_ffn", check_moe((m["g"], m["e"], 30, m["d"], m["f"]),
                              "bfloat16", gen, empty_from=17)[0])
    note("moe_ffn", check_moe((1, 4, 16, 64, 128), "float32", gen,
                              scale=0.1, empty_from=5)[0])
    lm = LONG_MOE
    long_case = (lm["g"], lm["e"], lm["c"], lm["d"], lm["f"])
    note("moe_ffn", check_moe(long_case, "float32", gen)[0])
    err, long_moe = check_moe(long_case, "bfloat16", gen)
    note("moe_ffn", err)
    log("  moe_ffn wide expert widths (F cut into slabs)")
    for case, dtype in WIDE_MOE:
        err, wide_moe = check_moe(case, dtype, gen)
        note("moe_ffn", err)
    from repro_torch.kernels.moe_ffn import ops as moe_ops
    for what, ins in (("G=1 C=30 bf16", main_moe[30]),
                      ("long bf16", long_moe), ("wide F bf16", wide_moe)):
        check_repeat(f"moe_ffn {what}", lambda: moe_ops.expert_ffn(*ins))
    check_router_ties()

    log("  timing at the serving shapes (bf16 expert FFN, fp32 SSD; CUDA "
        "graph replay)")
    log("  ssd_scan (no single PyTorch call computes an SSD scan: "
        "library_ms null)")
    t_ssd_s = {}
    for s, (ins, chunk) in main_ssd.items():
        t_ssd_s[s] = time_ssd(ins, chunk, flushed=s == max(MAIN_SSD_S))
        log(f"  ssd_scan S={s} chunk {chunk}: {json.dumps(t_ssd_s[s])}")
    t_zamba2 = {}
    for s, (ins, chunk) in zamba2_serve.items():
        t_zamba2[s] = time_ssd(ins, chunk)
        log(f"  ssd_scan zamba2-2.7b B=1 S={s} H=80 P=64 N=64 chunk {chunk}: "
            f"{json.dumps(t_zamba2[s])}")
    t_ssd = {**t_ssd_s[max(MAIN_SSD_S)],
             "by_seq": {s: t["ms"] for s, t in t_ssd_s.items()},
             "zamba2": time_ssd(*zamba2_ssd),
             "zamba2_by_seq": {s: {key: t[key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by")}
                 for s, t in t_zamba2.items()}}
    log(f"  ssd_scan zamba2-2.7b B=1 S=512 H=80 P=64 N=64 chunk 256: "
        f"{json.dumps(t_ssd['zamba2'])}")
    log("  moe_ffn (no single PyTorch call computes a per-expert SwiGLU: "
        "library_ms null)")
    t_moe = {}
    for c, ins in main_moe.items():
        t_moe[c] = time_moe(ins)
        log(f"  moe_ffn G=1 E=32 C={c} D=1024 F=512 bf16: "
            f"{json.dumps(t_moe[c])}")
    t_long = time_moe(long_moe)
    t_wide = time_moe(wide_moe)
    log(f"  moe_ffn wide G=1 E=2 C=40 D=6144 F=32768 bf16: "
        f"{json.dumps(t_wide)}")
    log(f"  moe_ffn long G=8 E=32 C=160 D=1024 F=512 bf16: "
        f"{json.dumps(t_long)}")
    t_moe_main = {**t_moe[4], "by_capacity": {c: t["ms"]
                                              for c, t in t_moe.items()},
                  "wide": {key: t_wide[key] for key in (
                      "ms", "plain_ms", "bound_ms", "bound_by")}}
    return errs, {**t_attn, "ssd_scan": t_ssd, "moe_ffn": t_moe_main}, \
        {**t_attn_long, "moe_ffn": t_long}


# ---------------------------------------------------------------------------
# phase 4: the full-width model
# ---------------------------------------------------------------------------


class _PlainAttention:
    """Routes the attention model's two kernel call sites to the plain
    versions, to compare the kernel path with the plain path on the same
    card."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention.ref import attention_ref
        from repro_torch.kernels.flash_decode.ref import decode_ref
        from repro_torch.models import attention as A

        class _FA:
            @staticmethod
            def flash_attention(q, k, v, *, causal, window, softcap):
                return attention_ref(q, k, v, causal=causal,
                                     window=int(window or 0), softcap=softcap)

        class _FD:
            @staticmethod
            def flash_decode(q, k, v, valid_len, *, softcap):
                b, _, h, hd = q.shape
                kv = k.shape[2]
                out = decode_ref(q.reshape(b, kv, h // kv, hd), k, v,
                                 valid_len, softcap=softcap)
                return out.reshape(b, 1, h, hd)

        self._A = A
        self._saved = (A.flash_ops, A.fd_ops)
        A.flash_ops, A.fd_ops = _FA, _FD
        return self

    def __exit__(self, *exc):
        self._A.flash_ops, self._A.fd_ops = self._saved
        return False


class _PlainSSD:
    """Routes the mamba block's kernel call site to ``ssd_chunked``."""

    def __enter__(self):
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked
        from repro_torch.models import ssm as S

        class _Ops:
            @staticmethod
            def ssd(x, dt, A, Bm, Cm, D, chunk, initial_state=None):
                return ssd_chunked(x, dt, A, Bm, Cm, D, chunk, initial_state)

        self._S = S
        self._saved = S.ssd_ops
        S.ssd_ops = _Ops
        return self

    def __exit__(self, *exc):
        self._S.ssd_ops = self._saved
        return False


class _PlainMoE:
    """Routes the MoE layer's kernel call site to ``expert_ffn_ref``."""

    def __enter__(self):
        from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref
        from repro_torch.models import moe as M

        class _Ops:
            @staticmethod
            def expert_ffn(x, w_gate, w_up, w_down):
                return expert_ffn_ref(x, w_gate, w_up, w_down)

        self._M = M
        self._saved = M.moe_ops
        M.moe_ops = _Ops
        return self

    def __exit__(self, *exc):
        self._M.moe_ops = self._saved
        return False


@contextlib.contextmanager
def _plain_attention_moe():
    with _PlainAttention(), _PlainMoE():
        yield


@contextlib.contextmanager
def _plain_attention_ssd():
    with _PlainAttention(), _PlainSSD():
        yield


class _RecordMoE:
    """Records, per MoE layer call, the routing (``assign``) and the expert
    FFN's inputs and output, calling through to whatever the call sites
    route to."""

    def __enter__(self):
        from repro_torch.models import moe as M
        self._M = M
        self._saved = (M.moe_ops, M.router_topk)
        self.assign, self.ffn = [], []
        ops, topk = self._saved
        rec = self

        class _Ops:
            @staticmethod
            def expert_ffn(*args):
                out = ops.expert_ffn(*args)
                rec.ffn.append((args, out))
                return out

        def router_topk(params, cfg, x):
            out = topk(params, cfg, x)
            rec.assign.append(out[0])
            return out

        M.moe_ops, M.router_topk = _Ops, router_topk
        return self

    def __exit__(self, *exc):
        self._M.moe_ops, self._M.router_topk = self._saved
        return False


# per model: the context that routes it to plain versions, and the kernel
# launches a drain of n_req requests over `ticks` decode ticks must show,
# from the model's config
MODELS = {
    "llama3.2-1b": (_PlainAttention, lambda cfg, n_req, ticks: {
        "flash_attention": cfg.num_layers * n_req,
        "flash_decode": cfg.num_layers * ticks, "ssd_scan": 0,
        "moe_ffn": 0}),
    "mamba2-370m": (_PlainSSD, lambda cfg, n_req, ticks: {
        "flash_attention": 0, "flash_decode": 0,
        "ssd_scan": cfg.num_layers * n_req, "moe_ffn": 0}),
    "granite-moe-1b-a400m": (
        _plain_attention_moe, lambda cfg, n_req, ticks: {
            "flash_attention": cfg.num_layers * n_req,
            "flash_decode": cfg.num_layers * ticks, "ssd_scan": 0,
            "moe_ffn": cfg.num_layers * (n_req + ticks)}),
    # 54 mamba layers (ssd_scan in prefill, no kernel in decode) and 9
    # applications of the shared attention block, one after each full
    # period; counted from the config, not from the port's own layout
    "zamba2-2.7b": (_plain_attention_ssd, lambda cfg, n_req, ticks: {
        "flash_attention": cfg.num_layers // cfg.hybrid_attn_every * n_req,
        "flash_decode": cfg.num_layers // cfg.hybrid_attn_every * ticks,
        "ssd_scan": cfg.num_layers * n_req, "moe_ffn": 0}),
}


def _kernel_ops():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.moe_ffn import ops as moe
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {"flash_attention": fa, "flash_decode": fd, "ssd_scan": ssd,
            "moe_ffn": moe}


def _reset_counts():
    for mod in _kernel_ops().values():
        mod.launches = 0


def _counts():
    return {name: mod.launches for name, mod in _kernel_ops().items()}


def check_small_model(arch):
    """The reduced model (fp32, seed 0) on the card, through the kernels,
    against the same weights on the CPU, through the plain versions:
    logits within 1e-4, and the same greedy tokens from the batcher."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.scheduler import ContinuousBatcher

    cfg = get_config(arch, reduced=True).replace(
        dtype="float32", param_dtype="float32")
    on_cpu = api.init_params(0, cfg, device="cpu")
    on_card = api.init_params(0, cfg, device="cpu").to("cuda")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, 40)))
    ref, _ = api.forward(on_cpu, cfg, tokens=toks)
    out, _ = api.forward(on_card, cfg, tokens=toks.cuda())
    err = (out.cpu() - ref).abs().max().item()
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 40, 70, 17)]
    generated = []
    for params, device in ((on_cpu, "cpu"), (on_card, "cuda")):
        b = ContinuousBatcher(params, cfg, num_slots=2, max_len=108,
                              eos_id=-1, device=device)
        for p in prompts:
            b.submit(p, max_new_tokens=4)
        generated.append({r.uid: r.generated for r in b.run_until_drained()})
    log(f"  reduced fp32 {arch}, card (kernels) vs CPU (plain): logits "
        f"max_abs_err={err:.3e} (atol 1e-4); greedy tokens "
        f"{'identical' if generated[0] == generated[1] else 'DIFFER'}")
    if not (err <= 1e-4 and generated[0] == generated[1]
            and len(generated[0]) == len(prompts)):
        raise AssertionError(f"reduced {arch} disagrees: err={err} "
                             f"{generated}")


def _check_fp32(arch, full):
    """fp32 at published width: prefill logits, every cache leaf (each
    layer's K/V, or its SSD state and conv tail, and each shared-block
    application's K/V) and the next decode logits, through the kernels
    against the plain path, atol 1e-3. Also the kernel launches of one
    prefill and of one decode step.

    For an MoE model a difference of ~1e-6 between kernel and plain
    version can flip a near-tied top-k choice, and every later layer then
    differs. So each MoE layer's expert FFN is held against the plain
    version on exactly the inputs the kernel run dispatched, at the fp32
    limit; the routing decisions of the two runs are counted; and the
    logits are compared only where none differ."""
    import numpy as np
    import torch
    from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref
    from repro_torch.models import api
    from repro_torch.models.transformer import count_params

    plain, want = MODELS[arch]
    cfg32 = full.replace(dtype="float32", param_dtype="float32")
    t0 = time.perf_counter()
    params = api.init_params(0, cfg32)
    torch.cuda.synchronize()
    log(f"  fp32 init: {count_params(params)} params in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(3, full.vocab_size, (2, 96))).cuda()
    with _RecordMoE() as rec_k:
        _reset_counts()
        logits_k, cache_k = api.prefill(params, cfg32, 112, tokens=toks)
        torch.cuda.synchronize()
        pre = _counts()
        nxt = torch.argmax(logits_k[:, -1], dim=-1,
                           keepdim=True).to(torch.int32)
        _reset_counts()
        dec_k, _ = api.decode_step(params, cfg32, nxt, cache_k)
        torch.cuda.synchronize()
        dec = _counts()
    with plain(), _RecordMoE() as rec_p:
        logits_p, cache_p = api.prefill(params, cfg32, 112, tokens=toks)
        dec_p, _ = api.decode_step(params, cfg32, nxt, cache_p)
    torch.cuda.synchronize()

    if rec_k.ffn:
        worst, big = 0.0, 0.0
        for args, out in rec_k.ffn:
            ref = expert_ffn_ref(*args)
            err = (out - ref).abs().max().item()
            tol = tolerance(ref, "float32")
            if not (math.isfinite(err) and err <= tol):
                raise AssertionError(f"moe_ffn disagrees in the model: "
                                     f"input {tuple(args[0].shape)} "
                                     f"err={err}")
            worst = max(worst, err)
            big = max(big, ref.abs().max().item())
        shapes = sorted({tuple(a[0].shape) for a, _ in rec_k.ffn})
        log(f"  fp32 expert FFN per MoE layer, kernel vs plain on the inputs "
            f"the kernel run dispatched ({len(rec_k.ffn)} calls, x "
            f"{shapes}): max_abs_err={worst:.3e} (tol 2e-5, max|ref| "
            f"{big:.3e})")
        n_diff = sum(int((a != b).sum())
                     for a, b in zip(rec_k.assign, rec_p.assign))
        n_all = sum(a.numel() for a in rec_k.assign)
        log(f"  routing: {n_diff} of {n_all} (layer, token, choice) "
            f"decisions differ between the kernel and the plain run")
        if n_diff:
            log(f"  {arch}: routing differs, so the fp32 logits and caches "
                f"of the two runs are not compared")
    else:
        n_diff = 0
    if not n_diff:
        err_pre = (logits_k - logits_p).abs().max().item()
        err_dec = (dec_k - dec_p).abs().max().item()
        err_cache, big, leaves = 0.0, 0.0, []
        groups = [g for g, lcs in cache_p.items() if isinstance(lcs, list)]
        assert groups == [g for g, lcs in cache_k.items()
                          if isinstance(lcs, list)]
        for group in groups:
            assert len(cache_k[group]) == len(cache_p[group])
            for lk, lp in zip(cache_k[group], cache_p[group]):
                for key in lk:
                    err_cache = max(err_cache,
                                    (lk[key] - lp[key]).abs().max().item())
                    big = max(big, lp[key].abs().max().item())
                    leaves.append(f"{group}.{key}")
        kinds = {k: leaves.count(k) for k in sorted(set(leaves))}
        log(f"  fp32 prefill logits, kernels vs plain: "
            f"max_abs_err={err_pre:.3e}; cache leaves {kinds}: "
            f"{err_cache:.3e} (max|ref| {big:.3e}); decode logits: "
            f"{err_dec:.3e} (atol 1e-3)")
        if not (err_pre <= 1e-3 and err_dec <= 1e-3 and err_cache <= 1e-3):
            raise AssertionError(f"full-width fp32 {arch} disagrees: "
                                 f"{err_pre} {err_cache} {err_dec}")
    want_pre, want_dec = want(full, 1, 0), want(full, 0, 1)
    log(f"  launches: prefill {pre}, decode step {dec}")
    if pre != want_pre or dec != want_dec:
        raise AssertionError(f"launches {pre} {dec} != {want_pre} "
                             f"{want_dec}")


def phase_model(arch):
    """``arch`` at its published width: the fp32 check, then a bf16
    continuous batcher draining 8 requests with the launch counters
    zeroed just before and read just after, per-unit times and a profile.
    Returns (bf16 params, drain launches, times)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.decode import make_serve_step
    from repro_torch.serving.scheduler import ContinuousBatcher

    log(f"  {arch} at published width, random weights (seed 0)")
    full = get_config(arch)
    _check_fp32(arch, full)
    torch.cuda.empty_cache()

    params = api.init_params(0, full)  # bf16
    rng = np.random.default_rng(0)
    n_req, new_tokens, slots, max_len = 8, 8, 4, 112
    lens = rng.integers(17, 97, n_req)
    lens[0] = 96
    prompts = [rng.integers(3, full.vocab_size, n).astype(np.int32)
               for n in lens]
    # warm-up drain (first-call costs: kernel load, allocator, cuBLAS)
    warm = ContinuousBatcher(params, full, num_slots=slots, max_len=max_len,
                             eos_id=-1)
    warm.submit(prompts[0], max_new_tokens=2)
    warm.run_until_drained()
    del warm

    batcher = ContinuousBatcher(params, full, num_slots=slots,
                                max_len=max_len, eos_id=-1)
    for p in prompts:
        batcher.submit(p, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    ticks = 0
    done = []
    while batcher.queue or any(r is not None for r in batcher.slots):
        ticks += batcher.step() > 0
        done += batcher.finished
        batcher.finished = []
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    log(f"  batcher: {len(done)} requests, {ticks} decode ticks, "
        f"launches {launches}, drain {wall * 1e3:.1f} ms")
    assert len(done) == n_req, done
    for r in done:
        assert len(r.generated) == new_tokens, r
        assert all(0 <= t < full.vocab_size for t in r.generated), r
    want = MODELS[arch][1](full, n_req, ticks)
    if launches != want:
        raise AssertionError(f"launches {launches} != {want}")

    # per-unit times on the same weights: one 96-token prefill, and one
    # decode tick of 4 slots at cache length 100 of 112
    ids = torch.from_numpy(prompts[0][None].astype(np.int64)).cuda()
    cache = api.init_cache(full, slots, max_len)
    len100 = torch.full((), 100, dtype=torch.int32, device="cuda")
    step = make_serve_step(full)
    state = {"tok": torch.zeros((slots, 1), dtype=torch.int32,
                                device="cuda"), "cache": cache}

    def prefill():
        api.prefill(params, full, max_len, tokens=ids)

    def tick():
        state["cache"]["len"] = len100
        state["tok"], state["cache"] = step(params, state["tok"],
                                            state["cache"])

    prefill_host, prefill_ms = _time_calls(prefill)
    tick_host, decode_ms = _time_calls(tick)
    tps = n_req * new_tokens / wall
    log(f"  bf16 prefill (96 tokens, 1 request): {prefill_ms:.3f} ms "
        f"(host enqueue {prefill_host:.3f} ms); decode tick (4 slots, cache "
        f"112): {decode_ms:.3f} ms (host enqueue {tick_host:.3f} ms); drain "
        f"throughput {tps:.1f} generated tokens/s")
    profile = _profile(prefill, tick)
    del state, cache
    torch.cuda.empty_cache()
    return params, launches, {
        "prefill_ms": prefill_ms, "decode_tick_ms": decode_ms,
        "prefill_host_ms": prefill_host, "decode_tick_host_ms": tick_host,
        "tokens_per_s": tps, "drain_ms": wall * 1e3, **profile}


def _time_calls(fn, reps: int = 10):
    """(host ms, wall ms) per call of ``fn``: the host's time to enqueue
    ``reps`` calls, and the time until the card has finished them."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host / reps * 1e3, wall / reps * 1e3


def _profile(prefill, tick, ticks: int = 3):
    """``torch.profiler`` over one prefill and ``ticks`` decode ticks:
    the card's busy share of the window, and where host and card time go
    (top operators by self CPU time, top kernels by device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill()
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    ops = sorted((e for e in avgs if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)
    log(f"  profile (1 prefill + {ticks} ticks): window {window * 1e3:.3f} "
        f"ms, card busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / 1e3 / (window * 1e3):.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches")
    log("    top host operators (self CPU ms, calls):")
    for e in ops[:10]:
        log(f"      {e.self_cpu_time_total / 1e3:9.3f} {e.count:6d}  {e.key}")
    log("    top kernels (device ms, launches):")
    for e in sorted(kernels, key=lambda e: -dev_us(e))[:10]:
        log(f"      {dev_us(e) / 1e3:9.3f} {e.count:6d}  {e.key[:90]}")
    log("    the port's kernels (device ms, launches):")
    for e in kernels:
        if any(f"::{name}_" in e.key for name in _kernel_ops()) \
                or "::combine_splits" in e.key:
            log(f"      {dev_us(e) / 1e3:9.3f} {e.count:6d}  {e.key[:90]}")
    return {"profile_window_ms": window * 1e3,
            "profile_busy_ms": busy_us / 1e3,
            "profile_kernel_launches": sum(e.count for e in kernels)}


# ---------------------------------------------------------------------------
# phase 5: the backend
# ---------------------------------------------------------------------------


def phase_backend(arch, params):
    """``params``: phase 4's bf16 ``arch`` weights at published width,
    seeded into the backend in place of its reduced config."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashWordTokenizer
    from repro_torch.engine.backend import TorchBackend
    from repro_torch.pipeline.protocols import OpRequest

    log(f"phase 5: TorchBackend ({arch}, published width) answers 8 "
        f"medec-shaped map requests")
    full = get_config(arch)
    rng = np.random.default_rng(1)
    vocab = ["patient", "dose", "mg", "daily", "history", "denies", "pain",
             "prescribed", "insulin", "was", "the", "with", "noted", "acute"]
    op = {"name": "detect_error", "type": "map",
          "prompt": ("Detect whether a medical error is present in "
                     "{{ input.note }}; identify the sentence and correct "
                     "it."),
          "output_schema": {"errors": "list[{flag, sentence}]"},
          "model": arch}
    reqs = [OpRequest("map", op, doc={
        "id": i, "note": " ".join(rng.choice(vocab, 60 + 10 * i))})
        for i in range(8)]
    be = TorchBackend()
    be._params[arch] = (full, params)
    _reset_counts()
    results = be.submit(reqs)
    launches = _counts()
    tok = HashWordTokenizer(full.vocab_size)
    for req, res in zip(reqs, results):
        assert res.error is None
        vals = res.value["errors"][0]["value"].split()
        assert len(vals) == be.max_new_tokens, res.value
        assert all(0 <= int(t) < full.vocab_size for t in vals), vals
        want_in = min(len(tok.encode(be._prompt_for(req))),
                      be.MAX_PROMPT_TOKENS)
        assert (res.usage.calls, res.usage.in_tokens, res.usage.out_tokens) \
            == (1, want_in, be.max_new_tokens), res.usage
    # the model's kernels launched, the others not at all
    used = MODELS[arch][1](full, 1, 1)
    assert all((launches[k] > 0) == (used[k] > 0) for k in used), launches
    cost = sum(be.usage_cost(arch, r.usage) for r in results)
    log(f"  8 results ok, launches {launches}, cost ${cost:.3e}")
    be.close()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    log("phase 1: device")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build")
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"  built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line:
                log(f"  [{name}] {line.split('function')[-1].strip()[:100]}")
            elif "registers" in line or "spill" in line:
                log(f"  [{name}]   {line.split(':', 1)[-1].strip()}")

    errs, times, long_times = phase_kernels()
    log("phase 4: the models")
    for arch in MODELS:
        check_small_model(arch)
    weights, launches = {}, {}
    for arch in MODELS:
        weights[arch], drain, model_times = phase_model(arch)
        log(f"  {arch}: {json.dumps(model_times)}")
        # each kernel's launches in the drain of each model whose path it is
        for k, n in drain.items():
            if n:
                launches.setdefault(k, {})[arch] = n
    for arch in MODELS:
        phase_backend(arch, weights.pop(arch))

    replaces = {
        "flash_attention": ("src/repro_torch/kernels/flash_attention/"
                            "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:108"),
        "flash_decode": ("src/repro_torch/kernels/flash_decode/"
                         "flash_decode.cu",
                         "src/repro/kernels/flash_decode/kernel.py:87"),
        "ssd_scan": ("src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:90"),
        "moe_ffn": ("src/repro_torch/kernels/moe_ffn/moe_ffn.cu",
                    "src/repro/kernels/moe_ffn/kernel.py:56"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": sum(launches[name].values()),
            "launches_by_model": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        for key in ("l2_flushed_ms", "recompute_ms", "by_seq", "zamba2",
                    "zamba2_by_seq", "by_capacity", "wide"):
            if key in t:
                kernels[-1][key] = t[key]
        if name in long_times:
            lt = long_times[name]
            kernels[-1]["long"] = {key: lt[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "l2_flushed_ms") if key in lt}
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
