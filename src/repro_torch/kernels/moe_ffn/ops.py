"""Wrapper of the fused expert-FFN CUDA kernel over the dispatched layout:
``x (G,E,C,D)``, ``w_gate/w_up (E,D,F)``, ``w_down (E,F,D)``.

A CPU tensor goes to the plain version (``ref.expert_ffn_ref``); a CUDA
tensor launches ``moe_ffn.cu`` or raises. ``launches`` counts the kernel's
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


# The launch geometry, mirrored from moe_ffn.cu: F columns of a gate/up
# pass, D columns of a down-projection pass, the largest portable cluster,
# the staged depth chunks, and per dtype the chunk depth, the row padding
# and the capacity-row tiles the kernel is built for.
PASS_F = 128
PASS_D = 256
MAX_CLUSTER = 8
STAGES = 4
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_GEOMETRY = {torch.float32: (16, 4, (32,)),
             torch.bfloat16: (32, 8, (16, 32))}


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut: clusters of ``nf`` blocks per (expert, row
    tile); F in ``slabs`` slabs of ``nf * fr`` columns, block r computing h
    for columns ``[r*fr, (r+1)*fr)`` of each and the output for D columns
    ``[r*dr, (r+1)*dr)``; ``nm`` tiles of ``bm`` rows cover the expert's
    ``G*C`` capacity rows across all groups; ``smem`` bytes of shared
    memory a block. With more than one slab the output is summed across
    slabs through an fp32 workspace."""
    nf: int
    fr: int
    dr: int
    bm: int
    nm: int
    slabs: int
    smem: int

    @property
    def blocks(self) -> int:
        """Blocks per expert."""
        return self.nf * self.nm


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(bm: int, fw: int, dtype: torch.dtype) -> int:
    """Shared memory of a block of ``bm`` rows whose h is ``fw`` wide
    (moe_ffn.cu's ``Smem::bytes``)."""
    bk, pad, _ = _GEOMETRY[dtype]
    esize = torch.empty((), dtype=dtype).element_size()
    w = max(2 * bk * (PASS_F + pad), bk * (PASS_D + pad))
    ldh = _cdiv(fw, 32) * 32 + pad
    return 8 * bm + esize * (STAGES * (bm * (bk + pad) + w) + bm * ldh)


def plan(g: int, e: int, c: int, d: int, f: int, dtype: torch.dtype) -> Plan:
    """The launch geometry of one call, from the shapes alone: F cut into
    ranges of whole gate/up passes, one block each (at most
    ``MAX_CLUSTER``), the same blocks cutting D into whole passes; the
    smallest row tile that holds all ``G*C`` rows, else the largest the
    kernel has that fits in shared memory with the h of its rows. Where no
    tile's h of all of F fits (F too wide: grok-1's 32768), the row tile
    is chosen as if all did, and F is cut into the widest slabs whose h
    fits. At the serving shapes (E=32, D=1024, F=512): one slab, 4 blocks
    an expert, 128 blocks."""
    _, _, tiles = _GEOMETRY[dtype]
    m = g * c
    nf = min(MAX_CLUSTER, _cdiv(f, PASS_F))
    fr = PASS_F * _cdiv(_cdiv(f, nf), PASS_F)
    nf = _cdiv(f, fr)
    dr = PASS_D * _cdiv(_cdiv(d, nf), PASS_D)
    fits = [t for t in tiles if _smem_bytes(t, f, dtype) <= MAX_SMEM]
    bm = next((t for t in fits or tiles if m <= t), (fits or tiles)[-1])
    if not fits:
        fr = PASS_F * max(k for k in range(1, fr // PASS_F + 1)
                          if _smem_bytes(bm, nf * k * PASS_F, dtype)
                          <= MAX_SMEM)
    fs = nf * fr
    return Plan(nf, fr, dr, bm, _cdiv(m, bm), _cdiv(f, fs),
                _smem_bytes(bm, min(f, fs), dtype))


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("moe_ffn").moe_ffn_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p,     # x, wg, wu, wd, out, workspace
                   i, i, i, i, i, i,     # G E C D F, dtype
                   i, i, i, i, ll,       # the plan: nf fr dr bm smem
                   p]                    # stream
    fn.restype = i
    return fn


def expert_ffn(
    x: torch.Tensor,       # (G, E, C, D)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # (E, F, D)
    *,
    block_c: int = 128,
    block_f: int = 512,
) -> torch.Tensor:
    """``(silu(x @ Wg_e) * (x @ Wu_e)) @ Wd_e`` per expert, summed in fp32,
    in x's dtype. ``block_c``/``block_f`` are the JAX wrapper's tile knobs,
    validated as it validates them; the Hopper kernel's tiles come from
    ``plan`` and it masks the ragged edges of C, D and F itself."""
    global launches
    g, e, c, d = x.shape
    f = w_gate.shape[-1]
    if block_c <= 0 or block_f <= 0:
        raise ValueError(
            f"moe_ffn: block shape must be positive, got "
            f"block_c={block_c}, block_f={block_f}")
    if w_gate.shape[0] != e or w_gate.shape[1] != d:
        raise ValueError(
            f"moe_ffn: experts axis mismatch — x is (G,E,C,D)="
            f"{tuple(x.shape)} but w_gate is (E,D,F)={tuple(w_gate.shape)}")
    if x.device.type == "cpu":
        return expert_ffn_ref(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"moe_ffn: unsupported device {x.device}")
    if w_up.shape != w_gate.shape or w_down.shape != (e, f, d):
        raise ValueError(
            f"moe_ffn: shapes w_gate {tuple(w_gate.shape)}, w_up "
            f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)} do not agree")
    ws = (w_gate, w_up, w_down)
    if x.dtype not in _DTYPE_CODES or any(w.dtype != x.dtype for w in ws):
        raise ValueError(f"moe_ffn: dtypes x {x.dtype}, weights "
                         f"{[w.dtype for w in ws]}; the kernel takes float32 "
                         f"or bfloat16, one dtype for all four")
    if any(w.device != x.device for w in ws):
        raise ValueError("moe_ffn: x and the weights must share a device")
    if not (x.is_contiguous() and all(w.is_contiguous() for w in ws)):
        raise ValueError("moe_ffn: x and the weights must be contiguous")
    pl = plan(g, e, c, d, f, x.dtype)
    out = torch.empty_like(x)
    ws = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if pl.slabs > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launch_fn()(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), 0 if ws is None else ws.data_ptr(), g, e, c, d, f,
        _DTYPE_CODES[x.dtype], pl.nf, pl.fr, pl.dr, pl.bm, pl.smem, stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn: kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return out
