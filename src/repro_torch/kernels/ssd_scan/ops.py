"""Wrapper of the SSD scan CUDA kernel, in the model layout: ``x (B,S,H,P)``,
``dt (B,S,H)``, ``A (H,)``, ``Bm/Cm (B,S,G,N)``, ``D (H,)``.

A CPU tensor goes to the plain version (``ref.ssd_chunked``); a CUDA tensor
launches ``ssd_scan.cu`` or raises. ``launches`` counts the kernel's
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

# A block owns SPLIT_WIDTH head dims of one (batch, head) and holds its
# part of the (P, N) state in registers, at most MAX_STATE_DIM wide. The
# blocks of one head form clusters that share the C.B^T tiles. The rest
# mirrors ssd_scan.cu's shared memory: query rows / keys of a score tile,
# the partials' floats, and a raw score tile's row stride.
SPLIT_WIDTH = 16
MAX_STATE_DIM = 256
CLUSTERS = (2, 4, 8)
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
_TILE, _PART, _LD_RAW = 32, 5120, 36

launches = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut: ``splits`` blocks per (batch, head), each
    ``SPLIT_WIDTH`` head dims, in clusters of ``cluster``; ``shared``: the
    cluster's blocks divide a chunk's C.B^T tiles and read each other's
    (else ``cluster`` is 1 and a block computes each tile as it uses it);
    ``resident``: a chunk's C, B and x rows are staged whole (else tile by
    tile); ``smem`` bytes of shared memory a block."""
    splits: int
    cluster: int
    resident: bool
    shared: bool
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(n: int, chunk: int, cluster: int, resident: bool,
               shared: bool) -> int:
    """Shared memory of a block (ssd_scan.cu's ``smem_floats``)."""
    ld = 4 * (_cdiv(n, 4) | 1)
    qt = _cdiv(chunk, _TILE) * _TILE
    rows = qt if resident else _TILE
    t = qt // _TILE
    raw = _cdiv(t * (t + 1) // 2, cluster) if shared else 1
    return 4 * (rows * (2 * ld + SPLIT_WIDTH) + SPLIT_WIDTH * ld + _PART
                + raw * _TILE * _LD_RAW + 3 * qt)


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("ssd_scan").ssd_scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, ll, ll,   # x and its batch/seq/head strides
                   p, ll, ll, ll,   # dt
                   p, ll, ll, ll,   # Bm (group stride)
                   p, ll, ll, ll,   # Cm
                   p, p, p,         # A, D, h0 (null: zeros)
                   p, p,            # y, final state
                   i, i, i, i, i, i, i,  # B, S, H, P, G, N, chunk
                   i, i, i, i, ll,  # the plan: splits cluster resident
                                    # shared smem
                   p]               # stream
    fn.restype = i
    return fn


def plan(p: int, n: int, chunk: int, share: bool = True) -> Plan:
    """The launch geometry of one call, from the shapes alone. ``splits``
    blocks per (batch, head): row p of the state and column p of y depend
    only on x[..., p], the shared scores and the decays, so the split is
    exact. The first of these that fits a block's shared memory:
    the chunk's rows staged whole with its C.B^T tiles shared by the
    smallest cluster of ``CLUSTERS`` dividing ``splits``; staged whole with
    each block computing its own tiles; tiles staged one by one, shared by
    the smallest cluster; tiles staged one by one, each block its own.
    ``share=False`` leaves out the shared modes (the recompute variant
    chip_smoke.py times). Pairs always fit the H100 at one block an SM;
    clusters of 4 do not all fit at once (both measured, PERF.md). At
    mamba2's serving shapes (H=32, P=64, N=128, chunk <= 96): 4 splits in
    clusters of 2, 128 blocks. Raises ``ValueError`` for a chunk too long
    for any mode (beyond about 10k steps)."""
    splits = _cdiv(p, SPLIT_WIDTH)
    sizes = [c for c in CLUSTERS if splits % c == 0] if share else []
    for resident in (True, False):
        for cluster, shared in [(c, True) for c in sizes] + [(1, False)]:
            smem = _smem_bytes(n, chunk, cluster, resident, shared)
            if smem <= MAX_SMEM:
                return Plan(splits, cluster, resident, shared, smem)
    raise ValueError(f"ssd_scan: chunk {chunk} needs more shared memory "
                     f"than the {MAX_SMEM} bytes an H100 block may use")


def ssd(
    x: torch.Tensor,     # (B, S, H, P) fp32
    dt: torch.Tensor,    # (B, S, H)
    A: torch.Tensor,     # (H,)
    Bm: torch.Tensor,    # (B, S, G, N)
    Cm: torch.Tensor,    # (B, S, G, N)
    D: torch.Tensor,     # (H,)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N) fp32). On CUDA the
    inputs may be strided views (the model passes slices of one
    projection) as long as their last axis is contiguous."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    if s % chunk != 0:
        raise ValueError(
            f"ssd_scan: seq axis not divisible — seq={s} is not a "
            f"multiple of chunk={chunk}; pad the sequence first (the "
            f"kernel would silently truncate the tail chunk)")
    if g <= 0 or h % g != 0:
        raise ValueError(
            f"ssd_scan: heads axis invalid — x has {h} heads, B/C have "
            f"{g} groups; needs heads % groups == 0")
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,) \
            or Bm.shape != (b, s, g, n) or Cm.shape != Bm.shape:
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, D "
            f"{tuple(D.shape)} do not agree")
    ins = (x, dt, A, Bm, Cm, D)
    if initial_state is not None:
        if initial_state.shape != (b, h, p, n):
            raise ValueError(f"ssd_scan: initial_state "
                             f"{tuple(initial_state.shape)} != "
                             f"{(b, h, p, n)}")
        ins += (initial_state,)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError("ssd_scan: the kernel takes float32 inputs only")
    if any(t.device != x.device for t in ins):
        raise ValueError("ssd_scan: all inputs must share a device")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)) or not (
            A.is_contiguous() and D.is_contiguous()) or (
            initial_state is not None and not initial_state.is_contiguous()):
        raise ValueError("ssd_scan: x, B and C need a contiguous last axis; "
                         "A, D and initial_state must be contiguous")
    if n > MAX_STATE_DIM:
        raise ValueError(f"ssd_scan: state dim {n} beyond the kernel's "
                         f"{MAX_STATE_DIM}")
    return _launch(x, dt, A, Bm, Cm, D, chunk, initial_state,
                   plan(p, n, chunk))


def _launch(x, dt, A, Bm, Cm, D, chunk, initial_state, pl: Plan):
    """Launch the kernel on checked inputs as ``pl`` says."""
    global launches
    b, s, h, p = x.shape
    n = Bm.shape[3]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    h0 = 0 if initial_state is None else initial_state.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launch_fn()(
        x.data_ptr(), *x.stride()[:3],
        dt.data_ptr(), *dt.stride(),
        Bm.data_ptr(), *Bm.stride()[:3],
        Cm.data_ptr(), *Cm.stride()[:3],
        A.data_ptr(), D.data_ptr(), h0, y.data_ptr(), final.data_ptr(),
        b, s, h, p, Bm.shape[2], n, chunk, pl.splits, pl.cluster,
        int(pl.resident), int(pl.shared), pl.smem, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return y, final
