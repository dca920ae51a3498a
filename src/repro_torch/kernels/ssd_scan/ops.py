"""Wrapper of the SSD scan CUDA kernel, in the model layout: ``x (B,S,H,P)``,
``dt (B,S,H)``, ``A (H,)``, ``Bm/Cm (B,S,G,N)``, ``D (H,)``.

A CPU tensor goes to the plain version (``ref.ssd_chunked``); a CUDA tensor
launches ``ssd_scan.cu`` or raises. ``launches`` counts the kernel's
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

MAX_HEAD_DIM = 128  # P: a lane holds at most 4 head dims of a row

launches = 0


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
                   i, i, i, i, i, i, i, p]  # B, S, H, P, G, N, chunk, stream
    fn.restype = i
    return fn


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
    global launches
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
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head dim {p} beyond the kernel's "
                         f"{MAX_HEAD_DIM}")
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
        b, s, h, p, g, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA "
                           f"error {err}")
    launches += 1
    return y, final
