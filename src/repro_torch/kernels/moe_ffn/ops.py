"""Wrapper of the fused expert-FFN CUDA kernel over the dispatched layout:
``x (G,E,C,D)``, ``w_gate/w_up (E,D,F)``, ``w_down (E,F,D)``.

A CPU tensor goes to the plain version (``ref.expert_ffn_ref``); a CUDA
tensor launches ``moe_ffn.cu`` or raises. ``launches`` counts the kernel's
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's C entry points, built and loaded at first use."""
    lib = _build.load("moe_ffn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.moe_ffn_workspace.argtypes = [i, i, i, i, i]
    lib.moe_ffn_workspace.restype = ll
    lib.moe_ffn_launch.argtypes = [p, p, p, p, p, p,   # x, wg, wu, wd, out,
                                   i, i, i, i, i,      # scratch; G E C D F
                                   i, p]               # dtype, stream
    lib.moe_ffn_launch.restype = i
    return lib


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
    validated as it validates them; the Hopper kernel picks its own tiles
    and masks the ragged edges of C and F itself."""
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
    out = torch.empty_like(x)
    lib = _lib()
    n_scratch = lib.moe_ffn_workspace(g, e, c, d, f)
    scratch = torch.empty((max(n_scratch, 0),), dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.moe_ffn_launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if n_scratch > 0 else None,
        g, e, c, d, f, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"moe_ffn: kernel launch failed with CUDA error "
                           f"{err}")
    launches += 1
    return out
