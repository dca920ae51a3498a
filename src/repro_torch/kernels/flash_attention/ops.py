"""Wrapper of the flash-attention CUDA kernel, in the model layout.

``flash_attention(q, k, v)`` takes q ``(B, S, H, Hd)`` and k/v
``(B, S, K, Hd)``. A CPU tensor goes to the plain version (``ref.py``); a
CUDA tensor launches ``flash_attention.cu`` or raises. ``launches`` counts
the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

# The JAX wrapper's tile knobs, validated as it validates them. The Hopper
# kernel picks its own tiles: 16 to 128 query rows per bf16 block (32 in
# fp32), whatever the group size, and 32 or 64 keys per staged tile.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("flash_attention").flash_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, f, i, p]
    fn.restype = i
    return fn


def flash_attention(
    q: torch.Tensor,  # (B, S, H, Hd)
    k: torch.Tensor,  # (B, S, K, Hd)
    v: torch.Tensor,  # (B, S, K, Hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: float = 0.0,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    global launches
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if kh <= 0 or h % kh != 0:
        raise ValueError(
            f"flash_attention: heads axis invalid — q has {h} heads, k/v "
            f"have {kh} kv-heads; GQA needs heads % kv_heads == 0")
    if block_q <= 0 or block_k <= 0:
        raise ValueError(
            f"flash_attention: block shape must be positive, got "
            f"block_q={block_q}, block_k={block_k}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=int(window or 0),
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.shape != (b, s, kh, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)}/"
                         f"{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k and v must share a device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} beyond the "
                         f"kernel's range (max {MAX_HEAD_DIM})")
    out = _launch(q, k, v, causal=causal, window=window, softcap=softcap)
    launches += 1
    return out


def _launch(q, k, v, *, causal, window, softcap):
    """Launch the kernel on checked CUDA tensors."""
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, k.shape[2], hd, int(causal), int(window or 0),
        float(softcap), hd ** -0.5, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    return out
