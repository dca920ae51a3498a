"""Wrapper of the flash-decode CUDA kernel: model-layout query
``(B, 1, H, Hd)`` against a ``(B, S, K, Hd)`` cache.

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor launches
``flash_decode.cu`` or raises. ``launches`` counts the calls that launch
the kernel (one call is its split pass and, with more than one split, the
pass that adds the splits), and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode.ref import decode_ref

# The JAX wrapper's cache-block knob, validated as it validates it. The
# Hopper kernel splits the cache across blocks (``num_splits``) and walks a
# split in its own tiles of 32 or 64 positions.
DEFAULT_BLOCK_S = 512
MAX_HEAD_DIM = 256
# Cache splits (``num_splits``): about four blocks to each of the H100's
# 132 SMs (a block holds a (batch, kv head)'s rows; a group of more than
# 64 bf16 or 32 fp32 rows takes more than one), and no split shorter than
# 128 positions, below which the pass that adds the splits costs more than
# the split saves (both measured on the H100: PERF.md, PR 16).
SPLIT_BLOCKS = 4 * 132
MIN_SPLIT_KEYS = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The kernel's C entry point, built and loaded at first use."""
    fn = _build.load("flash_decode").flash_decode_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, f, i, p]
    fn.restype = i
    return fn


def num_splits(b: int, kv_heads: int, s: int) -> int:
    """Splits of the cache for one call: about ``SPLIT_BLOCKS`` blocks of
    (batch, kv head) rows, each split at least ``MIN_SPLIT_KEYS`` positions
    of the capacity ``s``. Taken from the shapes alone, never from
    ``valid_len``, so the grid never depends on the data."""
    want = -(-SPLIT_BLOCKS // (b * kv_heads))
    return max(1, min(want, s // MIN_SPLIT_KEYS))


def flash_decode(
    q: torch.Tensor,          # (B, 1, H, Hd)
    k: torch.Tensor,          # (B, S, K, Hd)
    v: torch.Tensor,
    valid_len: Union[int, torch.Tensor],  # int32, one element
    *,
    softcap: float = 0.0,
    block_s: int = DEFAULT_BLOCK_S,
) -> torch.Tensor:
    """On CUDA, ``valid_len`` should already be an int32 tensor on the card:
    the kernel reads it there, so a decode step needs no host sync."""
    global launches
    b, _, h, hd = q.shape
    kh = k.shape[2]
    if kh <= 0 or h % kh != 0:
        raise ValueError(
            f"flash_decode: heads axis invalid — q has {h} heads, k/v "
            f"cache has {kh} kv-heads; GQA needs heads % kv_heads == 0")
    if block_s <= 0:
        raise ValueError(
            f"flash_decode: block shape must be positive, got "
            f"block_s={block_s}")
    g = h // kh
    if q.device.type == "cpu":
        out = decode_ref(q.reshape(b, kh, g, hd), k, v, valid_len,
                         softcap=softcap)
        return out.reshape(b, 1, h, hd)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    s = k.shape[1]
    if q.shape[1] != 1 or k.shape != (b, s, kh, hd) or v.shape != k.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_decode: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; the kernel takes float32 or bfloat16")
    if not isinstance(valid_len, torch.Tensor):
        valid_len = torch.tensor([int(valid_len)], dtype=torch.int32,
                                 device=q.device)
    if valid_len.dtype != torch.int32 or valid_len.numel() != 1:
        raise ValueError("flash_decode: valid_len must be one int32")
    if not (k.device == q.device and v.device == q.device
            and valid_len.device == q.device):
        raise ValueError("flash_decode: q, k, v and valid_len must share a "
                         "device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode: q, k and v must be contiguous")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head_dim {hd} beyond the kernel's "
                         f"range (max {MAX_HEAD_DIM})")
    out = _launch(q, k, v, valid_len, softcap=softcap)
    launches += 1
    return out


def _launch(q, k, v, valid_len, *, softcap):
    """Launch the kernel on checked CUDA tensors."""
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    n_split = num_splits(b, kh, s)
    out = torch.empty_like(q)
    # per split and row: m, l and hd sums, fp32
    part = (torch.empty(n_split * b * h * (hd + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, s, kh,
        hd, g, n_split, float(softcap), hd ** -0.5, _DTYPE_CODES[q.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA "
                           f"error {err}")
    return out
