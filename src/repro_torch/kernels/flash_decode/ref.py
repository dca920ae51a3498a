"""Plain PyTorch version of the flash-decode kernel (the oracle).

The wrapper runs it for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernel against it on the card. Same function as the JAX package's
``decode_ref``.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def decode_ref(q, k, v, valid_len, *, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,K,G,Hd); k/v: (B,S,K,Hd); valid_len: int or int tensor with
    one element. Returns (B,K,G,Hd)."""
    hd = q.shape[-1]
    s = k.shape[1]
    scale = hd ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if isinstance(valid_len, torch.Tensor):
        valid_len = valid_len.reshape(())
    mask = torch.arange(s, device=q.device) < valid_len
    scores = torch.where(mask[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.to(q.dtype)
