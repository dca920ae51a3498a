"""Plain PyTorch version of the flash-attention kernel (the oracle).

The wrapper runs it for CPU tensors; ``chip_smoke.py`` holds the CUDA
kernel against it on the card. Same function as the JAX package's
``attention_ref``.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(
    q: torch.Tensor,  # (B, S, H, Hd)
    k: torch.Tensor,  # (B, S, K, Hd)
    v: torch.Tensor,  # (B, S, K, Hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=2)
        v = torch.repeat_interleave(v, h // kv, dim=2)
    scale = hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(s, device=q.device)
    delta = pos[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= delta >= 0
    if window > 0:
        mask &= delta < window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
