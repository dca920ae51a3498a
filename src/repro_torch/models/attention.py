"""Grouped-query attention with RoPE and a KV cache, for the dense decoder
and the hybrid family's shared block.

Two call sites reach the hand-written kernels, always (``cfg.use_pallas``
is not read): causal self-attention prefill goes through
``kernels.flash_attention.ops.flash_attention`` and non-ring global decode
through ``kernels.flash_decode.ops.flash_decode``. On a CUDA tensor each
wrapper launches its kernel; on a CPU tensor it runs its plain version.
``attend`` is the plain masked attention of the JAX package, kept for the
paths that do not reach a kernel (non-causal self-attention).

Ring-buffer (sliding-window) decode, int8 caches and cross-attention arrive
with their slices (the local/global attention and encoder-decoder/VLM items
of ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


class Attention(nn.Module):
    """Projection weights, ``(in, out)`` like the JAX params."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        if cfg.qk_norm:
            raise NotImplementedError(
                "qk_norm: ported with the local/global attention item of "
                "ROADMAP.md §1")
        dtype = L.dtype_of(cfg.param_dtype)
        hd = cfg.resolved_head_dim
        self.wq = L._param(L.dense_init(gen, cfg.d_model, cfg.num_heads * hd,
                                        dtype))
        self.wk = L._param(L.dense_init(gen, cfg.d_model,
                                        cfg.num_kv_heads * hd, dtype))
        self.wv = L._param(L.dense_init(gen, cfg.d_model,
                                        cfg.num_kv_heads * hd, dtype))
        self.wo = L._param(L.dense_init(gen, cfg.num_heads * hd, cfg.d_model,
                                        dtype))


def attend(
    q: torch.Tensor,  # (B,Q,H,Hd)
    k: torch.Tensor,  # (B,K,Kh,Hd)
    v: torch.Tensor,  # (B,K,Kh,Hd)
    *,
    q_pos: torch.Tensor,  # (B,Q) or (1,Q)
    k_pos: torch.Tensor,  # (B,K) or (1,K)
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: float = 0.0,
    kv_valid: Optional[torch.Tensor] = None,  # (B,K) bool
) -> torch.Tensor:
    """Plain masked attention. Returns (B,Q,H,Hd). The probabilities are
    cast to ``v.dtype`` before P.V, as in the JAX package."""
    num_heads = q.shape[2]
    g = num_heads // k.shape[2]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = L.softcap(scores, attn_softcap)
    delta = q_pos[:, :, None] - k_pos[:, None, :]  # (B?,Q,K)
    ok = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        ok = ok & (delta >= 0)
    if window is not None and window > 0:
        ok = ok & (delta < window)
    scores = torch.where(ok[:, None], scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor):
    hd = cfg.resolved_head_dim
    q = (x @ p.wq).reshape(*x.shape[:-1], cfg.num_heads, hd)
    k = (x @ p.wk).reshape(*x.shape[:-1], cfg.num_kv_heads, hd)
    v = (x @ p.wv).reshape(*x.shape[:-1], cfg.num_kv_heads, hd)
    return q, k, v


def attn_prefill(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B,S,D)
    positions: torch.Tensor,  # (B,S)
    *,
    window: Optional[int] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention. Returns (out, (k, v)) so callers can
    seed a decode cache from the prefill pass."""
    q, k, v = project_qkv(p, cfg, x)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if causal:
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window,
                                        softcap=cfg.attn_softcap)
    else:
        out = attend(q, k, v, q_pos=positions, k_pos=positions, causal=False,
                     window=window, attn_softcap=cfg.attn_softcap)
    out = out.reshape(*out.shape[:-2], -1)
    return out @ p.wo, (k, v)


def attn_decode(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B,1,D)
    cache_k: torch.Tensor,  # (B,Smax,K,Hd)
    cache_v: torch.Tensor,
    cache_len: torch.Tensor,  # int32 scalar on the model's device
    *,
    window: Optional[int] = None,
    ring: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode against a global KV cache.

    The new K/V row is written into ``cache_k``/``cache_v`` in place at
    slot ``min(cache_len, Smax-1)`` (``index_copy_``): the JAX package
    donates the cache to its decode step for the same reason, so no step
    holds two copies of it. The query then attends slots
    ``[0, cache_len]``, i.e. the kernel gets ``valid_len = cache_len + 1``.
    """
    if ring or window is not None:
        raise NotImplementedError(
            "ring-buffer / windowed decode: ported with the local/global "
            "attention item of ROADMAP.md §1")
    b = x.shape[0]
    smax = cache_k.shape[1]
    pos = cache_len.reshape(1, 1).expand(b, 1)  # query abs position
    q, k_new, v_new = project_qkv(p, cfg, x)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k_new = L.apply_rope(k_new, pos, cfg.rope_theta)
    slot = torch.clamp(cache_len, max=smax - 1).reshape(1).long()
    cache_k.index_copy_(1, slot, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, slot, v_new.to(cache_v.dtype))
    valid_len = (cache_len + 1).to(torch.int32).reshape(1)
    out = fd_ops.flash_decode(q, cache_k, cache_v, valid_len,
                              softcap=cfg.attn_softcap)
    out = out.reshape(b, 1, -1)
    return out @ p.wo, (cache_k, cache_v)


def attn_decode_cached(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    lc: Dict[str, torch.Tensor],  # layer cache: {"k", "v"}
    cache_len: torch.Tensor,
    *,
    window: Optional[int] = None,
    ring: bool = False,
):
    """Dict entry point, for float caches. The cache is updated in place
    and returned."""
    if "k_scale" in lc:
        raise NotImplementedError(
            "int8 KV cache: ported with the local/global attention item of "
            "ROADMAP.md §1")
    out, (ck, cv) = attn_decode(p, cfg, x, lc["k"], lc["v"], cache_len,
                                window=window, ring=ring)
    return out, {"k": ck, "v": cv}
