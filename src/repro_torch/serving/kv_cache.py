"""Decode-cache sizing and accounting helpers (the global-attention,
mamba and hybrid parts of the JAX package's ``serving/kv_cache.py``; int8
quantisation arrives with local/global attention)."""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_kinds, layout


def cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Decode-cache bytes of ``init_cache(cfg, batch, max_len)``."""
    bpe = 2 if cfg.dtype == "bfloat16" else 4
    total = 0
    for kind in layer_kinds(cfg):
        if kind == "mamba":
            total += batch * cfg.ssm_nheads * cfg.ssm_head_dim * \
                cfg.ssm_state * 4
            total += batch * (cfg.ssm_conv_width - 1) * cfg.ssm_conv_dim * bpe
        else:
            total += 2 * batch * max_len * cfg.num_kv_heads * \
                cfg.resolved_head_dim * bpe
    if cfg.family == "hybrid":  # one K/V pair per shared-block application
        total += layout(cfg)[1] * 2 * batch * max_len * cfg.num_kv_heads * \
            cfg.resolved_head_dim * bpe
    return total


def param_bytes(cfg: ModelConfig) -> int:
    bpe = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg.approx_params() * bpe


def measured_cache_bytes(cache) -> int:
    """Bytes of every tensor in a cache (nested dicts and lists)."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, dict):
        return sum(measured_cache_bytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(measured_cache_bytes(v) for v in cache)
    return 0
