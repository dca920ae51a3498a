"""Dense decoder-only transformer with global attention (llama3.2-1b).

The JAX package stacks layer params along axis 0 and scans over them; the
port holds one ``Block`` per layer in a ``ModuleList`` and loops in Python.
The decode cache mirrors that: ``cache["layers"][i]`` is layer i's
``{"k", "v"}`` of shape ``(B, max_len, K, Hd)``, and ``cache["len"]`` is
one int32 tensor on the model's device shared by the batch.

Other families and options raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Cache = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice does not port yet."""
    todo = []
    if cfg.family != "dense":
        todo.append(f"family {cfg.family!r} (MoE: item 7, SSM/hybrid: item "
                    f"8, enc-dec/VLM: item 9)")
    if cfg.attn_pattern != "global":
        todo.append("local_global attention (item 6)")
    if cfg.kv_cache_dtype == "int8":
        todo.append("int8 KV cache (item 6)")
    if cfg.qk_norm:
        todo.append("qk_norm (item 6)")
    if cfg.post_norms:
        todo.append("post_norms (item 6)")
    if cfg.scale_embeddings:
        todo.append("scale_embeddings (item 6)")
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet — " + "; ".join(todo)
            + " (ROADMAP.md, modules to port)")


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


def layout(cfg: ModelConfig) -> Tuple[List[str], int, List[str]]:
    """Returns (pattern, n_full_periods, tail_kinds), as the JAX package
    does; for the dense global decoder, one ``attn_global`` slot per
    layer and no tail."""
    check_supported(cfg)
    return ["attn_global"], cfg.num_layers, []


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


class Block(nn.Module):
    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.norm_attn = L.RMSNorm(cfg.d_model, gen.device)
        self.attn = A.Attention(gen, cfg)
        self.norm_mlp = L.RMSNorm(cfg.d_model, gen.device)
        self.mlp = L.MLP(gen, cfg.d_model, cfg.d_ff,
                         L.dtype_of(cfg.param_dtype))


class Transformer(nn.Module):
    """Weights of the dense decoder: ``embed``, ``layers``, ``final_norm``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.embed = L.Embedding(gen, cfg)
        self.layers = nn.ModuleList(Block(gen, cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, gen.device)


def init_params(seed: Union[int, torch.Generator], cfg: ModelConfig, *,
                device: Optional[Union[str, torch.device]] = None
                ) -> Transformer:
    """Random weights from the JAX inits' distributions, drawn from a
    ``torch.Generator`` on ``device`` (default: the card)."""
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(int(seed))
    with torch.no_grad():
        return Transformer(gen, cfg)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------


def _embed_inputs(params: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params.embed.tokens, cfg, tokens)


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def _apply_layer_full(p: Block, cfg: ModelConfig, x, positions):
    h, kv = A.attn_prefill(p.attn, cfg, p.norm_attn(x, cfg.norm_eps),
                           positions)
    x = x + h
    return x + p.mlp(p.norm_mlp(x, cfg.norm_eps)), kv


def _apply_layer_decode(p: Block, cfg: ModelConfig, x, lc: Cache, cache_len):
    h, new_lc = A.attn_decode_cached(p.attn, cfg, p.norm_attn(x, cfg.norm_eps),
                                     lc, cache_len)
    x = x + h
    return x + p.mlp(p.norm_mlp(x, cfg.norm_eps)), new_lc


# --------------------------------------------------------------------------
# cache
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = L.dtype_of(cfg.dtype)
    return {
        "len": torch.zeros((), dtype=torch.int32, device=dev),
        "layers": [{"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
                   for _ in range(cfg.num_layers)],
    }


def _seed_attn_cache(cfg: ModelConfig, kind: str, k: torch.Tensor,
                     v: torch.Tensor, max_len: int) -> Cache:
    """Pack prefill K/V (B,S,Kh,Hd) into a decode cache buffer by
    zero-padding the sequence axis to ``max_len`` (global layers)."""
    if kind != "attn_global":
        raise NotImplementedError(
            f"{kind} cache seeding: ported with local/global attention "
            f"(ROADMAP.md module item 6)")
    pad = max_len - k.shape[1]
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


# --------------------------------------------------------------------------
# forward / prefill / decode
# --------------------------------------------------------------------------


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            return_hidden: bool = False):
    """Full-sequence forward. Returns (logits_or_hidden, aux=0)."""
    x = _embed_inputs(params, cfg, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for p in params.layers:
        x, _ = _apply_layer_full(p, cfg, x, positions)
    x = params.final_norm(x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(params.embed.out_table, cfg, x), aux


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            max_len: int):
    """Run the prompt through the model. Returns (last-position logits
    (B,1,V), populated decode cache)."""
    x = _embed_inputs(params, cfg, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    layers = []
    for p in params.layers:
        x, (k, v) = _apply_layer_full(p, cfg, x, positions)
        layers.append(_seed_attn_cache(cfg, "attn_global", k, v, max_len))
    x = params.final_norm(x, cfg.norm_eps)
    logits = L.unembed(params.embed.out_table, cfg, x[:, -1:, :])
    cache: Cache = {
        "len": torch.full((), s, dtype=torch.int32, device=x.device),
        "layers": layers,
    }
    return logits, cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache):
    """One autoregressive step. Returns (logits (B,1,V), cache). The layer
    caches are updated in place (see ``attention.attn_decode``); the
    returned dict holds them with ``len`` advanced by one."""
    x = _embed_inputs(params, cfg, token)
    cache_len = cache["len"]
    new_layers = []
    for p, lc in zip(params.layers, cache["layers"]):
        x, nc = _apply_layer_decode(p, cfg, x, lc, cache_len)
        new_layers.append(nc)
    x = params.final_norm(x, cfg.norm_eps)
    logits = L.unembed(params.embed.out_table, cfg, x)
    return logits, {"len": cache_len + 1, "layers": new_layers}


def count_params(params: nn.Module) -> int:
    return int(sum(math.prod(t.shape) for t in params.parameters()))
