"""Decoder-only model: the dense decoder with global attention
(llama3.2-1b), the same decoder with an MoE layer in place of the MLP
(granite-moe-1b-a400m), the attention-free Mamba2 stack (mamba2-370m) and
the hybrid Mamba2 stack with one shared attention+MLP block (zamba2-2.7b).

The JAX package stacks layer params along axis 0 and scans over them; the
port holds one block per layer in a ``ModuleList`` and loops in Python: a
``Block`` (attention + MLP or MoE) for an ``attn_global`` layer, a
``MambaBlock`` for a ``mamba`` layer. A hybrid model also holds ``shared``,
one ``Block`` applied after the last layer of each full period of
``hybrid_attn_every`` layers (never after the tail layers), as the JAX
package applies its shared block. The decode cache mirrors that:
``cache["layers"][i]`` is layer i's ``{"k", "v"}`` of shape
``(B, max_len, K, Hd)``, or its
``{"ssm": (B, H, P, N) fp32, "conv": (B, W-1, conv_dim)}``;
``cache["shared"][j]`` (hybrid only) is the ``{"k", "v"}`` of the shared
block's j-th application, a tensor of its own; and ``cache["len"]`` is one
int32 tensor on the model's device shared by the batch.

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
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Cache = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice does not port yet."""
    todo = []
    if cfg.family not in ("dense", "ssm", "moe", "hybrid"):
        todo.append(f"family {cfg.family!r} (encoder-decoder/VLM item)")
    local_global = "local/global attention item"
    if cfg.attn_pattern != "global":
        todo.append(f"local_global attention ({local_global})")
    if cfg.kv_cache_dtype == "int8":
        todo.append(f"int8 KV cache ({local_global})")
    if cfg.qk_norm:
        todo.append(f"qk_norm ({local_global})")
    if cfg.post_norms:
        todo.append(f"post_norms ({local_global})")
    if cfg.scale_embeddings:
        todo.append(f"scale_embeddings ({local_global})")
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet — " + "; ".join(todo)
            + "; see ROADMAP.md §1, modules to port")


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


def layout(cfg: ModelConfig) -> Tuple[List[str], int, List[str]]:
    """Returns (pattern, n_full_periods, tail_kinds), as the JAX package
    does: for the hybrid family ``hybrid_attn_every`` mamba slots a period
    and the ``num_layers % every`` layers left over as a mamba tail; else
    one slot per layer (``mamba`` for the SSM family, else
    ``attn_global``) and no tail."""
    check_supported(cfg)
    if cfg.family == "hybrid":
        every = max(cfg.hybrid_attn_every, 1)
        n_full = cfg.num_layers // every
        return (["mamba"] * every, n_full,
                ["mamba"] * (cfg.num_layers - n_full * every))
    kind = "mamba" if cfg.family == "ssm" else "attn_global"
    return [kind], cfg.num_layers, []


def layer_kinds(cfg: ModelConfig) -> List[str]:
    pattern, n_full, tail = layout(cfg)
    return pattern * n_full + tail


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


class _DenseFFN(L.MLP):
    """The MLP with the MoE layer's call: ``(cfg, x) -> (output, None)``."""

    def forward(self, cfg: ModelConfig, x: torch.Tensor):
        return super().forward(x), None


class Block(nn.Module):
    """Attention + feed-forward layer (``attn_global``); the feed-forward
    sublayer ``ffn`` is an ``MoE`` when ``cfg.is_moe``, else the MLP. Its
    decode cache is ``{"k", "v"}`` of shape ``(B, max_len, K, Hd)``.
    ``full`` returns (x, layer cache, MoE aux loss or None), as
    ``MambaBlock.full`` does; ``decode`` drops the aux loss, as the JAX
    decode does."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.norm_attn = L.RMSNorm(cfg.d_model, gen.device)
        self.attn = A.Attention(gen, cfg)
        self.norm_mlp = L.RMSNorm(cfg.d_model, gen.device)
        self.ffn = (M.MoE(gen, cfg) if cfg.is_moe else
                    _DenseFFN(gen, cfg.d_model, cfg.d_ff,
                              L.dtype_of(cfg.param_dtype)))

    @staticmethod
    def empty_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dev: torch.device) -> Cache:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = L.dtype_of(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    def full(self, cfg: ModelConfig, x, positions, max_len: int):
        h, (k, v) = A.attn_prefill(self.attn, cfg,
                                   self.norm_attn(x, cfg.norm_eps), positions)
        x = x + h
        h, aux = self.ffn(cfg, self.norm_mlp(x, cfg.norm_eps))
        return (x + h, _seed_attn_cache(cfg, "attn_global", k, v, max_len),
                aux)

    def decode(self, cfg: ModelConfig, x, lc: Cache, cache_len):
        h, new_lc = A.attn_decode_cached(self.attn, cfg,
                                         self.norm_attn(x, cfg.norm_eps),
                                         lc, cache_len)
        x = x + h
        return x + self.ffn(cfg, self.norm_mlp(x, cfg.norm_eps))[0], new_lc


class MambaBlock(nn.Module):
    """Mamba2 layer (``mamba``); its decode cache is
    ``{"ssm": (B, H, P, N) fp32, "conv": (B, W-1, conv_dim)}``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, gen.device)
        self.mamba = S.Mamba(gen, cfg)

    @staticmethod
    def empty_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dev: torch.device) -> Cache:
        return S.init_ssm_state(cfg, batch, dev)._asdict()

    def full(self, cfg: ModelConfig, x, positions, max_len: int):
        h, state = S.mamba_prefill(self.mamba, cfg, self.norm(x, cfg.norm_eps))
        return x + h, state._asdict(), None

    def decode(self, cfg: ModelConfig, x, lc: Cache, cache_len):
        h, state = S.mamba_decode(self.mamba, cfg, self.norm(x, cfg.norm_eps),
                                  S.SSMState(**lc))
        return x + h, state._asdict()


_BLOCKS = {"attn_global": Block, "mamba": MambaBlock}


class Transformer(nn.Module):
    """Weights of the decoder: ``embed``, ``layers``, ``final_norm``, and
    for the hybrid family ``shared`` (one attention + MLP block, held even
    where no full period applies it, as in the JAX init)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(gen, cfg)
        self.layers = nn.ModuleList(_BLOCKS[kind](gen, cfg)
                                    for kind in layer_kinds(cfg))
        self.final_norm = L.RMSNorm(cfg.d_model, gen.device)
        if cfg.family == "hybrid":
            self.shared = Block(gen, cfg)


def _schedule(cfg: ModelConfig):
    """(kind, cache list) of each block in the order they run: every layer
    (``"layers"``), and for the hybrid family the shared block
    (``"shared"``) after the last layer of each full period."""
    pattern, n_full, _ = layout(cfg)
    period = len(pattern)
    hybrid = cfg.family == "hybrid"
    for i, kind in enumerate(layer_kinds(cfg)):
        yield kind, "layers"
        if hybrid and (i + 1) % period == 0 and i < n_full * period:
            yield "attn_global", "shared"


def _blocks(params: Transformer, cfg: ModelConfig):
    """The modules in ``_schedule``'s order, each with its cache list."""
    layers = iter(params.layers)
    for _, where in _schedule(cfg):
        yield (next(layers) if where == "layers" else params.shared), where


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


# --------------------------------------------------------------------------
# cache
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    dev = resolve_device(device)
    # one zeroed buffer per block: decode writes attention caches in place,
    # so the shared block's applications must not share storage (as an
    # ``expand`` would)
    caches = _cache_lists(cfg)
    for kind, where in _schedule(cfg):
        caches[where].append(
            _BLOCKS[kind].empty_cache(cfg, batch, max_len, dev))
    return {"len": torch.zeros((), dtype=torch.int32, device=dev), **caches}


def _seed_attn_cache(cfg: ModelConfig, kind: str, k: torch.Tensor,
                     v: torch.Tensor, max_len: int) -> Cache:
    """Pack prefill K/V (B,S,Kh,Hd) into a decode cache buffer by
    zero-padding the sequence axis to ``max_len`` (global layers)."""
    if kind != "attn_global":
        raise NotImplementedError(
            f"{kind} cache seeding: ported with the local/global attention "
            f"item of ROADMAP.md §1")
    pad = max_len - k.shape[1]
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad))}


def _cache_lists(cfg: ModelConfig) -> Dict[str, list]:
    """Empty per-block cache lists of a cache dict, keyed as ``_schedule``
    names them; every list-valued key of a cache is one of these."""
    return {"layers": [], **({"shared": []} if cfg.family == "hybrid"
                             else {})}


# --------------------------------------------------------------------------
# forward / prefill / decode
# --------------------------------------------------------------------------


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            return_hidden: bool = False):
    """Full-sequence forward. Returns (logits_or_hidden, aux): the sum of
    the MoE layers' load-balancing losses (zero without MoE layers)."""
    x = _embed_inputs(params, cfg, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, _ in _blocks(params, cfg):
        x, _, a = p.full(cfg, x, positions, s)
        if a is not None:
            aux = aux + a
    x = params.final_norm(x, cfg.norm_eps)
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
    caches = _cache_lists(cfg)
    for p, where in _blocks(params, cfg):
        x, lc, _ = p.full(cfg, x, positions, max_len)
        caches[where].append(lc)
    x = params.final_norm(x, cfg.norm_eps)
    logits = L.unembed(params.embed.out_table, cfg, x[:, -1:, :])
    return logits, {
        "len": torch.full((), s, dtype=torch.int32, device=x.device),
        **caches}


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, token: torch.Tensor,
                cache: Cache):
    """One autoregressive step. Returns (logits (B,1,V), cache). Attention
    layer caches are updated in place (see ``attention.attn_decode``), a
    mamba layer's state is replaced; the returned dict holds them with
    ``len`` advanced by one."""
    x = _embed_inputs(params, cfg, token)
    cache_len = cache["len"]
    old = {where: iter(lcs) for where, lcs in cache.items()
           if isinstance(lcs, list)}
    caches = _cache_lists(cfg)
    for p, where in _blocks(params, cfg):
        x, nc = p.decode(cfg, x, next(old[where]), cache_len)
        caches[where].append(nc)
    x = params.final_norm(x, cfg.norm_eps)
    logits = L.unembed(params.embed.out_table, cfg, x)
    return logits, {"len": cache_len + 1, **caches}


def count_params(params: nn.Module) -> int:
    return int(sum(math.prod(t.shape) for t in params.parameters()))
