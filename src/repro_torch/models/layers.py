"""Shared building blocks: plain functions on tensors, and the small
``nn.Module``s that hold their weights.

Weights keep the JAX package's ``(in, out)`` layout and are applied as
``x @ W`` (no ``nn.Linear``, whose layout is ``(out, in)``), so weights
bridged from JAX need no transposes. Inits draw from the same
distributions as the JAX inits, from an explicit ``torch.Generator``; the
numbers differ from ``jax.random``'s, so parity tests bridge weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, ``(in, out)``."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# --------------------------------------------------------------------------
# functions
# --------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """(1+scale) RMS norm (gemma/llama style), computed in fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate the two halves (x[..., :half], x[..., half:]) by
    position-dependent angles in fp32.

    x: (..., S, H, Hd) or (..., S, Hd); positions broadcastable to (..., S).
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    if x.ndim == angles.ndim + 1:  # head axis present
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x @ Wg) * (x @ Wu)) @ Wd``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed(table: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor
          ) -> torch.Tensor:
    return table[tokens].to(dtype_of(cfg.dtype))


def unembed(table: torch.Tensor, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    logits = (x @ table.t()).float()
    return softcap(logits, cfg.final_softcap)


def softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


# --------------------------------------------------------------------------
# weight holders
# --------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """Norm scales stay fp32 (tiny, and no bf16 rounding of the gain)."""

    def __init__(self, dim: int, device: torch.device):
        super().__init__()
        self.scale = _param(torch.zeros((dim,), dtype=torch.float32,
                                        device=device))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(self.scale, x, eps)


class MLP(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w_gate = _param(dense_init(gen, d_model, d_ff, dtype))
        self.w_up = _param(dense_init(gen, d_model, d_ff, dtype))
        self.w_down = _param(dense_init(gen, d_ff, d_model, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self.w_gate, self.w_up, self.w_down, x)


class Embedding(nn.Module):
    """Token table; an untied ``unembed`` table when the config says so."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        self.tokens = _param(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype))
        self.unembed = (None if cfg.tie_embeddings else
                        _param(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                          dtype)))

    @property
    def out_table(self) -> torch.Tensor:
        return self.tokens if self.unembed is None else self.unembed
