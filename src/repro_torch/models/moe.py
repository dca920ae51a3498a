"""Mixture-of-Experts layer (granite-moe 32e top-8), the port of the JAX
package's ``models/moe.py``.

The grouped dense-dispatch ("einsum MoE") formulation: tokens are split
into groups, and within each group a (S_g, E, C) one-hot dispatch tensor
routes tokens to per-expert capacity slots. The expert SwiGLU runs over the
dispatched (G, E, C, D) layout, always through
``kernels.moe_ffn.ops.expert_ffn`` (``cfg.use_pallas`` is not read): on a
CUDA tensor the wrapper launches the hand-written kernel, on a CPU tensor
it runs the plain ``expert_ffn_ref``.

The reference's semantics are kept where they decide which tokens are
dropped: top-k ties go to the lower expert index (``jax.lax.top_k``),
capacity is claimed slot-major (every top-1 choice of a group before any
top-2 choice), and the padding rows of the last group route like any
other token.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class MoE(nn.Module):
    """Router and expert weights, drawn from the distributions of the JAX
    ``init_moe``: the router (D, E) is fp32 whatever ``param_dtype`` is;
    ``w_gate``/``w_up`` (E, D, F) are drawn as (D, E*F) with fan-in D, and
    ``w_down`` (E, F, D) as (E*F, D) with fan-in E*F."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype = L.dtype_of(cfg.param_dtype)
        d, e, fe = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
        self.router = L._param(L.dense_init(gen, d, e, torch.float32))
        self.w_gate = L._param(L.dense_init(gen, d, e * fe, dtype)
                               .reshape(d, e, fe).permute(1, 0, 2)
                               .contiguous())
        self.w_up = L._param(L.dense_init(gen, d, e * fe, dtype)
                             .reshape(d, e, fe).permute(1, 0, 2).contiguous())
        self.w_down = L._param(L.dense_init(gen, fe * e, d, dtype)
                               .reshape(e, fe, d))

    def forward(self, cfg: ModelConfig,
                x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``moe_ffn`` with this layer's weights: (output, aux loss)."""
        return moe_ffn(self, cfg, x)


def router_topk(params: MoE, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routing with softmax-renormalized gates.

    x: (N, D) -> (assign (N,k) int32, gates (N,k) fp32, probs (N,E) fp32).
    The top k of a stable descending sort of the probabilities: among equal
    probabilities the lower expert index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` promises no order)."""
    logits = x.float() @ params.router
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    gate_vals, assign = vals[:, :k], idx[:, :k]
    gates = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return assign.to(torch.int32), gates, probs


def _dispatch_combine(assign: torch.Tensor, gates: torch.Tensor,
                      num_experts: int, capacity: int, dtype: torch.dtype):
    """(G, S, E, C) dispatch/combine tensors, one group per leading index;
    ``assign``/``gates`` are (G, S, k).

    Priority is slot-major: all top-1 choices of a group claim capacity
    before any top-2 choice, in token order within each choice. A choice
    whose position in its expert reaches ``capacity`` gets an all-zero
    slot row, as JAX's ``one_hot`` of an out-of-range index: it is
    dropped. For one (token, expert) at most one choice is nonzero, so
    both tensors are exact in any dtype."""
    g, s, k = assign.shape
    oh = F.one_hot(assign.long(), num_experts)                    # (G,S,k,E)
    oh_prio = oh.transpose(1, 2).reshape(g, k * s, num_experts)
    pos = torch.cumsum(oh_prio, dim=1) - oh_prio   # position within expert
    pos = pos.reshape(g, k, s, num_experts).transpose(1, 2)       # (G,S,k,E)
    pos_sel = (pos * oh).sum(dim=-1)                              # (G,S,k)
    slot_oh = F.one_hot(pos_sel.clamp(max=capacity),
                        capacity + 1)[..., :capacity].to(dtype)   # (G,S,k,C)
    ohd = oh.to(dtype)
    disp = torch.einsum("gske,gskc->gsec", ohd, slot_oh)
    comb = torch.einsum("gske,gskc->gsec", ohd,
                        slot_oh * gates.to(dtype)[..., None])
    return disp, comb


def expert_capacity(tokens_per_group: int, cfg: ModelConfig,
                    capacity_factor: float = 0.0) -> int:
    cf = capacity_factor or cfg.moe_capacity_factor
    c = math.ceil(tokens_per_group * cfg.num_experts_per_tok
                  * cf / cfg.num_experts)
    return max(4, min(c, tokens_per_group))


def moe_ffn(
    params: MoE,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, S, D)
    *,
    group_size: Optional[int] = None,
    capacity_factor: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), load-balancing aux loss scalar). One group
    spans the flattened tokens of the whole batch (at decode: every slot,
    idle ones included); the token count is zero-padded to a multiple of
    the group size."""
    b, s, d = x.shape
    n = b * s
    gs = min(group_size or cfg.moe_group_size, n)
    n_pad = math.ceil(n / gs) * gs
    flat = x.reshape(n, d)
    if n_pad != n:
        flat = F.pad(flat, (0, 0, 0, n_pad - n))
    ng = n_pad // gs

    assign, gates, probs = router_topk(params, cfg, flat)

    # aux loss on unpadded tokens (switch-transformer load balancing)
    tok_oh = F.one_hot(assign[:n, 0].long(), cfg.num_experts).float()
    frac_tokens = tok_oh.mean(dim=0)
    frac_probs = probs[:n].mean(dim=0)
    aux = cfg.num_experts * torch.sum(frac_tokens * frac_probs)

    cap = expert_capacity(gs, cfg, capacity_factor)
    disp, comb = _dispatch_combine(assign.reshape(ng, gs, -1),
                                   gates.reshape(ng, gs, -1),
                                   cfg.num_experts, cap, x.dtype)
    xg = flat.reshape(ng, gs, d)
    xin = torch.einsum("gsec,gsd->gecd", disp, xg).contiguous()
    xout = moe_ops.expert_ffn(xin, params.w_gate, params.w_up,
                              params.w_down)
    yg = torch.einsum("gsec,gecd->gsd", comb, xout)
    y = yg.reshape(n_pad, d)[:n].reshape(b, s, d)
    return y, aux
