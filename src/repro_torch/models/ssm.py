"""Mamba2 (SSD, state-space duality) block for mamba2-370m.

Prefill runs the chunked SSD scan, always through
``kernels.ssd_scan.ops.ssd`` (``cfg.use_pallas`` is not read): on a CUDA
tensor the wrapper launches the hand-written kernel, on a CPU tensor it
runs the plain ``ssd_chunked``. Decode is the O(1)-per-token recurrence
over the (H, P, N) state plus a width-W causal conv ring, in plain PyTorch:
the JAX package has no kernel there either.

All SSD math runs in fp32; projections stay in the config compute dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class SSMState(NamedTuple):
    """Decode-time cache of one mamba block."""
    ssm: torch.Tensor   # (B, H, P, N) fp32 state
    conv: torch.Tensor  # (B, W-1, conv_dim) last conv inputs


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


class Mamba(nn.Module):
    """Weights of one block, drawn from the distributions of the JAX
    ``init_mamba``. ``A_log``, ``D``, ``dt_bias`` and the norm scale are
    fp32 whatever ``param_dtype`` is, as there."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dtype = L.dtype_of(cfg.param_dtype)
        dev = gen.device
        nh = cfg.ssm_nheads
        self.in_proj = L._param(L.dense_init(gen, cfg.d_model,
                                             cfg.ssm_in_proj_dim, dtype))
        conv_w = torch.randn((cfg.ssm_conv_width, cfg.ssm_conv_dim),
                             generator=gen, dtype=torch.float32, device=dev)
        self.conv_w = L._param((conv_w * 0.1).to(dtype))
        self.conv_b = L._param(torch.zeros((cfg.ssm_conv_dim,), dtype=dtype,
                                           device=dev))
        # A in (1, 16) as in the mamba2 reference
        u = torch.rand((nh,), generator=gen, dtype=torch.float32, device=dev)
        a_init = torch.exp(math.log(1.0) + u * (math.log(16.0)
                                                - math.log(1.0)))
        self.A_log = L._param(torch.log(a_init))
        self.D = L._param(torch.ones((nh,), dtype=torch.float32, device=dev))
        dt = torch.rand((nh,), generator=gen, dtype=torch.float32,
                        device=dev) * 0.1
        self.dt_bias = L._param(torch.log(torch.expm1(dt.clamp(1e-3, 0.1))))
        self.norm = L.RMSNorm(cfg.ssm_d_inner, dev)
        self.out_proj = L._param(L.dense_init(gen, cfg.ssm_d_inner,
                                              cfg.d_model, dtype))


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(zxbcdt, [d_in, d_in + 2 * gn, cfg.ssm_nheads], dim=-1)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    d_in = cfg.ssm_d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return torch.split(xbc, [d_in, gn, gn], dim=-1)


# --------------------------------------------------------------------------
# block-level prefill / decode
# --------------------------------------------------------------------------


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d over a zero history. xbc: (B,S,C); w: (W,C).
    A sum of W shifted slices, in the JAX package's order (``F.conv1d``
    would sum in another order, and in TF32 through cuDNN on the card)."""
    width = w.shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    s = xbc.shape[1]
    out = sum(padded[:, i:i + s, :] * w[i][None, None, :]
              for i in range(width))
    return out + bias[None, None, :]


def _gated_out(p: Mamba, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor
               ) -> torch.Tensor:
    """Gated rmsnorm of ``y * silu(z)``, then the output projection."""
    return p.norm(y * F.silu(z), cfg.norm_eps) @ p.out_proj


def mamba_prefill(p: Mamba, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, S, D), from a zero state (the JAX block's ``initial`` has no
    caller in either package). Returns (out (B,S,D), state after the last
    token)."""
    b, s, _ = x.shape
    width = cfg.ssm_conv_width
    z, xbc_raw, dt = _split_in_proj(cfg, x @ p.in_proj)
    xbc = F.silu(_causal_conv(xbc_raw, p.conv_w, p.conv_b))
    xs, bm, cm = _split_xbc(cfg, xbc)

    nh, hd = cfg.ssm_nheads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    xs = xs.reshape(b, s, nh, hd).float()
    bm = bm.reshape(b, s, g, n).float()
    cm = cm.reshape(b, s, g, n).float()
    dtv = F.softplus(dt.float() + p.dt_bias[None, None, :])
    A = -torch.exp(p.A_log)

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk != 0:
        # zeros after the softplus: dt = 0 leaves the state as it is
        pad = chunk - s % chunk
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))

    y, fstate = ssd_ops.ssd(xs, dtv, A, bm, cm, p.D, chunk)
    y = y[:, :s].reshape(b, s, cfg.ssm_d_inner).to(x.dtype)
    out = _gated_out(p, cfg, y, z)
    # the conv tail: the last W-1 inputs before the SiLU, zeros before
    # the first token
    conv_tail = F.pad(xbc_raw, (0, 0, width - 1, 0))[:, -(width - 1):, :]
    return out, SSMState(ssm=fstate, conv=conv_tail)


def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: torch.device) -> SSMState:
    return SSMState(
        ssm=torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.ssm_conv_dim),
                         dtype=L.dtype_of(cfg.dtype), device=device),
    )


def mamba_decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                 state: SSMState) -> Tuple[torch.Tensor, SSMState]:
    """x: (B, 1, D). One step of the recurrence; returns a new state."""
    b = x.shape[0]
    z, xbc_new, dt = _split_in_proj(cfg, x @ p.in_proj)

    # conv ring: append the new input, convolve the last W entries
    conv_in = torch.cat([state.conv, xbc_new], dim=1)  # (B, W, C)
    xbc = torch.einsum("bwc,wc->bc", conv_in, p.conv_w) + p.conv_b
    xs, bm, cm = _split_xbc(cfg, F.silu(xbc)[:, None, :])

    nh, hd = cfg.ssm_nheads, cfg.ssm_head_dim
    xs = xs.reshape(b, nh, hd).float()
    bm = bm.reshape(b, cfg.ssm_groups, cfg.ssm_state).float()
    cm = cm.reshape(b, cfg.ssm_groups, cfg.ssm_state).float()
    dtv = F.softplus(dt[:, 0].float() + p.dt_bias[None, :])
    A = -torch.exp(p.A_log)

    hpg = nh // cfg.ssm_groups
    bexp = bm.repeat_interleave(hpg, dim=1)  # (B,H,N)
    cexp = cm.repeat_interleave(hpg, dim=1)
    decay = torch.exp(dtv * A[None, :])      # (B,H)
    h_new = (state.ssm * decay[:, :, None, None]
             + torch.einsum("bhn,bhp,bh->bhpn", bexp, xs, dtv))
    y = torch.einsum("bhn,bhpn->bhp", cexp, h_new) + xs * p.D[None, :, None]
    y = y.reshape(b, 1, cfg.ssm_d_inner).to(x.dtype)
    return _gated_out(p, cfg, y, z), SSMState(ssm=h_new,
                                              conv=conv_in[:, 1:, :])
