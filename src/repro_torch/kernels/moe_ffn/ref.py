"""Plain PyTorch version of the fused expert-FFN kernel (the JAX package's
``moe_ffn/ref.py::expert_ffn_ref``). The wrapper runs it for CPU tensors,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def expert_ffn_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """x: (G,E,C,D); weights: (E,D,F)/(E,F,D) -> (G,E,C,D) in x's dtype.
    Every product is taken in fp32."""
    xf = x.float()
    gate = torch.einsum("gecd,edf->gecf", xf, w_gate.float())
    up = torch.einsum("gecd,edf->gecf", xf, w_up.float())
    out = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, w_down.float())
    return out.to(x.dtype)
