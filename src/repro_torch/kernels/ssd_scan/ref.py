"""Plain PyTorch versions of the SSD scan kernel.

- ``ssd_ref``: the token-by-token recurrence in the kernel layout
  ``(B, H, S, P)``, the oracle (the JAX package's ``ssd_scan/ref.py``).
- ``ssd_chunked``: the chunked SSD algorithm in the model layout
  ``(B, S, H, P)`` (the JAX package's ``models/ssm.py::ssd_chunked``). The
  wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the CUDA
  kernel against it on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(
    x: torch.Tensor,    # (B, H, S, P)
    dt: torch.Tensor,   # (B, H, S)
    A: torch.Tensor,    # (H,)
    Bm: torch.Tensor,   # (B, G, S, N)
    Cm: torch.Tensor,   # (B, G, S, N)
    D: torch.Tensor,    # (H,)
    h0: torch.Tensor,   # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = h_{t-1} e^{dt_t A} + dt_t x_t B_t^T, y_t = C_t . h_t + D x_t.
    Returns (y (B,H,S,P), final_state (B,H,P,N) fp32)."""
    hpg = x.shape[1] // Bm.shape[1]
    bexp = Bm.repeat_interleave(hpg, dim=1)  # (B,H,S,N)
    cexp = Cm.repeat_interleave(hpg, dim=1)
    state = h0.float()
    ys = []
    for t in range(x.shape[2]):
        xt, dtt = x[:, :, t], dt[:, :, t]
        decay = torch.exp(dtt * A[None, :])
        state = (state * decay[:, :, None, None]
                 + torch.einsum("bhp,bhn,bh->bhpn", xt, bexp[:, :, t], dtt))
        ys.append(torch.einsum("bhn,bhpn->bhp", cexp[:, :, t], state)
                  + xt * D[None, :, None])
    return torch.stack(ys, dim=2).to(x.dtype), state


def ssd_chunked(
    x: torch.Tensor,    # (B, S, H, P) fp32
    dt: torch.Tensor,   # (B, S, H)    fp32, already softplus'd
    A: torch.Tensor,    # (H,)         fp32, negative
    Bm: torch.Tensor,   # (B, S, G, N) fp32
    Cm: torch.Tensor,   # (B, S, G, N) fp32
    D: torch.Tensor,    # (H,)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N)). S % chunk must be 0.

    Within a chunk, a causal decay-weighted ``C.B^T`` term; across chunks,
    the (P, N) state carried in a loop. The chunk states contract over the
    chunk axis in one einsum, where the JAX code forms the (Q, H, P, N)
    outer products and sums them: the same sum, without a tensor of
    S x H x P x N floats."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    nc, q = s // chunk, chunk

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bexp = Bm.reshape(b, nc, q, g, n).repeat_interleave(hpg, dim=3)
    cexp = Cm.reshape(b, nc, q, g, n).repeat_interleave(hpg, dim=3)

    a = dtc * A[None, None, None, :]                  # (B,nc,Q,H) log-decay
    a_cum = torch.cumsum(a, dim=2)                     # inclusive

    # intra-chunk: L[i,j] = exp(a_cum[i] - a_cum[j]) for i >= j else 0; the
    # difference is formed before the exp, so no exp(+-a_cum) overflows
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                       torch.zeros((), dtype=seg.dtype, device=x.device))
    scores = torch.einsum("bcqhn,bckhn->bchqk", cexp, bexp)   # (B,nc,H,Q,Q)
    att = scores * lmat.permute(0, 1, 4, 2, 3)
    att = att * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]    # weight by dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att, xc)

    # chunk states: sum_j exp(a_cum[last] - a_cum[j]) dt_j x_j B_j^T
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # (B,nc,Q,H)
    chunk_states = torch.einsum("bcqhn,bcqhp->bchpn", bexp,
                                xc * (dtc * decay_to_end)[..., None])
    chunk_decay = torch.exp(a.sum(dim=2))                     # (B,nc,H)

    # inter-chunk recurrence, in the inputs' precision
    state = (initial_state.to(x.dtype) if initial_state is not None else
             torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # y_inter[i] = exp(a_cum[i]) * C_i . h_prev
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cexp, prev_states)
    y_inter = y_inter * torch.exp(a_cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y + x * D[None, None, :, None], state
