"""Serving step functions and the host-side generation loop.

``make_serve_step`` gives one token in, (next token, cache) out. Sampling
is greedy by default (``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does); temperature sampling draws from an explicit
``torch.Generator``. The decode step updates the KV cache in place, the
counterpart of the JAX package donating it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 tokens."""
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)
    else:
        tok = torch.argmax(logits, dim=-1, keepdim=True)
    return tok.to(torch.int32)


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0):
    def serve_step(params, token, cache, generator=None):
        logits, cache = api.decode_step(params, cfg, token, cache)
        return _sample(logits[:, -1, :], temperature, generator), cache

    return serve_step


def generate(
    params,
    cfg: ModelConfig,
    prompt,  # (B, S) int
    steps: int,
    *,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Prefill the prompt, then decode ``steps - 1`` more tokens.
    Returns the ``steps`` generated ids, (B, steps)."""
    dev = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
    b, s = prompt.shape
    max_len = max_len or (s + steps + 8)
    logits, cache = api.prefill(params, cfg, max_len, tokens=prompt)
    gen = None
    if temperature > 0.0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    tok = _sample(logits[:, -1, :], temperature, gen)
    serve_step = make_serve_step(cfg, temperature)
    out = [tok]
    for _ in range(steps - 1):
        tok, cache = serve_step(params, tok, cache, gen)
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()
