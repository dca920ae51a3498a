"""Family-dispatching facade, the same interface as the JAX package's:

    init_params(seed, cfg, device=)            -> params
    forward(params, cfg, **inputs)             -> (logits|hidden, aux)
    prefill(params, cfg, max_len, **inputs)    -> (last logits, cache)
    decode_step(params, cfg, token, cache)     -> (logits, cache)
    init_cache(cfg, batch, max_len, device=)   -> cache
    input_names(cfg)                           -> which inputs the family takes

Encoder-decoder and VLM models raise ``NotImplementedError`` until their
slice (the encoder-decoder/VLM item of ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _check_decoder_only(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM models are not ported yet "
            f"(the encoder-decoder/VLM item of ROADMAP.md §1)")


def input_names(cfg: ModelConfig):
    _check_decoder_only(cfg)
    return ("tokens",)


def init_params(seed, cfg: ModelConfig, *, device=None):
    _check_decoder_only(cfg)
    return transformer.init_params(seed, cfg, device=device)


def forward(params, cfg: ModelConfig, *, tokens, return_hidden: bool = False):
    _check_decoder_only(cfg)
    return transformer.forward(params, cfg, tokens,
                               return_hidden=return_hidden)


def prefill(params, cfg: ModelConfig, max_len: int, *, tokens):
    _check_decoder_only(cfg)
    return transformer.prefill(params, cfg, tokens, max_len)


def decode_step(params, cfg: ModelConfig, token, cache):
    _check_decoder_only(cfg)
    return transformer.decode_step(params, cfg, token, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, Any]:
    _check_decoder_only(cfg)
    return transformer.init_cache(cfg, batch, max_len, device=device)
