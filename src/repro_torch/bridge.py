"""Carry weights from the JAX package's param tree into the port.

``params_from_numpy(tree, cfg, device)`` takes that tree with every leaf
converted to a numpy array (``jax.tree.map(np.asarray, params)``). bfloat16
leaves must arrive as their raw ``uint16`` bits (``.view(np.uint16)``):
numpy's bf16 dtype comes from ``ml_dtypes``, which ``torch.from_numpy``
refuses and which the port does not import. The bridge views those bits as
``torch.bfloat16``. The per-slot stacked axis 0 of
``tree["layers"]["slot0"]`` is unstacked into one block per layer (a
``Block`` or a ``MambaBlock``), and every weight keeps its ``(in, out)``
layout. Norm scales, an MoE router and a mamba block's ``A_log``, ``D``
and ``dt_bias`` are fp32 whatever ``param_dtype`` is, as in the JAX init.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _tensor(a: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        if a.dtype != np.uint16:
            raise TypeError(f"bfloat16 leaf must arrive as uint16 bits, got "
                            f"{a.dtype}")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy()).to(dtype)
    return t.to(device)


def _assign(param: torch.nn.Parameter, a: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> None:
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"bridge: leaf shape {tuple(a.shape)} != port "
                         f"shape {tuple(param.shape)}")
    param.data = _tensor(a, dtype, device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> transformer.Transformer:
    dev = resolve_device(device)
    pdt = L.dtype_of(cfg.param_dtype)
    # structure and shapes from a throwaway init on the CPU
    model = transformer.init_params(0, cfg, device="cpu")
    slot = tree["layers"]["slot0"]
    if tree.get("tail"):
        raise NotImplementedError("layer tails: not in the ported "
                                  "families")
    with torch.no_grad():
        _assign(model.embed.tokens, tree["embed"]["tokens"], pdt, dev)
        if "unembed" in tree["embed"]:
            _assign(model.embed.unembed, tree["embed"]["unembed"], pdt, dev)
        _assign(model.final_norm.scale, tree["final_norm"]["scale"],
                torch.float32, dev)
        for i, blk in enumerate(model.layers):
            if isinstance(blk, transformer.MambaBlock):
                _assign_mamba(blk, slot, i, pdt, dev)
                continue
            _assign(blk.norm_attn.scale, slot["norm_attn"]["scale"][i],
                    torch.float32, dev)
            _assign(blk.norm_mlp.scale, slot["norm_mlp"]["scale"][i],
                    torch.float32, dev)
            for name in ("wq", "wk", "wv", "wo"):
                _assign(getattr(blk.attn, name), slot["attn"][name][i], pdt,
                        dev)
            tree_ffn = slot["moe"] if cfg.is_moe else slot["mlp"]
            if cfg.is_moe:
                _assign(blk.ffn.router, tree_ffn["router"][i], torch.float32,
                        dev)
            for name in ("w_gate", "w_up", "w_down"):
                _assign(getattr(blk.ffn, name), tree_ffn[name][i], pdt, dev)
    return model


_MAMBA_FP32 = ("A_log", "D", "dt_bias")
_MAMBA_PARAM_DTYPE = ("in_proj", "conv_w", "conv_b", "out_proj")


def _assign_mamba(blk: transformer.MambaBlock, slot: Dict[str, Any], i: int,
                  pdt: torch.dtype, dev: torch.device) -> None:
    _assign(blk.norm.scale, slot["norm"]["scale"][i], torch.float32, dev)
    tree = slot["mamba"]
    _assign(blk.mamba.norm.scale, tree["norm"]["scale"][i], torch.float32,
            dev)
    for name in _MAMBA_FP32:
        _assign(getattr(blk.mamba, name), tree[name][i], torch.float32, dev)
    for name in _MAMBA_PARAM_DTYPE:
        _assign(getattr(blk.mamba, name), tree[name][i], pdt, dev)
