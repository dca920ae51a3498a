"""Carry weights from the JAX package's param tree into the port.

``params_from_numpy(tree, cfg, device)`` takes that tree with every leaf
converted to a numpy array (``jax.tree.map(np.asarray, params)``). bfloat16
leaves must arrive as their raw ``uint16`` bits (``.view(np.uint16)``):
numpy's bf16 dtype comes from ``ml_dtypes``, which ``torch.from_numpy``
refuses and which the port does not import. The bridge views those bits as
``torch.bfloat16``. The JAX tree stacks a period's slot ``i`` along axis
0 (``tree["layers"]["slot{i}"]``), so layer ``period * every + i`` takes
index ``period`` of slot ``i``; the unstacked ``tree["tail"][j]`` goes to
layer ``n_full * every + j``, and a hybrid model's ``tree["shared"]`` to
its one shared block. Every weight keeps its ``(in, out)`` layout. Norm
scales, an MoE router and a mamba block's ``A_log``, ``D`` and
``dt_bias`` are fp32 whatever ``param_dtype`` is, as in the JAX init.
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
    pattern, n_full, _ = transformer.layout(cfg)
    every = len(pattern)
    with torch.no_grad():
        _assign(model.embed.tokens, tree["embed"]["tokens"], pdt, dev)
        if "unembed" in tree["embed"]:
            _assign(model.embed.unembed, tree["embed"]["unembed"], pdt, dev)
        _assign(model.final_norm.scale, tree["final_norm"]["scale"],
                torch.float32, dev)
        for i, blk in enumerate(model.layers):
            if i < n_full * every:
                leaves = _index(tree["layers"][f"slot{i % every}"],
                                i // every)
            else:
                leaves = tree["tail"][i - n_full * every]
            _assign_block(blk, leaves, pdt, dev)
        if cfg.family == "hybrid":
            _assign_block(model.shared, tree["shared"], pdt, dev)
    return model


def _index(leaves: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Entry ``i`` of a stacked slot: every leaf indexed along axis 0."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in leaves.items()}


def _assign_block(blk, leaves: Dict[str, Any], pdt: torch.dtype,
                  dev: torch.device) -> None:
    """One layer's (unstacked) leaves into a ``Block`` or ``MambaBlock``."""
    if isinstance(blk, transformer.MambaBlock):
        _assign_mamba(blk, leaves, pdt, dev)
        return
    _assign(blk.norm_attn.scale, leaves["norm_attn"]["scale"],
            torch.float32, dev)
    _assign(blk.norm_mlp.scale, leaves["norm_mlp"]["scale"], torch.float32,
            dev)
    for name in ("wq", "wk", "wv", "wo"):
        _assign(getattr(blk.attn, name), leaves["attn"][name], pdt, dev)
    ffn = leaves["moe"] if "moe" in leaves else leaves["mlp"]
    if "moe" in leaves:
        _assign(blk.ffn.router, ffn["router"], torch.float32, dev)
    for name in ("w_gate", "w_up", "w_down"):
        _assign(getattr(blk.ffn, name), ffn[name], pdt, dev)


_MAMBA_FP32 = ("A_log", "D", "dt_bias")
_MAMBA_PARAM_DTYPE = ("in_proj", "conv_w", "conv_b", "out_proj")


def _assign_mamba(blk: transformer.MambaBlock, leaves: Dict[str, Any],
                  pdt: torch.dtype, dev: torch.device) -> None:
    _assign(blk.norm.scale, leaves["norm"]["scale"], torch.float32, dev)
    tree = leaves["mamba"]
    _assign(blk.mamba.norm.scale, tree["norm"]["scale"], torch.float32, dev)
    for name in _MAMBA_FP32:
        _assign(getattr(blk.mamba, name), tree[name], torch.float32, dev)
    for name in _MAMBA_PARAM_DTYPE:
        _assign(getattr(blk.mamba, name), tree[name], pdt, dev)
