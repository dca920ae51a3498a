"""The port's attention kernels on the CPU, held against the JAX package.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against their plain versions there). Here, on the same numpy inputs
and the case tables of ``tests/test_kernels.py``:

- each plain version (``repro_torch.kernels.*.ref``) matches the JAX
  oracle and the JAX Pallas op in interpret mode, at the JAX tolerances
  (2e-5 fp32, 2e-2 bf16);
- each wrapper raises the JAX wrapper's call-time ``ValueError``s;
- a CPU tensor takes the plain version and the launch counter stays 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import DECODE_CASES, FLASH_CASES

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.flash_decode.ops import flash_decode as jax_decode
from repro.kernels.flash_decode.ref import decode_ref as jax_decode_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ref import decode_ref


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# The coming slices' attention shapes at CPU sizes (short S, a window of
# 16): granite-34b's G = 48, a G of 7, gemma2's Hd = 256 with a window and
# softcap 50, and a head dim that is not a multiple of 16. The CUDA kernels
# meet them at full size in chip_smoke.py.
PORT_FLASH_CASES = [
    # b, s, h, kv, hd, window, softcap, dtype
    (1, 24, 48, 1, 128, 0, 0.0, jnp.float32),
    (2, 40, 14, 2, 64, 0, 0.0, jnp.float32),
    (1, 64, 4, 2, 256, 16, 50.0, jnp.float32),
    (1, 48, 4, 2, 40, 0, 0.0, jnp.float32),
    (1, 24, 48, 1, 128, 0, 0.0, jnp.bfloat16),
    (1, 64, 4, 2, 256, 16, 50.0, jnp.bfloat16),
]
PORT_DECODE_CASES = [
    # b, s, h, kv, hd, valid_len, softcap
    (2, 64, 48, 1, 128, 50, 0.0),
    (1, 40, 14, 2, 64, 33, 0.0),
    (1, 64, 4, 2, 256, 60, 50.0),
    (2, 48, 8, 2, 40, 31, 0.0),
]


def _flash_inputs(b, s, h, kv, hd, dtype):
    rng = np.random.default_rng(b * s + h)
    return [_pair(rng, shape, dtype)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("b,s,h,kv,hd,window,cap,dtype",
                         FLASH_CASES + PORT_FLASH_CASES)
def test_flash_attention_plain_matches_jax(b, s, h, kv, hd, window, cap,
                                           dtype):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(b, s, h, kv, hd, dtype)
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    ref = attention_ref(tq, tk, tv, causal=True, window=window, softcap=cap)
    jref = jax_attention_ref(jq, jk, jv, causal=True, window=window,
                             softcap=cap)
    pallas = jax_flash(jq, jk, jv, causal=True, window=window or None,
                       softcap=cap, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(ref), _np(jref), atol=tol)
    np.testing.assert_allclose(_np(ref), _np(pallas), atol=tol)


@pytest.mark.parametrize("b,s,h,kv,hd,window,cap,dtype",
                         FLASH_CASES + PORT_FLASH_CASES)
def test_flash_attention_cpu_tensor_takes_plain_version(b, s, h, kv, hd,
                                                        window, cap, dtype):
    (_, tq), (_, tk), (_, tv) = _flash_inputs(b, s, h, kv, hd, dtype)
    out = fa_ops.flash_attention(tq, tk, tv, causal=True,
                                 window=window or None, softcap=cap,
                                 block_q=32, block_k=32)
    ref = attention_ref(tq, tk, tv, causal=True, window=window, softcap=cap)
    assert fa_ops.launches == 0
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert torch.equal(out, ref)


def _decode_inputs(b, s, h, kv, hd):
    rng = np.random.default_rng(s + h)
    return [_pair(rng, shape, jnp.float32)
            for shape in ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


@pytest.mark.parametrize("b,s,h,kv,hd,vlen,cap",
                         DECODE_CASES + PORT_DECODE_CASES)
def test_flash_decode_plain_matches_jax(b, s, h, kv, hd, vlen, cap):
    (jq, tq), (jk, tk), (jv, tv) = _decode_inputs(b, s, h, kv, hd)
    g = h // kv
    ref = decode_ref(tq.reshape(b, kv, g, hd), tk, tv, vlen, softcap=cap)
    jref = jax_decode_ref(jq.reshape(b, kv, g, hd), jk, jv, vlen, softcap=cap)
    pallas = jax_decode(jq, jk, jv, vlen, softcap=cap, block_s=64)
    np.testing.assert_allclose(_np(ref), _np(jref), atol=2e-5)
    np.testing.assert_allclose(_np(ref), _np(pallas).reshape(b, kv, g, hd),
                               atol=2e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,vlen,cap",
                         DECODE_CASES + PORT_DECODE_CASES)
def test_flash_decode_cpu_tensor_takes_plain_version(b, s, h, kv, hd, vlen,
                                                     cap):
    (_, tq), (_, tk), (_, tv) = _decode_inputs(b, s, h, kv, hd)
    g = h // kv
    out = fd_ops.flash_decode(tq, tk, tv, torch.tensor([vlen], dtype=torch.int32),
                              softcap=cap, block_s=64)
    ref = decode_ref(tq.reshape(b, kv, g, hd), tk, tv, vlen, softcap=cap)
    assert fd_ops.launches == 0
    assert out.shape == (b, 1, h, hd)
    assert torch.equal(out.reshape(b, kv, g, hd), ref)


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def test_flash_attention_rejects_ragged_heads():
    with pytest.raises(ValueError, match="flash_attention.*heads"):
        fa_ops.flash_attention(_z(1, 8, 3, 16), _z(1, 8, 2, 16),
                               _z(1, 8, 2, 16))


def test_flash_attention_rejects_nonpositive_block():
    with pytest.raises(ValueError, match="flash_attention.*block"):
        fa_ops.flash_attention(_z(1, 8, 4, 16), _z(1, 8, 2, 16),
                               _z(1, 8, 2, 16), block_q=0)


def test_flash_decode_rejects_ragged_heads():
    with pytest.raises(ValueError, match="flash_decode.*heads"):
        fd_ops.flash_decode(_z(1, 1, 3, 16), _z(1, 8, 2, 16),
                            _z(1, 8, 2, 16), torch.tensor(4))


def test_flash_decode_rejects_nonpositive_block():
    with pytest.raises(ValueError, match="flash_decode.*block"):
        fd_ops.flash_decode(_z(1, 1, 4, 16), _z(1, 8, 2, 16),
                            _z(1, 8, 2, 16), torch.tensor(4), block_s=-1)


def test_kernel_sources_and_build_are_lazy():
    """The CUDA sources ship in the package, each library is named by a
    hash of its sources, and importing the wrappers built nothing."""
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        assert _build._source(name).is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    assert _build.load.cache_info().currsize == 0


def test_wrappers_have_no_group_limit():
    """Any G with heads % kv_heads == 0 is taken: the kernels' row tiles
    hold a fixed number of (position, group head) rows, not one block per
    group."""
    assert not hasattr(fa_ops, "MAX_GROUP") and not hasattr(fd_ops,
                                                            "MAX_GROUP")
    assert fa_ops.MAX_HEAD_DIM == fd_ops.MAX_HEAD_DIM == 256


@pytest.mark.parametrize("b,kv,s", [
    (4, 8, 112), (1, 8, 8192), (2, 1, 300), (1, 16, 4608), (3, 2, 100),
    (1, 1, 31), (1, 1, 100000)])
def test_decode_splits_follow_the_capacity(b, kv, s):
    """The cache split count is a function of the shapes alone (never of
    valid_len): at least one split, every split but a lone one at least
    MIN_SPLIT_KEYS positions long, and about SPLIT_BLOCKS blocks once the
    capacity allows that many."""
    n = fd_ops.num_splits(b, kv, s)
    assert n >= 1
    assert n == 1 or s // n >= fd_ops.MIN_SPLIT_KEYS
    assert (n - 1) * b * kv < fd_ops.SPLIT_BLOCKS
    if s // fd_ops.MIN_SPLIT_KEYS >= fd_ops.SPLIT_BLOCKS:
        assert n * b * kv >= fd_ops.SPLIT_BLOCKS


def test_library_path_changes_with_every_included_header(tmp_path,
                                                          monkeypatch):
    """A library is named by its source and every local header it includes,
    so editing a header rebuilds each kernel that includes it, and only
    those."""
    import shutil

    from repro_torch.kernels import _build
    kernels = tmp_path / "kernels"
    shutil.copytree(_build.KERNEL_DIR, kernels,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "KERNEL_DIR", kernels)
    for name in _build.KERNELS:
        src = _build._source(name)
        for inc in _build._LOCAL_INCLUDE.findall(src.read_text()):
            assert (src.parent / inc).resolve() in _build.inputs(name)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    header = kernels / "attn_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    users = {name for name in _build.KERNELS
             if header.resolve() in _build.inputs(name)}
    assert users == {"flash_attention", "flash_decode"}
    for name in _build.KERNELS:
        assert (before[name] != after[name]) == (name in users)
