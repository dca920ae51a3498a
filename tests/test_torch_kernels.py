"""The port's attention kernels on the CPU, held against the JAX package,
and the launch geometry of every kernel.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them against their plain versions there). Here, on the same numpy inputs
and the case tables of ``tests/test_kernels.py``:

- each plain version (``repro_torch.kernels.*.ref``) matches the JAX
  oracle and the JAX Pallas op in interpret mode, at the JAX tolerances
  (2e-5 fp32, 2e-2 bf16);
- each wrapper raises the JAX wrapper's call-time ``ValueError``s;
- a CPU tensor takes the plain version and the launch counter stays 0;
- each wrapper's launch plan (cache splits, cluster, row tiles, F slabs,
  head-dim splits) is a function of the shapes that covers them exactly,
  fits a block's shared memory with the constants of its kernel's source,
  and fills at least half a wave of the H100's 132 SMs at the serving
  shapes.
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
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

SMS = 132  # streaming multiprocessors of an H100 SXM


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


# (G, E, C, D, F): granite-moe-1b's decode tick and prefill buckets, its
# 4096-token case, the CPU tests' expert-FFN table with an odd width, and
# expert widths whose h does not fit a block (grok-1-314b's D=6144,
# F=32768; ragged slabs)
MOE_PLAN_CASES = [
    (1, 32, 4, 1024, 512), (1, 32, 10, 1024, 512), (1, 32, 20, 1024, 512),
    (1, 32, 30, 1024, 512), (8, 32, 160, 1024, 512), (2, 4, 16, 64, 128),
    (1, 8, 100, 32, 300), (1, 2, 8, 16, 48), (1, 3, 7, 33, 40),
    (1, 8, 4, 6144, 32768), (4, 8, 64, 6144, 32768), (1, 2, 8, 1024, 2600),
    (1, 2, 8, 1024, 5000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,e,c,d,f", MOE_PLAN_CASES)
def test_moe_plan_covers_the_shapes(g, e, c, d, f, dtype):
    """The expert FFN's plan: every block of a cluster owns F columns (whole
    gate/up passes) of each slab, the slabs cover F exactly and the cluster
    covers D; the row tiles cover the G*C capacity rows of an expert
    exactly; the block fits in shared memory; the plan takes shapes only
    and repeats itself; and at granite's serving shapes (G=1, C <= 30) one
    slab and one tile hold everything, so each weight byte is read once,
    over at least half a wave of SMs."""
    pl = moe_ops.plan(g, e, c, d, f, dtype)
    assert pl == moe_ops.plan(g, e, c, d, f, dtype)
    assert 1 <= pl.nf <= moe_ops.MAX_CLUSTER
    assert pl.fr % moe_ops.PASS_F == 0 and pl.dr % moe_ops.PASS_D == 0
    fs = pl.nf * pl.fr
    assert pl.slabs * fs >= f > (pl.slabs - 1) * fs
    if pl.slabs == 1:
        assert f > (pl.nf - 1) * pl.fr
    assert pl.nf * pl.dr >= d
    assert pl.nm * pl.bm >= g * c > (pl.nm - 1) * pl.bm
    assert pl.smem == moe_ops._smem_bytes(pl.bm, min(f, fs), dtype)
    assert pl.smem <= moe_ops.MAX_SMEM
    if (g, e, d, f) == (1, 32, 1024, 512):
        assert pl.nm == 1 and pl.slabs == 1
        assert (pl.nf, pl.fr, pl.dr) == (4, 128, 256)
        assert e * pl.blocks >= SMS // 2


def test_moe_plan_refuses_an_h_beyond_shared_memory():
    """The h of a row tile stays in shared memory, so the plan never holds
    one wider than fits: at an expert width whose h cannot fit (grok-1's
    F = 32768), it cuts F into the widest slabs that do, in both dtypes,
    where granite's F = 512 takes one slab."""
    for dtype in (torch.float32, torch.bfloat16):
        assert moe_ops.plan(1, 32, 4, 1024, 512, dtype).slabs == 1
        pl = moe_ops.plan(1, 8, 4, 6144, 32768, dtype)
        assert pl.slabs > 1 and pl.smem <= moe_ops.MAX_SMEM
        wider = pl.nf * (pl.fr + moe_ops.PASS_F)
        assert moe_ops._smem_bytes(pl.bm, wider, dtype) > moe_ops.MAX_SMEM
        assert moe_ops._smem_bytes(pl.bm, 32768, dtype) > moe_ops.MAX_SMEM


# (B, H, P, N, chunk): mamba2-370m's prefill buckets (chunk = S), its
# 4096-token case, zamba2-2.7b's shape, the CPU tests' SSD table, odd split
# counts at chunk 256 (no cluster) and chunks long enough that the shared
# C.B^T tiles do not fit a block
SSD_PLAN_CASES = [
    (1, 32, 64, 128, 32), (1, 32, 64, 128, 64), (1, 32, 64, 128, 96),
    (1, 32, 64, 128, 256), (1, 80, 64, 64, 256), (2, 4, 16, 32, 16),
    (1, 8, 32, 16, 32), (2, 4, 8, 8, 16), (1, 2, 64, 64, 24),
    (1, 32, 48, 128, 256), (1, 32, 16, 128, 256), (1, 8, 80, 256, 256),
    (1, 8, 64, 128, 512), (1, 8, 64, 256, 1024)]


@pytest.mark.parametrize("b,h,p,n,chunk", SSD_PLAN_CASES)
def test_ssd_plan_covers_the_shapes(b, h, p, n, chunk):
    """The SSD scan's plan: the head-dim splits cover P exactly, the
    clusters divide them and stay within the portable size (1 where the
    tiles are not shared), the planned block fits in shared memory, a
    chunk stays whole in shared memory wherever some mode allows it, the
    plan repeats itself, and mamba2's and zamba2's shapes fill at least
    half a wave of SMs."""
    pl = ssd_ops.plan(p, n, chunk)
    assert pl == ssd_ops.plan(p, n, chunk)
    assert pl.splits * ssd_ops.SPLIT_WIDTH >= p > (pl.splits - 1) * \
        ssd_ops.SPLIT_WIDTH
    assert pl.splits % pl.cluster == 0
    assert 1 <= pl.cluster <= max(ssd_ops.CLUSTERS)
    assert pl.shared or pl.cluster == 1
    assert pl.smem == ssd_ops._smem_bytes(n, chunk, pl.cluster, pl.resident,
                                         pl.shared)
    assert pl.smem <= ssd_ops.MAX_SMEM
    fitting = [cl for cl in ssd_ops.CLUSTERS if pl.splits % cl == 0
               and ssd_ops._smem_bytes(n, chunk, cl, True, True)
               <= ssd_ops.MAX_SMEM]
    if fitting:
        assert (pl.cluster, pl.resident, pl.shared) == (fitting[0], True,
                                                         True)
    if ssd_ops._smem_bytes(n, chunk, 1, True, False) <= ssd_ops.MAX_SMEM:
        assert pl.resident
    alone = ssd_ops.plan(p, n, chunk, share=False)
    assert (alone.cluster, alone.shared) == (1, False)
    assert alone.smem <= ssd_ops.MAX_SMEM
    if h >= 32 and p == 64:
        assert b * h * pl.splits >= SMS // 2
    if (h, p, n) == (32, 64, 128) and chunk <= 96:
        assert (pl.splits, pl.cluster, pl.resident, pl.shared) == (4, 2,
                                                                   True, True)


def test_ssd_plan_refuses_a_chunk_beyond_shared_memory():
    """A chunk's dt, log-decays and weights stay in shared memory in every
    mode, so a chunk too long for any is refused before a launch."""
    with pytest.raises(ValueError, match="ssd_scan: chunk 16384"):
        ssd_ops.plan(64, 128, 16384)


def _cu_constants(path):
    """The namespace-level ``constexpr int|size_t name = expression;`` of a
    CUDA source (integer arithmetic on the names before it), and the
    ``BK``/``PAD`` of each ``Geo<T>``."""
    import re
    text = path.read_text()
    found = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|size_t) (\w+) = ([\w\s+*/()-]+);", text,
            re.MULTILINE):
        expr = re.sub(r"[A-Za-z_]\w*", lambda m: str(found[m[0]]), expr)
        found[name] = eval(expr.replace("/", "//"), {"__builtins__": {}})
    for t, bk, pad in re.findall(
            r"struct Geo<(\w+)> \{\s*static constexpr int BK = (\d+), "
            r"PAD = (\d+);", text):
        found[f"Geo<{t}>"] = (int(bk), int(pad))
    return found


def test_moe_plan_mirrors_the_kernel_source():
    """The plan's copies of moe_ffn.cu's geometry agree with the source,
    so the shared memory it passes is what the kernel counts."""
    from repro_torch.kernels import _build
    k = _cu_constants(_build._source("moe_ffn"))
    assert (k["kPassA"], k["kPassB"], k["kMaxCluster"], k["kStages"],
            k["kMaxSmem"]) == (moe_ops.PASS_F, moe_ops.PASS_D,
                               moe_ops.MAX_CLUSTER, moe_ops.STAGES,
                               moe_ops.MAX_SMEM)
    assert k["Geo<float>"] == moe_ops._GEOMETRY[torch.float32][:2]
    assert k["Geo<bf16>"] == moe_ops._GEOMETRY[torch.bfloat16][:2]


def test_ssd_plan_mirrors_the_kernel_source():
    """The plan's copies of ssd_scan.cu's geometry agree with the source,
    so the shared memory it passes is what the kernel counts."""
    from repro_torch.kernels import _build
    k = _cu_constants(_build._source("ssd_scan"))
    assert (k["kTile"], k["kPS"], k["kMaxN"], k["kPart"], k["kMaxCluster"],
            k["kMaxSmem"]) == (ssd_ops._TILE, ssd_ops.SPLIT_WIDTH,
                               ssd_ops.MAX_STATE_DIM, ssd_ops._PART,
                               max(ssd_ops.CLUSTERS), ssd_ops.MAX_SMEM)
    assert k["kLdR"] == ssd_ops._LD_RAW


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """Every kernel includes ``sm90.cuh`` (the two attention kernels
    through ``attn_tile.cuh``), so editing it rebuilds all four."""
    import shutil

    from repro_torch.kernels import _build
    kernels = tmp_path / "kernels"
    shutil.copytree(_build.KERNEL_DIR, kernels,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "KERNEL_DIR", kernels)
    header = kernels / "sm90.cuh"
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    header.write_text(header.read_text() + "\n// edited\n")
    for name in _build.KERNELS:
        assert header.resolve() in _build.inputs(name)
        assert _build.library_path(name) != before[name]
