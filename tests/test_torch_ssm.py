"""The port's Mamba2 path (mamba2-370m) against the JAX package's, on the CPU.

- The SSD scan's plain versions (``ssd_ref``, ``ssd_chunked``) and its
  wrapper against the JAX oracle, the JAX ``ssd_chunked`` and the JAX
  Pallas op in interpret mode, over the case table of
  ``tests/test_kernels.py``, at its tolerance (5e-4).
- The reduced mamba2-370m (2 layers, d=128, state 16, head dim 16, chunk
  16): weights initialised by the JAX package and bridged into the port,
  the same numpy tokens into both. fp32 logits, prefill state and decode
  logits agree to 2e-5, the tolerance of ``tests/test_models.py``, with
  JAX run both without and with its Pallas routing.
- Both batchers and both backends on that model.

Every tolerance is the JAX tests' own; the errors observed on this CPU are
written beside each.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_kernels import SSD_CASES
from test_torch_models import numpy_tree

from repro.configs import get_config as jax_get_config
from repro.engine.backend import JaxBackend
from repro.engine.executor import Executor
from repro.engine.workloads import WORKLOADS
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import api as jax_api
from repro.models import ssm as jax_ssm
from repro.serving import scheduler as jax_sched
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.backend import TorchBackend
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref
from repro_torch.models import api
from repro_torch.models import ssm
from repro_torch.models.transformer import MambaBlock, count_params
from repro_torch.serving import scheduler as sched

ARCH = "mamba2-370m"
SSD_ATOL = 5e-4   # tests/test_kernels.py
ATOL = 2e-5       # tests/test_models.py


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _ssd_inputs(b, s, h, p, g, n, seed):
    """The JAX test's distributions, drawn once with numpy: dt a softplus,
    A in (-e, -1), B and C of std 0.5, D ones."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(size=(h,))).astype(np.float32)
    Bm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    D = np.ones((h,), np.float32)
    return x, dt, A, Bm, Cm, D


def _kernel_layout(x, dt, Bm, Cm):
    """Model layout (B,S,H,P) -> the oracle's (B,H,S,P), for torch tensors
    and JAX arrays alike."""
    perm = "permute" if isinstance(x, torch.Tensor) else "transpose"
    return (getattr(x, perm)(0, 2, 1, 3), getattr(dt, perm)(0, 2, 1),
            getattr(Bm, perm)(0, 2, 1, 3), getattr(Cm, perm)(0, 2, 1, 3))


# --------------------------------------------------------------------------
# the SSD scan's plain versions and wrapper
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_plain_matches_jax(b, s, h, p, g, n, chunk):
    """Observed here, over the table (outputs up to 27): port ``ssd_ref``
    vs JAX ``ssd_ref`` 3.8e-6; port ``ssd_chunked`` vs JAX ``ssd_chunked``
    1.8e-5 and vs the Pallas op 1.8e-5; ``ssd_chunked`` vs the oracle
    1.0e-5."""
    arrs = _ssd_inputs(b, s, h, p, g, n, seed=s + h)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in arrs)
    jx, jdt, jA, jB, jC, jD = (jnp.asarray(a) for a in arrs)
    h0 = np.zeros((b, h, p, n), np.float32)

    kx, kdt, kb, kc = _kernel_layout(x, dt, Bm, Cm)
    yr, hr = ssd_ref(kx, kdt, A, kb, kc, D, torch.from_numpy(h0))
    kx, kdt, kb, kc = _kernel_layout(jx, jdt, jB, jC)
    jyr, jhr = jax_ssd_ref(kx, kdt, jA, kb, kc, jD, jnp.asarray(h0))
    np.testing.assert_allclose(_np(yr), _np(jyr), atol=SSD_ATOL)
    np.testing.assert_allclose(_np(hr), _np(jhr), atol=SSD_ATOL)

    y, hf = ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    jy, jhf = jax_ssm.ssd_chunked(jx, jdt, jA, jB, jC, jD, chunk)
    py, phf = jax_ssd(jx, jdt, jA, jB, jC, jD, chunk)
    for want_y, want_h in ((jy, jhf), (py, phf),
                           (_np(yr).transpose(0, 2, 1, 3), hr)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=SSD_ATOL)
        np.testing.assert_allclose(_np(hf), _np(want_h), atol=SSD_ATOL)
    # the two chunked versions compute the same sums: far below the limit
    assert np.abs(_np(y) - _np(jy)).max() < SSD_ATOL / 10


def test_ssd_initial_state_carries():
    """Splitting a sequence in two with the state carried == one pass, in
    the port's wrapper (CPU), and both halves equal the JAX wrapper's, as
    ``tests/test_kernels.py::test_ssd_initial_state_carries``."""
    b, s, h, p, g, n, chunk = 1, 64, 2, 8, 1, 16, 16
    arrs = _ssd_inputs(b, s, h, p, g, n, seed=7)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in arrs)
    jx, jdt, jA, jB, jC, jD = (jnp.asarray(a) for a in arrs)
    half = s // 2
    y_full, h_full = ssd_ops.ssd(x, dt, A, Bm, Cm, D, chunk)
    y1, h1 = ssd_ops.ssd(x[:, :half], dt[:, :half], A, Bm[:, :half],
                         Cm[:, :half], D, chunk)
    y2, h2 = ssd_ops.ssd(x[:, half:], dt[:, half:], A, Bm[:, half:],
                         Cm[:, half:], D, chunk, initial_state=h1)
    np.testing.assert_allclose(_np(y_full[:, half:]), _np(y2), atol=SSD_ATOL)
    np.testing.assert_allclose(_np(h_full), _np(h2), atol=SSD_ATOL)
    jy1, jh1 = jax_ssd(jx[:, :half], jdt[:, :half], jA, jB[:, :half],
                       jC[:, :half], jD, chunk)
    jy2, jh2 = jax_ssd(jx[:, half:], jdt[:, half:], jA, jB[:, half:],
                       jC[:, half:], jD, chunk, initial_state=jh1)
    np.testing.assert_allclose(_np(y2), _np(jy2), atol=SSD_ATOL)
    np.testing.assert_allclose(_np(h2), _np(jh2), atol=SSD_ATOL)
    assert ssd_ops.launches == 0


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_CASES)
def test_ssd_cpu_tensor_takes_plain_version(b, s, h, p, g, n, chunk):
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in
                           _ssd_inputs(b, s, h, p, g, n, seed=1))
    h0 = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, h, p, n)).astype(np.float32))
    y, hf = ssd_ops.ssd(x, dt, A, Bm, Cm, D, chunk, initial_state=h0)
    yr, hr = ssd_chunked(x, dt, A, Bm, Cm, D, chunk, h0)
    assert ssd_ops.launches == 0
    assert y.shape == (b, s, h, p) and hf.shape == (b, h, p, n)
    assert hf.dtype == torch.float32
    assert torch.equal(y, yr) and torch.equal(hf, hr)


def test_ssd_decay_differences_stay_finite():
    """The decay trap: with A down to -16 and a chunk of 256, a_cum reaches
    -3528 within the chunk, where exp(a_cum[i]) * exp(-a_cum[j]) is
    0 * inf. ``ssd_chunked`` forms the difference first and stays finite
    and equal to the oracle (observed error 1.3e-4, outputs up to 12)."""
    b, s, h, p, g, n = 1, 256, 4, 8, 1, 16
    x, dt, _, Bm, Cm, D = (torch.from_numpy(a) for a in
                           _ssd_inputs(b, s, h, p, g, n, seed=3))
    A = -torch.tensor([1.0, 4.0, 9.0, 16.0])
    a_cum = torch.cumsum(dt * A, dim=1)
    assert float(a_cum.min()) < -500  # exp(-a_cum) overflows fp32
    y, hf = ssd_chunked(x, dt, A, Bm, Cm, D, 256)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    kx, kdt, kb, kc = _kernel_layout(x, dt, Bm, Cm)
    yr, hr = ssd_ref(kx, kdt, A, kb, kc, D, torch.zeros((b, h, p, n)))
    np.testing.assert_allclose(_np(y), _np(yr.transpose(1, 2)),
                               atol=SSD_ATOL)
    np.testing.assert_allclose(_np(hf), _np(hr), atol=SSD_ATOL)


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _ssd_args(s, h=4, g=2, p=8, n=4):
    return (_z(1, s, h, p), _z(1, s, h), _z(h), _z(1, s, g, n),
            _z(1, s, g, n), _z(h))


@pytest.mark.parametrize("args,chunk,match", [
    (_ssd_args(10), 4, "ssd_scan.*seq"),
    (_ssd_args(8), 0, "ssd_scan.*chunk"),
    (_ssd_args(8, h=5, g=2), 4, "ssd_scan.*heads"),
], ids=["ragged_seq", "nonpositive_chunk", "ragged_head_groups"])
def test_ssd_rejects_what_the_jax_wrapper_rejects(args, chunk, match):
    """The three call-time errors of ``tests/test_kernel_validation.py``,
    with the same match text, in both wrappers."""
    with pytest.raises(ValueError, match=match):
        ssd_ops.ssd(*args, chunk=chunk)
    with pytest.raises(ValueError, match=match):
        jax_ssd(*(jnp.asarray(a.numpy()) for a in args), chunk=chunk)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def bridged_mamba(dtype="float32", seed=0):
    """(jax cfg, jax params, port cfg, port params) of the reduced
    mamba2-370m, with the port's weights bridged from the JAX init."""
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype=dtype,
                                                      param_dtype=dtype)
    tcfg = get_config(ARCH, reduced=True).replace(dtype=dtype,
                                                  param_dtype=dtype)
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def fp32_models():
    return bridged_mamba("float32")


JAX_ROUTES = {"jnp": {}, "pallas": {"use_pallas": True,
                                    "pallas_interpret": True}}


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_bf16_bridge_is_bit_exact():
    """Every mamba leaf is copied bit for bit; ``A_log``, ``D``,
    ``dt_bias`` and the norm scales stay fp32 in a bf16 model."""
    _, jparams, tcfg, tparams = bridged_mamba("bfloat16", seed=5)
    tree = numpy_tree(jparams)
    slot = tree["layers"]["slot0"]
    pairs = [(tparams.embed.tokens, tree["embed"]["tokens"]),
             (tparams.final_norm.scale, tree["final_norm"]["scale"])]
    for i, blk in enumerate(tparams.layers):
        assert isinstance(blk, MambaBlock)
        m = slot["mamba"]
        pairs += [(blk.norm.scale, slot["norm"]["scale"][i]),
                  (blk.mamba.norm.scale, m["norm"]["scale"][i])]
        pairs += [(getattr(blk.mamba, k), m[k][i])
                  for k in ("in_proj", "conv_w", "conv_b", "A_log", "D",
                            "dt_bias", "out_proj")]
    n_leaves = len(jax.tree_util.tree_leaves(jparams["layers"])) \
        * tcfg.num_layers + 2
    assert len(pairs) == n_leaves
    for t, a in pairs:
        if a.dtype == np.uint16:
            assert t.dtype == torch.bfloat16
            got = t.view(torch.int16).numpy().view(np.uint16)
        else:
            assert t.dtype == torch.float32
            got = t.numpy()
        assert got.shape == a.shape and np.array_equal(got, a)
    for blk in tparams.layers:
        assert blk.mamba.in_proj.dtype == torch.bfloat16
        assert blk.mamba.conv_b.dtype == torch.bfloat16
        for name in ("A_log", "D", "dt_bias"):
            assert getattr(blk.mamba, name).dtype == torch.float32
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert count_params(tparams) == n_jax


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
def test_forward_logits_match_jax(fp32_models, route):
    """Observed here: 7.7e-7 (logits up to ~1)."""
    jcfg, jparams, tcfg, tparams = fp32_models
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, 32, tcfg.vocab_size)
    jl, _ = jax_api.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    tl, aux = api.forward(tparams, tcfg, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 32, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def _assert_state_matches(tc, jc):
    """Layer i of the port's cache against slice i of the JAX slot0
    stack: the (B,H,P,N) fp32 SSD state and the (B,W-1,C) conv tail."""
    st = jc["slots"]["slot0"]
    for i, layer in enumerate(tc["layers"]):
        assert layer["ssm"].dtype == torch.float32
        np.testing.assert_allclose(layer["ssm"].numpy(),
                                   np.asarray(st.ssm[i]), atol=ATOL)
        np.testing.assert_allclose(layer["conv"].numpy(),
                                   np.asarray(st.conv[i]), atol=ATOL)


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
@pytest.mark.parametrize("s", [32, 40])
def test_prefill_logits_and_state_match_jax(fp32_models, route, s):
    """S=32 is two chunks of 16; S=40 is padded to 48 with zeros *after*
    the softplus, so the pad steps leave the state as it is (padding
    before it would move the state, see
    ``test_prefill_pads_dt_after_softplus``). Observed here: logits 4.6e-7,
    SSD state 2.8e-8, conv tail 1.8e-6."""
    jcfg, jparams, tcfg, tparams = fp32_models
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, s, tcfg.vocab_size, seed=4)
    jl, jc = jax_api.prefill(jparams, jcfg, 64, tokens=jnp.asarray(toks))
    tl, tc = api.prefill(tparams, tcfg, 64, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tc["len"]) == int(jc["len"]) == s
    assert len(tc["layers"]) == tcfg.num_layers
    _assert_state_matches(tc, jc)


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
def test_decode_steps_match_jax(fp32_models, route):
    """Three decode steps after a prefill of 40 tokens: logits and the
    state after each. Observed here: 5.8e-7."""
    jcfg, jparams, tcfg, tparams = fp32_models
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, 40, tcfg.vocab_size, seed=2)
    nxt = _tokens(2, 3, tcfg.vocab_size, seed=3)
    _, jc = jax_api.prefill(jparams, jcfg, 48, tokens=jnp.asarray(toks))
    _, tc = api.prefill(tparams, tcfg, 48, tokens=torch.from_numpy(toks))
    for i in range(3):
        jl, jc = jax_api.decode_step(jparams, jcfg,
                                     jnp.asarray(nxt[:, i:i + 1]), jc)
        tl, tc = api.decode_step(tparams, tcfg,
                                 torch.from_numpy(nxt[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        _assert_state_matches(tc, jc)
    assert int(tc["len"]) == 43


def test_decode_matches_forward(fp32_models):
    """prefill(S-1) + decode_step(1 token) == forward, on the port: the
    prefill's state and conv tail carry on exactly where the chunked scan
    left off."""
    _, _, tcfg, tparams = fp32_models
    b, s = 2, 41
    toks = torch.from_numpy(_tokens(b, s, tcfg.vocab_size, seed=1))
    full, _ = api.forward(tparams, tcfg, tokens=toks)
    pl, cache = api.prefill(tparams, tcfg, 48, tokens=toks[:, :s - 1])
    dl, cache = api.decode_step(tparams, tcfg, toks[:, s - 1:s], cache)
    np.testing.assert_allclose(pl[:, 0].numpy(), full[:, s - 2].numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, s - 1].numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("s", [9, 2])
def test_causal_conv_matches_jax(s):
    """The conv as a sum of W shifted slices equals the JAX package's
    (observed 0: the same sums in the same order), also for a sequence
    shorter than the conv's W-1 steps of history."""
    rng = np.random.default_rng(0)
    xbc = rng.standard_normal((2, s, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    got = ssm._causal_conv(*(torch.from_numpy(a) for a in (xbc, w, bias)))
    want = jax_ssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_prefill_pads_dt_after_softplus(fp32_models):
    """The chunk-padding trap, on the block itself (S=40, chunk 16): the
    state out of ``mamba_prefill`` equals the state of the unpadded
    recurrence, and would not if dt were padded before the softplus."""
    _, _, tcfg, tparams = fp32_models
    p = tparams.layers[0].mamba
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 40, tcfg.d_model)).astype(np.float32))
    _, state = ssm.mamba_prefill(p, tcfg, x)
    # the same block with the chunk = S: no padding at all
    _, exact = ssm.mamba_prefill(p, tcfg.replace(ssm_chunk=40), x)
    np.testing.assert_allclose(state.ssm.numpy(), exact.ssm.numpy(),
                               atol=ATOL)
    # padding the raw dt would give the 8 pad steps dt = softplus(dt_bias)
    # and decay the state of some head by more than 10%: the check above
    # would see it
    pad_decay = torch.exp(8 * F.softplus(p.dt_bias) * -torch.exp(p.A_log))
    assert float(pad_decay.min()) < 0.9


def test_init_params_draws_the_jax_distributions():
    """Shapes and dtypes of the JAX tree; A_log in [log 1, log 16];
    dt_bias = log(expm1(dt)) with dt in [1e-3, 0.1]; D ones, conv bias and
    norm scales zero; conv weights N(0, 0.1^2)."""
    cfg = get_config(ARCH, reduced=True).replace(ssm_state=32, d_model=256)
    jcfg = jax_get_config(ARCH, reduced=True).replace(ssm_state=32,
                                                      d_model=256)
    tparams = api.init_params(0, cfg, device="cpu")
    jtree = numpy_tree(jax_api.init_params(jax.random.PRNGKey(0), jcfg))
    jm = jtree["layers"]["slot0"]["mamba"]
    for blk in tparams.layers:
        m = blk.mamba
        for name in ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                     "out_proj"):
            t = getattr(m, name)
            assert tuple(t.shape) == jm[name].shape[1:], name
            want = torch.bfloat16 if jm[name].dtype == np.uint16 \
                else torch.float32
            assert t.dtype == want, name
        a_log = m.A_log.numpy()
        assert (a_log >= -1e-6).all() and (a_log <= math.log(16) + 1e-6).all()
        dt = np.log1p(np.exp(m.dt_bias.numpy()))   # softplus undoes it
        assert (dt >= 1e-3 - 1e-7).all() and (dt <= 0.1 + 1e-7).all()
        assert torch.equal(m.D, torch.ones_like(m.D))
        assert not m.conv_b.float().any() and not m.norm.scale.any()
        assert abs(float(m.conv_w.float().std()) - 0.1) < 0.01
        assert abs(float(m.in_proj.float().std()) * 16 - 0.8796) < 0.02
    assert count_params(tparams) == sum(a.size for a in
                                        jax.tree_util.tree_leaves(jtree))


def test_hybrid_still_raises():
    """The hybrid family builds now (``tests/test_torch_hybrid.py``), but
    a hybrid config with an attention option its shared block would need
    and the port lacks still raises, naming its ROADMAP item."""
    cfg = get_config("zamba2-2.7b", reduced=True)
    for kw in ({"kv_cache_dtype": "int8"}, {"attn_pattern": "local_global"},
               {"qk_norm": True}):
        with pytest.raises(NotImplementedError,
                           match="local/global attention item.*ROADMAP"):
            api.init_params(0, cfg.replace(**kw), device="cpu")


@pytest.mark.parametrize("reduced", [True, False])
def test_cache_accounting_matches_jax(reduced):
    """``cache_bytes`` counts the SSD state in fp32 and the conv tail in
    the compute dtype, as the JAX package does, and a built cache
    measures that (the full width is sized without being built)."""
    from repro.serving import kv_cache as jax_kv
    from repro_torch.serving import kv_cache
    jcfg = jax_get_config(ARCH, reduced=reduced)
    tcfg = get_config(ARCH, reduced=reduced)
    for batch, max_len in ((1, 32), (4, 112)):
        assert kv_cache.cache_bytes(tcfg, batch, max_len) == \
            jax_kv.cache_bytes(jcfg, batch, max_len)
    assert kv_cache.param_bytes(tcfg) == jax_kv.param_bytes(jcfg)
    if reduced:
        cache = api.init_cache(tcfg, 4, 112, device="cpu")
        layer = cache["layers"][0]
        assert layer["ssm"].shape == (4, 16, 16, 16)
        assert layer["ssm"].dtype == torch.float32
        assert layer["conv"].shape == (4, 3, tcfg.ssm_conv_dim)
        assert layer["conv"].dtype == torch.bfloat16
        assert kv_cache.measured_cache_bytes(cache) - 4 == \
            kv_cache.cache_bytes(tcfg, 4, 112)


# --------------------------------------------------------------------------
# serving: both batchers, both backends
# --------------------------------------------------------------------------


def test_pad_tokens_enter_the_ssm_state_in_both_batchers(fp32_models):
    """Reference behaviour the port copies: the batcher right-pads a prompt
    with id 0 to a multiple of 32, and for an SSM the pad tokens run
    through every layer into the spliced state (for attention they only
    fill cache rows past the prompt). The spliced state of a 5-token
    prompt equals JAX's (observed 2.0e-8, conv tail 1.2e-6) and differs
    from the state of the 5 tokens alone by about its own size (0.016 and
    0.042 in the two layers)."""
    jcfg, jparams, tcfg, tparams = fp32_models
    prompt = np.random.default_rng(9).integers(
        3, tcfg.vocab_size, 5).astype(np.int32)
    tb = sched.ContinuousBatcher(tparams, tcfg, num_slots=2, max_len=48,
                                 eos_id=-1, device="cpu")
    jb = jax_sched.ContinuousBatcher(jparams, jcfg, num_slots=2,
                                     max_len=48, eos_id=-1)
    for b in (tb, jb):
        b.submit(prompt, max_new_tokens=4)
        b._admit()
    st = jb.cache["slots"]["slot0"]
    _, alone = api.prefill(tparams, tcfg, 48,
                           tokens=torch.from_numpy(prompt[None].astype(
                               np.int64)))
    for i, layer in enumerate(tb.cache["layers"]):
        np.testing.assert_allclose(layer["ssm"][0].numpy(),
                                   np.asarray(st.ssm[i, 0]), atol=ATOL)
        np.testing.assert_allclose(layer["conv"][0].numpy(),
                                   np.asarray(st.conv[i, 0]), atol=ATOL)
        assert not layer["ssm"][1].any()  # the other slot is untouched
        gap = (layer["ssm"][0] - alone["layers"][i]["ssm"][0]).abs().max()
        assert float(gap) > 1e-3


@pytest.mark.parametrize("slots", [4, 1])
def test_mamba_tokens_identical_in_both_batchers(slots):
    """Bridged fp32 reduced mamba2: 6 prompts of 5-70 tokens (none a
    multiple of 32), 4 new tokens each, greedy. Every generated token
    agrees. With one slot the JAX splice leaves the batch state as it is,
    and the port copies that too."""
    jcfg, jparams, tcfg, tparams = bridged_mamba("float32", seed=7)
    rng = np.random.default_rng(7)
    lens = [5, 70, 12, 33, 47, 63]
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    max_len = 96 + 4 + 8
    tb = sched.ContinuousBatcher(tparams, tcfg, num_slots=slots,
                                 max_len=max_len, eos_id=-1, device="cpu")
    jb = jax_sched.ContinuousBatcher(jparams, jcfg, num_slots=slots,
                                     max_len=max_len, eos_id=-1)
    for p in prompts:
        tb.submit(p, max_new_tokens=4)
        jb.submit(p, max_new_tokens=4)
    got = {r.uid: r.generated for r in tb.run_until_drained()}
    want = {r.uid: r.generated for r in jb.run_until_drained()}
    assert len(got) == len(prompts)
    assert all(len(g) == 4 for g in got.values())
    assert got == want
    assert tb._slot_len == jb._slot_len
    assert jax.device_get(jb.cache["len"]) == int(tb.cache["len"])


MEDEC = WORKLOADS["medec"]()


def _mamba_pipeline():
    pipe = dict(MEDEC.initial_pipeline)
    pipe["operators"] = [dict(op, model=ARCH) for op in pipe["operators"]]
    return pipe


def _run(backend):
    return Executor(backend).run(_mamba_pipeline(), MEDEC.sample[:3])


def test_mamba_usage_and_cost_equal_jax_backend():
    """The executor charges the medec pipeline on mamba2-370m the same on
    either backend, through each one's batcher."""
    tbe = TorchBackend(seed=0, max_new_tokens=2, device="cpu")
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(JaxBackend(seed=0, max_new_tokens=2))
    assert len(out_t) == len(out_j) == 3
    assert (st_t.llm_calls, st_t.in_tokens, st_t.out_tokens) == \
        (st_j.llm_calls, st_j.in_tokens, st_j.out_tokens)
    assert st_t.llm_calls == 3 and st_t.out_tokens == 6
    assert st_t.cost == st_j.cost > 0.0
    assert ARCH in tbe._batchers


def test_mamba_bridged_weights_give_equal_documents():
    """Both backends seeded with the same fp32 mamba2 weights write the
    same documents (the generated token ids)."""
    jcfg, jparams, tcfg, tparams = bridged_mamba("float32", seed=3)
    jbe = JaxBackend(seed=0, max_new_tokens=4)
    jbe._params[ARCH] = (jcfg, jparams)
    tbe = TorchBackend(seed=0, max_new_tokens=4, device="cpu")
    tbe._params[ARCH] = (tcfg, tparams)
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(jbe)
    assert out_t == out_j
    assert all(len(d["errors"][0]["value"].split()) == 4 for d in out_t)
    assert st_t.cost == st_j.cost
