"""The port's MoE path (granite-moe-1b-a400m) against the JAX package's, on
the CPU.

- The expert FFN's plain version (``expert_ffn_ref``) and its wrapper
  against the JAX oracle and the JAX Pallas op in interpret mode, over the
  case table of ``tests/test_kernels.py``, at its tolerance (2e-5).
- The routing traps of the reference, each held exactly: the tie order of
  top-k, the slot-major capacity dispatch with its drops, the capacity
  formula, and the zero rows that pad the last group.
- The MoE layer and the reduced granite-moe (2 layers, d=128, 4 experts,
  top-2, expert width 64, capacity factor 2.0): weights initialised by the
  JAX package and bridged into the port, the same numpy inputs into both,
  JAX run both without and with its Pallas routing. fp32 outputs agree to
  1e-5 (the layer) and 2e-5 (the model, the tolerance of
  ``tests/test_models.py``).
- Both batchers and both backends on that model.

Every comparison runs on the CPU; the errors observed here are written
beside each.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import MOE_CASES
from test_torch_models import numpy_tree

from repro.configs import get_config as jax_get_config
from repro.engine.backend import JaxBackend
from repro.engine.executor import Executor
from repro.engine.workloads import WORKLOADS
from repro.kernels.moe_ffn.ops import expert_ffn as jax_expert_ffn
from repro.kernels.moe_ffn.ref import expert_ffn_ref as jax_expert_ffn_ref
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro.serving import kv_cache as jax_kv
from repro.serving import scheduler as jax_sched
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.backend import TorchBackend
from repro_torch.kernels.moe_ffn import ops as moe_ops
from repro_torch.kernels.moe_ffn.ref import expert_ffn_ref
from repro_torch.models import api
from repro_torch.models import moe
from repro_torch.models.transformer import Block, count_params
from repro_torch.serving import kv_cache
from repro_torch.serving import scheduler as sched

ARCH = "granite-moe-1b-a400m"
FFN_ATOL = 2e-5   # tests/test_kernels.py
MOE_ATOL = 1e-5
ATOL = 2e-5       # tests/test_models.py
JAX_ROUTES = {"jnp": {}, "pallas": {"use_pallas": True,
                                    "pallas_interpret": True}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(reduced=True, dtype="float32", **kw):
    """(jax cfg, port cfg) of granite-moe with the same overrides."""
    return (jax_get_config(ARCH, reduced=reduced).replace(
                dtype=dtype, param_dtype=dtype, **kw),
            get_config(ARCH, reduced=reduced).replace(
                dtype=dtype, param_dtype=dtype, **kw))


def _moe_pair(jcfg, tcfg, seed=0):
    """JAX MoE params from ``init_moe`` and a port ``MoE`` holding the same
    numbers."""
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = moe.MoE(torch.Generator().manual_seed(seed), tcfg)
    for name, param in tp.named_parameters():
        a = np.array(jp[name].astype(jnp.float32))
        param.data = torch.from_numpy(a).to(param.dtype)
    return jp, tp


# --------------------------------------------------------------------------
# the expert FFN's plain version and wrapper
# --------------------------------------------------------------------------


def _ffn_inputs(g, e, c, d, f, seed):
    """The JAX test's scales, drawn once with numpy: x * 0.5, weights * 0.1."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((g, e, c, d)) * 0.5).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32),
            (rng.standard_normal((e, f, d)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("g,e,c,d,f,bc,bf", MOE_CASES)
def test_expert_ffn_matches_jax(g, e, c, d, f, bc, bf):
    """The plain version and the CPU wrapper against the JAX oracle and the
    Pallas op in interpret mode (with the table's tiles). Observed here:
    7.5e-8 against the oracle, 2.4e-7 against the Pallas op (outputs up
    to 0.5). The wrapper takes the plain version for a CPU tensor and
    launches nothing."""
    arrs = _ffn_inputs(g, e, c, d, f, seed=g * e + c)
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    ref = expert_ffn_ref(*t)
    out = moe_ops.expert_ffn(*t, block_c=bc, block_f=bf)
    assert moe_ops.launches == 0
    assert out.shape == (g, e, c, d) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    np.testing.assert_allclose(_np(ref), _np(jax_expert_ffn_ref(*j)),
                               atol=FFN_ATOL)
    np.testing.assert_allclose(
        _np(ref), _np(jax_expert_ffn(*j, block_c=bc, block_f=bf)),
        atol=FFN_ATOL)


def test_expert_ffn_zero_rows_and_dtype():
    """An empty capacity row comes out zero, and a bf16 input gives a bf16
    output within the JAX bf16 tolerance (2e-2) of the JAX oracle
    (observed 0)."""
    arrs = _ffn_inputs(1, 4, 8, 32, 64, seed=5)
    arrs[0][:, :, 5:] = 0.0
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    out = moe_ops.expert_ffn(*t)
    assert out.dtype == torch.bfloat16
    assert not out[:, :, 5:].any()
    want = jax_expert_ffn_ref(*(jnp.asarray(a).astype(jnp.bfloat16)
                                for a in arrs))
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-2)


def _z(*shape):
    return np.zeros(shape, np.float32)


@pytest.mark.parametrize("args,kw,match", [
    ((_z(1, 2, 4, 8), _z(2, 8, 16), _z(2, 8, 16), _z(2, 16, 8)),
     {"block_c": 0}, "moe_ffn.*block"),
    ((_z(1, 2, 4, 8), _z(3, 8, 16), _z(3, 8, 16), _z(3, 16, 8)),
     {}, "moe_ffn.*experts"),
], ids=["nonpositive_block", "expert_dim_mismatch"])
def test_expert_ffn_rejects_what_the_jax_wrapper_rejects(args, kw, match):
    """The two call-time errors of ``tests/test_kernel_validation.py``, with
    the same match text, in both wrappers."""
    with pytest.raises(ValueError, match=match):
        moe_ops.expert_ffn(*(torch.from_numpy(a) for a in args), **kw)
    with pytest.raises(ValueError, match=match):
        jax_expert_ffn(*(jnp.asarray(a) for a in args), **kw)


# --------------------------------------------------------------------------
# routing traps
# --------------------------------------------------------------------------


def _tie_rows(e, n_random, seed):
    """Rows whose logits under an identity router are the rows themselves:
    all equal (a zero pad row), equal pairs, ties across the top-k
    boundary, and random rows."""
    rng = np.random.default_rng(seed)
    rows = [np.zeros(e), np.full(e, 0.3)]
    pairs = np.repeat(rng.standard_normal(e // 2), 2)
    rows += [pairs, pairs[::-1].copy()]
    edge = np.linspace(1.0, 0.0, e)
    edge[1:4] = edge[2]          # a three-way tie that the top-2 cut splits
    rows += [edge, np.r_[np.full(e - 1, 0.1), 0.5]]
    rows += list(rng.standard_normal((n_random, e)))
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("reduced", [True, False])
def test_router_topk_tie_order_matches_jax(reduced):
    """``jax.lax.top_k`` puts the lower index first among equal values; the
    port's stable sort does the same. The router is the identity, so the
    logits are the rows exactly and the ties are exact. Assignments are
    equal, gates and probabilities within 1e-7 (observed 6.0e-8), and an
    all-equal row picks experts 0..k-1."""
    jcfg, tcfg = _cfgs(reduced)
    e, d, k = tcfg.num_experts, tcfg.d_model, tcfg.num_experts_per_tok
    rows = _tie_rows(e, 8, seed=1)
    x = np.zeros((len(rows), d), np.float32)
    x[:, :e] = rows
    router = np.eye(d, e, dtype=np.float32)
    tp = moe.MoE(torch.Generator().manual_seed(0), tcfg)
    tp.router.data = torch.from_numpy(router)
    ta, tg, tprobs = moe.router_topk(tp, tcfg, torch.from_numpy(x))
    ja, jg, jprobs = jax_moe.router_topk({"router": jnp.asarray(router)},
                                         jcfg, jnp.asarray(x))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-7)
    np.testing.assert_array_equal(ta[0].numpy(), np.arange(k))
    np.testing.assert_array_equal(ta[1].numpy(), np.arange(k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_combine_equal_jax_on_a_lossy_group(dtype):
    """Slot-major dispatch with drops: capacity factor 1.0 and a group of
    40 tokens under a skewed router. The assignments are equal; on the
    same assignments and gates, ``disp`` and ``comb`` equal JAX's exactly
    (each one-hot sum has one nonzero term), and choices were dropped."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    jp, tp = _moe_pair(jcfg, tcfg, seed=2)
    tp.router.data[:, 0] += 0.3   # crowd expert 0
    jp = dict(jp, router=jnp.asarray(tp.router.numpy()))
    cap = moe.expert_capacity(40, tcfg)
    assert cap == jax_moe.expert_capacity(40, jcfg) == 20
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    for grp in x:
        ta, tg, _ = moe.router_topk(tp, tcfg, torch.from_numpy(grp))
        ja, jg, _ = jax_moe.router_topk(jp, jcfg, jnp.asarray(grp))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
        # the same gates into both (they differ by an ulp between the two)
        disp, comb = moe._dispatch_combine(
            ta[None], torch.from_numpy(np.array(jg))[None], 4, cap, tdt)
        jd, jc = jax_moe._dispatch_combine(ja, jg, 4, cap, jdt)
        assert disp.dtype == tdt and disp.shape == (1, 40, 4, cap)
        np.testing.assert_array_equal(_np(disp[0]), _np(jd.astype(
            jnp.float32)))
        np.testing.assert_array_equal(_np(comb[0]), _np(jc.astype(
            jnp.float32)))
        assert float(disp.sum()) < 40 * 2  # some choices were dropped
        # every kept choice has a slot of its own
        assert float(disp.sum(dim=1).max()) == 1.0


def test_expert_capacity_equal_jax():
    """``max(4, min(ceil(gs*k*cf/E), gs))`` over group sizes from 1 (one
    decode slot: 4 slots for one token) to 512, both configs and four
    capacity factors."""
    for reduced in (True, False):
        jcfg, tcfg = _cfgs(reduced)
        for gs in (1, 2, 3, 4, 5, 8, 16, 40, 96, 97, 512):
            for cf in (0.0, 1.0, 1.25, 2.0):
                want = jax_moe.expert_capacity(gs, jcfg, cf)
                assert moe.expert_capacity(gs, tcfg, cf) == want
                assert want >= 4
    full = get_config(ARCH)
    assert [moe.expert_capacity(n, full) for n in (1, 4, 8, 32, 64, 96)] \
        == [4, 4, 4, 10, 20, 30]


MOE_LAYER_CASES = {
    # name: (config overrides, (B, S) tokens, group size)
    "lossless": ({}, (2, 24), None),
    "drops": ({"moe_capacity_factor": 1.0}, (2, 24), None),
    "padded_group": ({}, (2, 20), 16),   # 40 tokens -> 3 groups of 16
}


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
@pytest.mark.parametrize("case", sorted(MOE_LAYER_CASES))
def test_moe_ffn_matches_jax(case, route):
    """Output and aux loss of the layer. Observed here: output 1.8e-7, aux
    1.2e-7 (outputs up to 0.66, aux 1.03), in each case and route. With
    capacity factor 1.0, 4 of the 96 choices are dropped."""
    over, (b, s), group = MOE_LAYER_CASES[case]
    jcfg, tcfg = _cfgs(**over)
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    jp, tp = _moe_pair(jcfg, tcfg, seed=4)
    x = np.random.default_rng(5).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    ty, taux = moe.moe_ffn(tp, tcfg, torch.from_numpy(x), group_size=group)
    jy, jaux = jax_moe.moe_ffn(jp, jcfg, jnp.asarray(x), group_size=group)
    assert ty.shape == (b, s, tcfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=MOE_ATOL)
    if case == "drops":
        lossless, _ = moe.moe_ffn(tp, tcfg.replace(moe_capacity_factor=2.0),
                                  torch.from_numpy(x))
        assert float((ty - lossless).abs().max()) > 1e-3
    if case == "padded_group":
        # the 8 zero rows of the last group route to experts 0..k-1
        flat = torch.nn.functional.pad(torch.from_numpy(x).reshape(40, -1),
                                       (0, 0, 0, 8))
        assign, _, _ = moe.router_topk(tp, tcfg, flat)
        assert (assign[40:] == torch.arange(2, dtype=torch.int32)).all()


def test_decode_capacity_is_shared_across_slots():
    """Reference behaviour the port copies (ROADMAP §3): at decode one
    group spans every slot, and at granite's published routing (32
    experts, top-8, capacity factor 1.25) 8 slots get a capacity of 4,
    so slots compete for experts. With 8 identical tokens each of their 8
    experts gets 8 claims: slots 0-3 keep all their choices and slots
    4-7 lose all of them (a zero MoE output); with 4 slots nothing drops.
    The expert and model widths are narrowed (d=64, expert width 32): the
    capacity depends only on the expert count, top-k, capacity factor and
    slot count. The port equals JAX in both cases (observed 7.5e-9)."""
    jcfg, tcfg = _cfgs(False, d_model=64, moe_d_ff=32)
    jp, tp = _moe_pair(jcfg, tcfg, seed=6)
    tok = np.random.default_rng(7).standard_normal(64).astype(np.float32)
    alone, _ = moe.moe_ffn(tp, tcfg, torch.from_numpy(tok)[None, None])
    for slots in (8, 4):
        assert moe.expert_capacity(slots, tcfg) == 4
        x = np.tile(tok, (slots, 1, 1))
        ty, _ = moe.moe_ffn(tp, tcfg, torch.from_numpy(x))
        jy, _ = jax_moe.moe_ffn(jp, jcfg, jnp.asarray(x))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_ATOL)
        np.testing.assert_allclose(ty[:4].numpy(),
                                   np.broadcast_to(alone.numpy(),
                                                   (4, 1, 64)), atol=1e-6)
        if slots == 8:
            assert not ty[4:].any()
    assert float(alone.abs().max()) > 1e-2


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def bridged_granite(dtype="float32", seed=0, **over):
    """(jax cfg, jax params, port cfg, port params) of the reduced
    granite-moe, with the port's weights bridged from the JAX init."""
    jcfg, tcfg = _cfgs(dtype=dtype, **over)
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def fp32_models():
    return bridged_granite("float32")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
def test_forward_logits_and_aux_match_jax(fp32_models, route):
    """Logits, and the aux loss summed over the two MoE layers. Observed
    here: logits 5.4e-7 (up to 0.9), aux 0 (2.54)."""
    jcfg, jparams, tcfg, tparams = fp32_models
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, 24, tcfg.vocab_size)
    jl, jaux = jax_api.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    tl, taux = api.forward(tparams, tcfg, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 24, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert float(taux) > 1.0  # two layers of ~1 each
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL)


def _assert_kv_matches(tc, jc, rows=None):
    """Layer i of the port's cache against slice i of the JAX slot0
    stack (optionally only the first ``rows`` positions)."""
    st = jc["slots"]["slot0"]
    for i, layer in enumerate(tc["layers"]):
        for key in ("k", "v"):
            got = layer[key].numpy()[:, :rows]
            want = np.asarray(st[key][i])[:, :rows]
            np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
def test_prefill_logits_and_cache_match_jax(fp32_models, route):
    """Observed here: logits 5.2e-7, K/V 2.4e-6."""
    jcfg, jparams, tcfg, tparams = fp32_models
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, 40, tcfg.vocab_size, seed=4)
    jl, jc = jax_api.prefill(jparams, jcfg, 64, tokens=jnp.asarray(toks))
    tl, tc = api.prefill(tparams, tcfg, 64, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tc["len"]) == int(jc["len"]) == 40
    _assert_kv_matches(tc, jc)


@pytest.mark.parametrize("route", sorted(JAX_ROUTES))
def test_decode_steps_match_jax(fp32_models, route):
    """Three decode steps after a prefill of 40 tokens: logits and the
    cache after each. Observed here: 3.0e-6."""
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
        _assert_kv_matches(tc, jc)
    assert int(tc["len"]) == 43


def test_decode_matches_forward(fp32_models):
    """prefill(S-1) + decode_step(1 token) == forward, on the port. The
    reduced config's capacity factor (E/k = 2.0) is lossless, so the
    decode group of 2 tokens routes them as the forward's group of 40
    does."""
    _, _, tcfg, tparams = fp32_models
    b, s = 2, 20
    toks = torch.from_numpy(_tokens(b, s, tcfg.vocab_size, seed=1))
    full, _ = api.forward(tparams, tcfg, tokens=toks)
    pl, cache = api.prefill(tparams, tcfg, 48, tokens=toks[:, :s - 1])
    dl, cache = api.decode_step(tparams, tcfg, toks[:, s - 1:s], cache)
    np.testing.assert_allclose(pl[:, 0].numpy(), full[:, s - 2].numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, s - 1].numpy(),
                               atol=ATOL)
    assert int(cache["len"]) == s


def test_init_params_draws_the_jax_distributions():
    """Shapes and dtypes of the JAX tree; the router stays fp32 in a bf16
    model; truncated normals in +-2 sigma scaled by fan-in: D for the
    router, ``w_gate`` and ``w_up``, E*F for ``w_down``."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", d_model=256, moe_d_ff=128,
                       num_experts=8)
    tparams = api.init_params(0, tcfg, device="cpu")
    jtree = numpy_tree(jax_api.init_params(jax.random.PRNGKey(0), jcfg))
    jm = jtree["layers"]["slot0"]["moe"]
    fan_in = {"router": 256, "w_gate": 256, "w_up": 256, "w_down": 8 * 128}
    for blk in tparams.layers:
        assert isinstance(blk, Block) and isinstance(blk.ffn, moe.MoE)
        for name, fan in fan_in.items():
            t = getattr(blk.ffn, name)
            assert tuple(t.shape) == jm[name].shape[1:], name
            want = torch.bfloat16 if jm[name].dtype == np.uint16 \
                else torch.float32
            assert t.dtype == want, name
            w = t.float() * math.sqrt(fan)
            assert float(w.abs().max()) <= 2.0 + 1e-2, name
            # std of a N(0,1) truncated at +-2 is 0.8796
            assert abs(float(w.std()) - 0.8796) < 0.03, name
        assert blk.ffn.router.dtype == torch.float32
    assert count_params(tparams) == sum(a.size for a in
                                        jax.tree_util.tree_leaves(jtree))


def test_bf16_bridge_is_bit_exact():
    """Every leaf is copied bit for bit, the MoE leaves included; the router
    and the norm scales stay fp32 in a bf16 model."""
    _, jparams, tcfg, tparams = bridged_granite("bfloat16", seed=5)
    tree = numpy_tree(jparams)
    slot = tree["layers"]["slot0"]
    pairs = [(tparams.embed.tokens, tree["embed"]["tokens"]),
             (tparams.final_norm.scale, tree["final_norm"]["scale"])]
    for i, blk in enumerate(tparams.layers):
        pairs += [(blk.norm_attn.scale, slot["norm_attn"]["scale"][i]),
                  (blk.norm_mlp.scale, slot["norm_mlp"]["scale"][i])]
        pairs += [(getattr(blk.attn, k), slot["attn"][k][i])
                  for k in ("wq", "wk", "wv", "wo")]
        pairs += [(getattr(blk.ffn, k), slot["moe"][k][i])
                  for k in ("router", "w_gate", "w_up", "w_down")]
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
    assert tparams.layers[0].ffn.w_down.dtype == torch.bfloat16
    assert tparams.layers[0].ffn.router.dtype == torch.float32


@pytest.mark.parametrize("reduced", [True, False])
def test_cache_accounting_matches_jax(reduced):
    """Attention layers only: an MoE layer keeps no decode state."""
    jcfg = jax_get_config(ARCH, reduced=reduced)
    tcfg = get_config(ARCH, reduced=reduced)
    for batch, max_len in ((1, 32), (4, 112)):
        assert kv_cache.cache_bytes(tcfg, batch, max_len) == \
            jax_kv.cache_bytes(jcfg, batch, max_len)
    assert kv_cache.param_bytes(tcfg) == jax_kv.param_bytes(jcfg)
    if reduced:
        cache = api.init_cache(tcfg, 4, 112, device="cpu")
        assert sorted(cache["layers"][0]) == ["k", "v"]
        assert kv_cache.measured_cache_bytes(cache) - 4 == \
            kv_cache.cache_bytes(tcfg, 4, 112)


# --------------------------------------------------------------------------
# serving: both batchers, both backends
# --------------------------------------------------------------------------


def _admitted(cfg_over, prompt, seed=0):
    """Each package's batcher admits ``prompt`` (right-padded with id 0 to
    32 tokens) into slot 0; returns (port cache, jax cache, port params,
    port cfg)."""
    jcfg, jparams, tcfg, tparams = bridged_granite("float32", seed=seed,
                                                   **cfg_over)
    tb = sched.ContinuousBatcher(tparams, tcfg, num_slots=2, max_len=48,
                                 eos_id=-1, device="cpu")
    jb = jax_sched.ContinuousBatcher(jparams, jcfg, num_slots=2,
                                     max_len=48, eos_id=-1)
    for b in (tb, jb):
        b.submit(prompt, max_new_tokens=4)
        b._admit()
    return tb.cache, jb.cache, tparams, tcfg


def test_pad_tokens_claim_expert_capacity_in_both_batchers():
    """Reference behaviour the port copies (ROADMAP §3): the batcher's pad
    tokens (id 0, to a multiple of 32) share the prompt's MoE group, and
    their top-1 claims precede the prompt's top-2 claims. Under a lossy
    capacity (factor 1.0) they drop some of the prompt's choices, so the
    prompt's K/V in layer 1 differ from those of the prompt alone (by
    0.51 here, on K/V up to 3.3); both batchers agree (observed 1.5e-6).
    Under the reduced config's lossless factor (2.0) padded and unpadded
    agree (observed 8.9e-7)."""
    prompt = np.random.default_rng(9).integers(
        3, 512, 7).astype(np.int32)
    alone_ids = torch.from_numpy(prompt[None].astype(np.int64))
    gaps = {}
    for cf in (1.0, 2.0):
        tc, jc, tparams, tcfg = _admitted({"moe_capacity_factor": cf},
                                          prompt, seed=8)
        st = jc["slots"]["slot0"]
        for i, layer in enumerate(tc["layers"]):
            for key in ("k", "v"):
                np.testing.assert_allclose(layer[key][0].numpy(),
                                           np.asarray(st[key][i, 0]),
                                           atol=ATOL)
        _, alone = api.prefill(tparams, tcfg, 48, tokens=alone_ids)
        gaps[cf] = float((tc["layers"][1]["k"][0, :7]
                          - alone["layers"][1]["k"][0, :7]).abs().max())
    assert gaps[2.0] < ATOL
    assert gaps[1.0] > 1e-2


@pytest.mark.parametrize("slots", [2, 1])
def test_granite_tokens_identical_in_both_batchers(slots):
    """Bridged fp32 reduced granite-moe: 6 prompts of 5-70 tokens (none a
    multiple of 32), 4 new tokens each, greedy. Every generated token
    agrees, through prefills of 32-96 tokens and decode groups of 1-2
    slots."""
    jcfg, jparams, tcfg, tparams = bridged_granite("float32", seed=7)
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


MEDEC = WORKLOADS["medec"]()


def _run(backend):
    pipe = dict(MEDEC.initial_pipeline)
    pipe["operators"] = [dict(op, model=ARCH) for op in pipe["operators"]]
    return Executor(backend).run(pipe, MEDEC.sample[:3])


def test_granite_usage_and_cost_equal_jax_backend():
    """The executor charges the medec pipeline on granite-moe the same on
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


def test_granite_bridged_weights_give_equal_documents():
    """Both backends seeded with the same fp32 granite-moe weights write the
    same documents (the generated token ids)."""
    jcfg, jparams, tcfg, tparams = bridged_granite("float32", seed=3)
    jbe = JaxBackend(seed=0, max_new_tokens=4)
    jbe._params[ARCH] = (jcfg, jparams)
    tbe = TorchBackend(seed=0, max_new_tokens=4, device="cpu")
    tbe._params[ARCH] = (tcfg, tparams)
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(jbe)
    assert out_t == out_j
    assert all(len(d["errors"][0]["value"].split()) == 4 for d in out_t)
    assert st_t.cost == st_j.cost
