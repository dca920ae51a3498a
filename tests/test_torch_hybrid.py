"""The port's hybrid path (zamba2-2.7b) against the JAX package's, on the CPU.

zamba2 is a Mamba2 stack with one shared attention+MLP block applied after
each full period of ``hybrid_attn_every`` mamba layers, never after the
tail layers; each application has its own KV cache. Three configs cover
the layout:

- the reduced zamba2 (2 layers, ``hybrid_attn_every=1``, d=64, 2 heads of
  32, state 16, head dim 16, chunk 16): two applications, no tail;
- a tail config (3 layers, ``hybrid_attn_every=2``): one full period, one
  application, then one mamba layer with no shared block after it;
- an ``n_full == 0`` config (1 layer, ``hybrid_attn_every=2``): the shared
  block exists but runs nowhere.

Weights come from the JAX init, bridged into the port; the same numpy
tokens go into both. JAX runs its jnp route for every case and its Pallas
route (interpret mode) once per kind of call (forward, prefill, decode) on
the reduced layout, and for the forward also on the tail layout. fp32 logits and every cache leaf (each mamba layer's
``ssm`` and ``conv``, each shared application's ``k`` and ``v``) agree to
2e-5, the tolerance of ``tests/test_models.py``; that is also below the
5e-4 of ``tests/test_kernels.py`` for values straight out of the SSD.
The errors observed on this CPU are written beside each test.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import numpy_tree

from repro.configs import get_config as jax_get_config
from repro.engine.backend import JaxBackend
from repro.engine.executor import Executor
from repro.engine.workloads import WORKLOADS
from repro.models import api as jax_api
from repro.models import transformer as jax_tf
from repro.serving import kv_cache as jax_kv
from repro.serving import scheduler as jax_sched
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.engine.backend import TorchBackend
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.serving import kv_cache
from repro_torch.serving import scheduler as sched

ARCH = "zamba2-2.7b"
ATOL = 2e-5  # tests/test_models.py

# the layouts under test, as overrides of the reduced config
LAYOUTS = {
    "reduced": {},
    "tail": {"num_layers": 3, "hybrid_attn_every": 2},
    "no_period": {"num_layers": 1, "hybrid_attn_every": 2},
}
JAX_ROUTES = {"jnp": {}, "pallas": {"use_pallas": True,
                                    "pallas_interpret": True}}


def _with_routes(cases, pallas):
    """Every case on the jnp route, and the ``pallas`` ones also on the
    Pallas-interpret route: the route only swaps the JAX package's kernels,
    so it is held once per kind of call, on the reduced layout (and the
    forward also on the tail layout), not across every layout."""
    return ([(*c, "jnp") for c in cases]
            + [(*c, "pallas") for c in pallas])


def _configs(layout="reduced", dtype="float32", reduced=True):
    kw = LAYOUTS[layout] if reduced else {}
    jcfg = jax_get_config(ARCH, reduced=reduced).replace(
        dtype=dtype, param_dtype=dtype, **kw)
    tcfg = get_config(ARCH, reduced=reduced).replace(
        dtype=dtype, param_dtype=dtype, **kw)
    return jcfg, tcfg


def bridged_zamba2(layout="reduced", dtype="float32", seed=0):
    """(jax cfg, jax params, port cfg, port params) with the port's weights
    bridged from the JAX init."""
    jcfg, tcfg = _configs(layout, dtype)
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return {name: bridged_zamba2(name) for name in LAYOUTS}


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_caches_match(tc, jc, cfg):
    """Every leaf of the port's cache against the JAX cache: layer i of a
    full period is index ``i // every`` of the JAX ``slot{i % every}``
    stack, a tail layer is ``jc["tail"][j]``, and shared application j is
    index j of the stacked ``jc["shared"]``."""
    pattern, n_full, tail = tf.layout(cfg)
    every = len(pattern)
    assert len(tc["layers"]) == cfg.num_layers
    for i, layer in enumerate(tc["layers"]):
        if i < n_full * every:
            st = jc["slots"][f"slot{i % every}"]
            want = (st.ssm[i // every], st.conv[i // every])
        else:
            st = jc["tail"][i - n_full * every]
            want = (st.ssm, st.conv)
        assert layer["ssm"].dtype == torch.float32
        np.testing.assert_allclose(_np(layer["ssm"]), _np(want[0]),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(layer["conv"]), _np(want[1]),
                                   atol=ATOL)
    assert len(tc["shared"]) == n_full
    for j, app in enumerate(tc["shared"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(app[key]),
                                       _np(jc["shared"][key][j]), atol=ATOL)
    assert int(tc["len"]) == int(jc["len"])


# --------------------------------------------------------------------------
# layout and accounting
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout,reduced", [
    ("reduced", False), ("reduced", True), ("tail", True),
    ("no_period", True)], ids=["full", "reduced", "tail", "no_period"])
def test_layout_equals_jax(layout, reduced):
    """The full zamba2 is 9 periods of 6 mamba layers with no tail; the
    other configs as in the module docstring."""
    jcfg, tcfg = _configs(layout, reduced=reduced)
    pattern, n_full, tail = jax_tf.layout(jcfg)
    assert tf.layout(tcfg) == (pattern, n_full, tail)
    assert tf.layer_kinds(tcfg) == pattern * n_full + tail
    want = {"full": (6, 9, 0), "reduced": (1, 2, 0), "tail": (2, 1, 1),
            "no_period": (2, 0, 1)}
    name = "full" if not reduced else layout
    assert (len(pattern), n_full, len(tail)) == want[name]
    assert set(pattern + tail) == {"mamba"}


@pytest.mark.parametrize("reduced", [True, False])
def test_cache_accounting_matches_jax(reduced):
    """``cache_bytes`` adds one K/V pair per shared application, as the
    JAX package does, and a cache the port builds measures that (the full
    width is built on the ``meta`` device, shapes without storage, and
    the JAX one is shaped with ``eval_shape``)."""
    jcfg, tcfg = _configs(reduced=reduced, dtype="bfloat16")
    for batch, max_len in ((1, 32), (4, 112)):
        want = jax_kv.cache_bytes(jcfg, batch, max_len)
        assert kv_cache.cache_bytes(tcfg, batch, max_len) == want
        cache = api.init_cache(tcfg, batch, max_len, device="meta")
        assert len(cache["shared"]) == tf.layout(tcfg)[1]
        jshape = jax.eval_shape(
            lambda: jax_api.init_cache(jcfg, batch, max_len))
        assert kv_cache.measured_cache_bytes(cache) == \
            jax_kv.measured_cache_bytes(jshape) == want + 4
    assert kv_cache.param_bytes(tcfg) == jax_kv.param_bytes(jcfg)


@pytest.mark.parametrize("layout", ["reduced", "tail", "no_period"])
def test_bridge_counts_every_param_once(models, layout):
    """The bridged model holds exactly the JAX tree's leaves, the shared
    block counted once (also where no period applies it)."""
    _, jparams, _, tparams = models[layout]
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert tf.count_params(tparams) == n_jax
    shared = sum(x.size for x in jax.tree_util.tree_leaves(
        jparams["shared"]))
    assert tf.count_params(tparams.shared) == shared


def test_bf16_bridge_is_bit_exact():
    """Every leaf of the tail config in bf16, the slots, the tail and the
    shared block, is copied bit for bit (norm scales, ``A_log``, ``D`` and
    ``dt_bias`` stay fp32)."""
    _, jparams, tcfg, tparams = bridged_zamba2("tail", "bfloat16", seed=5)
    tree = numpy_tree(jparams)
    leaves = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            else:
                leaves[f"{prefix}{k}"] = v

    slots = tree["layers"]
    walk("embed.", tree["embed"])
    walk("final_norm.", tree["final_norm"])
    walk("shared.", tree["shared"])
    for i in range(2):
        walk(f"layers.{i}.", {k: jax.tree.map(lambda a: a[0], v) for k, v
                              in slots[f"slot{i}"].items()})
    walk("layers.2.", tree["tail"][0])
    # the port names the shared block's MLP ``ffn``, as in every Block
    got = {name.replace(".ffn.", ".mlp."): t
           for name, t in tparams.named_parameters()}
    assert sorted(got) == sorted(leaves)
    for key, a in leaves.items():
        t = got[key]
        if a.dtype == np.uint16:
            assert t.dtype == torch.bfloat16, key
            bits = t.view(torch.int16).numpy().view(np.uint16)
        else:
            assert t.dtype == torch.float32, key
            bits = t.numpy()
        assert bits.shape == a.shape and np.array_equal(bits, a), key


# --------------------------------------------------------------------------
# forward, prefill, decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout,route", _with_routes(
    [("reduced",), ("tail",), ("no_period",)], [("reduced",), ("tail",)]))
def test_forward_logits_match_jax(models, layout, route):
    """Observed here: 1.0e-6 at most (logits up to ~1); the aux loss is
    zero."""
    jcfg, jparams, tcfg, tparams = models[layout]
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, 32, tcfg.vocab_size)
    jl, _ = jax_api.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    tl, aux = api.forward(tparams, tcfg, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 32, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_no_period_skips_the_shared_block(models):
    """With ``n_full == 0`` the shared block's weights do not touch the
    output: zeroing them leaves the logits bit for bit as they were."""
    _, _, tcfg, tparams = models["no_period"]
    toks = torch.from_numpy(_tokens(1, 16, tcfg.vocab_size, seed=8))
    before, _ = api.forward(tparams, tcfg, tokens=toks)
    saved = {n: t.clone() for n, t in tparams.shared.named_parameters()}
    try:
        for t in tparams.shared.parameters():
            t.zero_()
        after, _ = api.forward(tparams, tcfg, tokens=toks)
    finally:
        for n, t in tparams.shared.named_parameters():
            t.copy_(saved[n])
    assert torch.equal(before, after)


@pytest.mark.parametrize("layout,s,route", _with_routes(
    [("reduced", 32), ("reduced", 40), ("tail", 32), ("tail", 40)],
    [("reduced", 40)]))
def test_prefill_logits_and_caches_match_jax(models, layout, s, route):
    """S=32 is two SSD chunks of 16; S=40 pads to 48 inside the SSD.
    Observed here: logits 7.5e-7, shared K/V 3.6e-6, SSD state 2.5e-8,
    conv tail 2.4e-6."""
    jcfg, jparams, tcfg, tparams = models[layout]
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, s, tcfg.vocab_size, seed=4)
    jl, jc = jax_api.prefill(jparams, jcfg, 64, tokens=jnp.asarray(toks))
    tl, tc = api.prefill(tparams, tcfg, 64, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc["shared"][0]["k"].shape == (2, 64, tcfg.num_kv_heads,
                                          tcfg.resolved_head_dim)
    _assert_caches_match(tc, jc, tcfg)


@pytest.mark.parametrize("layout,route", _with_routes(
    [("reduced",), ("tail",)], [("reduced",)]))
def test_decode_steps_match_jax(models, layout, route):
    """Four decode steps after a prefill of 40 tokens: logits and every
    cache leaf after each. Observed here: logits 8.9e-7, shared K/V
    3.2e-6, SSD state 3.5e-8, conv tail 3.1e-6."""
    jcfg, jparams, tcfg, tparams = models[layout]
    jcfg = jcfg.replace(**JAX_ROUTES[route])
    toks = _tokens(2, 40, tcfg.vocab_size, seed=2)
    nxt = _tokens(2, 4, tcfg.vocab_size, seed=3)
    _, jc = jax_api.prefill(jparams, jcfg, 48, tokens=jnp.asarray(toks))
    _, tc = api.prefill(tparams, tcfg, 48, tokens=torch.from_numpy(toks))
    for i in range(4):
        jl, jc = jax_api.decode_step(jparams, jcfg,
                                     jnp.asarray(nxt[:, i:i + 1]), jc)
        tl, tc = api.decode_step(tparams, tcfg,
                                 torch.from_numpy(nxt[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        _assert_caches_match(tc, jc, tcfg)
    assert int(tc["len"]) == 44


@pytest.mark.parametrize("layout", ["reduced", "tail"])
def test_decode_matches_forward(models, layout):
    """prefill(S-1) + decode_step(1 token) == forward, on the port: the
    shared block's decode reads the K/V its prefill seeded."""
    _, _, tcfg, tparams = models[layout]
    b, s = 2, 41
    toks = torch.from_numpy(_tokens(b, s, tcfg.vocab_size, seed=1))
    full, _ = api.forward(tparams, tcfg, tokens=toks)
    pl, cache = api.prefill(tparams, tcfg, 48, tokens=toks[:, :s - 1])
    dl, cache = api.decode_step(tparams, tcfg, toks[:, s - 1:s], cache)
    np.testing.assert_allclose(pl[:, 0].numpy(), full[:, s - 2].numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, s - 1].numpy(),
                               atol=ATOL)


def test_shared_caches_do_not_alias():
    """Nine applications (9 layers, one period each): every application
    owns its K/V storage, in ``init_cache`` and after prefill; the nine
    prefill-seeded caches differ, and one decode step writes exactly row
    ``len`` of each and nothing else (a decode through caches that shared
    one buffer would write all nine rows into every cache)."""
    jcfg, tcfg = _configs()
    tcfg = tcfg.replace(num_layers=9)
    assert tf.layout(tcfg)[1] == 9
    params = api.init_params(0, tcfg, device="cpu")

    def ptrs(cache):
        return {t.untyped_storage().data_ptr() for app in cache["shared"]
                for t in app.values()}

    assert len(ptrs(api.init_cache(tcfg, 2, 24, device="cpu"))) == 18
    toks = torch.from_numpy(_tokens(2, 16, tcfg.vocab_size, seed=6))
    _, cache = api.prefill(params, tcfg, 24, tokens=toks)
    assert len(ptrs(cache)) == 18
    ks = [app["k"][:, :16] for app in cache["shared"]]
    for a, b in itertools.combinations(ks, 2):
        assert float((a - b).abs().max()) > 1e-3
    before = [{k: t.clone() for k, t in app.items()}
              for app in cache["shared"]]
    _, cache = api.decode_step(params, tcfg, toks[:, -1:], cache)
    for old, new in zip(before, cache["shared"]):
        for key in ("k", "v"):
            changed = (old[key] != new[key]).any(dim=(0, 2, 3))
            assert changed.nonzero().flatten().tolist() == [16], key


# --------------------------------------------------------------------------
# serving: both batchers, both backends
# --------------------------------------------------------------------------


def _batch_caches_match(tb, jb, cfg):
    _assert_caches_match(
        tb.cache, {**jb.cache, "len": jax.device_get(jb.cache["len"])}, cfg)


@pytest.mark.parametrize("slots", [2, 1])
def test_zamba2_tokens_identical_in_both_batchers(slots):
    """Bridged fp32 reduced zamba2: 6 prompts of 5-70 tokens, 4 new tokens
    each, greedy. After the first admit the batch caches agree leaf by
    leaf; with one slot the JAX splice leaves them as they were, so the
    shared K/V (and the mamba state) stay zero in both. Every generated
    token agrees."""
    jcfg, jparams, tcfg, tparams = bridged_zamba2(seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, tcfg.vocab_size, n).astype(np.int32)
               for n in (5, 70, 12, 33, 47, 63)]
    max_len = 96 + 4 + 8
    tb = sched.ContinuousBatcher(tparams, tcfg, num_slots=slots,
                                 max_len=max_len, eos_id=-1, device="cpu")
    jb = jax_sched.ContinuousBatcher(jparams, jcfg, num_slots=slots,
                                     max_len=max_len, eos_id=-1)
    for b in (tb, jb):
        for p in prompts:
            b.submit(p, max_new_tokens=4)
        b._admit()
    _batch_caches_match(tb, jb, tcfg)
    spliced = [bool(app[key].any()) for app in tb.cache["shared"]
               for key in ("k", "v")]
    assert all(spliced) if slots > 1 else not any(spliced)
    if slots == 1:
        assert not np.asarray(jb.cache["shared"]["k"]).any()
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


def test_zamba2_usage_and_cost_equal_jax_backend():
    """The executor charges the medec pipeline on zamba2-2.7b the same on
    either backend, each through its batcher (neither has a hybrid
    branch)."""
    tbe = TorchBackend(seed=0, max_new_tokens=2, device="cpu")
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(JaxBackend(seed=0, max_new_tokens=2))
    assert len(out_t) == len(out_j) == 3
    assert (st_t.llm_calls, st_t.in_tokens, st_t.out_tokens) == \
        (st_j.llm_calls, st_j.in_tokens, st_j.out_tokens)
    assert st_t.llm_calls == 3 and st_t.out_tokens == 6
    assert st_t.cost == st_j.cost > 0.0
    assert ARCH in tbe._batchers


def test_zamba2_bridged_weights_give_equal_documents():
    """Both backends seeded with the same fp32 zamba2 weights write the
    same documents (the generated token ids)."""
    jcfg, jparams, tcfg, tparams = bridged_zamba2(seed=3)
    jbe = JaxBackend(seed=0, max_new_tokens=4)
    jbe._params[ARCH] = (jcfg, jparams)
    tbe = TorchBackend(seed=0, max_new_tokens=4, device="cpu")
    tbe._params[ARCH] = (tcfg, tparams)
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(jbe)
    assert out_t == out_j
    assert all(len(d["errors"][0]["value"].split()) == 4 for d in out_t)
    assert st_t.cost == st_j.cost
