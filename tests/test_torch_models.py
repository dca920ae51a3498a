"""The port's dense decoder against the JAX package's, on the CPU.

Reduced llama3.2-1b (2 layers, d=128): the JAX package initialises the
weights, the bridge carries them into the port, and both run on the same
numpy tokens. fp32 logits agree to 2e-5 (the tolerance of
``tests/test_models.py``); the bf16 bridge copies every leaf bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as jax_api
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.transformer import count_params

ATOL = 2e-5
ARCH = "llama3.2-1b"


def bridged_llama(dtype="float32", seed=0):
    """(jax cfg, jax params, port cfg, port params) of the reduced llama,
    with the port's weights bridged from the JAX init."""
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype=dtype,
                                                      param_dtype=dtype)
    tcfg = get_config(ARCH, reduced=True).replace(dtype=dtype,
                                                  param_dtype=dtype)
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(numpy_tree(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def numpy_tree(jparams):
    """The JAX param tree as numpy, bf16 leaves as their uint16 bits."""
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint16) if x.dtype == jnp.bfloat16 else a
    return jax.tree.map(leaf, jparams)


@pytest.fixture(scope="module")
def fp32_models():
    return bridged_llama("float32")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_forward_logits_match_jax(fp32_models):
    jcfg, jparams, tcfg, tparams = fp32_models
    toks = _tokens(2, 24, tcfg.vocab_size)
    jl, _ = jax_api.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    tl, aux = api.forward(tparams, tcfg, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 24, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_decode_matches_forward(fp32_models):
    """prefill(S-1) + decode_step(1 token) == forward, as
    ``tests/test_models.py::test_decode_matches_forward``, on the port."""
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


def test_decode_logits_match_jax(fp32_models):
    """Two decode steps after a prefill, port against JAX."""
    jcfg, jparams, tcfg, tparams = fp32_models
    toks = _tokens(2, 19, tcfg.vocab_size, seed=2)
    nxt = _tokens(2, 2, tcfg.vocab_size, seed=3)
    _, jc = jax_api.prefill(jparams, jcfg, 32, tokens=jnp.asarray(toks))
    _, tc = api.prefill(tparams, tcfg, 32, tokens=torch.from_numpy(toks))
    for i in range(2):
        jl, jc = jax_api.decode_step(jparams, jcfg,
                                     jnp.asarray(nxt[:, i:i + 1]), jc)
        tl, tc = api.decode_step(tparams, tcfg,
                                 torch.from_numpy(nxt[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_prefill_cache_matches_jax(fp32_models):
    """Layer i of the port's cache is slice i of the JAX slot0 stack,
    zero-padded to max_len the same way."""
    jcfg, jparams, tcfg, tparams = fp32_models
    toks = _tokens(2, 19, tcfg.vocab_size, seed=4)
    jl, jc = jax_api.prefill(jparams, jcfg, 48, tokens=jnp.asarray(toks))
    tl, tc = api.prefill(tparams, tcfg, 48, tokens=torch.from_numpy(toks))
    assert tl.shape == (2, 1, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert int(tc["len"]) == int(jc["len"]) == 19
    assert len(tc["layers"]) == tcfg.num_layers
    for i, layer in enumerate(tc["layers"]):
        for key in ("k", "v"):
            want = np.asarray(jc["slots"]["slot0"][key][i])
            assert layer[key].shape == want.shape == (2, 48, 2, 32)
            np.testing.assert_allclose(layer[key].numpy(), want, atol=ATOL)
            assert not layer[key][:, 19:].any()


def test_bf16_bridge_is_bit_exact():
    jcfg, jparams, tcfg, tparams = bridged_llama("bfloat16", seed=5)
    tree = numpy_tree(jparams)
    slot = tree["layers"]["slot0"]
    pairs = [(tparams.embed.tokens, tree["embed"]["tokens"]),
             (tparams.final_norm.scale, tree["final_norm"]["scale"])]
    for i, blk in enumerate(tparams.layers):
        pairs += [(blk.norm_attn.scale, slot["norm_attn"]["scale"][i]),
                  (blk.norm_mlp.scale, slot["norm_mlp"]["scale"][i])]
        pairs += [(getattr(blk.attn, n), slot["attn"][n][i])
                  for n in ("wq", "wk", "wv", "wo")]
        pairs += [(getattr(blk.ffn, n), slot["mlp"][n][i])
                  for n in ("w_gate", "w_up", "w_down")]
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
        assert got.shape == a.shape
        assert np.array_equal(got, a)
    assert tparams.embed.tokens.dtype == torch.bfloat16
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(jparams))
    assert count_params(tparams) == n_jax


@pytest.mark.parametrize("reduced", [True, False])
def test_kv_cache_accounting_matches_jax(reduced):
    """``cache_bytes``/``param_bytes`` equal the JAX package's, and a
    cache built by the port measures what ``cache_bytes`` says (the full
    width is sized without being built)."""
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
        jcache = jax_api.init_cache(jcfg, 4, 112)
        assert kv_cache.measured_cache_bytes(cache) - 4 == \
            jax_kv.measured_cache_bytes(jcache) - 4 == \
            kv_cache.cache_bytes(tcfg, 4, 112)


def test_argmax_takes_first_maximum():
    """Greedy decoding ties break to the lowest id in both packages."""
    x = np.array([[0.0, 3.0, 1.0, 3.0], [5.0, 5.0, 5.0, 5.0]], np.float32)
    assert torch.argmax(torch.from_numpy(x), dim=-1).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)).tolist() == [1, 0]


def test_entry_points_default_to_the_card():
    """With no device the port asks for CUDA and raises where there is
    none; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 1, 8)


def test_unported_configs_raise():
    cfg = get_config(ARCH, reduced=True)
    for kw in ({"attn_pattern": "local_global"}, {"kv_cache_dtype": "int8"},
               {"qk_norm": True}, {"post_norms": True},
               {"family": "audio"}, {"family": "vlm"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api.init_params(0, cfg.replace(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.init_params(0, cfg.replace(encoder_layers=2), device="cpu")
