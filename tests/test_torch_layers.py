"""The port's building blocks against the JAX package's, in fp32 on the
CPU, on the same numpy inputs (atol 1e-6)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import layers as L

ATOL = 1e-6


def _rng():
    return np.random.default_rng(0)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_rmsnorm_matches_jax():
    rng = _rng()
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    out = L.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-6)
    ref = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    _close(out, ref)


@pytest.mark.parametrize("shape", [(2, 7, 4, 32), (3, 7, 16)])
def test_apply_rope_matches_jax(shape):
    """Rotation of the two halves of the head dim, theta=500000, with and
    without a head axis."""
    rng = _rng()
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(shape[1], dtype=np.int32) + 5,
                          shape[:2]).copy()
    out = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    _close(out, ref)


def test_mlp_matches_jax():
    rng = _rng()
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = {n: (0.2 * rng.standard_normal(s)).astype(np.float32) for n, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    out = L.mlp(*(torch.from_numpy(w[n]) for n in ("w_gate", "w_up",
                                                   "w_down")),
                torch.from_numpy(x))
    ref = JL.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    _close(out, ref)


@pytest.mark.parametrize("final_softcap", [0.0, 30.0])
def test_embed_unembed_match_jax(final_softcap):
    tcfg = get_config("llama3.2-1b", reduced=True).replace(
        dtype="float32", param_dtype="float32", final_softcap=final_softcap)
    jcfg = jax_get_config("llama3.2-1b", reduced=True).replace(
        dtype="float32", param_dtype="float32", final_softcap=final_softcap)
    rng = _rng()
    table = (0.02 * rng.standard_normal((tcfg.vocab_size, tcfg.d_model))
             ).astype(np.float32)
    toks = rng.integers(0, tcfg.vocab_size, (2, 9))
    e = L.embed(torch.from_numpy(table), tcfg, torch.from_numpy(toks))
    je = JL.embed({"tokens": jnp.asarray(table)}, jcfg, jnp.asarray(toks))
    _close(e, je)
    x = rng.standard_normal((2, 9, tcfg.d_model)).astype(np.float32)
    u = L.unembed(torch.from_numpy(table), tcfg, torch.from_numpy(x))
    ju = JL.unembed({"tokens": jnp.asarray(table)}, jcfg, jnp.asarray(x))
    _close(u, ju)


def test_softcap_matches_jax():
    """Outputs reach +-50, where one fp32 ulp is ~4e-6: compared to a
    relative 1e-6 rather than the absolute 1e-6 of the other layers."""
    x = _rng().standard_normal((4, 8)).astype(np.float32) * 80
    np.testing.assert_allclose(L.softcap(torch.from_numpy(x), 50.0).numpy(),
                               np.asarray(JL.softcap(jnp.asarray(x), 50.0)),
                               rtol=1e-6, atol=0)
    assert torch.equal(L.softcap(torch.from_numpy(x), 0.0),
                       torch.from_numpy(x))


def test_inits_follow_jax_distributions():
    """Same distributions as the JAX inits (the draws differ): truncated
    normal at +-2 sigma scaled by fan-in, embeddings N(0, 0.02)."""
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, 256, 512, torch.float32)
    assert w.shape == (256, 512)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-6
    # std of a N(0,1) truncated at +-2 is 0.8796
    assert abs(float(w.std()) * 16 - 0.8796) < 0.02
    e = L.embed_init(gen, 1000, 64, torch.bfloat16)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 0.001


def test_configs_equal_jax():
    """The config copy keeps every field of the JAX dataclass, with the
    same values for every ported arch, full and reduced."""
    for arch, reduced in itertools.product(
            ("llama3.2-1b", "mamba2-370m", "granite-moe-1b-a400m",
             "zamba2-2.7b"),
            (False, True)):
        t = get_config(arch, reduced=reduced)
        j = jax_get_config(arch, reduced=reduced)
        assert t.__dataclass_fields__.keys() == j.__dataclass_fields__.keys()
        for name in j.__dataclass_fields__:
            assert getattr(t, name) == getattr(j, name), name
        assert t.approx_params() == j.approx_params()


def test_tokenizer_ids_equal_jax():
    from repro.data.tokenizer import HashWordTokenizer as JTok
    from repro_torch.data.tokenizer import HashWordTokenizer
    text = "Detect whether a medical error\nis present in the note: 5 mg"
    for vocab in (512, 128256):
        assert HashWordTokenizer(vocab).encode(text) == JTok(vocab).encode(text)
        assert HashWordTokenizer(vocab).count(text) == JTok(vocab).count(text)
