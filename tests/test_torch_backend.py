"""``TorchBackend`` against ``JaxBackend`` through the JAX package's
executor, on the CPU, and the port's independence from the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_models import bridged_llama

from repro.core.models_catalog import catalog
from repro.engine.backend import JaxBackend
from repro.engine.executor import Executor
from repro.engine.workloads import WORKLOADS
from repro_torch.engine.backend import TorchBackend
from repro_torch.engine.prices import PRICES
from repro_torch.pipeline.protocols import OpRequest

ROOT = Path(__file__).resolve().parents[1]
MEDEC = WORKLOADS["medec"]()


def _run(backend):
    out, stats = Executor(backend).run(MEDEC.initial_pipeline,
                                       MEDEC.sample[:3])
    return out, stats


def test_usage_and_cost_equal_jax_backend():
    """Same prompts, tokenizer, truncation and prices: the executor
    charges the medec pipeline identically on either backend."""
    tbe = TorchBackend(seed=0, max_new_tokens=2, device="cpu")
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(JaxBackend(seed=0, max_new_tokens=2))
    assert len(out_t) == len(out_j) == 3
    assert (st_t.llm_calls, st_t.in_tokens, st_t.out_tokens) == \
        (st_j.llm_calls, st_j.in_tokens, st_j.out_tokens)
    assert st_t.llm_calls == 3 and st_t.out_tokens == 6
    assert st_t.cost == st_j.cost > 0.0
    assert tbe._batchers, "decoder models must route through the batcher"


def test_bridged_weights_give_equal_documents():
    """Both backends pre-seeded with the same fp32 weights produce the
    same output documents (the generated token ids)."""
    jcfg, jparams, tcfg, tparams = bridged_llama("float32", seed=3)
    jbe = JaxBackend(seed=0, max_new_tokens=4)
    jbe._params["llama3.2-1b"] = (jcfg, jparams)
    tbe = TorchBackend(seed=0, max_new_tokens=4, device="cpu")
    tbe._params["llama3.2-1b"] = (tcfg, tparams)
    out_t, st_t = _run(tbe)
    out_j, st_j = _run(jbe)
    assert out_t == out_j
    assert all(len(d["errors"][0]["value"].split()) == 4 for d in out_t)
    assert st_t.cost == st_j.cost


def test_legacy_surface_matches_batched_usage():
    """The per-document ``run_*`` surface charges what ``submit`` does."""
    tbe = TorchBackend(seed=0, max_new_tokens=2, device="cpu")
    op = MEDEC.initial_pipeline["operators"][0]
    doc = MEDEC.sample[0]
    value, usage = tbe.run_map(op, doc)
    (res,) = tbe.submit([OpRequest("map", op, doc=doc)])
    assert res.error is None
    assert usage == res.usage
    assert len(value["errors"][0]["value"].split()) == 2
    assert tbe.fingerprint() == ("torch", 0, 2, 4)
    right = [{"k": "A", "x": 1}, {"k": "b", "x": 2}]
    joined, u = tbe.run_equijoin({"left_field": "k", "right_field": "k",
                                  "right_docs": right}, {"k": "B"})
    assert joined == {"right_k": "b", "right_x": 2} and u.calls == 1
    tbe.close()
    assert not tbe._params and not tbe._batchers


def test_prices_equal_jax_catalog():
    cards = catalog()
    assert set(PRICES) == set(cards)
    for name, (price_in, price_out) in PRICES.items():
        assert (price_in, price_out) == (cards[name].price_in,
                                         cards[name].price_out), name


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBackend()


def test_port_imports_nothing_of_jax_or_repro():
    """Every module of the port, and chip_smoke.py without its main, load
    with no ``jax*`` and no ``repro.*`` module in the process."""
    code = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
