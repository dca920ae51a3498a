"""``TorchBackend``: semantic operators on real forward passes of the port.

It mirrors the JAX package's ``JaxBackend`` request for request: the same
prompt construction and output shaping, the same tokenizer and prompt
truncation, a persistent continuous batcher per model, and the same usage
accounting and prices, so an executor charges a pipeline the same on
either backend. The models are untrained: this validates the substrate,
not extraction quality. It implements the batched ``Backend`` protocol v2
(``submit``) and the legacy per-document ``run_*`` surface.

``JaxBackend``'s compile-path lint gate is JAX-specific and is not run
here.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data.documents import doc_text, main_text_key
from repro_torch.data.tokenizer import HashWordTokenizer
from repro_torch.device import resolve_device
from repro_torch.engine.prices import PRICES
from repro_torch.models import api
from repro_torch.pipeline.protocols import OpRequest, OpResult, Usage
from repro_torch.serving.decode import generate
from repro_torch.serving.scheduler import ContinuousBatcher


def default_equijoin(op: Dict[str, Any], doc) -> Tuple[Optional[Dict], Usage]:
    """Semantic join of one document against ``op['right_docs']`` (a copy
    of the JAX package's shared implementation): ``right_*`` fields of the
    first exact match, or None, plus the per-probe usage."""
    right = op.get("right_docs", [])
    lval = str(doc.get(op["left_field"], "")).lower()
    fld_r = op["right_field"]
    best = None
    for r in right:
        if str(r.get(fld_r, "")).lower() == lval:
            best = r
            break
    usage = Usage(in_tokens=40 * max(len(right), 1), out_tokens=4, calls=1)
    if best is None:
        return None, usage
    return {f"right_{k}": v for k, v in best.items()
            if not k.startswith("_")}, usage


class TorchBackend:
    """Operators run real model forward passes through the port, on
    ``device`` (default: the card).

    Each model is its small smoke config, as in ``JaxBackend``; a caller
    serves other weights by seeding ``_params`` (see ``_model``).
    ``submit`` groups requests by model and drains them through a
    persistent fixed-slot continuous batcher.
    """

    preferred_batch_size = 8
    DECODE_SLOTS = 4
    # NOT memoizable: the batcher pads every slot to the longest active
    # one, so a request's tokens depend on which requests share its chunk
    deterministic = False
    MAX_PROMPT_TOKENS = 96

    def __init__(self, seed: int = 0, max_new_tokens: int = 8,
                 decode_slots: Optional[int] = None,
                 clock: Optional[Any] = None, *, device=None):
        self.device = resolve_device(device)
        self.seed = seed
        self.max_new_tokens = max_new_tokens
        if decode_slots is not None:
            self.DECODE_SLOTS = max(1, int(decode_slots))
        if clock is None:
            self.clock = time.time
        elif callable(getattr(clock, "now", None)):
            self.clock = clock.now
        else:
            self.clock = clock
        self._params: Dict[str, Any] = {}
        self._batchers: Dict[str, ContinuousBatcher] = {}

    def fingerprint(self) -> Tuple[Any, ...]:
        return ("torch", self.seed, self.max_new_tokens, self.DECODE_SLOTS)

    def close(self) -> None:
        """Drop the model weights and batchers so device memory can be
        reclaimed."""
        self._batchers.clear()
        self._params.clear()

    def _model(self, name: str):
        """(cfg, params) of a model; filled only when absent, so a caller
        may seed ``_params`` with weights of its own."""
        if name not in self._params:
            cfg = get_config(name, reduced=True)
            params = api.init_params(self.seed, cfg, device=self.device)
            self._params[name] = (cfg, params)
        return self._params[name]

    # -- batched dispatch (Backend protocol v2) -------------------------------

    def submit(self, requests: List[Any]) -> List[OpResult]:
        results: List[Optional[OpResult]] = [None] * len(requests)
        by_model: Dict[str, List[int]] = {}
        for i, req in enumerate(requests):
            if req.kind == "resolve":
                results[i] = OpResult(value=list(req.docs), usage=Usage())
            elif req.kind == "equijoin":
                value, usage = default_equijoin(req.op, req.doc)
                results[i] = OpResult(value=value, usage=usage)
            else:
                by_model.setdefault(req.op["model"], []).append(i)
        for model, idxs in by_model.items():
            prompts = [self._prompt_for(requests[i]) for i in idxs]
            for i, (toks, usage) in zip(idxs,
                                        self._generate_batch(model, prompts)):
                results[i] = OpResult(
                    value=self._value_for(requests[i], toks), usage=usage)
        return results

    def _prompt_for(self, req) -> str:
        op = req.op
        if req.kind in ("map", "summarize", "filter"):
            return f"{op.get('prompt', '')}\n{doc_text(req.doc)[:2000]}"
        if req.kind == "extract":
            return doc_text(req.doc)[:2000]
        if req.kind == "classify":
            return doc_text(req.doc)[:1000]
        if req.kind == "reduce":
            joined = " ".join(doc_text(d)[:400] for d in req.docs[:8])
            return f"{op.get('prompt', '')}\n{joined}"
        raise TypeError(f"TorchBackend cannot execute request kind "
                        f"{req.kind!r}")

    def _value_for(self, req, toks: List[int]) -> Any:
        op = req.op
        if req.kind in ("map", "summarize"):
            out_field = next(iter(op.get("output_schema", {})), "output")
            return {out_field: [{"tag": "gen",
                                 "value": " ".join(map(str, toks))}]}
        if req.kind == "filter":
            return bool(toks[0] % 2)
        if req.kind == "extract":
            key = op.get("text_key") or main_text_key(req.doc)
            words = doc_text(req.doc).split()
            return {key: " ".join(words[:len(words) // 2])}
        if req.kind == "classify":
            classes = req.extra["classes"]
            return classes[toks[0] % len(classes)]
        out_field = next(iter(op.get("output_schema", {})), "aggregated")
        return {out_field: [{"tag": "gen", "value": str(t)} for t in toks]}

    def _batcher(self, model: str) -> ContinuousBatcher:
        """Persistent per-model continuous batcher, drained per call."""
        b = self._batchers.get(model)
        if b is None:
            cfg, params = self._model(model)
            b = ContinuousBatcher(
                params, cfg, num_slots=self.DECODE_SLOTS,
                max_len=self.MAX_PROMPT_TOKENS + self.max_new_tokens + 8,
                eos_id=-1,  # match generate(): no early EOS stop
                clock=self.clock, device=self.device)
            self._batchers[model] = b
        return b

    def _generate_batch(self, model: str, texts: List[str]
                        ) -> List[Tuple[List[int], Usage]]:
        cfg, _ = self._model(model)
        tok = HashWordTokenizer(cfg.vocab_size)
        batcher = self._batcher(model)
        ids_list = [tok.encode(t)[:self.MAX_PROMPT_TOKENS] for t in texts]
        uids = [batcher.submit(np.asarray(ids, np.int32),
                               max_new_tokens=self.max_new_tokens)
                for ids in ids_list]
        finished = {r.uid: r for r in batcher.run_until_drained()}
        out = []
        for uid, ids in zip(uids, ids_list):
            usage = Usage(in_tokens=len(ids),
                          out_tokens=self.max_new_tokens, calls=1)
            out.append((list(finished[uid].generated), usage))
        return out

    def _generate(self, model: str, text: str) -> Tuple[List[int], Usage]:
        cfg, params = self._model(model)
        tok = HashWordTokenizer(cfg.vocab_size)
        ids = tok.encode(text)[:self.MAX_PROMPT_TOKENS]
        prompt = np.asarray(ids, dtype=np.int32)[None, :]
        out = generate(params, cfg, prompt, self.max_new_tokens,
                       device=self.device)
        usage = Usage(in_tokens=len(ids), out_tokens=self.max_new_tokens,
                      calls=1)
        return [int(t) for t in out[0]], usage

    def usage_cost(self, model: str, usage) -> float:
        price_in, price_out = PRICES[model]
        return (usage.in_tokens * price_in
                + usage.out_tokens * price_out) / 1e6

    def _run_one(self, req: OpRequest) -> Tuple[Any, Usage]:
        """v1 per-request path: same prompt and output shaping as the
        batched path, minus the scheduler."""
        toks, usage = self._generate(req.op["model"], self._prompt_for(req))
        return self._value_for(req, toks), usage

    def run_map(self, op, doc):
        return self._run_one(OpRequest("map", op, doc=doc))

    def run_filter(self, op, doc):
        return self._run_one(OpRequest("filter", op, doc=doc))

    def run_reduce(self, op, docs):
        return self._run_one(OpRequest("reduce", op, docs=list(docs)))

    def run_extract(self, op, doc):
        return self._run_one(OpRequest("extract", op, doc=doc))

    def run_classify(self, op, doc, classes, truth_field):
        return self._run_one(OpRequest(
            "classify", op, doc=doc,
            extra={"classes": classes, "truth_field": truth_field}))

    def run_equijoin(self, op, doc):
        return default_equijoin(op, doc)

    def run_resolve(self, op, docs):
        return list(docs), Usage()
