"""Document helpers the backend's prompt shaping needs (a copy of the JAX
package's ``data/documents.py``). A document is a dict of key -> value."""

from __future__ import annotations

from typing import Any, Dict, List

Document = Dict[str, Any]
Dataset = List[Document]


def doc_text(doc: Document, key: str = "") -> str:
    """The document's main text: explicit key, else its longest str field."""
    if key:
        return str(doc.get(key, ""))
    best = ""
    for v in doc.values():
        if isinstance(v, str) and len(v) > len(best):
            best = v
    return best


def main_text_key(doc: Document) -> str:
    best_k, best_len = "", -1
    for k, v in doc.items():
        if isinstance(v, str) and len(v) > best_len:
            best_k, best_len = k, len(v)
    return best_k
