"""Hash-word tokenizer of the serving path (a copy of the JAX package's).

Whitespace words are hashed (blake2s) into the architecture's vocab, so
both packages give the same ids for the same text: realistic token counts
and id distributions, not an invertible vocab.
"""

from __future__ import annotations

import hashlib
import re
from typing import List

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
N_SPECIAL = 3

_WORD_RE = re.compile(r"\S+|\n")


class HashWordTokenizer:
    """Deterministic word -> id hashing into a fixed vocab."""

    def __init__(self, vocab_size: int):
        if vocab_size <= N_SPECIAL + 1:
            raise ValueError(f"vocab_size must exceed {N_SPECIAL + 1}, "
                             f"got {vocab_size}")
        self.vocab_size = vocab_size

    def _hash(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2s(word.encode()).digest()[:4], "little")
        return N_SPECIAL + h % (self.vocab_size - N_SPECIAL)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self._hash(w) for w in _WORD_RE.findall(text)]
        return ([BOS_ID] + ids) if add_bos else ids

    def count(self, text: str) -> int:
        """Token count without building the id list."""
        return len(_WORD_RE.findall(text)) + 1
