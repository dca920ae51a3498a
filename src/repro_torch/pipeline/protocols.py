"""The port's own request/response records of the ``Backend`` protocol v2.

The JAX package's executor reads results duck-typed (``.value``,
``.usage``, ``.error``; ``usage.calls/in_tokens/out_tokens``), so these
copies plug into it without either package importing the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class TransientBackendError(RuntimeError):
    """Recoverable per-request failure (rate limit / outage)."""


@dataclass
class Usage:
    in_tokens: int = 0
    out_tokens: int = 0
    calls: int = 0

    def add(self, other: "Usage"):
        self.in_tokens += other.in_tokens
        self.out_tokens += other.out_tokens
        self.calls += other.calls


@dataclass(frozen=True)
class OpRequest:
    """One operator invocation: ``kind`` selects the semantic entry point,
    ``op`` is the operator config; per-document kinds populate ``doc``,
    group kinds ``docs``; ``extra`` carries kind-specific arguments
    (classify: ``classes``, ``truth_field``)."""

    kind: str
    op: Dict[str, Any]
    doc: Any = None
    docs: Any = None
    key: Any = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OpResult:
    """Answer to one request: ``value``, the ``usage`` the cost model
    charges, or a per-request ``error``."""

    value: Any = None
    usage: Any = None
    error: Optional[BaseException] = None
