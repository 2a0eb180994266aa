"""One comma-separated-selector vocabulary for every CLI in the repo.

``benchmarks/run.py --only`` and ``python -m repro_torch.analysis --only`` both
take "a,b,c" selectors. Each used to hand-roll its own split (and one of
them silently accepted trailing commas while the other errored), so the
split + unknown-name policy now lives here: tokens are stripped, empties
dropped, and — when the caller supplies the valid vocabulary — unknown
names are a *hard* ``SelectorError`` that lists what would have matched.
Callers with richer matching semantics (the bench registry's
'/'-boundary prefix selection) validate downstream and use only the
tokenizer.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

Spec = Union[None, str, Sequence[str]]


class SelectorError(ValueError):
    """A selector named something outside the valid vocabulary."""


def split_tokens(spec: Spec) -> List[str]:
    """Flatten a selector into stripped, non-empty tokens.

    Accepts ``None`` (no selection), one "a,b" string, or an iterable of
    such strings (argparse ``append`` flags); order is preserved and
    duplicates are kept (callers that care dedupe with semantics intact).
    """
    if spec is None:
        return []
    parts: Iterable[str] = [spec] if isinstance(spec, str) else spec
    out: List[str] = []
    for part in parts:
        out.extend(t.strip() for t in part.split(",") if t.strip())
    return out


def parse_selector(spec: Spec, *, valid: Optional[Iterable[str]] = None,
                   what: str = "name") -> Optional[List[str]]:
    """Tokenize a selector; ``None`` means "everything selected".

    With ``valid``, any token outside the vocabulary raises
    ``SelectorError`` naming both the offenders and the full valid set —
    a typo'd ``--only`` must fail the run, never silently select nothing.
    """
    tokens = split_tokens(spec)
    if not tokens:
        return None
    if valid is not None:
        vocab = sorted(valid)
        unknown = sorted(set(tokens) - set(vocab))
        if unknown:
            raise SelectorError(
                f"unknown {what}(s): {', '.join(unknown)}; "
                f"valid {what}s: {', '.join(vocab)}")
    return tokens
