"""Docstream format and tokenizer (paper §4.1).

"A docstream represents documents as single lines of text, with the first
element a document identifier, and the remainder ... an ordered set of terms."
Pre-processing faithfully mirrors the paper: sequences of non-alphabetic
characters become single spaces; uppercase folds to lowercase; long terms are
broken after each group of 20 consecutive alphabetic characters.  No
stemming, no stopping.
"""

from __future__ import annotations

import re
from typing import Iterable, Iterator

_NON_ALPHA = re.compile(r"[^a-zA-Z]+")
MAX_TERM = 20


def tokenize(text: str) -> list[str]:
    """Paper §4.1 pre-processing: alpha runs, lowercased, 20-char chunks."""
    out: list[str] = []
    for run in _NON_ALPHA.split(text):
        if not run:
            continue
        run = run.lower()
        for i in range(0, len(run), MAX_TERM):
            out.append(run[i:i + MAX_TERM])
    return out


def parse_docstream(lines: Iterable[str]) -> Iterator[tuple[str, list[str]]]:
    """Yield (doc_id, terms) from docstream lines."""
    for line in lines:
        parts = line.strip().split()
        if not parts:
            continue
        yield parts[0], parts[1:]


def to_docstream_line(doc_id: str, terms: list[str]) -> str:
    return " ".join([doc_id, *terms])
