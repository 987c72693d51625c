"""The comparison that decides ``correct``.

Every checked answer is held against the reference, worked out again from
the documents, deletes and queries the run generated.  The numbers:

* ``unanswered``: queries of the window without an answer;
* ``conj_wrong``: checked conjunctive answers whose docids are not the
  reference's set;
* ``ranked_wrong``: checked ranked answers of the wrong length (``min(k,
  documents with a positive score)``), with a docid repeated, outside the
  visible documents, or with scores out of descending order;
* ``score_gap``: the widest gap between a returned score and the
  reference's score of that docid, over the query's best reference score;
* ``rank_gap``: the widest gap by which a returned docid's reference score
  lies below the reference's k-th best, over the query's best score.

Each has a limit in the configuration's ``limits``; the exact counts have
the limit 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference.index import Collection, View

NUMBERS = ("unanswered", "conj_wrong", "ranked_wrong", "score_gap",
           "rank_gap")


@dataclass
class Checked:
    """One answer to judge: the query, what the run had ingested and
    deleted before it, and the answer (None when none came)."""

    terms: tuple
    mode: str
    k: int
    horizon: int
    ndel: int
    docids: np.ndarray | None
    scores: np.ndarray | None


def judge_ranked(view: View, c: Checked, scoring: dict):
    """(wrong, score_gap, rank_gap) of one ranked answer."""
    ref = view.scores(c.terms, c.mode, scoring, torch.float64).numpy()
    pos = np.sort(ref[ref > 0])[::-1]
    want = min(c.k, len(pos))
    d = np.asarray(c.docids, np.int64)
    s = np.asarray(c.scores, np.float64)
    if (len(d) != want or len(s) != len(d) or len(np.unique(d)) != len(d)
            or (len(d) and (d.min() < 1 or d.max() > view.horizon))
            or (len(d) and not view.alive[d].all())
            or np.any(np.diff(s) > 0)):
        return True, 0.0, 0.0
    if want == 0:
        return False, 0.0, 0.0
    top, kth = pos[0], pos[want - 1]
    got = ref[d]
    return (False, float(np.max(np.abs(s - got)) / top),
            float(max(0.0, np.max(kth - got)) / top))


def compare(checked: list[Checked], unanswered: int, docs, universe: int,
            deletes: list[int], scoring: dict) -> dict:
    """The numbers of one run (see the module docstring): ``checked``
    are the answers to judge, ``unanswered`` the window's queries that got
    none."""
    coll = Collection(docs, universe)
    views: dict[tuple[int, int], View] = {}
    out = dict.fromkeys(NUMBERS, 0)
    out["unanswered"] = unanswered
    out["score_gap"] = out["rank_gap"] = 0.0
    for c in checked:
        if c.docids is None:
            continue
        key = (c.horizon, c.ndel)
        view = views.get(key)
        if view is None:
            view = views[key] = View(coll, c.horizon, deletes[:c.ndel])
        if c.mode == "conjunctive":
            want = view.conjunctive(c.terms)
            got = np.asarray(c.docids, np.int64)
            out["conj_wrong"] += int(not np.array_equal(got, want))
            continue
        wrong, sg, rg = judge_ranked(view, c, scoring)
        out["ranked_wrong"] += int(wrong)
        out["score_gap"] = max(out["score_gap"], sg)
        out["rank_gap"] = max(out["rank_gap"], rg)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[n] <= limits[n] for n in NUMBERS)


def lines(numbers: dict, limits: dict) -> list[str]:
    """One line a number: its name, its reading and its limit."""
    return [f"check {n} {numbers[n]!r} limit {limits[n]!r}" for n in NUMBERS]
