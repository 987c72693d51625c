"""The card's peaks and the least bytes a kernel's work needs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates), which assume
its full 700 W power limit; a run prints the card's limit beside them.
"""

from __future__ import annotations

import numpy as np

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
    "power_w": 700,
}

#: bytes of one answer: a matching docid (conjunctive), or a top-k entry's
#: docid and score (ranked)
ANSWER_BYTES = {"conjunctive": 4, "ranked_tfidf": 8, "bm25": 8}


def fused_query_bytes(nblk, block_bytes: int, tids, mode: str,
                      n_answers: int) -> int:
    """Least bytes one ``fused_query`` launch moves: every chain block of
    each distinct query term in every resident image, read once
    (``nblk[i][t]`` blocks of ``block_bytes`` bytes in image ``i``), plus
    each answer written once (``n_answers`` matching docids or top-k
    entries)."""
    tids = np.fromiter(set(tids), np.int64)
    blocks = 0
    for n in nblk:
        t = tids[tids < len(n)]
        blocks += int(np.asarray(n, np.int64)[t].sum())
    return blocks * block_bytes + ANSWER_BYTES[mode] * int(n_answers)


def bound_seconds(nbytes: int) -> float:
    return nbytes / H100["hbm_bytes_per_s"]
