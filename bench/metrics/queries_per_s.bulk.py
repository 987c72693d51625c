"""``queries_per_s`` in the bulk cell, where its spread from run to run
is wider than any bound allows: the same reading (every query answered in
the window over the window's seconds, host clock).  A faster flush raises
it and lowers ``query_p95_ms`` with it.  It reads no span, so it is read
from the traced run's first window, which runs as an untraced run does."""

from bench import stats

PLAIN = True


def read(run):
    return stats.rate(run.queries - run.unanswered, run.window_s)
