"""``query_p95_ms`` in the fleet cell, where its spread from run to run
is wider than any bound allows: the same reading (nearest-rank 95th
percentile over all queries of the window, from each batch's formation
to its answer, ms).  It reads no span, so it is read from the traced
run's first window, which runs as an untraced run does."""

from bench import stats

PLAIN = True


def read(run):
    return stats.percentile(stats.query_latencies(run.batches), 95) * 1e3
