"""The 95th percentile (nearest rank) over all queries of the window of
the time from the moment a query's batch is formed, before any due
document goes in ahead of it, to its answer; host clock, ms."""

from bench import stats


def read(run):
    return stats.percentile(stats.query_latencies(run.batches), 95) * 1e3
