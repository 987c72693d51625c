"""The yardstick's arithmetic on counted examples: the kernel byte bound,
the percentile and the rate."""

import numpy as np
import pytest

from bench import bounds, stats


def test_fused_query_bytes_counts_each_chain_once():
    frozen = np.array([3, 1, 0, 2], np.int32)
    delta = np.array([0, 2, 1], np.int32)      # a shorter delta vocabulary
    # terms 0, 1 and 3 (3 twice: read once), 4 answers of a ranked mode
    got = bounds.fused_query_bytes((frozen, delta), 64, [0, 1, 3, 3],
                                   "bm25", 4)
    assert got == (3 + 1 + 2 + 0 + 2) * 64 + 4 * 8


def test_fused_query_bytes_conjunctive_answers():
    got = bounds.fused_query_bytes((np.array([5]),), 64, [0],
                                   "conjunctive", 100)
    assert got == 5 * 64 + 100 * 4


def test_bound_seconds_at_hbm_rate():
    assert bounds.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert bounds.H100["hbm_bytes_per_s"] == 3.35e12


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2, 4], 50) == 2


def test_latencies_one_entry_a_query():
    lat = stats.query_latencies([(0.0, 0.5, 2), (1.0, 1.25, 3)])
    assert lat == [0.5, 0.5, 0.25, 0.25, 0.25]
    assert stats.percentile(lat, 95) == 0.5


def test_rate_over_the_window():
    assert stats.rate(300, 1.5) == 200.0


@pytest.mark.parametrize("n_traced", [4, 3, 5])
def test_roofline_over_the_launches_the_trace_holds(n_traced):
    """Four launches counted at 3.35e6 bytes each (1 µs at the bound);
    the trace holds ``n_traced`` of 2 µs each: half the roofline, whether
    or not the profiler lost or added a record."""
    from bench import harness
    from bench.tracing import SpanRec
    read = harness.reader("fused_query_roofline").read
    run = harness.Run()
    run.spans = [SpanRec("fused_execute", i, i + 1, 0, None,
                         {"fused_query_roofline": 3.35e6}) for i in range(4)]
    run.device_events = [("fused_query_kernel<1>", i, i + 2e-6)
                         for i in range(n_traced)]
    assert read(run) == pytest.approx(50.0)
    run.device_events = []
    assert read(run) is None
