"""The window's sample of answers: uniform over every position, pure in
its seed, and drawn ahead so the window only stores what it is handed."""

import numpy as np
import pytest

from bench import harness, traffic


def drawn(seed: int, total: int, size: int, batch: int) -> list[int]:
    s = harness.Sample(size, traffic.generator(seed, traffic.SAMPLE))
    for lo in range(0, total, batch):
        for off, slot in s.slots(lo, min(batch, total - lo)):
            s.items[slot] = lo + off
    return s.items


@pytest.mark.parametrize("total,size", [(50, 100), (100, 100), (5000, 64)])
def test_distinct_positions_all_kept_while_they_fit(total, size):
    got = drawn(3, total, size, 32)
    assert len(got) == min(total, size) == len(set(got))
    assert all(0 <= p < total for p in got)
    if total <= size:
        assert sorted(got) == list(range(total))


def test_same_seed_same_sample_whatever_the_batch():
    assert drawn(2**31 + 9, 4000, 50, 32) == drawn(2**31 + 9, 4000, 50, 256)
    assert drawn(1, 4000, 50, 32) != drawn(2, 4000, 50, 32)


def test_every_position_equally_likely():
    total, size, runs = 2000, 40, 400
    hits = np.zeros(total)
    for seed in range(runs):
        hits[drawn(seed, total, size, 32)] += 1
    per_tenth = hits.reshape(10, -1).sum(axis=1)
    want = runs * size / 10
    # each tenth of the positions holds its share within 5 standard errors
    assert np.all(np.abs(per_tenth - want) < 5 * np.sqrt(want))
