"""Every query answered in the window over the window's seconds (from the
window's opening to its last answer), host clock."""

from bench import stats


def read(run):
    return stats.rate(run.queries - run.unanswered, run.window_s)
