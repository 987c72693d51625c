"""engine layer: the share of the window's answers whose
``QueryResult.backend`` is ``"device"`` (for a fleet, every shard's), %."""


def read(run):
    n = sum(run.backends.values())
    return run.backends.get("device", 0) / n * 100.0 if n else None
