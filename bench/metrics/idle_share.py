"""device: the share of the window in which the card runs nothing
(``torch.profiler``, CUDA activity), %."""


def read(run):
    if not run.device_events or run.busy_s is None:
        return None
    return (1.0 - run.busy_s / run.window_s) * 100.0
