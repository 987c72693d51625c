"""device backend layer: host-clock time of ``fused_execute``, one call a
(mode, k) group, with the card synchronized before and after; mean per
group, ms."""

from bench.tracing import Span

SPANS = (Span("repro_torch.engine.device_backend:fused_execute", sync=True),)


def read(run):
    xs = [s.seconds for s in run.named("fused_execute")]
    return sum(xs) / len(xs) * 1e3 if xs else None
