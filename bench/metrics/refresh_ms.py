"""device backend layer: host-clock time of each
``ResidentImageManager.refresh`` that rebuilt an image (returned True),
with the card synchronized before and after; mean, ms."""

from bench.tracing import Span

SPANS = (Span("repro_torch.engine.device_backend:"
              "ResidentImageManager.refresh", sync=True),)


def read(run):
    xs = [s.seconds for s in run.named("ResidentImageManager.refresh")
          if s.result]
    return sum(xs) / len(xs) * 1e3 if xs else None
