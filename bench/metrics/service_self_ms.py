"""serve layer: the host-clock time of each ``QueryService.flush`` that
ran a batch, less the engine's ``execute_many`` inside it on the same
thread (the writer queues' drain, the cache bookkeeping, the fan-back of
results); mean per flush, ms."""

from bench.tracing import Nested

ENGINE = ("Engine.execute_many", "ShardedEngine.execute_many")


def read(run):
    kids = Nested([s for s in run.spans if s.name in ENGINE])
    self_s = []
    for f in run.named("QueryService.flush"):
        inner = kids.inside(f, same_thread=True)
        if inner:
            self_s.append(f.seconds - max(s.seconds for s in inner))
    return sum(self_s) / len(self_s) * 1e3 if self_s else None
