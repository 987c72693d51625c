"""sharded index layer: ``ShardedEngine.execute_many`` less the longest of
its shards' ``Engine.execute_many`` calls inside it (the fan-out pool's
hand-off and the canonical merge); mean per batch, ms, host clock."""

from bench.tracing import Nested


def read(run):
    kids = Nested(run.named("Engine.execute_many"))
    self_s = []
    for f in run.named("ShardedEngine.execute_many"):
        inner = kids.inside(f)
        if inner:
            self_s.append(f.seconds - max(s.seconds for s in inner))
    return sum(self_s) / len(self_s) * 1e3 if self_s else None
