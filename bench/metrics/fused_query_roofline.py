"""fused_query kernel: the sum of its launches' byte bounds over the sum of
their device times in the ``torch.profiler`` trace, %.

A launch's bound is ``bench.bounds.fused_query_bytes`` over 3.35 TB/s: the
chains of each distinct query term of the (mode, k) group in the resident
frozen and delta images as they hold them, read once, and the answers
written once, counted from ``fused_execute``'s arguments and results.
Where the trace holds another number of launches than were counted (the
profiler can lose a record now and then), the launches it holds are
given the counted launches' mean bound.
"""

from bench import bounds
from bench.tracing import Span

KERNEL = "fused_query_kernel"


def _launch_bytes(args, kwargs, result):
    engine, resident, batch, mode = args[:4]
    tids, live = set(), 0
    for q in batch:
        ids = [engine.term_id(t) for t in q.terms]
        if mode == "conjunctive" and (None in ids or not ids):
            continue
        known = [i for i in ids if i is not None]
        if known:
            live += 1
            tids.update(known)
    if not live:
        return None                 # no launch for this group
    n_answers = sum(len(r.docids) for r in result)
    return bounds.fused_query_bytes(resident._nblk_np,
                                    engine.index.store.B, tids, mode,
                                    n_answers)


SPANS = (Span("repro_torch.engine.device_backend:fused_execute",
              capture=_launch_bytes),)


def read(run):
    counted = [s.captured.get("fused_query_roofline")
               for s in run.named("fused_execute")]
    counted = [b for b in counted if b is not None]
    device = [e - s for n, s, e in run.device_events if KERNEL in n]
    if not device or not counted:
        return None
    traced = sum(counted) * len(device) / len(counted)
    return bounds.bound_seconds(traced) / sum(device) * 100.0
