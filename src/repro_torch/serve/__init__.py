"""Serving front door: request batching, the pipelined write path, the
traffic harness, and the paged KV cache's control plane."""

from .kv_cache import PagedKVCache, triangle_page_schedule  # noqa: F401
from .query_service import QueryService, Ticket  # noqa: F401
from .traffic import (  # noqa: F401
    FakeClock,
    SLOSpec,
    TrafficReport,
    run_traffic,
)
from .workload import (  # noqa: F401
    Event,
    WorkloadSpec,
    build_query_pool,
    generate_schedule,
)
