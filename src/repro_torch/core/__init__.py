"""Host-side index structures (pure numpy), device images (torch), the
static tier with its freeze lifecycle, and the host fleet."""

from .lifecycle import FreezeManager, FreezePolicy, StaticTier  # noqa: F401
from .sharded_index import ShardedEngine  # noqa: F401
from .static_index import (  # noqa: F401
    StaticIndex,
    StaticPostingsCursor,
    StaticWordCursor,
)
