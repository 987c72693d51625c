from .adamw import adamw_init, adamw_update  # noqa: F401
from .schedules import cosine_schedule, linear_warmup  # noqa: F401
