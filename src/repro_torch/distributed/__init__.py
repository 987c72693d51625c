"""Sharding rules over ``torch.distributed.tensor``, int8 gradient
compression with error feedback, and the eager counterpart of the
reference's scheduling barrier."""

from .compression import (ErrorFeedback, compress_int8,  # noqa: F401
                          decompress_int8)
from .sharding import constrain, lm_param_rules  # noqa: F401
