"""AdamW and its learning-rate schedule (port of `repro.optim`)."""
from .adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from .schedules import warmup_cosine  # noqa: F401
