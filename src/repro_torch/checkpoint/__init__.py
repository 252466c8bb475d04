"""repro_torch.checkpoint — atomic checkpoints in the reference's on-disk
layout, and training supervision with resume (port of `repro.checkpoint`)."""
from .store import latest_step, restore, save  # noqa: F401
