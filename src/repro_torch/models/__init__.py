"""Model zoo: every family of the reference's architectures (dense, moe,
MLA, ssm, hybrid, vision, audio) as torch modules that serve and train
(port of `repro.models`)."""
from .config import ModelConfig  # noqa: F401
from .model import Model, build_model  # noqa: F401
