"""Model zoo: the dense, ssm (RWKV-6) and hybrid (Jamba) families of the
reference's architectures as torch modules (port of `repro.models`)."""
from .config import ModelConfig  # noqa: F401
from .model import Model, build_model  # noqa: F401
