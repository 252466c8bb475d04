"""repro_torch.data — ingestion and synthetic inputs (port of `repro.data`).

Host-side numpy, as in the reference: CSV readers (`csv_io`, with a
reader generated from a format descriptor), synthetic regression and
token data, the resumable token pipeline and the modality stubs.
"""
from .synthetic import gen_regression, gen_tokens  # noqa: F401
from .tokens import TokenPipeline  # noqa: F401
