"""repro_torch.core — the declarative LA DSL with lineage tracing,
lineage-based reuse and an optimizing compiler, on PyTorch (port of
`repro.core`). Dtypes are explicit everywhere: there is no global switch
like the reference's jax x64 flag; node dtypes default to float64 as
the DSL's generators do."""
from . import ops  # noqa: F401
from .batching import (BatchedPlan, BatchingError,  # noqa: F401
                       compile_batched)
from .compiler import Plan, compile_plan  # noqa: F401
from .dag import LTensor, batch_input, input_tensor  # noqa: F401
from .federated import (FederatedTensor, LocalSite,  # noqa: F401
                        federated_input)
from .jit_cache import clear_jit_cache, get_jit_cache  # noqa: F401
from .reuse import ReuseCache  # noqa: F401
from .runtime import (LineageRuntime, PreparedScript, evaluate,  # noqa: F401
                      get_runtime, lineage_trace, set_runtime, value)
from .segments import Segment  # noqa: F401
