"""repro_torch.serving — low-latency scoring of compiled lifecycle plans
(port of `repro.serving`).

The deployment end of the SystemDS lifecycle (§2: "model deployment
and scoring" as a first-class lifecycle stage, JMLC-style embedded
scoring): a `PreparedScript` is AOT-compiled at *deploy* time — every
power-of-two vmap bucket of its batched serving plan is warmed and
pinned in the closure cache — and live requests are coalesced onto those
warm bucketed executables with zero compiles on the request path.

Not to be confused with `repro_torch.launch.serve`, the transformer
prefill/decode text-generation loop for the LM model zoo; this
package serves *plans* (lmDS scoring, pipelines), not token loops.

    server = ModelServer(script, max_batch=16, max_wait_us=2000)
    server.deploy()                  # compile + warm + pin, off-path
    yhat, = server.score(x)          # thread-safe, coalesced
    server.shutdown()
"""
from .server import ModelServer, QueueFullError, ScoreFuture  # noqa: F401

__all__ = ["ModelServer", "QueueFullError", "ScoreFuture"]
