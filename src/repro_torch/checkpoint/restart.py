"""Fault-tolerant training supervision.

`run_with_restarts` drives a step function with:
  * periodic atomic checkpoints (params, opt state, data-pipeline state),
  * resume-from-latest on (re)start,
  * SIGTERM/SIGINT preemption handling — checkpoint-and-exit with a
    distinct exit code so a cluster launcher reschedules,
  * optional fault injection for tests (fail at step k, prove the run
    produces bit-identical results to an uninterrupted one — the
    lineage-exactness property from §4.1).

Port of `repro.checkpoint.restart` over the port's `store` (a tree of
tensors restores onto its template's devices).
"""
from __future__ import annotations

import signal
from dataclasses import dataclass
from typing import Any, Callable, Optional

from . import store

PREEMPTED_EXIT_CODE = 42


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    pipeline_state: dict


class Preemption(Exception):
    pass


def run_with_restarts(
        *, ckpt_dir: str, init_fn: Callable[[], TrainState],
        step_fn: Callable[[TrainState], TrainState],
        total_steps: int, ckpt_every: int = 50,
        fail_at: Optional[int] = None,
        install_signal_handlers: bool = False) -> TrainState:
    """Run to `total_steps`, resuming from the latest checkpoint."""
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True

    if install_signal_handlers:
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)

    latest = store.latest_step(ckpt_dir)
    if latest is not None:
        template = init_fn()
        tree, manifest = store.restore(
            ckpt_dir, {"params": template.params,
                       "opt_state": template.opt_state})
        state = TrainState(step=manifest["step"], params=tree["params"],
                           opt_state=tree["opt_state"],
                           pipeline_state=manifest["lineage"].get(
                               "pipeline", template.pipeline_state))
    else:
        state = init_fn()

    while state.step < total_steps:
        if fail_at is not None and state.step == fail_at:
            raise Preemption(f"injected failure at step {fail_at}")
        if preempted["flag"]:
            store.save(ckpt_dir, state.step,
                       {"params": state.params,
                        "opt_state": state.opt_state},
                       lineage={"pipeline": state.pipeline_state,
                                "preempted": True})
            raise SystemExit(PREEMPTED_EXIT_CODE)
        state = step_fn(state)
        if state.step % ckpt_every == 0 or state.step == total_steps:
            store.save(ckpt_dir, state.step,
                       {"params": state.params,
                        "opt_state": state.opt_state},
                       lineage={"pipeline": state.pipeline_state})
    return state
