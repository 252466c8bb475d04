"""End-to-end trainer.

Port of `repro.launch.train`, with the reference's flags and pieces: the
token pipeline's pure `batch_at(step)`, `StepMonitor`, `warmup_cosine`,
AdamW and atomic checkpoints with resume. The train step runs on CUDA
unless `--device cpu` is given (it raises without a GPU). Checkpoints
hold {"params", "opt_state"} in the reference's on-disk layout (nested
dicts, the periods stacked on axis 0, the reference's leaf order), so
this trainer and `python -m repro.launch.train` each resume the other's.

Restarts are bit-exact: the batch at a step is a pure function of the
pipeline's lineage, and on CUDA the trainer runs with
`torch.use_deterministic_algorithms` (the embedding's backward
scatter-adds its cotangent, which CUDA otherwise sums in a varying
order). PyTorch then needs `CUBLAS_WORKSPACE_CONFIG` set before the
process's first cuBLAS call: the trainer sets ":4096:8" if it is unset,
which suffices when it is the process's entry point.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch lm-100m --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 30
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.backend import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.fault import StepMonitor
from repro_torch.interop import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import build_model
from repro_torch.optim.schedules import warmup_cosine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config of the arch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


@contextlib.contextmanager
def deterministic(dev: torch.device):
    """`torch.use_deterministic_algorithms` on CUDA for the block, the
    caller's mode restored after it."""
    if dev.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _save(ckpt_dir, step, params, opt_state, cfg, pipe) -> None:
    p_ref, o_ref = train_state_to_reference(params, opt_state, cfg)
    store.save(ckpt_dir, step, {"params": p_ref, "opt_state": o_ref},
               lineage={"pipeline": pipe.state()})


def _restore(ckpt_dir, params, opt_state, cfg, dev):
    """Load the latest checkpoint into `params` (in place); returns (the
    restored optimizer state, the checkpoint's step)."""
    p_ref, o_ref = train_state_to_reference(params, opt_state, cfg)
    tree, manifest = store.restore(
        ckpt_dir, {"params": p_ref, "opt_state": o_ref}, device="cpu")
    values, opt_state = train_state_from_reference(
        tree["params"], tree["opt_state"], cfg, dev)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(values[name])
    return opt_state, manifest["step"]


def main(argv=None) -> dict:
    """Train as the flags say; returns {"model", "opt_state",
    "start_step", "losses" (one float a step run), "step_ms" (each step's
    time: CUDA events on the card, the host clock on the CPU), "p50_s",
    "p99_s", "stragglers"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, dev, train=True)
    print(f"arch={cfg.name} params={model.n_params()/1e6:.2f}M "
          f"layers={cfg.n_layers} d={cfg.d_model} device={dev}")

    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=args.batch,
                         seq_len=args.seq_len, seed=args.seed,
                         n_codebooks=cfg.n_codebooks)

    def lr_fn(step):
        return warmup_cosine(step, peak_lr=args.lr, warmup_steps=args.warmup,
                             total_steps=args.steps)

    params, opt_state = init_train_state(model, seed=args.seed)
    step_fn = make_train_step(model, lr=lr_fn)
    start_step = 0
    if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        opt_state, start_step = _restore(args.ckpt_dir, params, opt_state,
                                         cfg, dev)
        pipe.step = start_step
        print(f"resumed from step {start_step}")

    monitor = StepMonitor()
    losses, step_ms = [], []
    cuda = dev.type == "cuda"
    t_start = time.perf_counter()
    with deterministic(dev):
        for step in range(start_step, args.steps):
            batch = pipe.batch_at(step)
            t0 = time.perf_counter()
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            opt_state, metrics = step_fn(opt_state, batch)
            if cuda:
                ev[1].record()
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            step_ms.append(ev[0].elapsed_time(ev[1]) if cuda else dt * 1e3)
            losses.append(metrics["loss"])
            monitor.record(step, dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                tok_s = args.batch * args.seq_len / dt
                print(f"step {step:5d} loss={metrics['loss']:.4f} "
                      f"ce={metrics['ce']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} "
                      f"{dt*1e3:6.1f} ms/step {tok_s:8.0f} tok/s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                _save(args.ckpt_dir, step + 1, params, opt_state, cfg, pipe)
    p50, p99 = monitor.p50_p99()
    print(f"done in {time.perf_counter()-t_start:.1f}s  p50={p50*1e3:.1f}ms "
          f"p99={p99*1e3:.1f}ms stragglers={len(monitor.incidents)}")
    return dict(model=model, opt_state=opt_state, start_step=start_step,
                losses=losses, step_ms=step_ms, p50_s=p50, p99_s=p99,
                stragglers=len(monitor.incidents))


if __name__ == "__main__":
    main()
