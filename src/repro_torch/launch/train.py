"""The LM train loop on one device: checkpoint/restart, failure recovery,
the straggler watchdog and gradient accumulation.

The port of ``repro.launch.train``.  The step is
:func:`repro_torch.launch.steps.make_train_step`; the loop adds the
operational shell: a background checkpoint every ``ckpt_every`` steps
(joined before the next one), restore of the newest checkpoint at start
and after a failure (the data stream seeks to the restored step), a
heartbeat per step and the straggler watchdog.  A ``FailureInjector``'s
``slow`` faults stall inside the timed window, so the watchdog sees them.

One deliberate difference: the loop recovers only from the fault plane's
``InjectedFault``, as ``GenServer`` does.  The reference catches any
``RuntimeError``, which would turn a kernel that fails to build or launch
into an endless restore; here that error propagates.  The loop runs on one
device, CUDA unless the caller asks for the CPU, or, with ``mesh=``, as
one rank of a live ``(data, model)`` mesh (the reference's ``train(cfg,
mesh=)``; ``--devices N`` spawns N ranks on ``make_smoke_mesh(N)``, as
``serve --devices N`` does).  An encoder-decoder config (whisper-small) is
fed zero ``frames`` (global_batch, encoder_ctx, d_model) fp32 with every
batch, as the reference's loop feeds them.

On a mesh every rank holds its blocks of the parameters and of the AdamW
state (``steps.make_train_step(mesh=)``: FSDP over ``data``, heads, FFN
and vocab over ``model``), draws the same global batch from its own
``LMDataPipeline`` and takes its rows of it inside the step.  A checkpoint
gathers every leaf whole onto rank 0, which writes it in the one-device
format (``ModelParallel.unshard``), and a restore reads each rank's blocks
(``restore_checkpoint(..., shardings=)``), so a checkpoint written on one
mesh restores on another or on one device, and back.  Each rank beats
its own heart (``heartbeat_<rank>.json``).  Faults must be injected on
every rank at the same step (each rank's ``FailureInjector`` with the same
plan): all ranks then restore together.  A fault on one rank alone would
leave the others waiting in the step's next collective, a hang, not a
recovery.

Usage (a killed run restarted with the same ``--ckpt-dir`` resumes where
it died)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --steps 20 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --steps 3 --batch 4 --seq 4096 --microbatches 2    # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --reduced --steps 4 --batch 4 --seq 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --steps 3 --batch 16 --seq 448 --microbatches 2    # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-12b \\
      --reduced --steps 4 --batch 4 --seq 64 --microbatches 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen3-moe-30b-a3b --reduced --steps 4 --batch 4 --seq 64 \\
      --microbatches 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --steps 4 --batch 4 --seq 64 --microbatches 2 \\
      --devices 4 --device cpu         # a (2, 2) mesh of 4 gloo ranks

A MoE config (Qwen3-MoE, Llama-4-Scout) trains through the same loop:
checkpoint, restore, recovery and heartbeat as any other, its experts'
products forward and backward on kernel 3's batched form
(``kernels.matmul.BatchedMatmulFn``).  Qwen3-MoE's 48 layers take 30.5 B
parameters and Llama-4-Scout's 107.8 B, far past one card with fp32 AdamW;
``chip_smoke.py`` phase 30 trains both at 2 layers and full widths.

Gemma-3-12B's 48 layers take 11.8 B parameters, whose bf16 weights, fp32
masters and moments and gradients exceed one card; ``chip_smoke.py`` phase
28d trains it at one pattern period (6 layers, full widths) on the card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import LMDataPipeline
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Heartbeat,
                                                     InjectedFault,
                                                     StragglerWatchdog)
from repro_torch.kernels.util import resolve_device
from repro_torch.launch.steps import _model_fns, make_train_step
from repro_torch.models import transformer
from repro_torch.optim import adamw_init


def init_state(cfg, generator: torch.Generator | None, device, tp=None):
    """(params, AdamW state over the flat parameters) of ``cfg`` drawn from
    ``generator`` on ``device``; ``device="meta"`` gives the abstract state
    (shapes and dtypes) that a restore fills.  ``tp``: this rank's blocks
    of both, each leaf cut to its block as it is drawn (``keep=tp.block``:
    the bits of the whole draw, and no more than one whole layer on the
    rank beside its blocks)."""
    params = _model_fns(cfg).init_params(
        generator, cfg, device, keep=None if tp is None else tp.block)
    return params, adamw_init(transformer.flatten_params(params),
                              memory_mode=cfg.opt_memory_mode)


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          microbatches: int = 1, ckpt_dir: str | None = None,
          ckpt_every: int = 10, injector: FailureInjector | None = None,
          log_every: int = 1, backend: str = "kernels", device=None,
          seed: int = 0, mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` steps on ``LMDataPipeline(global_batch,
    seq_len, cfg.vocab, seed)`` batches (with zero frames for an
    encoder-decoder); returns the last step's metrics (floats) with
    ``stragglers``, ``recoveries`` and ``final_step``, and ``losses``, every
    step's loss in the order run.

    Weights are drawn from a generator seeded with ``seed`` on ``device``
    (``None``: CUDA).  With ``ckpt_dir`` the loop resumes from its newest
    checkpoint, saves every ``ckpt_every`` steps, beats its heart there
    and restores after an ``InjectedFault``; without one such a fault
    propagates.  ``mesh``: this rank of a live ``(data, model)`` mesh on
    its device (the module docstring); only mesh rank 0 logs."""
    dev = resolve_device(device if mesh is None else mesh.device)
    step_fn = make_train_step(cfg, warmup=max(2, steps // 10),
                              total_steps=steps, microbatches=microbatches,
                              backend=backend, mesh=mesh)
    tp = step_fn.tp
    lead = mesh is None or mesh.rank == 0
    abstract = init_state(cfg, None, "meta")
    shardings = None if tp is None else tp.shardings(abstract)

    def fresh():
        return init_state(cfg, torch.Generator(dev).manual_seed(seed), dev,
                          tp)

    def restore(s):
        return restore_checkpoint(ckpt_dir, s, abstract, device=dev,
                                  shardings=shardings)

    def save(s, state):
        if tp is not None:
            state = tp.unshard(state)
            if not lead:
                return None
        return save_checkpoint(ckpt_dir, s, state, background=True)

    def settle(thread):
        """Join rank 0's background write, then hold every rank until it
        has landed, so all read the same newest step."""
        if thread is not None:
            thread.join()
        if tp is not None:
            torch.distributed.barrier(group=mesh.everyone())

    frames = (torch.zeros((global_batch, cfg.encoder_ctx, cfg.d_model),
                          dtype=torch.float32, device=dev)
              if cfg.encoder_layers else None)
    pipe = LMDataPipeline(global_batch, seq_len, cfg.vocab, seed=seed)
    watchdog = StragglerWatchdog()
    heart = (Heartbeat(ckpt_dir, 0 if mesh is None else mesh.rank)
             if ckpt_dir else None)

    def say(msg):
        if lead:
            print(msg, flush=True)

    start = 0
    if ckpt_dir and (s := latest_step(ckpt_dir)) is not None:
        params, opt_state = restore(s)
        start = s
        pipe.seek(start)
        say(f"[train] restored checkpoint at step {s}")
    else:
        params, opt_state = fresh()

    ckpt_thread = None
    metrics = {}
    losses = []
    step = start
    recoveries = 0
    try:
        while step < steps:
            try:
                got_step, np_batch = next(pipe)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in np_batch.items()}
                if frames is not None:
                    batch["frames"] = frames
                if injector is not None:
                    injector.maybe_fail(got_step)
                t0 = time.time()
                if injector is not None:
                    # slow faults stall inside the timed window, so the
                    # watchdog sees exactly the injected straggler
                    stall = injector.sleep_faults(got_step)
                    if stall > 0:
                        time.sleep(stall)
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                losses.append(metrics["loss"])
                dt = time.time() - t0
                slow = watchdog.observe(got_step, dt)
                if heart is not None:
                    heart.beat(got_step)
                step = got_step + 1
                if got_step % log_every == 0:
                    say(f"[train] step={got_step} "
                        f"loss={metrics['loss']:.6f} "
                        f"gnorm={metrics['grad_norm']:.3f} "
                        f"dt={dt * 1e3:.0f}ms"
                        f"{' STRAGGLER' if slow else ''}")
                if ckpt_dir and step % ckpt_every == 0:
                    if ckpt_thread is not None:
                        ckpt_thread.join()
                    ckpt_thread = save(step, (params, opt_state))
            except InjectedFault as e:
                # node failure: restore the newest checkpoint and resume
                say(f"[train] FAILURE: {e}; recovering")
                if not ckpt_dir:
                    raise
                recoveries += 1
                # join() re-raises a failed background save: a recovery
                # must not restore a step that never landed
                settle(ckpt_thread)
                ckpt_thread = None
                s = latest_step(ckpt_dir)
                if s is None:
                    params, opt_state = fresh()
                    step = 0
                else:
                    params, opt_state = restore(s)
                    step = s
                pipe.seek(step)
        if ckpt_dir:
            settle(ckpt_thread)
    finally:
        pipe.close()
    metrics["losses"] = losses
    metrics["stragglers"] = len(watchdog.flagged)
    metrics["recoveries"] = recoveries
    metrics["final_step"] = step
    return metrics


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--backend", default="kernels",
                    choices=("kernels", "torch"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to spawn (gloo; all on --device's card or "
                         "on the CPU): the step spans a (data, model) mesh "
                         "of them, each rank holding its blocks of the "
                         "parameters and the AdamW state")
    return ap


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.devices > 1:
        from repro_torch.launch.mesh import launch
        launch(_train_rank, args.devices, device=args.device, args=(argv,))
        return
    _train(args)


def _train_rank(device, argv) -> None:
    """One rank of ``--devices N``: the loop over a (data, model) mesh of
    the ranks, reported by rank 0."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import live_mesh, make_smoke_mesh

    mesh = live_mesh(make_smoke_mesh(), device)
    shd.make_groups(mesh)
    _train(_parser().parse_args(argv), mesh)


def _train(args, mesh=None) -> None:
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    out = train(cfg, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, microbatches=args.microbatches,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                backend=args.backend, device=args.device, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        where = "" if mesh is None else (
            f" on a {tuple(mesh.shape.values())} (data, model) mesh")
        print(f"[train] done{where}: {out}")


if __name__ == "__main__":
    main()
