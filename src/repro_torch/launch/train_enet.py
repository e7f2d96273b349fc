"""Train ENet on synthetic Cityscapes-like data through the port's kernels.

    PYTHONPATH=src python -m repro_torch.launch.train_enet --steps 200 --hw 64
    PYTHONPATH=src python -m repro_torch.launch.train_enet --dtype bf16
    PYTHONPATH=src python -m repro_torch.launch.train_enet --smoke --device cpu

The port of ``examples/train_enet.py``.  With ``--backend kernels``
(the default) every conv of the forward runs on the two hand-written conv
kernels and the backward re-enters them through the adjoints (input
gradients as transposed or strided dense convs, weight gradients as
tap-gather correlations, DESIGN.md §6); ``--backend torch`` composes
``F.conv2d``, and ``--naive`` (torch only) runs the zero-laden baseline.
``--dtype bf16`` trains through the mixed-precision recipe
(``train_recipes.make_train_step(..., compute_dtype="bf16")``: fp32 masters,
bf16 activations through the kernels' bf16 forms, dynamic loss scaling and
the skip of a non-finite step, at the constant ``--lr``), as the reference
example does.  It runs on CUDA unless ``--device cpu`` is given (the
kernels' plain versions then stand in for them) and ends with the pixel
accuracy on a held-out batch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import SegDataPipeline
from repro_torch.kernels.util import resolve_device
from repro_torch.launch import train_recipes
from repro_torch.models.enet import ENet
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--classes", type=int, default=19)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--backend", choices=("kernels", "torch"),
                    default="kernels",
                    help="execution engine for every conv (fwd AND bwd)")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="compute dtype of the forward/backward activations; "
                         "bf16 trains through the mixed-precision recipe "
                         "(fp32 masters + dynamic loss scaling)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny run (caps steps/batch/hw)")
    ap.add_argument("--naive", action="store_true",
                    help="the zero-laden baseline (no decomposition; torch "
                         "backend only)")
    args = ap.parse_args(argv)
    if args.naive and args.backend == "kernels":
        ap.error("--naive has no kernels; use --backend torch")
    if args.smoke:
        args.steps = min(args.steps, 3)
        args.batch = min(args.batch, 1)
        args.hw = min(args.hw, 16)
        args.log_every = 1
    dev = resolve_device(args.device)

    model = ENet(args.classes, device=dev,
                 generator=torch.Generator().manual_seed(args.seed))
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params)
    pipe = SegDataPipeline(args.batch, hw=args.hw, classes=args.classes,
                           seed=args.seed)
    loss = train_recipes.loss_fn("enet", backend=args.backend,
                                 decomposed=not args.naive)
    cd = "bf16" if args.dtype == "bf16" else None
    if cd is not None:
        # the mixed-precision recipe owns the optimizer and loss scaling
        state = train_recipes.init_state(params)
        recipe_step = train_recipes.make_train_step(
            "enet", backend=args.backend, decomposed=not args.naive,
            compute_dtype=cd, lr=args.lr, weight_decay=1e-4)

    losses = []
    for step in range(args.steps):
        batch = train_recipes.batch_to(pipe.batch_at(step), dev)
        t0 = time.perf_counter()
        if cd is not None:
            state, m = recipe_step(state, batch)
            params, value, gnorm = state.params, m["loss"], m["grad_norm"]
        else:
            lr = cosine_schedule(step, args.steps // 10, args.steps,
                                 args.lr).to(dev)
            value, grads = train_recipes.loss_and_grads(loss, params, batch)
            params, opt, gnorm = adamw_update(grads, opt, params, lr=lr,
                                              weight_decay=1e-4)
        losses.append(value.item())
        if step % args.log_every == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorm.item():.3f} "
                  f"dt {(time.perf_counter() - t0) * 1e3:.0f}ms", flush=True)
        if not np.isfinite(losses[-1]):
            raise SystemExit(f"non-finite loss at step {step}")

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss: first10={first:.4f} last10={last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    batch = train_recipes.batch_to(pipe.batch_at(10_000), dev)
    forward = train_recipes.model_forward("enet", backend=args.backend,
                                          decomposed=not args.naive,
                                          compute_dtype=cd)
    with torch.no_grad():
        pred = forward(params, batch["image"]).argmax(-1)
    acc = (pred == batch["label"]).float().mean().item()
    print(f"pixel accuracy on held-out batch: {acc:.3f} "
          f"(chance = {1.0 / args.classes:.3f})")


if __name__ == "__main__":
    main()
