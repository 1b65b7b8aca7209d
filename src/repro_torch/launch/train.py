"""Training launcher of the port (``repro/launch/train.py``): trains a
registered architecture on the seeded synthetic stream, with checkpoints
and restart.

    python -m repro_torch.launch.train --arch smollm-135m --steps 200 --smoke --device cpu
    python -m repro_torch.launch.train --arch smollm-135m --steps 20 --batch 8 --seq 4096 \\
        --microbatches 4 --lr 1e-3      # full width on the card

The JAX launcher's flags and lines, plus ``--device`` (default: the CUDA
card; ``--device cpu`` trains on the CPU).  As in JAX's launcher, the
master parameters are f32 and the gradients accumulate in f32 for every
architecture, with its optimizer; the spec's ``train_param_dtype`` and
``grad_accum_dtype`` (bf16 for arctic-480b) are read only by the dry run
(``launch/dryrun.py``).  Compute runs in the config's ``compute_dtype``
(bf16) and each period is recomputed in the backward pass where the config
sets ``remat``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..configs import get_spec
from ..models import Model, init_random_
from ..train import (
    make_optimizer,
    make_train_step,
    restore_latest,
    save_checkpoint,
    synth_batch,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    spec = get_spec(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    ckpt_dir = args.ckpt_dir or os.path.join("artifacts", "ckpt", args.arch)
    opt = make_optimizer(spec.optimizer, lr=args.lr)
    model = init_random_(Model(cfg, device=args.device, train_dtype=torch.float32),
                         args.seed)
    state = opt.init(dict(model.named_parameters()))
    start = 0
    if args.resume:
        restored = restore_latest(ckpt_dir, {"params": model, "opt": state})
        if restored:
            start, tree = restored
            state = tree["opt"]
            print(f"resumed from step {start}")
    step_fn = make_train_step(opt, microbatches=args.microbatches, batch_shards=1)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = synth_batch(cfg, global_batch=args.batch, seq_len=args.seq,
                            seed=args.seed, step=i, device=model.device)
        model, state, metrics = step_fn(model, state, batch)
        if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
            save_checkpoint(ckpt_dir, i + 1, {"params": model, "opt": state})
        if i % 10 == 0 or i + 1 == args.steps:
            print(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/max(i-start+1,1):.2f}s/step)")
    print(f"done: {args.steps} steps, checkpoints in {ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
