"""LM training CLI: an architecture, reduced or at full width.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch tinyllama-1.1b --reduced --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/run1 [--codebook K] [--device cpu]

Port of `repro/launch/train.py`, with its flags and its lines. The model
is built from ``--seed`` on ``--device`` (default the card; ``--device
cpu`` runs on the CPU, and ``--device cuda`` without a card fails).
Every family trains; an encdec (whisper) or vlm (internvl2) model takes
JAX's zero frame or patch stubs beside the synthetic tokens, and a vlm's
tokens and labels lose their first ``n_ctx`` columns where ``--seq``
exceeds ``n_ctx``, as in JAX (`lm_batch`). Each step is
`repro_torch.train.step.make_train_step`'s, which updates the
parameters and the optimizer state in place (JAX donates them).
Checkpoints save in the background every ``--ckpt-every`` steps (each
leaf is copied to host memory before the next step runs), each labelled
with the number of steps it holds, and training resumes from the latest
checkpoint if the directory holds one. The files are the JAX package's,
so either package resumes the other's final checkpoints and the port's
mid-run ones; JAX's CLI labels a mid-run checkpoint one step short, so
a run resumed from one of those repeats that step (ROADMAP Queue 3).
``--codebook K`` then clusters the trained token-embedding table through
`repro_torch.launch.serve.build_codebook` (the paper's nested k-means,
on ``--codebook-backend``) and prints its VQ error and occupancy.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.data.pipeline import LMBatches
from repro_torch.kernels._build import resolve_device
from repro_torch.launch.serve import (build_codebook, codebook_group,
                                      modality_stubs)
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves


def lm_batch(cfg, arrays: dict, device) -> dict:
    """A step's batch from `LMBatches`' numpy ``arrays`` on ``device``,
    as JAX's CLI makes it: the encdec and vlm models get zero frame or
    patch stubs (`modality_stubs`), and a vlm's tokens and labels drop
    their first ``n_ctx`` columns when they are longer than that."""
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    if cfg.family == "vlm":
        p = cfg.encoder.n_ctx
        for k in ("tokens", "labels"):
            if batch[k].shape[1] > p:
                batch[k] = batch[k][:, p:]
    batch.update(modality_stubs(cfg, batch["tokens"].shape[0], device))
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", "--checkpoint-dir", dest="ckpt_dir",
                    default=None,
                    help="checkpoint directory (LM training state; the "
                         "--codebook fit checkpoints in-loop under "
                         "<dir>/codebook)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="restore the latest checkpoint in --ckpt-dir "
                         "before training / the codebook fit "
                         "(--no-resume starts fresh)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--codebook", type=int, default=0, metavar="K",
                    help="cluster the trained embedding table into K "
                         "cells via repro_torch.api and report VQ stats")
    ap.add_argument("--codebook-store", default=None, metavar="DIR",
                    help="fit the codebook from this on-disk chunk store "
                         "instead of the embedding table (its d must "
                         "equal the model's embedding dim); the VQ probe "
                         "still reports the table's occupancy under it")
    ap.add_argument("--codebook-backend", default="local",
                    choices=("local", "mesh", "xl", "multihost"),
                    help="engine for the codebook fit: local | mesh "
                         "(points sharded over the ranks) | xl (points + "
                         "centroids sharded: large K) | multihost (the "
                         "mesh engine over a process group)")
    ap.add_argument("--trace-dir", default=None,
                    help="write repro_torch.obs structured traces of the "
                         "codebook fit here (inspect with `python -m "
                         "repro_torch.obs summarize DIR`)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model and the codebook run")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if cfg.family in ("encdec", "vlm"):
        print(f"note: {args.arch} needs modality inputs; using zero "
              "frame/patch stubs for the synthetic-token run")
    params = M.init_params(args.seed, cfg, device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{args.arch} ({'reduced' if args.reduced else 'FULL'}): "
          f"{n_params:,} params")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                decay_steps=max(args.steps, 100))
    train_step = tstep.make_train_step(cfg, n_micro=args.n_micro,
                                       opt_cfg=opt_cfg)
    opt = adamw.init(params)

    data = LMBatches(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                     seed=args.seed)
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if store and args.resume and store.latest_step() is not None:
        start = store.latest_step()
        restored = store.restore({"params": params, "opt": opt},
                                 device=device)
        params, opt = restored["params"], restored["opt"]
        print(f"resumed from checkpoint at step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        params, opt, m = train_step(params, opt,
                                    lm_batch(cfg, data.at(step), device))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)")
        # labelled with the next step to run, as the final checkpoint
        # is: a resumed run starts there and applies no step twice
        done = step + 1
        if store and done % args.ckpt_every == 0 and done < args.steps:
            store.save(done, {"params": params, "opt": opt},
                       background=True)
    if store:
        store.save(args.steps, {"params": params, "opt": opt})
        store.wait()
        print(f"final checkpoint at step {args.steps}")

    if args.codebook:
        E = params["embed"].float().cpu().numpy()
        # the k-means fit checkpoints in-loop and resumes if a prior run
        # was killed; --resume only applies where there is a store
        ckpt_dir = (f"{args.ckpt_dir}/codebook" if args.ckpt_dir
                    else None)
        with codebook_group(args.codebook_backend, device):
            km = build_codebook(args.codebook_store or E, args.codebook,
                                args.seed, checkpoint_dir=ckpt_dir,
                                resume=args.resume and ckpt_dir is not None,
                                backend=args.codebook_backend,
                                trace_dir=args.trace_dir, device=device)
        sizes = np.bincount(km.predict(E), minlength=args.codebook)
        print(f"embedding codebook (k={args.codebook}): "
              f"VQ-MSE {-km.score(E) / E.shape[0]:.6f} "
              f"occupancy min={sizes.min()} max={sizes.max()} "
              f"empty={int((sizes == 0).sum())}")


if __name__ == "__main__":
    main()
