"""Batched serving launcher: prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch tinyllama-1.1b --batch 4 --prompt-len 32 --gen 16 \\
        [--no-reduced] [--codebook K] [--device cpu]

Port of `repro/launch/serve.py`. The model is built from ``--seed`` on
``--device`` (default the card; ``--device cpu`` runs on the CPU, and
``--device cuda`` without a card fails). ``--reduced`` (the default)
takes the architecture's reduced config and ``--no-reduced`` its full
width. Every family runs; the encdec (whisper) and vlm (internvl2)
models take zero frame or patch embeddings beside the prompt, as JAX's
CLI gives them (`modality_stubs`), and the vlm's cache holds its patch
prefix, the prompt and the generated tokens (`cache_len`).

With ``--codebook K`` the server also maintains a k-means VQ codebook
over the token-embedding table, served through `repro_torch.serve`: the
codebook is fitted once at startup (checkpointable with
``--checkpoint-dir`` / ``--save-every``, resumable with ``--resume``)
and then wrapped in a `ClusterService`: every served batch's
embeddings are INGESTED, not folded inline, so the background refresher
keeps the codebook fresh while decode traffic reads versioned snapshots
without ever waiting on a `partial_fit`. Decode output is tagged with
its codebook cell.

``--codebook-backend`` other than local fits over the ranks of a
`torch.distributed` process group, one rank per process. The CLI is one
process: with no group up, it joins a one-rank group of its own at a
free localhost port (NCCL on the card, gloo on the CPU) for the fit and
leaves it after.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
from repro_torch.data.store import ChunkStore
from repro_torch.kernels._build import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.serve import ClusterService, IngestQueue
from repro_torch.train import step as tstep


def build_codebook(E, k: int, seed: int, *,
                   checkpoint_dir: str | None = None,
                   save_every: int = 20,
                   resume: bool = False,
                   backend: str = "local",
                   trace_dir: str | None = None,
                   device="cuda") -> NestedKMeans:
    """Fit the embedding codebook through the unified api.

    ``E`` is the data to cluster: an in-memory ``(n, d)`` array (the
    embedding table), or an on-disk `repro_torch.data.store` chunk store
    (a directory path or an open `ChunkStore`) for embedding corpora
    bigger than host memory. Store-backed fits stream the nested prefix
    from disk on any backend; everything downstream (checkpointing,
    resume, the local hand-off) is identical.

    With ``checkpoint_dir`` the fit checkpoints its full loop state
    every ``save_every`` rounds and (``resume=True``) continues a killed
    fit bit-identically instead of restarting. ``resume`` without a
    checkpoint dir is a loud error: silently refitting from scratch is
    exactly what a resuming operator does not want.

    ``trace_dir`` attaches a `repro_torch.obs.FitObserver` to the fit
    (`python -m repro_torch.obs summarize DIR`).

    ``backend`` selects the execution engine for the FIT: "local"
    (default), "mesh" (points sharded over the ranks), "xl" (points AND
    centroids sharded: the large-k regime) or "multihost" (the mesh
    engine over the group it joins). The sharded backends need a
    `torch.distributed` process group; every rank calls this with the
    same arguments. "mesh" and "xl" build a ``(data, model)`` mesh over
    every rank, the model dim ``gcd(world, k)`` for xl (1 for mesh).
    The returned estimator is always a LOCAL one on ``device``: a
    sharded fit's (k, d) cluster stats are adopted onto the local
    engine, so serving streams without a sharded layout per micro-batch.
    """
    if resume and not checkpoint_dir:
        raise ValueError(
            "--resume needs --checkpoint-dir: there is nowhere to "
            "resume from without a checkpoint store")
    if isinstance(E, (str, Path)):
        E = ChunkStore(E)
    n = E.n if isinstance(E, ChunkStore) else E.shape[0]
    ck = (CheckpointConfig(checkpoint_dir=checkpoint_dir,
                           save_every=save_every)
          if checkpoint_dir else None)
    mesh = None
    if backend in ("mesh", "xl"):
        if not dist.is_initialized():
            raise RuntimeError(
                f"backend={backend!r} fits over a torch.distributed "
                f"process group: call torch.distributed.init_process_group "
                f"first, on every rank")
        world = dist.get_world_size()
        # widest model dim both the rank count and k divide by, degrading
        # to m=1 (centroids unsharded) only when unavoidable, and loudly,
        # since an operator asked for xl to SHARD k
        m = math.gcd(world, k) if backend == "xl" else 1
        if backend == "xl" and m == 1 and world > 1:
            print(f"warning: backend='xl' cannot shard k={k} over "
                  f"{world} ranks (gcd 1); centroids stay replicated "
                  f"(equivalent to backend='mesh')")
        mesh = make_host_mesh((world // m, m), ("data", "model"))
    cfg = FitConfig(k=k, algorithm="tb", rho=float("inf"),
                    b0=min(2 * k, n), bounds="hamerly2",
                    max_rounds=200, seed=seed, checkpoint=ck,
                    backend=backend, data_axes=("data",),
                    model_axis="model", trace_dir=trace_dir)
    km = NestedKMeans(cfg, mesh=mesh, device=device)
    km.fit(E, resume=resume)
    if backend != "local":
        # only the (k, d)-sized cluster stats are handed over: km.stats_
        # is whole on every backend, while the row-sharded per-point
        # state stays where it is
        out = km.outcome_
        out = dataclasses.replace(
            out, state=dataclasses.replace(out.state, stats=km.stats_))
        km = NestedKMeans(dataclasses.replace(cfg, backend="local"),
                          device=device)
        km.adopt(out)
    return km


def modality_stubs(cfg, batch: int, device) -> dict:
    """The inputs beside the tokens that JAX's CLIs give an encdec or vlm
    model: zero ``frames`` (batch, n_ctx, d_frontend) or zero
    ``patches`` (batch, n_ctx, d_model), bf16; ``{}`` for the other
    families."""
    enc = cfg.encoder
    if cfg.family == "encdec":
        shape = (batch, enc.n_ctx, enc.d_frontend)
        return {"frames": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)}
    if cfg.family == "vlm":
        shape = (batch, enc.n_ctx, cfg.d_model)
        return {"patches": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)}
    return {}


def cache_len(cfg, prompt_len: int, gen: int) -> int:
    """The decode cache's positions: the prompt and the generated tokens,
    and the vlm's patch prefix before them."""
    return prompt_len + gen + (cfg.encoder.n_ctx if cfg.family == "vlm"
                               else 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, tokens: torch.Tensor, gen: int, *,
             inputs=None, service=None, E=None) -> dict:
    """Prefill ``tokens`` (B, P), then ``gen - 1`` greedy decode steps.

    ``inputs`` holds what the model takes beside the tokens (an encdec
    model's ``frames``, a vlm's ``patches``; `modality_stubs`). With a
    ``service``, each decode step's tokens are ingested as the
    rows of ``E`` (the embedding table, host f32) they index, their ids
    the dedup keys. Returns ``{"gen": (B, gen) int32 ids, "t_prefill",
    "t_decode"}`` (seconds, host clock, the device drained).
    """
    dev = tokens.device
    B, P = tokens.shape
    prefill = tstep.make_prefill_step(cfg, cache_len=cache_len(cfg, P, gen))
    decode = tstep.make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens, **(inputs or {})})
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)

    out = [tok.cpu().numpy()]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, tok, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        ids = tok.cpu().numpy()
        out.append(ids)
        if service is not None:
            # stream the served embeddings toward the refresher; token
            # ids double as dedup keys ("each sample exactly once")
            ids = ids.ravel()
            service.ingest(E[ids], ids=ids.tolist())
    _sync(dev)
    return {"gen": np.concatenate(out, axis=1), "t_prefill": t_prefill,
            "t_decode": time.perf_counter() - t0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def codebook_group(backend: str, device: torch.device):
    """With a sharded codebook ``backend`` and no process group up, a
    one-rank group of this process's own at a free localhost port (NCCL
    on the card, gloo on the CPU), left on exit; else nothing."""
    own = backend != "local" and not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    try:
        yield
    finally:
        if own:
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the architecture's reduced config (default); "
                         "--no-reduced builds it at full width")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model and the codebook run")
    ap.add_argument("--codebook", type=int, default=0, metavar="K",
                    help="maintain a K-cell VQ codebook over the "
                         "embedding table via repro_torch.serve")
    ap.add_argument("--codebook-store", default=None, metavar="DIR",
                    help="fit the codebook from this on-disk chunk store "
                         "instead of the embedding table (its d must "
                         "equal the model's embedding dim; the fit "
                         "streams from disk)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint the codebook fit in-loop here")
    ap.add_argument("--save-every", type=int, default=20,
                    help="codebook checkpoint cadence in host rounds")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed codebook fit from "
                         "--checkpoint-dir (error without it)")
    ap.add_argument("--codebook-backend", default="local",
                    choices=("local", "mesh", "xl", "multihost"),
                    help="execution engine for the codebook fit: local "
                         "| mesh (points sharded) | xl (points + "
                         "centroids sharded, for large K) | multihost "
                         "(the mesh engine over a process group)")
    ap.add_argument("--trace-dir", default=None,
                    help="write repro_torch.obs structured traces of the "
                         "codebook fit here (inspect with `python -m "
                         "repro_torch.obs summarize DIR`)")
    args = ap.parse_args(argv)
    if not args.codebook and (args.resume or args.checkpoint_dir
                              or args.trace_dir):
        ap.error("--checkpoint-dir/--resume/--trace-dir only apply to "
                 "the codebook fit; pass --codebook K")

    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    params = M.init_params(args.seed, cfg, device)
    rng = np.random.default_rng(args.seed)
    B, P = args.batch, args.prompt_len

    service = None
    E = None
    if args.codebook:
        E = params["embed"].float().cpu().numpy()
        t0 = time.time()
        with codebook_group(args.codebook_backend, device):
            codebook = build_codebook(args.codebook_store or E,
                                      args.codebook, args.seed,
                                      checkpoint_dir=args.checkpoint_dir,
                                      save_every=args.save_every,
                                      resume=args.resume,
                                      backend=args.codebook_backend,
                                      trace_dir=args.trace_dir,
                                      device=device)
        what = (f"store {args.codebook_store}" if args.codebook_store
                else f"{E.shape} embeddings")
        print(f"codebook: k={args.codebook} over {what} "
              f"in {time.time() - t0:.2f}s "
              f"(rounds={codebook.n_rounds_}, "
              f"converged={codebook.converged_})")
        # background refresh: served embeddings are queued, folded in by
        # the refresher thread, and published as versioned snapshots;
        # dedup on token id keeps each embedding's contribution unique
        service = ClusterService(
            codebook, micro_batch=256, flush_after_s=0.05,
            queue=IngestQueue(max_rows=4096, dedup=True)).start()

    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P))).to(device)
    try:
        res = generate(cfg, params, tokens, args.gen,
                       inputs=modality_stubs(cfg, B, device),
                       service=service, E=E)
    except BaseException:
        if service is not None:
            service.stop(drain=False)
        raise
    gen, t_decode = res["gen"], res["t_decode"]
    print(f"{args.arch}: prefill {B}x{P} in {res['t_prefill'] * 1e3:.1f}ms; "
          f"{args.gen - 1} decode steps in {t_decode * 1e3:.1f}ms "
          f"({B * (args.gen - 1) / max(t_decode, 1e-9):.0f} tok/s) "
          f"on {device}")
    print("generated token ids (row 0):", gen[0].tolist())

    if service is not None:
        # tag output tokens with their codebook cell (router/dedup view)
        cells = service.predict(E[gen[0]])
        print("codebook cells  (row 0):", cells.tolist())
        service.stop()               # final flush of the ingest queue
        m = service.export_metrics()
        snap = service.snapshot
        print(f"codebook service: {m['refresh']['count']} background "
              f"refreshes over {m['refresh']['rows']} embeddings, "
              f"snapshot v{snap.version} "
              f"(deduped={m['queue']['deduped']}, "
              f"batch MSE {snap.batch_mse:.5f})")


if __name__ == "__main__":
    main()
