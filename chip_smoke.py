#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any fault exits non-zero):
  1. the device: name, count, and nvidia-smi's name and power limit;
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, in parallel), printing the build time, ptxas's
     registers / shared memory / spills per kernel, and the count of
     tensor-core (HGMMA, HMMA) and TMA-load (UTMALDG) instructions in each
     library's SASS (``cuobjdump -sass``); the libraries of the three
     f32 top-2s (assign_top2, fused_nested_round, fused_round: the
     tensor-core top-2 of tc_top2.cuh) must have both HGMMA and UTMALDG;
  3. hold each kernel against its plain PyTorch version on the card, on
     inputs made from a numpy seed: at the main-path shape (n=400,000,
     d=784, k=50), at k=1, k=257 and an unaligned n, kernel 1 also in
     bf16. Kernel 4's top-2 is held to the plain version's with x.c,
     |x|^2 and |c|^2 taken in float64 and rounded once to f32 (an f32
     product is too far off where they cancel, as at kmeans_xl width);
     its distance from the plain version itself is logged. Kernels 1 (in
     f32) and 3 are held, beyond their plain versions, to the ref
     expression's top-2 taken that way (`assign_top2_exact`), within
     FULL_RTOL = 5e-7 of |x|^2 + max |c|^2 plus FULL_ATOL = 1e-5, and the
     largest gap is logged. The plain sums on the card
     (`ref.cluster_sum_ref`) must give the same bits twice and agree with
     ``index_add_``, at the main-path shape and at kmeans_xl's width.
     Tolerances
     are those of tests/test_kernels.py: f32 rtol 1e-5 (atol 1e-4), bf16 rtol 2e-2;
     labels may differ only where the two distances tie within 100x the
     tolerance. Sums over many rows are
     held to their rtol (1e-5 for cluster_sum, 1e-4 for the fused
     rounds' sums, as tests/test_kernels.py holds them) relative to their
     L1 mass (sum of |w x| per entry), the scale of f32 rounding in a
     sum of that many terms. Each kernel must give the same bits twice,
     and the sums of kernels 2-4 (the shared deterministic scatter) must
     have the bits of the order oracle `ref.ordered_sums` (rows of a chunk
     in row order, then the chunks in order) over the kernel's own labels;
  4. the main path at full size: ``NestedKMeans(FitConfig(k=50, b0=5000,
     algorithm="tb", rho=inf, bounds="hamerly2")).fit`` on 400,000
     ``infmnist_like`` rows (the paper's infMNIST experiment) with 10,000
     validation rows, then ``predict``. Each kernel's launch count is set
     to 0 just before and read just after; all three must be > 0. The
     profiled second fit logs the scatter's device time by pass, the
     tensor-core top-2s' device time (both must show), and the count of
     host calls that wait for the device. A second identical fit must
     give bit-identical centroids and labels, and the same fit with
     ``kernel_backend="ref"`` (plain versions on the card) must reach a
     final validation MSE within 1e-3 relative; it runs twice, and the
     two must give the same bits. The schedules of the cuda and ref fits
     are logged with the round where they part, and a shadowed cuda fit
     takes each round's step on the plain versions too, from the same
     state: the same recomputations, labels that differ only at
     near-ties (float64 gap within 1e-3 relative), and the cuda fit's
     bits;
  5. time each kernel at its main-path shape with CUDA events after a
     warm-up, beside its plain version, one PyTorch library call where
     one computes the same function, and its bound on an H100 SXM (the
     larger of bytes over 3.35 TB/s and the operations over their type's
     peak: the tensor-core top-2s' 3 x 2 n k_pad d in 3xTF32 at 495
     TFLOP/s, k_pad the k tiles they run, other adds in f32 at 67
     TFLOP/s); cuBLAS's f32 ``torch.mm`` of x.c^T at that shape is timed
     as a yardstick (not the same function);
  6. the kmeans_xl data-parallel round at full width on one card's share
     of the rows: n=2^22 (2^30 points over 256 chips), d=1024, k=4096,
     f32, Gaussian blobs made on the card. Kernel 4 (the one-shot round)
     is held against its plain version as in phase 3 on the last 65,536
     rows, and its sums over all rows against plain sums taken in row
     chunks and, bit for bit, against the order oracle (the one check at
     64 cluster tiles). Then, with the launch counts set to 0 just before
     and read just after: ``make_dp_round(mesh=None, fused=True)`` runs 3
     Lloyd steps (the batch MSE may not rise beyond 1e-6 relative), two
     steps under a one-rank NCCL `DeviceMesh` must give the same bits as
     ``mesh=None``, and one unfused step (kernels 1 and 2) must give the
     same labels but for near-ties, C bit-identical on every cluster no
     such row touches, and C within 1e-4 relative of the fused step's
     (kernel 1's top-2 runs the same tensor-core loop). The fused step's
     labels must equal the float64 argmin of every row but for
     near-ties, and its C must be within 1e-4 relative of the C those
     float64 labels give; the unfused C's gap to it is logged. The
     profiled fused step gives kernel 4's parts by kernel: the
     tensor-core top-2, the scatter's three passes (row lists, sums over
     the lists, chunk reduction), and the small passes; where the trace
     lost the step's kernels, as torch.profiler has in some runs on the
     card, the step is traced again, at most twice. Last, kernel 4
     is timed at that shape (mean of 3 after a warm-up) beside its plain
     version on a 2^18-row slice and its bound, the larger of the bytes
     over 3.35 TB/s and its operations at their type's peak (the
     distances in 3xTF32 at 495 TFLOP/s, the adds into S in f32), with
     the full-f32 CUDA-core bound and a yardstick beside it: cuBLAS's f32
     ``torch.mm`` of x.c^T on the slice, scaled to all rows;
  7. the paper's other algorithms and bound families at the infMNIST
     cell's width, on phase 4's rows: lloyd (to convergence, at most 100
     rounds), mb and mb-f (b0=2000, 400 rounds: two passes over the rows,
     one reshuffle), tb with ``bounds="elkan"`` and with
     ``bounds="exponion"`` (phase 4's config otherwise, to convergence)
     and lloyd-elkan (at most 100 rounds). For each, the launch counts
     are set to 0 just before the fit and read just after: assign_top2
     and cluster_sum must be > 0 on lloyd, mb and mb-f, cluster_sum on
     the elkan and exponion paths (their (b, k) distances are plain
     matrix products, as in the JAX package). A second identical fit
     must give bit-identical centroids and labels, and the same fit with
     ``kernel_backend="ref"`` must reach a final validation MSE within
     1e-3 relative. Rounds, wall, the sum of n_recomputed, the final
     validation MSE, peak device memory and the validation MSE against
     the rounds' time are logged (phase 4's tb fit beside them), and the
     second fit is profiled on the device (its kernels, copies and CUDA
     runtime calls; not the host's operators, as phase 4's are). The two
     tb families run once more shadowed: each round's step is also taken
     with ``bounds="none"`` from the same state, and the labels may
     differ from it only at near-ties (float64 gap within 1e-3
     relative);
  8. out-of-core and kill-and-resume on phase 4's rows, under a
     ``tempfile.mkdtemp()`` directory that is removed at the end (its
     free disk space logged first): (a) the rows are written to a chunk
     store (65,536-row chunks) and fitted with phase 4's config through
     ``config.data_source``; C, labels and telemetry but ``t`` must be
     bit-equal to the in-memory fit of ``X[store_permutation(...)]``
     with ``shuffle=False``, and a second fit from an open `ChunkStore`
     must repeat them; the store write time, the fit's wall and peak
     device memory and the bytes read against one pass are logged. (b)
     Phase 4's fit with a checkpoint every 25 rounds is killed by an
     ``on_round`` that raises at round 137 (the last save is round 125),
     then resumed with ``fit(resume=True)``: C, labels and telemetry but
     ``t`` must be bit-equal to phase 4's unbroken fit. (c) The same for
     phase 7's tb-elkan and mb fits with a checkpoint every 50 rounds,
     each held to its unbroken fit. The saves, ms per save, restore ms
     and checkpoint bytes are logged. Each fit's launch counts are set to
     0 just before and read just after: kernels 1-3 must be launched in
     the phase, and each resumed part must launch its path's kernels;
  9. the streaming service (``repro_torch.serve.ClusterService``) on
     phase 4's rows and fit, adopted by fresh estimators, with a stream
     of ``infmnist_like(120_000, seed=2)`` rows. (a) The latency design of
     benchmarks/serve_latency.py: 2048-row predicts, 256 stream rows a
     request, 500 timed requests a mode after a warm-up with the
     refresh off (before and after the others; the worse p99 counts),
     inline (the serving thread folds 16,384 rows at a time) and in the
     background (a service with 256-row micro-batches); p50, p99, max
     and the background-to-off p99 ratio are logged beside the JAX
     package's 1.5x claim, with no limit on times. (b) 4 reader threads
     predict for 5 s while one producer delivers every row twice under
     one id into a dedup ``IngestQueue(max_rows=16384,
     policy="block")``, and goes on alone: every snapshot a reader loads
     must verify, its versions may not fall, at least 10 refreshes must
     run while they read, after ``stop(drain=True)`` the rows folded in
     must equal the unique rows delivered and the rise of sum(counts)
     (exactly once), and every 50th request's labels must equal
     ``ref.assign_top2_ref`` on its snapshot's C on the card but at
     near-ties. (c) The stream's first 32,768 rows, scaled x3 after the
     first 16,384, into a service with a 65,536-row history and a
     checkpointed estimator, readers reading throughout: at least one
     escalation, each followed by a newer snapshot that verifies; its
     wall and the readers' p99 during it are logged. (d)
     The same 20 ``partial_fit(256)`` batches from the adopted codebook
     on two fresh estimators give bit-equal C, counts and telemetry but
     ``t``, and C within 1e-5 relative (Frobenius) of the same batches on
     the plain versions (``kernel_backend="ref"``). The launch counts are
     set to 0 before (a) and read after (d): assign_top2 and
     fused_nested_round must be > 0. Last, a predict's time is split into
     the upload of its rows, the kernel and the rest (host).
  10. tracing and the invariant checkers on phase 4's rows and config,
     under a ``tempfile.mkdtemp()`` directory removed at the end: (a) the
     fit with ``trace_dir`` set must be bit-equal (C, labels, telemetry
     but ``t``) to phase 4's untraced fit; `repro_torch.obs.summarize`
     of its directory must count its rounds and a ``kscans_total`` equal
     to the sum of ``n_recomputed``, every round's H100 ``utilization``
     must be <= 1.0 (higher means the roofline model is wrong), and the
     last and mean utilization, each round's bottleneck and the spans'
     totals are logged. (b) After a warm-up, untraced fits, traced fits
     and fits whose observer is the no-op seam rotate, 2 each; the
     median per-round wall of each (the work clock, which stops before
     the round reaches the sink) is logged beside the JAX package's 3 %
     claim (benchmarks/obs_overhead.py), and each fit's wall is split
     into its rounds, the observer's own calls, the collector's pauses
     and the rest, with no limit on the times. (c) ``hostsync.audit_backend("local")`` on
     this fit with tracing on must report 0 violations, and its selftest
     must show sync-debug mode catching the planted per-round coercion at
     its line on the card. (d) ``retrace.audit_backend`` on this fit, from
     empty trace counters, must report no violation, and its first-seen
     round keys must equal its distinct (b, capacity) buckets, whose
     count is logged. (e) ``donation.check_inplace`` on a store fit of
     the rows (65,536-row chunks, as in phase 8): the device buffer's
     pointer must never move, and no growth may allocate a second
     buffer; what a growth allocates is logged against the buffer's
     bytes. (f) hostsync and retrace (JAX's audit fits) on mesh, xl and
     multihost: one NCCL rank in this process, whose collectives are the
     identity, so the gloo staging scope opens 0 times; then 2 spawned
     ranks, a gloo group on the card, whose collectives of CUDA tensors
     stage through the host in that scope: 0 unsanctioned syncs in every
     rank, the staged collectives and their syncs logged a round. Every
     rank's first-seen keys must equal its buckets. The launch counts
     are set to 0 before (a) and read after (f): kernels 1-3 must be > 0.
  11. the mesh and multihost engines on phase 4's rows and config: (a) a
     one-process ``backend="multihost"`` fit, which joins a one-rank NCCL
     group from its coordinator fields, then a ``backend="mesh"`` fit
     over that group, each with ``predict``: C, labels and telemetry but
     ``t`` bit-equal to phase 4's local fit. (b) 2 spawned ranks, a gloo
     group whose ranks both compute on the card (NCCL refuses two ranks
     on one card), fit the rows, 200,000 a rank: every rank must compute
     on the card with the cuda plan and hold the same bits; a second fit,
     whose every all-reduce is timed, must give the same bits, and the
     fit on the ref plan a final validation MSE within 1e-3 relative; the
     labels may differ from phase 4's only at near-ties (float64 gap
     within 1e-3 relative under the 2-rank C); rounds and the round
     where the two schedules part are logged. (c) The same ranks fit a
     7-chunk store of the rows in (b)'s shuffle order with
     ``shuffle=False``: bit-equal to (b); each rank's bytes read are
     logged against one pass. (d) The 2-rank fit checkpointed every 25
     rounds is killed at round 137 and resumed on the 2 ranks, bit-equal
     to (b); the checkpoint is then resumed on the local engine, and its
     schedule is logged. Each fit's launch counts are set to 0 just
     before it and read just after, in each process: kernels 1-3 must be
     > 0 in (a)'s fits, on every rank of (b) and in the local resume, and
     assign_top2 and cluster_sum in (d)'s resumed fits.
  12. the XL engine (``backend="xl"``: centroids sharded over the model
     dim of a (data, model) `DeviceMesh`), after phase 6's X and the
     caches are freed: (a) a one-rank NCCL (1, 1) XL fit of phase 4's
     rows and config, with ``predict``: C, labels and telemetry but ``t``
     bit-equal to phase 4's local fit. (b) kmeans_xl's width (d=1024,
     k=4096, tb, hamerly2, rho=inf, the cuda plan) on 2^20 Gaussian blob
     rows made on the card with phase 6's recipe (and 2^14 validation
     rows), b0=2^16, at most 40 rounds (the cuts are logged): the XL fit
     on the one-rank NCCL mesh bit-equal to the local fit; then kernels
     1-3 at that width, on 65,536 of the rows with the fit's centroids,
     at k=2048 (a model rank's slice) and k=4096: kernels 1 and 3's d1
     and d2 within FULL_RTOL of the scale |x|^2 + max |c|^2 of the
     once-rounded float64 top-2, their labels equal but at ties within
     100x f32's rtol 1e-5 of the distance (the plain version's f32
     product is logged, as in phase 6); kernel 2, on kernel 1's labels
     with +1/0/-1 weights, and kernel 3's sums within the L1 mass bound
     of plain sums and bit-equal to the order oracle; each twice
     bit-identical, and timed beside its plain version and bound (kernel
     2 also beside ``index_add_``) with the card's name and power limit.
     (c) 2
     spawned ranks, a gloo (data=1, model=2) group on the one card (NCCL
     refuses two ranks on one card), k_local=2048 each, fit (b)'s rows:
     every rank on the card with the cuda plan holding the same bits; a
     second fit, each collective timed (the stream drained before and
     after it), bit-identical; the fit on the ref plan within 1e-3 of its
     val MSE; labels differ from (b)'s only at near-ties (float64 gap
     within 1e-3 relative under the 2-rank C), the val MSE within 1e-4 of
     (b)'s; kernels 1 and 2 launched on every rank. (d) The same 2 ranks
     on phase 4's rows (k=50): the tb-elkan and tb-exponion fits, at
     most 200 rounds, shadowed (each round's step also with
     bounds="none" from the same state; labels may differ from it only
     at near-ties; the pairs are logged); a 7-chunk store fit bit-equal
     to the in-memory XL fit; the
     fit checkpointed every 25 rounds, killed at round 137 and resumed on
     the ranks, bit-equal to the unbroken fit; the checkpoint resumed on
     the local engine (its val MSE logged against the XL fit's); then 4
     ranks, a (1, 4) group, fit k=8 with exponion bounds, whose rings are
     degenerate (k_local=2), shadowed the same way. Each process logs its
     peak device memory; kernels 1-3 must be launched in the phase.
  13. the serve entry point (`repro_torch.launch.serve`) at
     tinyllama-1.1b's full width (22 layers, d_model 2048, 32 heads over
     4 kv heads, d_ff 5632, vocab 32000; 1.1 B bf16 parameters made from
     seed 0 on the card): (a) batch 4, prompt 32, 16 generated tokens
     (the CLI's defaults and prompt recipe) through `generate`, twice
     (the same tokens); the decode step's logits at position 32 against
     the prefill of the 33-token prompt (tests/test_models.py's
     property): with the weights upcast to f32 (f32 activations and
     cache) within rtol=atol=1e-3; in bf16, the served model, whose
     rounding alone passes 6e-2 on a few logits at 22 layers, the greedy
     tokens must be equal at every row whose top two prefill logits are
     more than 0.12 apart, and at least half the rows must be such;
     prefill ms, ms a decode step, tokens/s and peak memory are logged.
     (b) `build_codebook` with k=1024 over the 32000 x 2048 embedding
     table (local): kernels 1-3 each launched, a second fit bit-equal,
     the table's float64 MSE within 1e-3 of the same fit on the ref
     plan; kernels 1-3 held at the fit's shapes (the b0 = 2048 rows of
     its first batch and all 32000 rows, d = 2048, k = 1024) on the
     table and the fitted codebook, as phase 12 holds them, and timed
     beside their plain versions and bounds; its `ClusterService`
     (dedup by token id) fed a decode's tokens through `generate`: rows
     folded in = unique ids delivered = the rise of sum(counts), the
     snapshot verifies, the tokens equal (a)'s, and the cells of the
     served tokens equal the plain assignment but at near-ties. (c) one
     NCCL rank with backend "mesh" and "xl": the adopted codebook
     bit-equal to (b)'s; 2 spawned gloo ranks on the card (E through an
     ``.npy``), "mesh" (rows split) and "xl" (k_local 512): both ranks
     hold one adopted codebook within 1e-4 relative (Frobenius) of (b)'s,
     its service folds 512 ids delivered twice in once, and a
     `ClusterService` over the 2-rank sharded estimator raises its
     ValueError. (d) ``python -m repro_torch.launch.serve --arch
     tinyllama-1.1b --no-reduced --codebook 1024`` as a subprocess: rc 0,
     its lines parsed, its codebook's rounds (b)'s and row 0's tokens
     (a)'s. Kernels 1-3 must be launched in the phase.
  14. LM training (`repro_torch.launch.train`'s step) at tinyllama-1.1b's
     full width from seed 0, the CLI's defaults (batch 8, seq 128, 2
     microbatches, lr 3e-4 warmed up over 10 steps; `LMBatches` from seed
     0): (a) 10 steps, the loss must fall from step 0 to step 9; ms a
     step, tokens/s and peak memory are logged, and a 12th step is
     profiled. (b) The first step's loss and gradients at full width but
     2 layers, bf16 against the same weights upcast to f32: the loss
     within 6e-2, each leaf's gradient within 5e-2 relative (Frobenius).
     (c) The same 6 steps twice: every param, moment and the count
     bit-equal; a run checkpointed in the background after step 3 under
     ``tempfile.mkdtemp()`` (removed after), killed, restored into a
     state made from another seed and resumed: bit-equal at step 6. (d)
     `build_codebook` with k=1024 over (a)'s trained 32000 x 2048 table:
     kernels 1-3 launched, a second fit bit-equal, its float64 MSE within
     1e-3 of the ref plan's; kernels 1-3 held at the fit's shapes as in
     phase 13. (e) ``python -m repro_torch.launch.train --arch
     tinyllama-1.1b --reduced --steps 4 --ckpt-every 2 --ckpt-dir DIR``
     as a subprocess: rc 0, step 0's and step 3's losses those of the
     same steps in this process; its final checkpoint taken away, the
     same command resumes from step 2 and prints the unbroken run's step
     3 line (reduced, so the script keeps its time limit). Kernels 1-3
     must be launched in the phase.
  15. the moe, ssm and hybrid families at full width from seed 0, phase
     13's prompt and phase 14's training defaults: (a) granite-moe-1b-a400m
     (24 layers, d_model 1024, 32 experts top-8 of d_ff 512, vocab 49155;
     1.385 B bf16 parameters) through `generate` twice (the same tokens);
     decode against the prefill one token longer at capacity factor 8
     (drops depend on the token count): in f32 within 1e-3, in bf16
     phase 13's greedy-token rule; the shares of (token, choice) pairs
     dropped at the config's 1.25 in prefill and one decode step,
     recounted from each layer's router; prefill ms, ms a decode step,
     tokens/s and peak memory. (b) 10 train steps: the loss falls from
     step 0 to step 9, the aux loss (the first microbatch, before each
     step) finite and logged; ms a step, tokens/s, peak memory; one more
     step profiled (device busy share, the top ops); 3 steps twice:
     params, moments and count bit-equal. (c) `build_codebook` with
     k=1024 over (b)'s trained 49155 x 1024 table as phase 14 (d):
     kernels 1-3 launched, a second fit bit-equal, the ref plan's MSE
     within 1e-3, kernels 1-3 held and timed at the fit's shapes. (d)
     mamba2-2.7b (64 layers, d_model 2560, 80 SSD heads, d_state 128;
     2.83 B) served as (a) (no MoE), then 6 train steps: every grad norm
     finite, the loss falling. (e) jamba-v0.1-52b at full width cut to
     one period of 8 layers (13.27 B): served twice in bf16 (the same
     tokens); decode against prefill at capacity factor 8 as (a), the
     f32 arm after the bf16 model's leaves are upcast one by one in
     place; peak memory. (f) ``python -m repro_torch.launch.serve --arch
     granite-moe-1b-a400m --no-reduced --codebook 1024`` as a subprocess:
     rc 0, row 0's tokens (a)'s. Kernels 1-3 must be launched in the
     phase.
  16. the paper's RCV1 fit: `KMEANS_RCV1`'s algorithm (tb, hamerly2,
     k=50, b0=5000) on `benchmarks/common.py::dataset("rcv1")`'s rows,
     60,000 ``rcv1_like`` rows at d=2048 (seed 0; the config's 781,265
     cut for the host's generation time) with 6,000 validation rows,
     held as phase 4 holds infMNIST: kernels 1-3 launched (fit +
     predict), a second fit bit-identical, the final validation MSE
     within 1e-3 of the ``kernel_backend="ref"`` fit's, which repeats its
     bits; rounds, the sum of ``n_recomputed``, wall and peak memory
     logged; kernels 1-3 held and timed on the rows and the fitted
     centroids at d=2048, k=50 as phase 12 holds them
     (`check_wide_kernels`), beside their plain versions, ``index_add_``
     and their bounds.
  17. the encdec and vlm families from seed 0, on normal frames or
     patches from a numpy seed, phase 13's prompt and phase 14's
     training defaults: (a) whisper-tiny at full width (4 + 4 layers,
     d_model 384, 6 heads, vocab 51865, 1536 frames; its parameter count
     is the config's plus the decoder's cross attention and its norm,
     4 d^2 + d a layer, and the final norm) served twice (the same
     tokens), decode against the prefill one token longer in f32 within
     1e-3 and in bf16 by phase 13's rule, then served on the serve CLI's
     zero frames. (e) `build_codebook` with k=1024 over its 51865 x 384
     table as phase 13 (b) (kernels 1-3 launched, bit-equal twice, the
     ref plan's MSE within 1e-3, kernels 1-3 held and timed at the fit's
     shapes), then ``python -m repro_torch.launch.serve --arch
     whisper-tiny --no-reduced --codebook 1024``: rc 0, its codebook's
     rounds the in-process fit's and row 0's tokens (a)'s on the zero
     frames. (b) 10 train steps (batch 8, seq 128, 2 microbatches): the
     loss falls, every grad norm finite; ms a step, tokens/s, peak
     memory; 3 steps twice bit-equal. (c) internvl2-76b at full width cut
     to 8 of its 80 layers (8.95 B parameters; 80 are 131.4 GiB in bf16),
     256 patches before the prompt, served twice in bf16 with the cache
     sized patches + prompt + generated; decode against prefill in bf16,
     then in f32 after the leaves are upcast one by one in place; peak
     memory. (d) internvl2-76b at 1 layer (2.96 B) trained over 256
     patches + 128 tokens (the loss after the patch prefix is stripped):
     3 steps twice bit-equal (the first run's state in host memory),
     every loss finite; the states reckoned before the run. Kernels 1-3
     must be launched in the phase.
  18. sharded training (`make_train_step(cfg, mesh=...)`, the params and
     moments laid out by `sharding.param_specs`, each batch by
     `batch_specs`; batch 8, seq 128, 2 microbatches, seed 0): (a)
     granite-moe-1b-a400m at full width on a one-rank NCCL (1, 1) mesh,
     2 steps: every param, moment, the count and the losses bit-equal to
     the local step's; (b) the same on 2 spawned gloo ranks sharing the
     card, ("data", "model") = (1, 2), expert-parallel + TP: losses within
     6e-2 of (a)'s, two runs bit-equal; (c) whisper-tiny at full width on
     4 gloo ranks, (1, 4): context-parallel decoder attention, the
     encoder's attention whole on each rank, TP MLPs; its f32 arm within
     1e-5 of its one-rank step, bf16 within 6e-2; (d) tinyllama-1.1b cut
     to 2 layers on (2, 2), f32, 2 steps: FSDP + TP + data parallelism,
     within 1e-5 of its one-rank step, two runs bit-equal. Each rank logs
     ms a step, tokens/s, peak memory and the collectives' share of a
     second, timed run (each collective drained before and after). No
     kernel of this repository is on this path.
  19. sharded serving and the dry run: (a) tinyllama-1.1b and
     granite-moe-1b-a400m at full width on a one-rank NCCL (1, 1) mesh,
     phase 13's prompt (4 x 32) and 4 greedy steps through
     ``make_prefill_step``/``make_decode_step`` with ``mesh=`` (granite:
     the expert-parallel dispatch at prefill, the global one at decode):
     tokens and logits bit-equal to the unsharded steps'; (b)
     tinyllama-1.1b cut to 2 layers, f32, on 2 spawned gloo ranks sharing
     the card, (1, 2): tokens the one-rank run's, logits within 1e-5
     relative (Frobenius); (c) ``python -m repro_torch.launch.dryrun`` in
     subprocesses on the host, started with the script (no card needed):
     tinyllama-1.1b ``prefill_32k`` and ``decode_32k`` at pod16x16,
     mamba2-2.7b ``long_500k`` at pod2x16x16 and ``--kmeans``, every
     record ``ok``, each one's line logged; (d) `op_cost`'s FLOPs over
     (a)'s tinyllama prefill and one decode step traced on fake tensors
     equal ``FlopCounterMode``'s over the CUDA run, each step's measured
     time at least its counted bound, and kmeans_xl's
     ``kernel_analytic`` bound (213.303 ms) beside phase 6's kernel-4
     time. No kernel of this repository is on this path.

The last two lines are a JSON object of the kernels (each with its
main path's ``launches`` and phases 13-17's ``launches_phase13`` ...
``launches_phase17``) and the JSON
result ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# fails without the rest of the repository beside this script
from repro_torch.roofline.analysis import (  # noqa: E402
    PEAK_TF32_FLOPS, roofline_terms)
from repro_torch.util.tree import tree_leaves, tree_map  # noqa: E402

N, D, K = 400_000, 784, 50           # KMEANS_INFMNIST
N_VAL = 10_000
TOL = {"f32": 1e-5, "bf16": 2e-2}
DEV = "cuda"
N_XL, D_XL, K_XL = 2 ** 22, 1024, 4096  # KMEANS_XL, one chip's rows
XL_PLAIN_ROWS = 2 ** 18               # rows the plain round is run on
XL_CHECK_ROWS = 65_536                # last rows whose top-2 is checked
REPLACES = {
    "assign_top2": "src/repro/kernels/kmeans_assign.py:73",
    "cluster_sum": "src/repro/kernels/cluster_sum.py:56",
    "fused_nested_round": "src/repro/kernels/fused_round.py:225",
    "fused_round": "src/repro/kernels/fused_round.py:78",
}
SOURCE = "src/repro_torch/kernels/csrc/{}.cu"
#: the libraries whose f32 top-2 is tc_top2.cuh's (TMA + wgmma)
TC_LIBS = ("assign_top2", "fused_nested_round", "fused_round")
#: the tensor-core top-2s of assign_top2 and the nested round against
#: `assign_top2_exact`: |err| <= FULL_RTOL * full_scale + FULL_ATOL (as
#: tests/torch_round_oracle.py states them)
FULL_RTOL, FULL_ATOL = 5e-7, 1e-5


def log(*a) -> None:
    print(*a, flush=True)


class Failure(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


# ---------------------------------------------------------------- phase 1

def device_phase() -> dict:
    need(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1] device: {name} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    need(not torch.backends.cuda.matmul.allow_tf32,
         "TF32 matmuls are on; the plain versions are f32")
    return {"name": name, "count": count, "smi": smi}


# ---------------------------------------------------------------- phase 2

def sass_counts(lib) -> dict:
    """Tensor-core (HGMMA, HMMA) and TMA-load (UTMALDG) instructions in a
    built library's SASS, as ``cuobjdump -sass`` lists them."""
    from pathlib import Path

    from repro_torch.kernels import _build
    exe = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA", "UTMALDG")}


def build_phase() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    report = _build.build(force=True)
    log(f"[2] built {len(report)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for name, (secs, ptxas) in report.items():
        counts = sass_counts(_build.lib_path(name))
        log(f"    {name}.cu: nvcc {secs:.1f} s; SASS " + ", ".join(
            f"{op} {n}" for op, n in counts.items()))
        for line in ptxas.splitlines():
            if "Compiling entry" in line or "Used" in line \
                    or "spill" in line or "wgmma" in line:
                log("      " + line.split("ptxas info    : ")[-1])
        if name in TC_LIBS:
            need(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                 f"{name}'s library has no HGMMA or no UTMALDG: its "
                 f"top-2 is not on the tensor cores fed by TMA")


# ---------------------------------------------------------------- phase 3

def _x_c(n, d, k, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy((rng.normal(size=(k, d)) * 2).astype(np.float32))
    return x.to(DEV, dtype), c.to(DEV, dtype)


def _labels_ok(a_got, a_want, d2m, tol, relative=False) -> int:
    """Labels equal but for ties within 100x tol (times the distance if
    ``relative``); returns the count of tied rows that differ."""
    diff = torch.nonzero(a_got != a_want)[:, 0]
    if diff.numel():
        want = d2m[diff, a_want[diff].long()]
        gap = (d2m[diff, a_got[diff].long()] - want).abs()
        scale = want.abs().clamp_min(1.0) if relative else 1.0
        need(bool((gap < tol * 100 * scale).all()),
             f"labels differ beyond a tie at {diff.numel()} rows")
    return int(diff.numel())


def _close(got, want, rtol, atol, what) -> float:
    # equal values (+inf included) have no error
    err = torch.where(got == want, 0.0, (got - want).abs())
    top = float(err.max()) if err.numel() else 0.0
    need(bool((err <= atol + rtol * want.abs()).all()),
         f"{what}: max abs err {top}")
    return top


def same_bits(got, want) -> bool:
    """Every tensor of ``got`` has the shape and bits of ``want``'s."""
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def _mass_close(got, want, mass, what, rtol=1e-5) -> float:
    """|got - want| <= rtol * mass + 1e-4 (mass: sum of |terms|)."""
    err = (got - want).abs()
    top = float(err.max()) if err.numel() else 0.0
    need(bool((err <= rtol * mass + 1e-4).all()),
         f"{what}: max abs err {top}")
    return top


def check_assign(n, d, k, dtype) -> float:
    from repro_torch.kernels import kmeans_assign, ref
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x, c = _x_c(n, d, k, n + k, tdt)
    got = kmeans_assign.assign_top2_cuda(x, c)
    torch.cuda.synchronize()
    want = ref.assign_top2_ref(x, c)
    tol = TOL[dtype]
    need(got[0].dtype == torch.int32, "labels are not int32")
    e1 = _close(got[1], want[1], tol, tol * 10, "d1")
    if k == 1:
        need(bool(torch.isinf(got[2]).all()), "k=1: d2 is not +inf")
        e2 = 0.0
    else:
        e2 = _close(got[2], want[2], tol, tol * 10, "d2")
    ties = _labels_ok(got[0], want[0], ref.pairwise_dist2(x, c), tol)
    oracle = ""
    if dtype == "f32":
        gap, plain_gap = check_full_oracle(*got, x, c, "assign_top2",
                                           plain=want[1])
        oracle = (f"; {gap:.3g} of the scale from the float64 oracle (held "
                  f"to {FULL_RTOL:g}; the plain version's f32 product "
                  f"{plain_gap:.3g})")
    again = kmeans_assign.assign_top2_cuda(x, c)
    need(same_bits(again, got), "assign_top2 is not deterministic")
    log(f"    assign_top2 {dtype} n={n} d={d} k={k}: max abs err d1 {e1:.3g}"
        f" d2 {e2:.3g}, tied labels {ties}{oracle}, second run "
        f"bit-identical")
    return max(e1, e2)


def _weights(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], n).astype(
        np.float32)).to(DEV)


def check_cluster_sum(n, d, k) -> float:
    from repro_torch.kernels import cluster_sum, ref
    x, _ = _x_c(n, d, 1, n + d, torch.float32)
    rng = np.random.default_rng(n + k)
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(DEV)
    w = _weights(n, n)
    S, v = cluster_sum.cluster_sum_cuda(x, a, k, weights=w)
    torch.cuda.synchronize()
    S_r, v_r = ref.cluster_sum_ref(x, a, k, weights=w)
    mass, vmass = ref.cluster_sum_ref(x.abs(), a, k, weights=w.abs())
    e = max(_mass_close(S, S_r, mass, "S"),
            _mass_close(v, v_r, vmass, "v"))
    S2, v2 = cluster_sum.cluster_sum_cuda(x, a, k, weights=w)
    need(torch.equal(S, S2) and torch.equal(v, v2),
         "cluster_sum is not deterministic")
    need(same_bits((S, v), ref.ordered_sums(x, k, a, w)),
         "cluster_sum differs from the order oracle")
    log(f"    cluster_sum n={n} d={d} k={k} (+1/0/-1 weights): max abs err "
        f"{e:.3g}, second run and the order oracle bit-identical")
    return e


def _nested_inputs(n, d, k):
    """A mixed mask: ~20% unseen, ~30% of the seen settled, ~10% invalid."""
    x, c = _x_c(n, d, k, 7 * n + k, torch.float32)
    rng = np.random.default_rng(n * 3 + k)
    a_prev = rng.integers(0, k, n).astype(np.int32)
    a_prev[rng.random(n) < 0.2] = -1
    settled = (rng.random(n) < 0.3) & (a_prev >= 0)
    d_keep = rng.random(n).astype(np.float32)
    lb_keep = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    host = (a_prev, settled, d_keep, lb_keep, valid)
    return [x, c] + [torch.from_numpy(h).to(DEV) for h in host]


def check_fused(n, d, k) -> float:
    from repro_torch.kernels import fused_round, ref
    args = _nested_inputs(n, d, k)
    got = fused_round.fused_nested_round_cuda(*args)
    torch.cuda.synchronize()
    want = fused_round.fused_nested_round_ref(*args)
    x, c, a_prev = args[:3]
    ties = _labels_ok(got[0], want[0], ref.pairwise_dist2(x, c),
                      TOL["f32"])
    e = max(_close(got[1], want[1], 1e-5, 1e-4, "d_new"),
            _close(got[2], want[2], 1e-5, 1e-4, "lb_new"))
    # the sums against the plain sums over the kernel's own labels (one
    # may differ from the plain label at a tie, moving a whole row)
    sums = fused_round.delta_sums(x, a_prev, got[0], got[1], k)
    new, old = got[0].clamp(0, k - 1), a_prev.clamp(0, k - 1)
    mass = (ref.cluster_sum_ref(x.abs(), new, k)[0]
            + ref.cluster_sum_ref(x.abs(), old, k)[0],
            ref.cluster_sum_ref(x[:, :0], new, k)[1]
            + ref.cluster_sum_ref(x[:, :0], old, k)[1],
            sums[2])
    for g, w, m, what in zip(got[3:], sums, mass, ("dS", "dv", "sse")):
        e = max(e, _mass_close(g, w, m, what, rtol=1e-4))
    # which of the two f32 sums is nearer the float64 one
    exact = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(
        0, new.long(), got[1].double() ** 2)
    log(f"    fused sse vs float64: kernel max abs err "
        f"{float((got[5].double() - exact).abs().max()):.4g}, plain "
        f"{float((sums[2].double() - exact).abs().max()):.4g}")
    # the recomputed rows' top-2 against the float64 oracle; the rest
    # pass through bit for bit
    a_prev, settled, d_keep, lb_keep, valid = args[2:]
    keep = valid & settled
    need(bool((got[0][~valid] == -1).all()) and not bool(got[1][~valid].any())
         and torch.equal(got[0][keep], a_prev[keep])
         and torch.equal(got[1][keep], d_keep[keep])
         and torch.equal(got[2][keep], lb_keep[keep]),
         "fused_nested_round: invalid or settled rows not as given")
    new_rows = valid & ~settled
    gap, _ = check_full_oracle(got[0][new_rows], got[1][new_rows],
                               got[2][new_rows], x[new_rows], c,
                               "fused_nested_round", squared=False)
    log(f"    fused_nested_round's top-2 on its {int(new_rows.sum())} "
        f"recomputed rows: {gap:.3g} of the scale from the float64 oracle "
        f"(held to {FULL_RTOL:g})")
    again = fused_round.fused_nested_round_cuda(*args)
    need(all(torch.equal(g, a) for g, a in zip(got, again)),
         "fused_nested_round is not deterministic")
    need(same_bits(got[3:], ref.ordered_sums(x, k, a_prev=a_prev,
                                             a_new=got[0], d_new=got[1])),
         "fused_nested_round's sums differ from the order oracle")
    log(f"    fused_nested_round n={n} d={d} k={k}: max abs err {e:.3g}, "
        f"tied labels {ties}, second run and the order oracle (sums) "
        f"bit-identical")
    return e


def check_ref_sums(n, d, k) -> None:
    """The plain sums on the card (`ref.cluster_sum_ref`, which takes
    `ref.onehot_sums` there): the same bits twice, and within
    cluster_sum's tolerance of ``index_add_``."""
    from repro_torch.kernels import ref
    x, _ = _x_c(n, d, 1, 3 * n + d, torch.float32)
    rng = np.random.default_rng(n + 2 * k)
    a = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(DEV)
    w = _weights(n, n + 1)
    got = ref.cluster_sum_ref(x, a, k, weights=w)
    again = ref.cluster_sum_ref(x, a, k, weights=w)
    need(same_bits(again, got), "the plain sums on the card are not "
         "deterministic")
    idx = a.long()
    xw = x * w[:, None]
    want = torch.zeros(k, d, device=DEV).index_add_(0, idx, xw)
    mass = torch.zeros(k, d, device=DEV).index_add_(0, idx, xw.abs())
    e = _mass_close(got[0], want, mass, "plain S against index_add_")
    e = max(e, _mass_close(got[1], torch.zeros(k, device=DEV).index_add_(
        0, idx, w), torch.zeros(k, device=DEV).index_add_(0, idx, w.abs()),
        "plain v against index_add_"))
    log(f"    plain sums n={n} d={d} k={k}: second run bit-identical, "
        f"{e:.3g} from index_add_")


def _chunked_sums(x, a, d1, k, rows=XL_PLAIN_ROWS):
    """Plain S, v, sse and the L1 mass of S over all rows of x by label
    a, summed over row chunks (the plain version cannot take all rows of
    the full-width round at once)."""
    from repro_torch.kernels import ref
    S = torch.zeros(k, x.shape[1], device=DEV)
    mass = torch.zeros_like(S)
    v = torch.zeros(k, device=DEV)
    sse = torch.zeros(k, device=DEV)
    for lo in range(0, x.shape[0], rows):
        xs, al = x[lo:lo + rows], a[lo:lo + rows]
        s, vv = ref.cluster_sum_ref(xs, al, k)
        S += s
        v += vv
        mass += ref.cluster_sum_ref(xs.abs(), al, k)[0]
        sse += ref.cluster_sum_ref(xs[:, :0], al, k,
                                   weights=d1[lo:lo + rows])[1]
    return S, v, sse, mass


def round_top2_exact(x, c):
    """The top-2 of kernel 4's plain version with x.c, |x|^2 and |c|^2
    each taken in float64 and rounded once to f32, the values nearest the
    exact ones (as tests/torch_round_oracle.py computes it)."""
    x64, c64 = x.double(), c.double()
    xn = (x64 * x64).sum(1).float()
    cn = (c64 * c64).sum(1).float()
    pd = (x64 @ c64.T).float().mul_(-2.0).add_(cn)
    del x64
    a = torch.argmin(pd, dim=1)
    b1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if c.shape[0] == 1:
        b2 = torch.full_like(b1, float("inf"))
    else:
        b2 = pd.scatter_(1, a[:, None], float("inf")).min(dim=1).values
    return (a.to(torch.int32), torch.clamp_min(b1 + xn, 0.0),
            torch.clamp_min(b2 + xn, 0.0))


def top2_of(pd):
    """(a int32, d1, d2) of an (n, k) distance matrix: the lower index
    wins a tie, a duplicate of the min counts as the 2nd, k == 1 gives
    +inf."""
    a = torch.argmin(pd, dim=1)
    d1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if pd.shape[1] == 1:
        d2 = torch.full_like(d1, float("inf"))
    else:
        d2 = pd.scatter_(1, a[:, None], float("inf")).min(dim=1).values
    return a.to(torch.int32), d1, d2


def assign_top2_exact(x, c):
    """The top-2 of the ref expression max(|x|^2 - 2 x.c + |c|^2, 0) with
    x.c, |x|^2 and |c|^2 each taken in float64 and rounded once to f32,
    the rest in f32 (as tests/torch_round_oracle.py computes it): what
    kernels 1 and 3 are held to at FULL_RTOL."""
    x64, c64 = x.double(), c.double()
    xn = (x64 * x64).sum(1).float()
    cn = (c64 * c64).sum(1).float()
    dot = (x64 @ c64.T).float()
    del x64
    return top2_of(torch.clamp_min(dot.mul_(-2.0).add_(xn[:, None])
                                   .add_(cn), 0.0))


def full_scale(x, c):
    """|x|^2 + max_j |c_j|^2 per row, f32: the scale of FULL_RTOL."""
    c64 = c.double()
    return ((x.double() ** 2).sum(1) + (c64 * c64).sum(1).max()).float()


def check_full_oracle(a, d1, d2, x, c, what, squared=True, plain=None):
    """Kernel 1's or 3's top-2 (a, d1, d2; euclidean unless ``squared``)
    against `assign_top2_exact`: labels equal but for near-ties, d1 and
    d2 within FULL_RTOL of the scale plus FULL_ATOL (plus the sqrt's own
    rounding where they are euclidean). Returns the largest error over
    the scale, and the plain version's d1 (``plain``, squared) gap over
    the scale (None without it)."""
    from repro_torch.kernels import ref
    want = assign_top2_exact(x, c)
    sc = full_scale(x, c).double()
    plain_gap = None
    if plain is not None:
        plain_gap = float(((plain.double() - want[1].double()).abs()
                           / sc).max())
    _labels_ok(a, want[0], ref.pairwise_dist2(x, c),
               FULL_RTOL * float(sc.max()) / 100 + FULL_ATOL)
    top = 0.0
    for g, w in zip((d1, d2), want[1:]):
        g, w = g.double(), w.double()
        if not squared:
            g = g * g
        fin = torch.isfinite(w)
        need(torch.equal(torch.isfinite(g), fin), f"{what}: +inf differs")
        err = torch.where(g == w, 0.0, (g - w).abs())[fin]
        slack = FULL_RTOL * sc[fin] + FULL_ATOL \
            + (0.0 if squared else 2.4e-7 * w[fin])
        if not err.numel():
            continue
        need(bool((err <= slack).all()), f"{what}: beyond the float64 "
             f"oracle's tolerance by {float((err - slack).max()):.3g}")
        top = max(top, float((err / sc[fin]).max()))
    return top, plain_gap


def _max_gap(got, want) -> float:
    err = torch.where(got == want, 0.0, (got - want).abs())
    return float(err.max()) if err.numel() else 0.0


def check_fused_round(x, c, plain_rows=None) -> float:
    """Kernel 4's top-2 on the last ``plain_rows`` rows (all rows if None)
    against `round_top2_exact`, its sums over all rows against plain
    sums; the d1 gaps to the plain version (an f32 product) are logged."""
    from repro_torch.kernels import fused_round, ref
    n, k = x.shape[0], c.shape[0]
    got = fused_round.fused_round_cuda(x, c)
    torch.cuda.synchronize()
    lo = 0 if plain_rows is None else n - plain_rows
    plain_d1 = fused_round.fused_round_ref(x[lo:], c)[1]
    want = round_top2_exact(x[lo:], c)
    a, d1, d2 = (t[lo:] for t in got[:3])
    need(a.dtype == torch.int32, "labels are not int32")
    # the kernel's distances are the partial distance plus |x|^2, which
    # is what the tie gap is measured in
    pd = torch.mm(x[lo:], c.T).mul_(-2.0).add_((c * c).sum(1)).add_(
        (x[lo:] * x[lo:]).sum(1)[:, None])
    ties = _labels_ok(a, want[0], pd, TOL["f32"], relative=True)
    del pd
    e = e1 = _close(d1, want[1], TOL["f32"], 1e-4, "d1")
    e2 = 0.0
    if k == 1:
        need(bool(torch.isinf(d2).all()), "k=1: d2 is not +inf")
    else:
        e2 = _close(d2, want[2], TOL["f32"], 1e-4, "d2")
        e = max(e, e2)
    # the sums against plain sums over the kernel's own labels (one may
    # differ from the plain label at a tie, moving a whole row)
    S, v, sse, mass = _chunked_sums(x, got[0], got[1], k)
    for g, w, m, what in zip(got[3:], (S, v, sse), (mass, v, sse),
                             ("S", "v", "sse")):
        e = max(e, _mass_close(g, w, m, what, rtol=1e-4))
    again = fused_round.fused_round_cuda(x, c)
    need(all(torch.equal(g, a2) for g, a2 in zip(got, again)),
         "fused_round is not deterministic")
    del again
    need(same_bits(got[3:], ref.ordered_sums(x, k, got[0], d1sq=got[1])),
         "fused_round's sums differ from the order oracle")
    rows = "all" if plain_rows is None else f"the last {plain_rows}"
    log(f"    fused_round n={n} d={x.shape[1]} k={k} (top-2 on {rows} rows)"
        f": max abs err {e:.3g} (d1 {e1:.3g}, d2 {e2:.3g} from the "
        f"once-rounded float64 values), tied labels {ties}, second run "
        f"and the order oracle (S, v, sse) bit-identical; d1 "
        f"{_max_gap(d1, plain_d1):.3g} from the plain "
        f"version's f32 product, which is {_max_gap(plain_d1, want[1]):.3g}"
        f" from the once-rounded values")
    return e


def compare_phase() -> dict:
    log("[3] kernels against their plain versions on the card")
    err = {
        "assign_top2": check_assign(N, D, K, "f32"),
        "cluster_sum": check_cluster_sum(N, D, K),
        "fused_nested_round": check_fused(N, D, K),
    }
    check_assign(N, D, K, "bf16")
    for n, d, k in ((4099, D, 1), (4099, D, 257), (1000, 200, 257),
                    (777, 33, 50)):
        check_assign(n, d, k, "f32")
        check_cluster_sum(n, d, k)
        check_fused(n, d, k)
    check_cluster_sum(5000, 0, K)        # counts only
    check_ref_sums(N, D, K)
    check_ref_sums(2 ** 16, D_XL, K_XL)
    for n, d, k in ((4099, D, 1), (4099, D, 257), (777, 33, 50),
                    (N, D, K)):
        check_fused_round(*_x_c(n, d, k, 5 * n + k, torch.float32))
    return err


# ---------------------------------------------------------------- phase 4

def _averages(prof):
    """``prof.key_averages()``, computed once a trace: each call groups
    every event again, seconds for a fit's trace."""
    if not hasattr(prof, "_averages"):
        prof._averages = prof.key_averages()
    return prof._averages


def profile_report(prof, wall_s: float, wall_profiled_s: float,
                   what: str = "fit") -> None:
    """The profiled run's device work (kernels and copies, each counted
    once: an operator's own entry would count its kernels again), its
    share of the run's wall time, and the host calls that took longest.
    ``wall_s`` is the wall time of the same run unprofiled."""
    events = _averages(prof)
    # a schedule's step span is a range on the device, not device work
    dev = sorted((e for e in events if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("ProfilerStep")),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    log(f"    profile: device busy {busy_ms:.1f} ms in "
        f"{sum(e.count for e in dev)} kernels and copies = "
        f"{busy_ms / 10 / wall_profiled_s:.1f} % of the profiled {what}'s "
        f"wall {wall_profiled_s:.2f} s ({busy_ms / 10 / wall_s:.1f} % of "
        f"the unprofiled {what}'s {wall_s:.2f} s)")
    for e in dev[:12]:
        log(f"      device {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    for e in host[:8]:
        log(f"      host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"{e.count:7d}x  {e.key[:90]}")


#: phase 4's config: the paper's infMNIST experiment
MAIN_CONFIG = dict(b0=5000, algorithm="tb", rho=math.inf, bounds="hamerly2",
                   seed=0)


def fit_once(X, Xv, **kw):
    """Phase 4's fit, with ``kw`` over its config."""
    from repro_torch.api import FitConfig, NestedKMeans
    cfg = FitConfig(k=K, **dict(MAIN_CONFIG, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = NestedKMeans(cfg, device=DEV).fit(X, X_val=Xv)
    torch.cuda.synchronize()
    return km, time.perf_counter() - t0


#: host calls that wait for the device, as torch.profiler names them
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
#: the fit's tensor-core top-2s by the name the profiler gives them:
#: assign_top2 (EPI_FULL) and the nested round (EPI_NESTED) at BN = 64
FIT_TOP2 = {"nkm::tc::tc_top2_kernel<64, 2>": "assign_top2's top-2",
            "nkm::tc::tc_top2_kernel<64, 3>": "the nested round's top-2",
            "nkm::tc::split_c_kernel": "c split and |c|^2"}


def sync_counts(prof) -> dict:
    """{host call: count} of the calls that wait for the device."""
    out = dict.fromkeys(SYNC_CALLS, 0)
    for e in _averages(prof):
        if e.key in out:
            out[e.key] += e.count
    return out


def _schedule(km) -> str:
    return " ".join(f"{r.b}:{r.n_recomputed}" for r in km.telemetry_
                    if r.batch_mse is not None)


def main_path_phase() -> dict:
    from repro_torch.data.synthetic import infmnist_like
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    X = infmnist_like(N, seed=0)
    Xv = infmnist_like(N_VAL, seed=1)
    log(f"[4] data: infmnist_like {X.shape} + {Xv.shape} in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    km, wall = fit_once(X, Xv)
    labels = km.predict(X)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tel = [r for r in km.telemetry_ if r.batch_mse is not None]
    log(f"    cuda fit: {km.n_rounds_} records, {len(tel)} rounds, final b "
        f"{km.telemetry_[-1].b}, sum n_recomputed "
        f"{sum(r.n_recomputed for r in tel)}, converged {km.converged_}, "
        f"final val MSE {km.final_mse_!r}, wall {wall:.2f} s, peak device "
        f"memory {peak / 2 ** 30:.2f} GiB")
    log(f"    launches on the main path (fit + predict): {launches}")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched on the main "
             f"path")

    C = km.cluster_centers_
    need(C.shape == (K, D) and bool(np.isfinite(C).all()),
         "centroids are not finite (k, d)")
    need(labels.shape == (N,) and labels.dtype == np.int32
         and labels.min() >= 0 and labels.max() < K, "predict labels")
    need(km.labels_.shape == (N,) and (km.labels_ >= 0).all(),
         "fit labels")
    agree = float((labels == km.labels_).mean())
    log(f"    predict(X) agrees with the fit's labels on {agree:.6f} of rows")
    need(km.converged_ is False or agree == 1.0,
         "a converged fit's labels differ from predict")
    # predict against the plain assignment on a small input
    xs = torch.from_numpy(X[:2000]).to(DEV)
    a_ref = ref.assign_top2_ref(xs, torch.from_numpy(C).to(DEV))[0]
    need(bool((a_ref.cpu().numpy() == labels[:2000]).mean() > 0.999),
         "predict disagrees with the plain assignment")

    # the second fit runs under torch.profiler: where the fit's time goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        km2, wall2 = fit_once(X, Xv)
    same = np.array_equal(km2.cluster_centers_, C) \
        and np.array_equal(km2.labels_, km.labels_)
    log(f"    second cuda fit (profiled): wall {wall2:.2f} s, bit-identical "
        f"centroids and labels: {same}")
    need(same, "a second identical fit is not bit-identical")
    profile_report(prof, wall, wall2)
    scatter_report(prof, "fit")
    syncs = sync_counts(prof)
    log(f"    host calls that wait for the device in the profiled fit: "
        f"{sum(syncs.values())} ({syncs}) in {len(tel)} rounds")
    parts = device_parts(prof, FIT_TOP2)
    log("    the tensor-core top-2s in the profiled fit: " + ", ".join(
        f"{what} ({name}) {parts[name][0]:.2f} ms in {parts[name][1]} "
        f"launches" for name, what in FIT_TOP2.items()))
    for name in list(FIT_TOP2)[:2]:
        need(parts[name][1] > 0, f"the profiled fit shows no {name}")

    kmr, wallr = fit_once(X, Xv, kernel_backend="ref")
    kmr2, wallr2 = fit_once(X, Xv, kernel_backend="ref")
    rel = abs(kmr.final_mse_ - km.final_mse_) / abs(kmr.final_mse_)
    same_ref = np.array_equal(kmr2.cluster_centers_, kmr.cluster_centers_) \
        and np.array_equal(kmr2.labels_, kmr.labels_)
    log(f"    ref fit (plain versions on the card): {kmr.n_rounds_} records,"
        f" final val MSE {kmr.final_mse_!r}, wall {wallr:.2f} s, relative "
        f"gap {rel:.3g}; a second ref fit (wall {wallr2:.2f} s): final val "
        f"MSE {kmr2.final_mse_!r}, bit-identical centroids and labels: "
        f"{same_ref}")
    log(f"    schedule cuda (b:n_recomputed): {_schedule(km)}")
    log(f"    schedule ref  (b:n_recomputed): {_schedule(kmr)}")
    split = next((i for i, (u, v) in enumerate(zip(
        [r for r in km.telemetry_ if r.batch_mse is not None],
        [r for r in kmr.telemetry_ if r.batch_mse is not None]))
        if (u.b, u.n_recomputed) != (v.b, v.n_recomputed)), None)
    log(f"    the cuda and ref schedules part at round {split}")
    need(rel <= 1e-3, "cuda and ref fits differ in val MSE beyond 1e-3")
    need(same_ref, "two ref fits on the card differ")
    shadow_fit(X, Xv, km)
    return {"launches": launches, "X": X, "Xv": Xv, "curve": _curve(km),
            "fit": fit_record(km), "outcome": km.outcome_}


def shadow_fit(X, Xv, km) -> None:
    """Where the kernels' fit parts from the plain versions': the cuda
    fit once more, each round's step also taken on the plain versions
    (``kernel_backend="ref"``) from the same input state. The bound
    decisions are the same code on the same state, so a round's
    recomputations agree; its outputs may differ only where the top-2s
    differ, and a label may differ only at a near-tie (float64 distances
    to the two centroids within 1e-3 relative). Those rows, and the last
    bits of d and lb, are what a later round's decisions then see. The
    fit itself must keep the cuda fit's bits."""
    import dataclasses

    from repro_torch.api import FitConfig
    from repro_torch.api.engines.local import LocalEngine
    from repro_torch.api.loop import run_loop
    from repro_torch.core import rounds
    cfg = FitConfig(k=K, b0=5000, algorithm="tb", rho=math.inf,
                    bounds="hamerly2", seed=0).resolve(N)
    run = LocalEngine().begin(X, cfg, X_val=Xv, device=DEV)
    plain = dataclasses.replace(run.kernel_plan, backend="ref")
    step = run.nested_step
    seen = {"rounds": 0, "rows": 0, "worst": 0, "lb_bits": 0, "top": 0.0}

    def both(state, b, capacity):
        out = step(state, b, capacity)
        alt = rounds.nested_round(
            run._Xd, state, b=b, rho=cfg.rho, bounds=cfg.bounds,
            capacity=capacity, use_shalf=cfg.use_shalf, plan=plain)
        need(int(out[1].n_recomputed) == int(alt[1].n_recomputed),
             "the cuda and plain steps recompute different rows from one "
             "state")
        rows, _, gap = _near_ties(run._Xd[:b], state.stats.C,
                                  out[0].points.a[:b], alt[0].points.a[:b])
        seen["top"] = max(seen["top"], gap)
        seen["rounds"] += 1
        seen["rows"] += rows
        seen["worst"] = max(seen["worst"], rows)
        seen["lb_bits"] += int((out[0].points.lb[:b]
                                != alt[0].points.lb[:b]).sum())
        return out

    run.nested_step = both
    out = run_loop(run, cfg)
    # break the cycle run -> both -> run, so that run's copy of X leaves
    # the card when this returns and not at the next garbage collection
    del run.nested_step
    need(np.array_equal(out.C, km.cluster_centers_),
         "the shadowed fit differs from the cuda fit")
    log(f"    shadow fit (each round's step also on the plain versions from "
        f"the same state): {seen['rounds']} steps, the same recomputations "
        f"in each; labels differ at {seen['rows']} rows in all (at most "
        f"{seen['worst']} in a step), every one a near-tie (largest float64 "
        f"gap {seen['top']:.3g} relative); lb differs in its last bits at "
        f"{seen['lb_bits']} rows in all")


# ---------------------------------------------------------------- phase 5

def time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time (ms) for the work, and what bounds it: the larger of
    the bytes over the memory rate and the operations over the peak rate
    of their type (``flops`` f32 on the CUDA cores, ``tf32_flops`` TF32 on
    the tensor cores), at the H100 SXM rates of
    `repro_torch.roofline.analysis`."""
    r = roofline_terms(flops, n_bytes, tf32_flops=tf32_flops)
    return (r.step_time_s() * 1e3,
            "bytes" if r.bottleneck == "memory" else "operations")


def timing_phase(X) -> dict:
    from repro_torch.kernels import cluster_sum, fused_round, kmeans_assign
    from repro_torch.kernels import ref
    log("[5] kernel times at the main-path shape (CUDA events, mean of 10 "
        "after one warm-up)")
    x = torch.from_numpy(X).to(DEV)
    c = x[:K].clone()
    out = {}

    # the tensor-core top-2s' operations: 3xTF32 over the k tiles they
    # run (k = 50 runs one 64-wide tile)
    k_pad = 64 if K <= 64 else -(-K // 128) * 128
    tc_ops = 3 * 2.0 * N * k_pad * D
    mm_ms = time_ms(lambda: torch.mm(x, c.T))
    log(f"    yardstick: cuBLAS f32 torch.mm of x.c^T at ({N}, {D}) x ({K}, "
        f"{D}): {mm_ms:.3f} ms (not the same function; not in the kernels "
        f"line)")
    b, how = bound(N * D * 4 + K * D * 4 + N * 12, 0.0, tf32_flops=tc_ops)
    out["assign_top2"] = dict(
        ms=time_ms(lambda: kmeans_assign.assign_top2_cuda(x, c)),
        plain_ms=time_ms(lambda: ref.assign_top2_ref(x, c)),
        library_ms=None, bound_ms=b, bound_by=how)

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(0, K, N).astype(np.int32)).to(DEV)
    w = _weights(N, 2)
    nz = int((w != 0).sum())
    b, how = bound(nz * D * 4 + N * 8 + (K * D + K) * 4, 2.0 * nz * D)
    a64 = a.long()
    xw = x * w[:, None]
    S0 = torch.zeros(K, D, device=DEV)
    out["cluster_sum"] = dict(
        ms=time_ms(lambda: cluster_sum.cluster_sum_cuda(
            x, a, K, weights=w)),
        plain_ms=time_ms(lambda: ref.cluster_sum_ref(
            x, a, K, weights=w)),
        library_ms=time_ms(lambda: S0.index_add_(0, a64, xw)),
        bound_ms=b, bound_by=how)
    del xw

    args = [x, c] + _nested_inputs(N, 1, K)[2:]
    a_prev = args[2]
    a_new = fused_round.fused_nested_round_cuda(*args)[0]
    # rows that add to dS: joins, new rows and leaves
    moved = int((((a_prev < 0) & (a_new >= 0))
                 | ((a_prev >= 0) & (a_new != a_prev))).sum())
    b, how = bound(N * D * 4 + K * D * 4 + N * (14 + 12)
                   + (K * D + 2 * K) * 4, 2.0 * moved * D, tf32_flops=tc_ops)
    out["fused_nested_round"] = dict(
        ms=time_ms(lambda: fused_round.fused_nested_round_cuda(*args)),
        plain_ms=time_ms(lambda: fused_round.fused_nested_round_ref(
            *args)),
        library_ms=None, bound_ms=b, bound_by=how)
    for name, r in out.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        log(f"    {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
            f" ms, library {lib}, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms'] * 100:.1f} % of "
            f"it")
    return out


# ---------------------------------------------------------------- phase 6

def xl_data(seed: int = 0, n: int = N_XL):
    """``n`` rows of Gaussian blobs on the card, the recipe of
    ``gaussian_blobs`` (centres N(0, 5^2), unit noise): 4096 centres,
    then the labels, then the noise, to which each row's centre is added
    in place, so the peak stays near the bytes of X (16 GiB at N_XL). C0
    is the first k rows (the paper's init)."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    centres = torch.randn(K_XL, D_XL, generator=g, device=DEV) * 5.0
    labels = torch.randint(0, K_XL, (n,), generator=g, device=DEV)
    X = torch.randn(n, D_XL, generator=g, device=DEV)
    for lo in range(0, n, XL_PLAIN_ROWS):
        X[lo:lo + XL_PLAIN_ROWS] += centres[labels[lo:lo + XL_PLAIN_ROWS]]
    return X, X[:K_XL].clone()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _near_ties(X, C, a, b):
    """Rows whose labels a and b differ must be near-ties: their float64
    distances to the two centroids within 1e-3 relative (100x the f32
    rtol). Returns the count of such rows, of those where a's centroid is
    the nearer in float64, and their largest relative gap."""
    diff = torch.nonzero(a != b)[:, 0]
    if not diff.numel():
        return 0, 0, 0.0
    x = X[diff].double()
    da = ((x - C[a[diff].long()].double()) ** 2).sum(1)
    db = ((x - C[b[diff].long()].double()) ** 2).sum(1)
    gap = (da - db).abs() / da
    need(bool((gap <= 1e-3).all()),
         f"two label sets differ beyond a near-tie at {diff.numel()} rows")
    return int(diff.numel()), int((da < db).sum()), float(gap.max())


def exact_labels(X, C, rows=XL_CHECK_ROWS):
    """The float64 argmin of |c|^2 - 2 x.c for every row of X (the lower
    index wins a tie), in row chunks."""
    C64 = C.double()
    cn = (C64 * C64).sum(1)
    a = torch.empty(X.shape[0], dtype=torch.int32, device=DEV)
    for lo in range(0, X.shape[0], rows):
        pd = torch.addmm(cn, X[lo:lo + rows].double(), C64.T, alpha=-2.0)
        a[lo:lo + rows] = pd.argmin(dim=1)
        del pd
    return a


def _rel_gap(C, C_ref) -> float:
    return float(torch.linalg.norm(C - C_ref) / torch.linalg.norm(C_ref))


#: kernel 4's device kernels, by the name the profiler gives them
TOP2_KERNEL = "nkm::tc::tc_top2_kernel<128, 1>"
SCATTER_KERNEL = "nkm::scatter_rows<2>"
ROUND_PARTS = {TOP2_KERNEL: "top-2 (tensor cores, 3xTF32)",
               "nkm::bucket_rows<2>": "scatter: row lists",
               SCATTER_KERNEL: "scatter: sums over the lists",
               "nkm::reduce_chunks": "scatter: chunk reduction",
               "nkm::tc::split_c_kernel": "c split and |c|^2",
               "nkm::tc::sqnorm_kernel": "|x|^2"}
#: the scatter's device kernels in all modes (cluster_sum is mode 0)
SCATTER_PARTS = {"nkm::bucket_rows": "row lists",
                 "nkm::scatter_rows": "sums over the lists",
                 "nkm::reduce_chunks": "chunk reduction"}


def device_parts(prof, names) -> dict:
    """{name: (device ms, launches)} of the device kernels whose name
    holds each of ``names``, in a profiled run."""
    out = dict.fromkeys(names, (0.0, 0))
    for e in _averages(prof):
        if str(e.device_type).endswith("CUDA"):
            for name in names:
                if name in e.key:
                    ms, count = out[name]
                    out[name] = (ms + e.self_device_time_total / 1e3,
                                 count + e.count)
    return out


def scatter_report(prof, run: str) -> None:
    """Logs the scatter's device time in a profiled run, by pass."""
    parts = device_parts(prof, SCATTER_PARTS)
    total = sum(ms for ms, _ in parts.values())
    log(f"    the scatter in the profiled {run}: {total:.2f} ms device ("
        + ", ".join(f"{what} {parts[name][0]:.2f} ms in "
                    f"{parts[name][1]} launches"
                    for name, what in SCATTER_PARTS.items()) + ")")


def fused_round_parts(prof) -> dict:
    """Device ms of each of kernel 4's kernels in a profiled run."""
    out = {name: ms for name, (ms, _) in
           device_parts(prof, ROUND_PARTS).items()}
    log("    fused_round's parts in the profiled dp step: " + ", ".join(
        f"{what} ({name}) {out[name]:.1f} ms"
        for name, what in ROUND_PARTS.items()))
    scatter = sum(out[name] for name in ROUND_PARTS
                  if name.split("<")[0] in SCATTER_PARTS)
    log(f"    the scatter's three passes together: {scatter:.1f} ms")
    return out


def trace_again(step, report) -> None:
    """Runs ``step`` twice under a new trace, the second time traced,
    after a pause; ``report`` reads the trace."""
    from torch.profiler import ProfilerActivity, profile, schedule
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=report)
    with prof:
        for i in range(2):
            if i == 1:
                time.sleep(0.2)
            step()
            prof.step()


def dp_round_phase(X, C0):
    """The data-parallel round at full width: 3 fused Lloyd steps, two
    steps under a one-rank NCCL mesh, one unfused step; returns the
    launch counts of that run."""
    import torch.distributed as dist
    from repro_torch.core.distributed import make_dp_round
    from repro_torch.core.state import ClusterStats, centroid_update
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fused = make_dp_round(None, fused=True)
    C, mses, walls = C0, [], []
    # where the step's time goes: step 0 runs untraced, step 1 warms the
    # tracer up, step 2 is traced and reported. A step launched at the
    # very start of a trace lost its first kernels (the 1.3 s top-2
    # among them) in some runs, so the traced step waits a moment first.
    parts = {}

    def report(p):
        profile_report(p, walls[0], walls[-1], what="dp step")
        parts.update(fused_round_parts(p))

    prof = profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=1, warmup=1, active=1),
        on_trace_ready=report)
    with prof:
        for i in range(3):
            if i == 2:
                time.sleep(0.2)
            out, wall = _timed(fused, X, C)
            C_in, C = C, out[0]
            mses.append(float(out[7]))
            walls.append(wall)
            need(C.shape == (K_XL, D_XL) and bool(torch.isfinite(C).all()),
                 "dp round: centroids are not finite (k, d)")
            need(out[3].shape == (N_XL,) and int(out[3].min()) >= 0
                 and int(out[3].max()) < K_XL, "dp round: labels")
            log(f"    fused dp step {i}: batch MSE {mses[-1]!r}, wall "
                f"{wall:.3f} s")
            prof.step()
    for m0, m1 in zip(mses, mses[1:]):
        need(m1 <= m0 * (1 + 1e-6), "the batch MSE rose in a Lloyd step")
    # torch.profiler on the card has lost the kernels of a traced step in
    # some runs (the launch counts show they ran): the last step is traced
    # again, at most twice, until its trace holds the top-2 and the scatter
    retraced = 0
    while retraced < 2 and not all(parts.get(name, 0.0) > 0.0
                                   for name in (TOP2_KERNEL, SCATTER_KERNEL)):
        log("    the trace lost the step's kernels; the last step is traced "
            "again")
        trace_again(lambda: walls.append(_timed(fused, X, C_in)[1]), report)
        retraced += 1

    # one rank over NCCL: the collective path must give the same bits
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh_step = make_dp_round(make_host_mesh((1,), ("data",)),
                                  fused=True)
        # the first collective also sets NCCL's communicator up
        runs = [_timed(mesh_step, X, C_in) for _ in range(2)]
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(g, w) for on_mesh, _ in runs
               for g, w in zip(on_mesh, out))
    log(f"    one-rank NCCL mesh steps: wall {runs[0][1]:.3f} s (first, "
        f"with NCCL's set-up), {runs[1][1]:.3f} s; bit-identical to "
        f"mesh=None: {same}")
    need(same, "the one-rank NCCL dp step differs from mesh=None")

    unfused, wall_u = _timed(make_dp_round(None, fused=False), X, C_in)
    ties, nearer, _ = _near_ties(X, C_in, out[3], unfused[3])
    moved = torch.unique(torch.cat([out[3][out[3] != unfused[3]],
                                    unfused[3][out[3] != unfused[3]]]))
    kept = torch.ones(K_XL, dtype=torch.bool, device=DEV)
    kept[moved.long()] = False
    # the round the steps approximate: every row at its float64 argmin,
    # summed by the plain version in row chunks
    a64 = exact_labels(X, C_in)
    off_f = _near_ties(X, C_in, out[3], a64)[0]
    off_u = _near_ties(X, C_in, unfused[3], a64)[0]
    S, v = _chunked_sums(X, a64, out[4], K_XL)[:2]
    zero = torch.zeros_like(v)
    C64 = centroid_update(ClusterStats(C=C_in, S=S, v=v, sse=zero,
                                       p=zero)).C
    del a64, S
    gap_f, gap_u = _rel_gap(out[0], C64), _rel_gap(unfused[0], C64)
    gap_fu = _rel_gap(unfused[0], out[0])
    log(f"    unfused dp step (kernels 1 + 2): wall {wall_u:.3f} s, labels "
        f"differ from the fused step's at {ties} near-tied rows (the fused "
        f"label nearer in float64 at {nearer}), C bit-identical on the "
        f"{int(kept.sum())} clusters no such row touches, C relative gap "
        f"{gap_fu:.3g} (held to 1e-4)")
    log(f"    against the float64 argmin of every row: the fused labels "
        f"differ at {off_f} near-tied rows, the unfused at {off_u}; C "
        f"relative gap to the C of those labels: fused {gap_f:.3g} (held "
        f"to 1e-4), unfused {gap_u:.3g}")
    need(torch.equal(unfused[0][kept], out[0][kept]),
         "fused and unfused C differ on clusters with the same rows")
    need(gap_fu <= 1e-4, "the fused and unfused steps' C differ beyond "
         "1e-4 relative")
    need(gap_f <= 1e-4, "the fused step's C differs beyond 1e-4 relative "
         "from the C of the float64 labels")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"    launches on the dp path ({3 + 2 * retraced} fused + 2 mesh + 1 "
        f"unfused step): "
        f"{launches}; peak device memory {peak / 2 ** 30:.2f} GiB")
    need(launches["fused_round"] > 0,
         "fused_round was never launched on the dp path")
    for name in (TOP2_KERNEL, SCATTER_KERNEL):
        need(parts.get(name, 0.0) > 0.0,
             f"the profiled dp step shows no {name}")
    return launches, parts


def xl_phase() -> dict:
    from repro_torch.kernels import fused_round
    t0 = time.perf_counter()
    X, C0 = xl_data()
    torch.cuda.synchronize()
    log(f"[6] kmeans_xl: X {tuple(X.shape)} f32 "
        f"({X.numel() * 4 / 2 ** 30:.1f} GiB) made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    err = check_fused_round(X, C0, plain_rows=XL_CHECK_ROWS)
    launches, parts = dp_round_phase(X, C0)

    n, d, k = N_XL, D_XL, K_XL
    n_bytes = n * d * 4 + k * d * 4 + n * 12 + (k * d + 2 * k) * 4
    # the distances in 3xTF32 on the tensor cores, the adds into S in f32
    b, how = bound(n_bytes, 1.0 * n * d, tf32_flops=3 * 2.0 * n * k * d)
    b_f32, _ = bound(n_bytes, 2.0 * n * k * d + 1.0 * n * d)
    xs = X[:XL_PLAIN_ROWS]
    mm_ms = time_ms(lambda: torch.mm(xs, C0.T), iters=3) \
        * (n / XL_PLAIN_ROWS)
    log(f"    yardstick: cuBLAS f32 torch.mm of x.c^T on the "
        f"({XL_PLAIN_ROWS}, {d}) slice, scaled to n={n}: {mm_ms:.3f} ms "
        f"(not the same function; not in the kernels line)")
    t = dict(
        ms=time_ms(lambda: fused_round.fused_round_cuda(X, C0), iters=3),
        plain_ms=time_ms(lambda: fused_round.fused_round_ref(xs, C0),
                         iters=3),
        library_ms=None, bound_ms=b, bound_by=how)
    top2 = parts[TOP2_KERNEL]
    log(f"    fused_round at n={n} d={d} k={k}: kernel {t['ms']:.3f} ms "
        f"(mean of 3 after a warm-up), bound {b:.3f} ms ({how}: 3xTF32 at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {b / t['ms'] * 100:.1f} % "
        f"of it; the CUDA-core f32 bound {b_f32:.3f} ms; its top-2 "
        f"{top2:.1f} ms in the profile ({b / top2 * 100:.1f} % of the "
        f"bound); plain {t['plain_ms']:.3f} ms on a ({XL_PLAIN_ROWS}, {d}) "
        f"slice, library n/a")
    return {"err": err, "launches": launches, "times": t}


# ---------------------------------------------------------------- phase 7

#: the paper's other algorithms and bound families at the infMNIST cell's
#: width: (name, FitConfig over phase 4's, the kernels its fit must launch)
OTHER_PATHS = (
    ("lloyd", dict(algorithm="lloyd", max_rounds=100),
     ("assign_top2", "cluster_sum")),
    ("mb", dict(algorithm="mb", b0=2000, max_rounds=400),
     ("assign_top2", "cluster_sum")),
    ("mbf", dict(algorithm="mbf", b0=2000, max_rounds=400),
     ("assign_top2", "cluster_sum")),
    ("tb-elkan", dict(bounds="elkan"), ("cluster_sum",)),
    ("tb-exponion", dict(bounds="exponion"), ("cluster_sum",)),
    ("lloyd-elkan", dict(algorithm="lloyd-elkan", max_rounds=100),
     ("cluster_sum",)),
)


def _curve(km) -> list:
    """(time in the rounds, validation MSE) at each evaluation."""
    return [(r.t, r.val_mse) for r in km.telemetry_
            if r.val_mse is not None]


def _curve_text(curve) -> str:
    return " ".join(f"{t:.4f}:{m:.6f}" for t, m in curve)


def other_paths_phase(X, Xv, tb_curve) -> dict:
    """Fits each path of OTHER_PATHS; returns {name: `fit_record` of its
    first fit}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    log(f"[7] the other algorithms and bound families on phase 4's rows "
        f"({N}, {D}), k={K}")
    log(f"    tb (phase 4) val MSE against the rounds' time (s:MSE): "
        f"{_curve_text(tb_curve)}")
    fits = {}
    for name, kw, kernels in OTHER_PATHS:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        km, wall = fit_once(X, Xv, **kw)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        tel = [r for r in km.telemetry_ if r.batch_mse is not None]
        log(f"    {name}: {len(tel)} rounds, converged {km.converged_}, "
            f"sum n_recomputed {sum(r.n_recomputed for r in tel)}, final "
            f"val MSE {km.final_mse_!r}, wall {wall:.2f} s (rounds "
            f"{km.telemetry_[-1].t:.3f} s), peak device memory "
            f"{peak / 2 ** 30:.2f} GiB")
        log(f"      launches: {launches}")
        for kern in kernels:
            need(launches[kern] > 0, f"{kern} was never launched on the "
                 f"{name} path")
        C, labels = km.cluster_centers_, km.labels_
        need(C.shape == (K, D) and bool(np.isfinite(C).all()),
             f"{name}: centroids are not finite (k, d)")
        need(labels.shape == (N,) and labels.min() >= 0
             and labels.max() < K, f"{name}: fit labels")
        # the second fit runs under torch.profiler: where its time goes
        # on the device (its kernels, copies and CUDA runtime calls; the
        # host's operators are left out of this trace to keep its parse
        # short)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            km2, wall2 = fit_once(X, Xv, **kw)
        same = np.array_equal(km2.cluster_centers_, C) \
            and np.array_equal(km2.labels_, labels)
        profile_report(prof, wall, wall2)
        syncs = sync_counts(prof)
        log(f"      host calls that wait for the device in the profiled "
            f"fit: {sum(syncs.values())} ({syncs})")
        kmr, wallr = fit_once(X, Xv, kernel_backend="ref", **kw)
        rel = abs(kmr.final_mse_ - km.final_mse_) / abs(kmr.final_mse_)
        n_ref = sum(r.batch_mse is not None for r in kmr.telemetry_)
        log(f"      second fit (wall {wall2:.2f} s) bit-identical: {same}; "
            f"ref fit: {n_ref} rounds, val MSE {kmr.final_mse_!r}, wall "
            f"{wallr:.2f} s, relative gap {rel:.3g}")
        log(f"      val MSE against the rounds' time (s:MSE): "
            f"{_curve_text(_curve(km))}")
        need(same, f"{name}: a second identical fit is not bit-identical")
        need(rel <= 1e-3, f"{name}: cuda and ref fits differ in val MSE "
             f"beyond 1e-3")
        if name.startswith("tb-"):
            shadow_bounds(X, Xv, km, kw)
        fits[name] = fit_record(km)
    return fits


def shadow_bounds(X, Xv, km, kw) -> None:
    """The bound family's fit once more, each round's step also taken
    with ``bounds="none"`` (every active row scans all k) from the same
    state: a bound only skips work that cannot change an assignment, so
    a label may differ from the exhaustive step's only at a near-tie
    (float64 distances to the two centroids within 1e-3 relative). The
    fit itself must keep its bits."""
    from repro_torch.api import FitConfig
    from repro_torch.api.engines.local import LocalEngine
    from repro_torch.api.loop import run_loop
    from repro_torch.core import rounds
    cfg = FitConfig(k=K, **dict(MAIN_CONFIG, **kw)).resolve(N)
    run = LocalEngine().begin(X, cfg, X_val=Xv, device=DEV)
    step = run.nested_step
    seen = {"rounds": 0, "rows": 0, "worst": 0, "top": 0.0}

    def both(state, b, capacity):
        out = step(state, b, capacity)
        alt = rounds.nested_round(
            run._Xd, state, b=b, rho=cfg.rho, bounds="none",
            capacity=capacity, use_shalf=cfg.use_shalf, plan=run.kernel_plan)
        rows, _, gap = _near_ties(run._Xd[:b], state.stats.C,
                                  out[0].points.a[:b], alt[0].points.a[:b])
        seen["top"] = max(seen["top"], gap)
        seen["rounds"] += 1
        seen["rows"] += rows
        seen["worst"] = max(seen["worst"], rows)
        return out

    run.nested_step = both
    out = run_loop(run, cfg)
    del run.nested_step       # the cycle run -> both -> run holds X
    need(np.array_equal(out.C, km.cluster_centers_),
         f"the shadowed {cfg.bounds} fit differs from its fit")
    log(f"      shadow fit (each round's step also with bounds='none' from "
        f"the same state): {seen['rounds']} steps; labels differ at "
        f"{seen['rows']} rows in all (at most {seen['worst']} in a step), "
        f"every one a near-tie (largest float64 gap {seen['top']:.3g} "
        f"relative)")


# ---------------------------------------------------------------- phase 8

#: the checkpointed fits of phase 8: (name, config over phase 4's,
#: save_every, the kernels the resumed part must launch)
RESUMED_PATHS = (
    ("tb-hamerly2", {}, 25, ("assign_top2", "cluster_sum")),
    ("tb-elkan", dict(bounds="elkan"), 50, ("cluster_sum",)),
    ("mb", dict(algorithm="mb", b0=2000, max_rounds=400), 50,
     ("assign_top2", "cluster_sum")),
)
#: the round whose ``on_round`` kills each checkpointed fit
KILL_ROUND = 137
STORE_CHUNK_ROWS = 65_536


class Killed(Exception):
    """Raised by ``on_round`` to kill a checkpointed fit mid-run."""


def _tel_minus_t(km) -> list:
    out = []
    for r in km.telemetry_:
        r = r.to_dict()
        r.pop("t")
        out.append(r)
    return out


def fit_record(km):
    """What phase 8 holds a fit to (C, labels, telemetry), on the host:
    the fit's state leaves the card."""
    import types
    return types.SimpleNamespace(cluster_centers_=km.cluster_centers_,
                                 labels_=km.labels_,
                                 telemetry_=km.telemetry_)


def _same_fit(got, want, labels_perm=None) -> bool:
    """C, labels and telemetry without ``t`` bit-equal; ``labels_perm``
    maps ``got``'s labels to ``want``'s rows."""
    labels = got.labels_ if labels_perm is None else got.labels_[labels_perm]
    return (np.array_equal(got.cluster_centers_, want.cluster_centers_)
            and np.array_equal(labels, want.labels_)
            and _tel_minus_t(got) == _tel_minus_t(want))


def _counted(launches: dict, fn):
    """Runs ``fn`` with the launch counts set to 0 just before and read
    just after; adds them into ``launches`` and returns (result, its
    counts)."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name, n in counts.items():
        launches[name] += n
    return out, counts


def store_fit(X, Xv, root: str, launches: dict) -> None:
    """(a): phase 4's rows written to a chunk store, fitted from it
    through ``config.data_source``, and held bit for bit to the
    in-memory fit of the rows in `store_permutation`'s order."""
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.data.store import (ChunkStore, store_permutation,
                                        write_store)
    path = os.path.join(root, "store")
    t0 = time.perf_counter()
    write_store(path, X, chunk_rows=STORE_CHUNK_ROWS)
    write_s = time.perf_counter() - t0
    with ChunkStore(path) as st:
        n_chunks = st.n_chunks
    log(f"    (a) store: {N} x {D} f32 rows in {n_chunks} chunks of "
        f"{STORE_CHUNK_ROWS} ({X.nbytes / 2 ** 30:.2f} GiB) written in "
        f"{write_s:.2f} s")
    cfg = FitConfig(k=K, data_source=path, **MAIN_CONFIG)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km, counts = _counted(launches, lambda: NestedKMeans(
        cfg, device=DEV).fit(X_val=Xv))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"        fit through config.data_source: {km.n_rounds_} records, "
        f"wall {wall:.2f} s (rounds {km.telemetry_[-1].t:.3f} s), peak "
        f"device memory {peak / 2 ** 30:.2f} GiB, launches {counts}")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(counts[name] > 0, f"{name} was never launched in the store fit")
    # the same fit from an open ChunkStore, whose read metrics we keep
    st = ChunkStore(path)
    t0 = time.perf_counter()
    km2, _ = _counted(launches, lambda: NestedKMeans(
        FitConfig(k=K, **MAIN_CONFIG), device=DEV).fit(st, X_val=Xv))
    wall2 = time.perf_counter() - t0
    m = st.metrics
    st.close()
    log(f"        the same fit from an open ChunkStore: wall {wall2:.2f} s, "
        f"read {m.bytes_read} bytes = {m.bytes_read / X.nbytes:.3f} of one "
        f"pass ({m.chunk_loads} chunk loads, {m.cache_hits} cache hits), "
        f"bit-identical: {_same_fit(km2, km)}")
    need(_same_fit(km2, km), "two fits from one store differ")
    perm = store_permutation(N, STORE_CHUNK_ROWS, MAIN_CONFIG["seed"])
    Xp = np.ascontiguousarray(X[perm])
    torch.cuda.reset_peak_memory_stats()
    km_m, wall_m = fit_once(Xp, Xv, shuffle=False)
    peak_m = torch.cuda.max_memory_allocated()
    same = _same_fit(km, km_m, labels_perm=perm)
    log(f"        in-memory fit of X[store_permutation(...)], shuffle=False: "
        f"wall {wall_m:.2f} s (rounds {km_m.telemetry_[-1].t:.3f} s), peak "
        f"device memory {peak_m / 2 ** 30:.2f} GiB; the store fit's C, "
        f"labels and telemetry (but t) are bit-equal to it: {same}")
    need(same, "the store fit differs from the in-memory fit of the "
         "permuted rows")


def _timed_method(cls, name: str, times: list):
    """Wraps ``cls.name`` to append each call's synchronised wall time
    to ``times``; returns the original."""
    orig = getattr(cls, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    setattr(cls, name, timed)
    return orig


def _step_bytes(store, step: int) -> int:
    d = store._step_dirs()[step]
    return sum(f.stat().st_size for f in d.iterdir())


def resumed_fit(X, Xv, root: str, name: str, kw: dict, save_every: int,
                kernels, unbroken, launches: dict) -> None:
    """(b), (c): the fit with a checkpoint every ``save_every`` rounds,
    killed by ``on_round`` at KILL_ROUND, then ``fit(resume=True)``; the
    resumed fit must have ``unbroken``'s bits."""
    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    from repro_torch.api.engines.local import _LocalRun
    from repro_torch.checkpoint import CheckpointStore
    ck = CheckpointConfig(checkpoint_dir=os.path.join(root, name),
                          save_every=save_every)
    cfg = FitConfig(k=K, checkpoint=ck, **dict(MAIN_CONFIG, **kw))

    def kill(rec):
        if rec.round == KILL_ROUND:
            raise Killed

    saves, restores = [], []
    orig_save = _timed_method(CheckpointStore, "save", saves)
    orig_restore = _timed_method(_LocalRun, "restore", restores)
    try:
        t0 = time.perf_counter()
        try:
            NestedKMeans(cfg, device=DEV, on_round=kill).fit(X, X_val=Xv)
        except Killed:
            pass
        else:
            raise Failure(f"{name}: the fit ended before round "
                          f"{KILL_ROUND}")
        wall_killed = time.perf_counter() - t0
        store = CheckpointStore(ck.checkpoint_dir)
        last = store.latest_step()
        want_last = KILL_ROUND // save_every * save_every
        need(last == want_last, f"{name}: the last save is round {last}, "
             f"not {want_last}")
        n_bytes = _step_bytes(store, last)
        t0 = time.perf_counter()
        km, counts = _counted(launches, lambda: NestedKMeans(
            cfg, device=DEV).fit(X, X_val=Xv, resume=True))
        wall = time.perf_counter() - t0
    finally:
        CheckpointStore.save = orig_save
        _LocalRun.restore = orig_restore
    same = _same_fit(km, unbroken)
    log(f"    ({'b' if name == 'tb-hamerly2' else 'c'}) {name}, "
        f"save_every={save_every}: killed at round {KILL_ROUND} after "
        f"{wall_killed:.2f} s, last save round {last}; "
        f"{len(saves)} saves in the two runs, "
        f"{1e3 * sum(saves) / len(saves):.1f} ms a save (largest "
        f"{1e3 * max(saves):.1f}), {n_bytes / 2 ** 20:.1f} MiB a checkpoint; "
        f"restore {1e3 * restores[0]:.1f} ms; resumed fit: "
        f"{km.n_rounds_ - last} more records, wall {wall:.2f} s, launches "
        f"{counts}; bit-equal to the unbroken fit: {same}")
    need(len(restores) == 1, f"{name}: the resume restored "
         f"{len(restores)} times")
    for kern in kernels:
        need(counts[kern] > 0, f"{kern} was never launched in the resumed "
             f"{name} fit")
    need(same, f"{name}: the resumed fit differs from the unbroken fit")


def resume_phase(X, Xv, unbroken: dict) -> dict:
    """Phase 8: out-of-core and kill-and-resume at phase 4's width.
    ``unbroken``: {path name: its unbroken fit} from phases 4 and 7.
    Returns the launches of phase 8's fits."""
    import shutil
    import tempfile
    launches = dict.fromkeys(REPLACES, 0)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        du = shutil.disk_usage(root)
        log(f"[8] chunk store and checkpoints under {root}: "
            f"{du.free / 2 ** 30:.1f} GiB free of {du.total / 2 ** 30:.1f}")
        store_fit(X, Xv, root, launches)
        for name, kw, every, kernels in RESUMED_PATHS:
            resumed_fit(X, Xv, root, name, kw, every, kernels,
                        unbroken[name], launches)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"    launches in phase 8's fits: {launches}; phase 8 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 8")
    return launches


# ---------------------------------------------------------------- phase 9

#: phase 9: the stream the service folds in, and the latency design of
#: benchmarks/serve_latency.py (its folder is not ported; this repeats it)
SERVE_ROWS = 120_000
QUERY_ROWS, ROWS_PER_REQ, MICRO, COARSE = 2048, 256, 256, 16384
N_REQ = 500                  # timed requests a mode
P99_CLAIM = 1.5              # the JAX package's background/off p99 claim
READ_S = 5.0                 # (b)'s reading window
N_READERS = 4
CHECK_EVERY = 50             # (b): every 50th request's labels are checked
HISTORY_ROWS = 65_536
DRIFT_ROWS = 32_768          # (c): the stream's rows it feeds, of which
DRIFT_CLEAN_ROWS = 16_384    # the first are fed as they are, then x3
REPEAT_BATCHES = 20
SERVE_WAIT_S = 120.0         # deadline of every wait and join of phase 9


def _adopted(outcome, **kw):
    """A fresh estimator on phase 4's config (``kw`` over it) that has
    adopted phase 4's fit."""
    from repro_torch.api import FitConfig, NestedKMeans
    return NestedKMeans(FitConfig(k=K, **dict(MAIN_CONFIG, **kw)),
                        device=DEV).adopt(outcome)


def _pcts(lat) -> dict:
    lat = np.asarray(lat, dtype=np.float64) * 1e3
    if not lat.size:
        return {"p50_ms": float("nan"), "p99_ms": float("nan"),
                "max_ms": float("nan"), "n": 0}
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max()), "n": int(lat.size)}


def _pcts_text(p: dict) -> str:
    return (f"p50 {p['p50_ms']:.3f} ms, p99 {p['p99_ms']:.3f} ms, max "
            f"{p['max_ms']:.3f} ms over {p['n']} requests")


def _join(threads, what: str) -> None:
    for t in threads:
        t.join(SERVE_WAIT_S)
    need(not any(t.is_alive() for t in threads), f"{what} did not end "
         f"within {SERVE_WAIT_S} s")


def _wait(pred, what: str) -> None:
    t0 = time.perf_counter()
    while not pred():
        need(time.perf_counter() - t0 < SERVE_WAIT_S,
             f"{what}: not reached within {SERVE_WAIT_S} s")
        time.sleep(0.005)


def _lat_off(km, Q) -> list:
    lat = []
    for _ in range(N_REQ):
        t0 = time.perf_counter()
        km.predict(Q)
        lat.append(time.perf_counter() - t0)
    return lat


def _lat_inline(km, Q, stream):
    """The serving thread folds each COARSE rows of stream in itself."""
    lat, pos, buf, folds = [], 0, 0, 0
    for _ in range(N_REQ):
        t0 = time.perf_counter()
        buf += ROWS_PER_REQ
        if buf >= COARSE:
            km.partial_fit(stream[pos:pos + COARSE])
            pos = (pos + COARSE) % (len(stream) - COARSE + 1)
            buf = 0
            folds += 1
        km.predict(Q)
        lat.append(time.perf_counter() - t0)
    return lat, folds


def _lat_background(km, Q, stream):
    """A `ClusterService` folds the stream in on its refresher thread
    while this thread serves."""
    from repro_torch.serve import ClusterService, IngestQueue
    queue = IngestQueue(max_rows=4 * COARSE, policy="drop-oldest")
    svc = ClusterService(km, micro_batch=MICRO, flush_after_s=0.02,
                         queue=queue).start()
    lat, pos = [], 0
    for _ in range(N_REQ):
        svc.ingest(stream[pos:pos + ROWS_PER_REQ])
        pos = (pos + ROWS_PER_REQ) % (len(stream) - ROWS_PER_REQ + 1)
        t0 = time.perf_counter()
        svc.predict(Q)
        lat.append(time.perf_counter() - t0)
    metrics = svc.export_metrics()
    svc.stop()
    return lat, metrics, queue.peak_depth


def predict_parts(snap, Q) -> None:
    """Where a request's time goes: the upload of its rows (host clock,
    synchronised), the kernel alone on rows already on the card (CUDA
    events), and the whole `CodebookSnapshot.predict` (host clock)."""
    from repro_torch.kernels import ops
    reps = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        Qd = torch.from_numpy(Q).to(DEV)
        torch.cuda.synchronize()
    up = (time.perf_counter() - t0) / reps * 1e3
    Cd = torch.from_numpy(np.array(snap.centroids)).to(DEV)
    kern = time_ms(lambda: ops.assign_top2(Qd, Cd), iters=reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        snap.predict(Q)
    whole = (time.perf_counter() - t0) / reps * 1e3
    log(f"    a {QUERY_ROWS}-row predict: {whole:.3f} ms in all (host "
        f"clock), of which the upload of its {Q.nbytes / 2 ** 20:.1f} MiB "
        f"of rows {up:.3f} ms (host clock, synchronised) and the "
        f"assign_top2 kernel {kern:.3f} ms (CUDA events); the rest is the "
        f"host: C's upload, the plan, the wrapper and the copy back")


def serve_latency(outcome, Q, stream):
    """(a): refresh off, inline and in the background; returns the
    estimator of the off mode."""
    kms = [_adopted(outcome) for _ in range(3)]
    for km in kms:                       # first calls outside the timing
        km.predict(Q)
        km.partial_fit(stream[:MICRO])
        km.partial_fit(stream[:COARSE])
    torch.cuda.synchronize()
    # the off floor is taken before and after the other modes, and the
    # worse p99 is the denominator (as benchmarks/serve_latency.py does)
    off_a = _lat_off(kms[0], Q)
    inline, folds = _lat_inline(kms[1], Q, stream)
    bg, metrics, peak = _lat_background(kms[2], Q, stream)
    off_b = _lat_off(kms[0], Q)
    p_a, p_b = _pcts(off_a), _pcts(off_b)
    off = p_a if p_a["p99_ms"] >= p_b["p99_ms"] else p_b
    p_in, p_bg = _pcts(inline), _pcts(bg)
    r_in, r_bg = (p_in["p99_ms"] / off["p99_ms"],
                  p_bg["p99_ms"] / off["p99_ms"])
    log(f"    (a) latency of a {QUERY_ROWS}-row predict, {ROWS_PER_REQ} "
        f"stream rows a request:")
    log(f"        off:        {_pcts_text(off)} (the worse of two runs; "
        f"the other p99 {min(p_a['p99_ms'], p_b['p99_ms']):.3f} ms)")
    log(f"        inline:     {_pcts_text(p_in)}; {r_in:.3f}x the off "
        f"p99, {folds} folds of {COARSE} rows")
    log(f"        background: {_pcts_text(p_bg)}; {r_bg:.3f}x the off p99 "
        f"(the JAX package claims <= {P99_CLAIM}x), "
        f"{metrics['refresh']['count']} refreshes of {MICRO} rows (refresh "
        f"p50 {metrics['refresh']['latency']['p50_s'] * 1e3:.3f} ms, p99 "
        f"{metrics['refresh']['latency']['p99_s'] * 1e3:.3f} ms), queue "
        f"peak depth {peak}")
    need(metrics["refresh"]["count"] >= 3,
         "(a): the background refresher did not run while serving")
    return kms[0]


def _reader(svc, Q, stop, out: dict) -> None:
    """Reads until ``stop``: every loaded snapshot must verify, versions
    may not fall, and the first request at or after each CHECK_EVERY-th
    one that one known snapshot served has its labels held to
    `ref.assign_top2_ref` on that snapshot's C on the card."""
    from repro_torch.kernels import ref
    Qd = torch.from_numpy(Q).to(DEV)
    last, due = 0, False
    try:
        while not stop.is_set():
            snap = svc.snapshot
            need(snap.verify(), f"a torn read at version {snap.version}")
            need(snap.version >= last, f"version {snap.version} after "
                 f"{last}")
            last = snap.version
            t0 = time.perf_counter()
            labels = svc.predict(Q)
            out["lat"].append((t0, time.perf_counter() - t0))
            due = due or len(out["lat"]) % CHECK_EVERY == 0
            if due and svc.snapshot is snap:
                C = torch.from_numpy(np.array(snap.centroids)).to(DEV)
                want = ref.assign_top2_ref(Qd, C)[0]
                out["ties"] += _labels_ok(
                    torch.from_numpy(labels).to(DEV), want,
                    ref.pairwise_dist2(Qd, C), TOL["f32"], relative=True)
                out["checked"] += 1
                due = False
    except BaseException as e:           # noqa: BLE001 — reported below
        out["error"] = e


def _readers(svc, Xq):
    import threading
    stop = threading.Event()
    outs = [{"lat": [], "checked": 0, "ties": 0, "error": None}
            for _ in range(N_READERS)]
    threads = [threading.Thread(
        target=_reader, daemon=True,
        args=(svc, Xq[i * QUERY_ROWS:(i + 1) * QUERY_ROWS], stop, outs[i]))
        for i in range(N_READERS)]
    for t in threads:
        t.start()
    return stop, threads, outs


def _stop_readers(stop, threads, outs) -> None:
    stop.set()
    _join(threads, "a reader")
    for i, o in enumerate(outs):
        if o["error"] is not None:
            raise Failure(f"reader {i}: {o['error']!r}")


def serve_concurrency(outcome, Xq, stream) -> None:
    """(b): 4 readers while one producer delivers every row twice."""
    import threading

    from repro_torch.serve import ClusterService, IngestQueue
    km = _adopted(outcome)
    n0 = float(np.sum(km.counts_, dtype=np.float64))
    queue = IngestQueue(max_rows=16384, policy="block", dedup=True)
    svc = ClusterService(km, micro_batch=MICRO, flush_after_s=0.02,
                         queue=queue).start()
    v0 = svc.snapshot.version
    errors = []

    def produce():
        try:
            for lo in range(0, len(stream), ROWS_PER_REQ):
                rows = stream[lo:lo + ROWS_PER_REQ]
                ids = range(lo, lo + len(rows))
                for _ in range(2):       # at-least-once delivery
                    svc.ingest(rows, ids=ids)
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)

    t0 = time.perf_counter()
    stop, readers, outs = _readers(svc, Xq)
    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    time.sleep(READ_S)
    refreshes_read = svc.metrics.refreshes
    _stop_readers(stop, readers, outs)
    read_s = time.perf_counter() - t0
    # the rest of the stream is folded in with no reader beside it
    _join([producer], "the producer")
    produce_s = time.perf_counter() - t0
    svc.stop(drain=True)
    need(not errors, f"the producer failed: {errors!r}")
    m = svc.export_metrics()
    rise = float(np.sum(km.counts_, dtype=np.float64)) - n0
    lat = [s for o in outs for _, s in o["lat"]]
    log(f"    (b) {N_READERS} readers for {read_s:.2f} s while one producer "
        f"delivered {len(stream)} rows twice (done after {produce_s:.2f} "
        f"s): {len(lat)} requests, {_pcts_text(_pcts(lat))}; "
        f"{refreshes_read} refreshes while they read, "
        f"{m['refresh']['count']} in all (versions {v0} to "
        f"{svc.snapshot.version}), refresh p50 "
        f"{m['refresh']['latency']['p50_s'] * 1e3:.3f} ms; queue "
        f"{m['queue']}")
    log(f"        refresh_rows {m['refresh']['rows']}, unique rows "
        f"delivered {len(stream)}, rise in sum(counts) {rise!r}; labels "
        f"checked against the plain assignment in "
        f"{sum(o['checked'] for o in outs)} requests "
        f"({sum(o['ties'] for o in outs)} near-tied rows differ)")
    need(refreshes_read >= 10, "(b): fewer than 10 refreshes while the "
         "readers read")
    need(m["refresh"]["rows"] == len(stream) == m["queue"]["accepted"]
         and rise == len(stream),
         "(b): the rows folded in are not the unique rows delivered")
    need(all(o["checked"] > 0 for o in outs),
         "(b): a reader had no request checked against the plain version")


def serve_drift(outcome, Xq, stream) -> None:
    """(c): the first DRIFT_ROWS rows of the stream, scaled x3 after the
    first DRIFT_CLEAN_ROWS; the service must escalate to a checkpointed
    re-fit while readers keep reading."""
    import shutil
    import tempfile

    from repro_torch.api import CheckpointConfig
    from repro_torch.serve import ClusterService, IngestQueue
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        km = _adopted(outcome, checkpoint=CheckpointConfig(
            checkpoint_dir=root, save_every=25))
        svc = ClusterService(
            km, micro_batch=MICRO, flush_after_s=0.02,
            queue=IngestQueue(max_rows=16384, policy="block"),
            history_rows=HISTORY_ROWS, drift_window=8, drift_factor=2.0)
        spans = []
        escalate = svc.escalate

        def timed(**kw):
            t0 = time.perf_counter()
            v, rows = svc.snapshot.version, len(svc._history)
            escalate(**kw)
            spans.append((t0, time.perf_counter(), v, svc.snapshot, rows,
                          km.n_rounds_))

        svc.escalate = timed
        svc.start()
        stop, readers, outs = _readers(svc, Xq)
        t0 = time.perf_counter()
        for lo in range(0, DRIFT_ROWS, ROWS_PER_REQ):
            rows = stream[lo:lo + ROWS_PER_REQ]
            svc.ingest(rows if lo < DRIFT_CLEAN_ROWS else 3.0 * rows)
        _wait(lambda: svc.queue.depth == 0, "(c): the queue drained")
        _stop_readers(stop, readers, outs)
        svc.stop(drain=True)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    m = svc.export_metrics()
    log(f"    (c) drift: {DRIFT_ROWS} rows, x3 after the first "
        f"{DRIFT_CLEAN_ROWS}, in {wall:.2f} s: {m['refresh']['count']} "
        f"refreshes, {m['refresh']['escalations']} escalations")
    need(m["refresh"]["escalations"] >= 1, "(c): no escalation")
    for t_start, t_end, v, snap, rows, records in spans:
        during = [s for o in outs for t, s in o["lat"]
                  if t_start <= t <= t_end]
        log(f"        escalation: a checkpointed fit of {rows} history rows "
            f"({records} records), wall {t_end - t_start:.3f} s; snapshot "
            f"{v} -> {snap.version}; readers during it: "
            f"{_pcts_text(_pcts(during))}")
        need(snap.version > v and snap.verify(),
             "(c): no newer snapshot that verifies after an escalation")
    lat = [s for o in outs for _, s in o["lat"]]
    log(f"        readers over the whole run: {_pcts_text(_pcts(lat))}")


def serve_repeat(outcome, stream) -> None:
    """(d): the same REPEAT_BATCHES micro-batches from the adopted
    codebook on two fresh estimators and on the plain versions."""
    batches = [stream[i * MICRO:(i + 1) * MICRO]
               for i in range(REPEAT_BATCHES)]
    runs, walls = [], []
    for kw in ({}, {}, {"kernel_backend": "ref"}):
        km = _adopted(outcome, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            km.partial_fit(b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / len(batches) * 1e3)
        runs.append(km)
    a, b, r = runs
    same = (np.array_equal(a.cluster_centers_, b.cluster_centers_)
            and np.array_equal(a.counts_, b.counts_)
            and _tel_minus_t(a) == _tel_minus_t(b))
    C, Cr = a.cluster_centers_, r.cluster_centers_
    rel = float(np.linalg.norm(C - Cr) / np.linalg.norm(Cr))
    log(f"    (d) {REPEAT_BATCHES} partial_fit({MICRO}) from the adopted "
        f"codebook twice: C, counts and telemetry but t bit-equal: {same}; "
        f"C against the same batches on the plain versions: {rel:.3g} "
        f"relative (Frobenius), counts equal: "
        f"{np.array_equal(a.counts_, r.counts_)}; a partial_fit takes "
        f"{walls[0]:.3f} / {walls[1]:.3f} ms on the kernels, {walls[2]:.3f} "
        f"ms on the plain versions (host clock, synchronised, no other "
        f"thread)")
    need(same, "(d): two runs of the same batches differ")
    need(rel <= 1e-5, "(d): C is not within 1e-5 of the plain versions'")


def serve_phase(X, outcome) -> dict:
    """Phase 9: the streaming service on the card, on phase 4's rows and
    fit. Returns its launches (the breakdown of a predict that follows
    them launches the kernel outside the count)."""
    from repro_torch.data.synthetic import infmnist_like
    from repro_torch.kernels import ops
    from repro_torch.serve import CodebookSnapshot
    t0 = time.perf_counter()
    stream = infmnist_like(SERVE_ROWS, seed=2)
    log(f"[9] the streaming service on phase 4's fit (adopted); stream "
        f"infmnist_like({SERVE_ROWS}, seed=2) made in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    Q = X[:QUERY_ROWS]
    ops.reset_launch_counts()
    km = serve_latency(outcome, Q, stream)
    serve_concurrency(outcome, X, stream)
    serve_drift(outcome, X, stream)
    serve_repeat(outcome, stream)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"    launches in phase 9: {launches}")
    for name in ("assign_top2", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 9")
    predict_parts(CodebookSnapshot.create(1, km.export_codebook(),
                                          device=DEV), Q)
    log(f"    phase 9 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 10

#: fits of each arm of phase 10 (b), after a warm-up (4, not 8: with
#: phase 15 the script needs the time to stay inside its limit)
OVERHEAD_PAIRS = 2


def _round_ts(km) -> list:
    """The fit's work clock at the end of each round."""
    return [r.t for r in km.telemetry_ if r.batch_mse is not None]


def _round_wall(km) -> float:
    """Median wall of one round of a fit (the steps of its work clock).
    The work clock stops before the loop hands the round to the obs sink
    (`round_end`), as the JAX package's `benchmarks/obs_overhead.py`
    does, so this wall does not see the sink's own work."""
    return float(np.median(np.diff([0.0] + _round_ts(km))))


def traced_fit(X, Xv, root: str, untraced) -> None:
    """(a): phase 4's fit traced, read back and held to the untraced."""
    from repro_torch.obs import read_events, summarize
    td = os.path.join(root, "trace")
    km, wall = fit_once(X, Xv, trace_dir=td)
    same = _same_fit(km, untraced)
    events = read_events(td)
    s = summarize(events)
    tel = [r for r in km.telemetry_ if r.batch_mse is not None]
    rounds = [e["attrs"] for e in events if e.get("name") == "round"]
    util = [r["utilization"] for r in rounds]
    log(f"    (a) traced fit: wall {wall:.2f} s, {s['rounds']} rounds, "
        f"kscans_total {s['kscans_total']}, bytes_total {s['bytes_total']}, "
        f"bit-equal to phase 4's untraced fit: {same}; files "
        f"{sorted(os.listdir(td))}")
    need(same, "the traced fit differs from phase 4's untraced fit")
    need(s["rounds"] == len(tel) == len(rounds),
         "the trace does not count the fit's rounds")
    need(s["kscans_total"] == sum(r.n_recomputed for r in tel),
         "kscans_total is not the sum of n_recomputed")
    need(all(u is not None and 0.0 < u <= 1.0 for u in util),
         f"a round's utilization is outside (0, 1]: {max(util)} (the H100 "
         f"roofline model is wrong)")
    bottlenecks = {b: sum(r["bottleneck"] == b for r in rounds)
                   for b in sorted({r["bottleneck"] for r in rounds})}
    log(f"        utilization_last {s['utilization_last']!r}, mean "
        f"{float(np.mean(util))!r}, max {max(util)!r}; work-weighted "
        f"{sum(r['bound_s'] for r in rounds) / s['round_s_total']!r} (sum "
        f"of bounds {sum(r['bound_s'] for r in rounds) * 1e3:.3f} ms over "
        f"{s['round_s_total']:.3f} s of rounds); rounds by bottleneck "
        f"{bottlenecks}")
    for name, sp in s["spans"].items():
        log(f"        span {name}: {sp['count']} x, total "
            f"{sp['total_s'] * 1e3:.2f} ms, max {sp['max_s'] * 1e3:.2f} ms")
    worst = sorted(rounds, key=lambda r: r["dt_s"], reverse=True)[:3]
    log("        slowest rounds: " + "; ".join(
        f"round {r['round']} b {r['b_global']} capacity {r['capacity']} "
        f"kscans {r['kscans']} {r['dt_s'] * 1e3:.2f} ms (bound "
        f"{r['bound_s'] * 1e3:.3f} ms)" for r in worst))


def _timed_observer(cost: dict):
    """A `FitObserver` that adds the host time of its own calls (set-up,
    round_end, count, fit_end, close and the spans' own enter and exit)
    to ``cost["observer"]``."""
    import contextlib

    from repro_torch.obs import FitObserver

    def timed(fn):
        def call(self, *a, **kw):
            t = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                cost["observer"] += time.perf_counter() - t
        return call

    @contextlib.contextmanager
    def span(self, name, **attrs):
        t = time.perf_counter()
        cm = FitObserver.span(self, name, **attrs)
        cm.__enter__()
        cost["observer"] += time.perf_counter() - t
        try:
            yield
        finally:
            t = time.perf_counter()
            cm.__exit__(None, None, None)
            cost["observer"] += time.perf_counter() - t

    body = {n: timed(getattr(FitObserver, n)) for n in (
        "__init__", "start", "round_end", "count", "fit_end", "close")}
    return type("TimedFitObserver", (FitObserver,), dict(body, span=span))


def obs_overhead(X, Xv, root: str) -> None:
    """(b): after a warm-up, rotate three arms: untraced fits, traced fits,
    and fits with ``trace_dir`` set whose observer is the no-op seam
    (``sink off``: the estimator's path without the sink's work). Each
    fit's wall is split into its rounds (the work clock), the observer's
    own calls, the garbage collector's pauses and the rest (the engine's
    set-up, evals, the loop's bookkeeping, the fit's tail)."""
    import gc

    import repro_torch.obs as obs_pkg
    from repro_torch.api.loop import ObsSink
    from repro_torch.util import tracecount
    fit_once(X, Xv)
    log(f"    (b) round keys the process has seen before it: "
        f"{tracecount.mark()[1]}")
    cost = {"observer": 0.0, "gc": 0.0, "gc_gen2": 0}
    gc_t0 = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            cost["gc"] += time.perf_counter() - gc_t0[0]
            cost["gc_gen2"] += info["generation"] == 2

    class NoSink(ObsSink):
        def __init__(self, *args, **kwargs):
            pass

        def start(self, **meta):
            pass

    plain = obs_pkg.FitObserver
    observers = {"untraced": plain, "traced": _timed_observer(cost),
                 "sink off": NoSink}
    names = list(observers)
    keys = ("wall", "rounds", "observer", "gc", "rest", "round_median",
            "gc_gen2")
    arms = {arm: {k: [] for k in keys} for arm in names}
    gc.callbacks.append(on_gc)
    try:
        for i in range(OVERHEAD_PAIRS):
            for arm in names[i % 3:] + names[:i % 3]:
                kw = ({} if arm == "untraced" else
                      {"trace_dir": os.path.join(root, f"overhead{i}")})
                obs_pkg.FitObserver = observers[arm]
                cost.update(observer=0.0, gc=0.0, gc_gen2=0)
                km, wall = fit_once(X, Xv, **kw)
                rounds = _round_ts(km)[-1]
                row = dict(wall=wall, rounds=rounds,
                           observer=cost["observer"], gc=cost["gc"],
                           rest=wall - rounds - cost["observer"]
                           - cost["gc"],
                           round_median=_round_wall(km),
                           gc_gen2=cost["gc_gen2"])
                for k in keys:
                    arms[arm][k].append(row[k])
    finally:
        gc.callbacks.remove(on_gc)
        obs_pkg.FitObserver = plain
    med = {arm: {k: float(np.median(v)) for k, v in a.items()}
           for arm, a in arms.items()}
    u = med["untraced"]
    log(f"        medians of {OVERHEAD_PAIRS} fits an arm, untraced: wall "
        f"{u['wall']:.4f} s, rounds {u['rounds'] * 1e3:.1f} ms, rest "
        f"{u['rest'] * 1e3:.1f} ms, a round (work clock, without "
        f"round_end) {u['round_median'] * 1e3:.4f} ms")
    for arm in ("traced", "sink off"):
        t = med[arm]
        log(f"        {arm}: wall {t['wall']:.4f} s, {arm}/untraced "
            f"{t['wall'] / u['wall']:.4f} ({(t['wall'] - u['wall']) * 1e3:+.1f}"
            f" ms); " + "; ".join(
                f"{k} {t[k] * 1e3:.1f} ms ({(t[k] - u[k]) * 1e3:+.1f})"
                for k in ("rounds", "observer", "gc", "rest"))
            + f"; a round {t['round_median'] * 1e3:.4f} ms, "
            f"{t['round_median'] / u['round_median']:.4f}x (the JAX "
            f"package claims within 3 % on this clock, "
            f"benchmarks/obs_overhead.py); gen-2 collections "
            f"{t['gc_gen2']:.0f}")
    log(f"        the observer {med['traced']['observer'] / len(_round_ts(km)) * 1e3:.4f}"
        f" ms a round")
    # the sink's per-round lookup of new round keys at this process's
    # key count: a diff against a snapshot (what `round_end` did before
    # `tracecount.since`) against `since` a mark, 288 calls each
    snap, mark = tracecount.snapshot(), tracecount.mark()
    t0 = time.perf_counter()
    for _ in range(288):
        tracecount.diff(snap)
    t1 = time.perf_counter()
    for _ in range(288):
        tracecount.since(mark)
    t2 = time.perf_counter()
    log(f"        a round's key lookup at {mark[1]} keys: diff of a "
        f"snapshot {(t1 - t0) / 288 * 1e3:.4f} ms, since a mark "
        f"{(t2 - t1) / 288 * 1e3:.4f} ms")
    for arm in names:
        log(f"        {arm} fits (wall, rounds s): " + "; ".join(
            f"{w:.3f} {r:.3f}" for w, r in zip(arms[arm]["wall"],
                                               arms[arm]["rounds"])))


def obs_phase(X, Xv, untraced) -> dict:
    """Phase 10: tracing and the invariant checkers at phase 4's width.
    Returns the launch counts of the phase."""
    import logging
    import shutil
    import tempfile

    from repro_torch.analysis import donation, hostsync, retrace
    from repro_torch.api import FitConfig
    from repro_torch.data.store import write_store
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    log("[10] tracing and the invariant checkers on phase 4's rows and "
        "config")
    # the auditors log what they measured (buckets, peak memory)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("        %(message)s"))
    alog = logging.getLogger("repro_torch.analysis")
    alog.addHandler(handler)
    alog.setLevel(logging.INFO)
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    ops.reset_launch_counts()
    try:
        traced_fit(X, Xv, root, untraced)
        obs_overhead(X, Xv, root)
        cfg = FitConfig(k=K, **MAIN_CONFIG)
        found = hostsync.audit_backend(
            "local", X=X, X_val=Xv, config=cfg, device=DEV,
            trace_dir=os.path.join(root, "hostsync"))
        log(f"    (c) hostsync audit (warm-up fit, then the audited fit with "
            f"tracing on): {len(found)} violations {[str(v) for v in found]}")
        need(found == [], "the hostsync audit found synchronisations")
        planted = hostsync.selftest(device=DEV)
        log(f"        selftest: the planted per-round coercion flagged as "
            f"{[str(v) for v in planted]}")
        keys = {}
        found = retrace.audit_backend("local", X=X, config=cfg, device=DEV,
                                      stats=keys)
        log(f"    (d) retrace audit from empty counters: {len(found)} "
            f"violations {[str(v) for v in found]}; {keys}")
        need(found == [], "the retrace audit found violations")
        need(keys["keys"] == keys["buckets"] > 1,
             f"the fit's first-seen round keys are not its buckets: {keys}")
        path = os.path.join(root, "store")
        write_store(path, X, chunk_rows=STORE_CHUNK_ROWS)
        found = donation.scan() + donation.check_inplace(
            path, cfg, device=DEV)
        log(f"    (e) in-place check of a store fit ({STORE_CHUNK_ROWS}-row "
            f"chunks): {len(found)} violations {[str(v) for v in found]}")
        need(found == [], "the store fit's buffer was not filled in place")
        sharded_audits()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        alog.removeHandler(handler)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"    launches in phase 10: {launches}; phase 10 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 10")
    return launches


#: (f): the sharded backends the audits run on and the spawned ranks
AUDIT_BACKENDS = ("mesh", "xl", "multihost")
AUDIT_RANKS = 2


def _audit_report(what: str, ranks: list, one_rank: bool) -> None:
    """Log and hold what each rank's hostsync and retrace audits found on
    each backend of `AUDIT_BACKENDS` (`analysis.ranks.audit_rank`)."""
    for b in AUDIT_BACKENDS:
        hs = [r["hostsync"][b] for r in ranks]
        rt = [r["retrace"][b] for r in ranks]
        rounds = [st["rounds"] for _, st in hs]
        staged = [st["staged"] for _, st in hs]
        syncs = [st["staged_syncs"] for _, st in hs]
        log(f"        {what}, backend={b!r}: hostsync violations by rank "
            f"{[len(v) for v, _ in hs]} over rounds {rounds}; gloo "
            f"collectives of CUDA tensors in them {staged} "
            f"({[round(n / max(m, 1), 3) for n, m in zip(staged, rounds)]} a "
            f"round), syncs they made (sanctioned) {syncs} "
            f"({[round(n / max(m, 1), 3) for n, m in zip(syncs, rounds)]} a "
            f"round); retrace violations {[len(v) for v, _ in rt]}, round "
            f"calls {[st['calls'] for _, st in rt]}, first-seen keys "
            f"{[st['keys'] for _, st in rt]} over buckets "
            f"{[st['buckets'] for _, st in rt]}: {rt[0][1]['invoked']}")
        for v, _ in hs + rt:
            for x in v:
                log(f"            {x}")
        need(all(not v for v, _ in hs), f"{what}: the {b} hostsync audit "
             f"found unsanctioned synchronisations")
        need(all(not v for v, _ in rt), f"{what}: the {b} retrace audit "
             f"found violations")
        need(all(st["keys"] == st["buckets"] > 1 for _, st in rt),
             f"{what}: the {b} fit's first-seen keys are not its buckets")
        need(all(st["invoked"] == rt[0][1]["invoked"] for _, st in rt),
             f"{what}: the ranks' {b} fits invoked different buckets")
        if one_rank:
            need(staged == [0], f"{what}: the {b} audit opened the gloo "
                 f"staging scope {staged} times")


def sharded_audits() -> None:
    """(f): hostsync and retrace on the sharded backends (JAX's audit
    fits): one NCCL rank in this process, whose collectives are the
    identity, so the gloo staging scope must open 0 times; then
    `AUDIT_RANKS` spawned ranks, a gloo group on the one card, whose
    collectives stage through the host: 0 unsanctioned syncs, the
    sanctioned ones logged a round."""
    import torch.distributed as dist

    from repro_torch.analysis.ranks import (RANK_CHECKS, audit_rank,
                                            spawn_audits)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        backend = dist.get_backend()
        one = audit_rank(RANK_CHECKS, AUDIT_BACKENDS, device=DEV)
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    log(f"    (f) hostsync and retrace on {', '.join(AUDIT_BACKENDS)} (JAX's "
        f"audit fits: 2048 and 4096 x 8 rows, k=8), one {backend} rank, "
        f"{wall:.1f} s:")
    _audit_report(f"one {backend} rank", [one], one_rank=True)
    t0 = time.perf_counter()
    ranks = spawn_audits(RANK_CHECKS, AUDIT_BACKENDS, ranks=AUDIT_RANKS,
                         device=DEV)
    log(f"        {AUDIT_RANKS} spawned ranks, a gloo group on the card, "
        f"{time.perf_counter() - t0:.1f} s:")
    _audit_report(f"{AUDIT_RANKS} gloo ranks", ranks, one_rank=False)


# ---------------------------------------------------------------- phase 11

#: phase 11: the ranks of the spawned fits, the chunks of (c)'s store,
#: the deadline of the ranks' join, and the checkpoint interval of (d)
#: (phase 8's)
MESH_RANKS = 2
MESH_STORE_CHUNKS = 7
MESH_JOIN_S = 900.0
MESH_SAVE_EVERY = 25


#: the collectives the sharded rounds run, by their torch.distributed names
COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter_tensor",
                  "all_to_all_single")


def _xl_config(k, **kw):
    """Phase 4's config on ``backend="xl"`` at ``k``, ``kw`` over it."""
    from repro_torch.api import FitConfig
    return FitConfig(k=k, **dict(dict(MAIN_CONFIG, backend="xl"), **kw))


class _TimedCollectives:
    """Inside the block, each collective of `COLLECTIVES` is timed
    with the stream drained before it and after it, so that the timer
    sees the collective alone: ``spent[name] = [seconds, calls]``."""

    def __enter__(self):
        import torch.distributed as dist
        self._dist = dist
        self._orig = {name: getattr(dist, name) for name in COLLECTIVES}
        self.spent = {name: [0.0, 0] for name in COLLECTIVES}

        def timed(name, fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.spent[name][0] += time.perf_counter() - t0
                self.spent[name][1] += 1
                return out
            return call

        for name, fn in self._orig.items():
            setattr(dist, name, timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._dist, name, fn)


def _mesh_record(out, wall: float, counts: dict, **extra) -> dict:
    """What a rank keeps of a fit (a `FitOutcome`: the estimator's
    ``outcome_`` or `run_loop`'s), as arrays for ``np.savez``."""
    tel = [{k: v for k, v in r.to_dict().items() if k != "t"}
           for r in out.telemetry]
    return dict(C=out.C, labels=out.labels, tel=np.array(json.dumps(tel)),
                wall=np.float64(wall),
                rounds_s=np.float64(out.telemetry[-1].t),
                val=np.float64(out.final_mse),
                counts=np.array([counts[n] for n in REPLACES]),
                device=np.array(str(out.state.stats.C.device)),
                plan=np.array(out.kernel_plan["backend"]), **extra)


def mesh_rank(rank: int, world: int, root: str, addr: str) -> None:
    """One spawned rank of phase 11's (b)-(d): a gloo group whose ranks
    all compute on the one card (NCCL refuses two ranks on one card).
    Writes ``rank<r>_<fit>.npz`` under ``root``."""
    import shutil

    import torch.distributed as dist

    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    from repro_torch.data.store import ChunkStore
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    if not torch.cuda.is_available():
        raise Failure(f"rank {rank} sees no CUDA device")
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh((world,), ("data",))
        X = np.load(os.path.join(root, "X.npy"), mmap_mode="r")
        Xv = np.load(os.path.join(root, "Xv.npy"))

        def fit(tag, data=X, on_round=None, resume=False, extra=dict,
                **kw):
            cfg = FitConfig(k=K, backend="mesh", **dict(MAIN_CONFIG, **kw))
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km = NestedKMeans(cfg, mesh=mesh, device=DEV,
                              on_round=on_round)
            km.fit(data, X_val=Xv, resume=resume)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            np.savez(os.path.join(root, f"rank{rank}_{tag}.npz"),
                     **_mesh_record(km.outcome_, wall, ops.launch_counts(),
                                    **extra()))

        fit("b")
        # the repeat, with every all-reduce timed
        with _TimedCollectives() as timed:
            fit("b2", extra=lambda: dict(
                reduce_s=np.float64(timed.spent["all_reduce"][0]),
                n_reduce=np.int64(timed.spent["all_reduce"][1])))
        fit("ref", kernel_backend="ref")
        with ChunkStore(os.path.join(root, "store")) as st:
            fit("store", data=st, shuffle=False, extra=lambda: dict(
                bytes_read=np.int64(st.metrics.bytes_read)))
        ck = CheckpointConfig(checkpoint_dir=os.path.join(root, "ck"),
                              save_every=MESH_SAVE_EVERY)

        def kill(rec):
            if rec.round == KILL_ROUND:
                raise Killed

        try:
            fit("killed", on_round=kill, checkpoint=ck)
            raise Failure(f"the {world}-rank fit ended before round "
                          f"{KILL_ROUND}")
        except Killed:
            pass
        if rank == 0:
            shutil.copytree(os.path.join(root, "ck"),
                            os.path.join(root, "ck_killed"))
        dist.barrier()
        fit("resumed", resume=True, checkpoint=ck)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(root: str, fn=None, world: int = MESH_RANKS,
                 join_s: float = MESH_JOIN_S) -> None:
    """Runs ``fn`` (default `mesh_rank`) on ``world`` spawned ranks and
    waits for them; a rank that is still running at the deadline is
    killed."""
    from repro_torch.analysis.ranks import spawn_and_join
    fn = fn or mesh_rank
    spawn_and_join(fn, (world, root, f"tcp://localhost:{_free_port()}"),
                   world, join_s, fn.__name__)


def _rank_fits(root: str, tag: str, plan: str = "cuda",
               world: int = MESH_RANKS) -> list:
    """The ranks' records of one fit; every rank must have computed on
    the card with ``plan`` and hold the same C, labels and telemetry."""
    ranks = [dict(np.load(os.path.join(root, f"rank{r}_{tag}.npz")))
             for r in range(world)]
    for r in ranks:
        need(str(r["device"]).startswith("cuda") and str(r["plan"]) == plan,
             f"a rank of the {tag} fit computed on {r['device']} with the "
             f"{r['plan']} plan")
        for key in ("C", "labels", "tel"):
            need(np.array_equal(r[key], ranks[0][key]),
                 f"the ranks of the {tag} fit hold different {key}")
    return ranks


def _rank_record(rank: dict, labels_perm=None):
    """A rank's fit as `fit_record` gives one (C, labels, telemetry but
    ``t``); ``labels_perm`` maps its labels to the caller's rows."""
    import types

    from repro_torch.api.telemetry import Telemetry
    labels = rank["labels"]
    if labels_perm is not None:
        labels = np.empty_like(labels)
        labels[labels_perm] = rank["labels"]
    return types.SimpleNamespace(
        cluster_centers_=rank["C"], labels_=labels,
        telemetry_=[Telemetry.from_dict(dict(r, t=0.0))
                    for r in json.loads(str(rank["tel"]))])


def _parts_at(a, b):
    """The first round whose (b, n_recomputed) differ (None: none)."""
    ta = [r for r in a.telemetry_ if r.batch_mse is not None]
    tb = [r for r in b.telemetry_ if r.batch_mse is not None]
    return next((i for i, (u, v) in enumerate(zip(ta, tb))
                 if (u.b, u.n_recomputed) != (v.b, v.n_recomputed)),
                None if len(ta) == len(tb) else min(len(ta), len(tb)))


def _by_rank(ranks, key, scale=1.0, digits=3) -> list:
    return [round(float(r[key]) * scale, digits) for r in ranks]


def one_rank_fits(X, Xv, untraced, launches: dict) -> None:
    """(a): a one-process ``backend="multihost"`` fit, which joins a
    one-rank NCCL group from its coordinator fields, then a
    ``backend="mesh"`` fit over that group, each with ``predict`` and
    each bit-equal to phase 4's local fit."""
    import torch.distributed as dist

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.launch.mesh import make_host_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        for backend in ("multihost", "mesh"):
            if backend == "multihost":
                cfg = FitConfig(
                    k=K, backend=backend, num_processes=1, process_id=0,
                    coordinator_address=f"localhost:{_free_port()}",
                    **MAIN_CONFIG)
                mesh = None
            else:
                cfg = FitConfig(k=K, backend=backend, **MAIN_CONFIG)
                mesh = make_host_mesh((1,), ("data",))

            def fit_predict():
                km = NestedKMeans(cfg, mesh=mesh, device=DEV)
                km.fit(X, X_val=Xv)
                return km, km.predict(X)

            t0 = time.perf_counter()
            (km, labels), counts = _counted(launches, fit_predict)
            wall = time.perf_counter() - t0
            same = _same_fit(km, untraced)
            log(f"    (a) one-rank {backend} fit over "
                f"{dist.get_backend()} (world {dist.get_world_size()}) + "
                f"predict: wall {wall:.2f} s (rounds "
                f"{km.telemetry_[-1].t:.3f} s), {km.n_rounds_} records, "
                f"launches {counts}; C, labels and telemetry (but t) "
                f"bit-equal to phase 4's local fit: {same}; predict equals "
                f"the fit's labels on "
                f"{float((labels == km.labels_).mean()):.6f} of rows")
            need(dist.get_backend() == "nccl", f"the one-rank {backend} "
                 f"fit ran over {dist.get_backend()}, not NCCL")
            need(same, f"the one-rank {backend} fit differs from phase 4's "
                 f"local fit")
            for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
                need(counts[name] > 0, f"{name} was never launched in the "
                     f"one-rank {backend} fit")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_phase(X, Xv, untraced) -> dict:
    """Phase 11: the mesh and multihost engines on phase 4's rows.
    Returns the launch counts of the phase's fits, summed over its
    processes."""
    import shutil
    import tempfile

    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    from repro_torch.data.pipeline import nested_shard_layout
    from repro_torch.data.store import write_store
    t0 = time.perf_counter()
    log(f"[11] the mesh and multihost engines on phase 4's rows ({N}, "
        f"{D}), k={K}")
    launches = dict.fromkeys(REPLACES, 0)
    one_rank_fits(X, Xv, untraced, launches)
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        np.save(os.path.join(root, "X.npy"), X)
        np.save(os.path.join(root, "Xv.npy"), Xv)
        # (c)'s store holds the rows in (b)'s shuffle order, so its fit
        # with shuffle=False reads off the disk the row sequence of (b)
        perm = nested_shard_layout(N, MESH_RANKS,
                                   seed=MAIN_CONFIG["seed"]).perm
        write_store(os.path.join(root, "store"), X[perm],
                    chunk_rows=-(-N // MESH_STORE_CHUNKS))
        t1 = time.perf_counter()
        _spawn_ranks(root)
        log(f"    (b)-(d): {MESH_RANKS} spawned ranks, a gloo group on one "
            f"card, {N // MESH_RANKS} rows a rank: "
            f"{time.perf_counter() - t1:.1f} s in all, the processes' "
            f"start included")
        fits = {tag: _rank_fits(root, tag, "ref" if tag == "ref" else "cuda")
                for tag in ("b", "b2", "ref", "store", "resumed")}
        for ranks in fits.values():
            for r in ranks:
                for name, n in zip(REPLACES, r["counts"]):
                    launches[name] += int(n)
        b, b2 = fits["b"], fits["b2"]
        rec_b = _rank_record(b[0])
        tel = [r for r in rec_b.telemetry_ if r.batch_mse is not None]
        one = [r for r in untraced.telemetry_ if r.batch_mse is not None]
        log(f"    (b) {MESH_RANKS}-rank fit: {len(tel)} rounds (one rank: "
            f"{len(one)}), sum n_recomputed "
            f"{sum(r.n_recomputed for r in tel)} (one rank: "
            f"{sum(r.n_recomputed for r in one)}), final val MSE "
            f"{float(b[0]['val'])!r} (one rank: "
            f"{untraced.telemetry_[-1].val_mse!r}); wall by rank "
            f"{_by_rank(b, 'wall')} s, rounds {_by_rank(b, 'rounds_s')} s; "
            f"launches by rank "
            f"{[dict(zip(REPLACES, map(int, r['counts']))) for r in b]}")
        log(f"        the {MESH_RANKS}-rank and one-rank schedules part at "
            f"round {_parts_at(rec_b, untraced)}")
        for r in b:
            for name, n in zip(REPLACES, r["counts"]):
                need(name == "fused_round" or n > 0, f"{name} was never "
                     f"launched on a rank of the {MESH_RANKS}-rank fit")
        Xd = torch.from_numpy(X).to(DEV)
        ties, nearer, gap = _near_ties(
            Xd, torch.from_numpy(b[0]["C"]).to(DEV),
            torch.from_numpy(b[0]["labels"]).to(DEV),
            torch.from_numpy(untraced.labels_).to(DEV))
        del Xd
        log(f"        labels differ from the one-rank fit's at {ties} rows, "
            f"each a near-tie under the {MESH_RANKS}-rank C (largest "
            f"float64 gap {gap:.3g} relative; the {MESH_RANKS}-rank label "
            f"the nearer at {nearer})")
        same = _same_fit(_rank_record(b2[0]), rec_b)
        log(f"        second {MESH_RANKS}-rank fit, each all-reduce timed "
            f"(the stream drained before it): bit-identical to the first: "
            f"{same}; {int(b2[0]['n_reduce'])} all-reduces a rank, "
            f"{_by_rank(b2, 'reduce_s', 1e3, 1)} ms of the walls "
            f"{_by_rank(b2, 'wall')} s ("
            f"{[round(100 * float(r['reduce_s'] / r['wall']), 2) for r in b2]}"
            f" %)")
        need(same, f"a second {MESH_RANKS}-rank fit is not bit-identical")
        ref = fits["ref"][0]
        rel = abs(float(ref["val"]) - float(b[0]["val"])) / float(ref["val"])
        log(f"        {MESH_RANKS}-rank fit on the ref plan: val MSE "
            f"{float(ref['val'])!r}, relative gap {rel:.3g} (held to 1e-3), "
            f"wall {float(ref['wall']):.2f} s")
        need(rel <= 1e-3, f"the {MESH_RANKS}-rank cuda and ref fits differ "
             f"in val MSE beyond 1e-3")
        st = fits["store"]
        read = [int(r["bytes_read"]) for r in st]
        same = _same_fit(_rank_record(st[0], labels_perm=perm), rec_b)
        log(f"    (c) {MESH_RANKS}-rank fit from a {MESH_STORE_CHUNKS}-chunk "
            f"store of the rows in (b)'s order (shuffle=False): wall by rank "
            f"{_by_rank(st, 'wall')} s; bytes read by rank {read} = "
            f"{[round(x / X.nbytes, 3) for x in read]} of one pass "
            f"({sum(read) / X.nbytes:.3f} in all); C, labels and telemetry "
            f"(but t) bit-equal to (b): {same}")
        need(same, f"the {MESH_RANKS}-rank store fit differs from (b)")
        res = fits["resumed"]
        same = _same_fit(_rank_record(res[0]), rec_b)
        saved = KILL_ROUND // MESH_SAVE_EVERY * MESH_SAVE_EVERY
        log(f"    (d) {MESH_RANKS}-rank fit checkpointed every "
            f"{MESH_SAVE_EVERY} rounds, killed at round {KILL_ROUND}, resumed"
            f" from round {saved} on {MESH_RANKS} ranks: wall "
            f"{float(res[0]['wall']):.2f} s, launches by rank "
            f"{[dict(zip(REPLACES, map(int, r['counts']))) for r in res]}; "
            f"bit-equal to (b): {same}")
        need(same, f"the resumed {MESH_RANKS}-rank fit differs from (b)")
        for r in res:
            for name in ("assign_top2", "cluster_sum"):
                need(int(r["counts"][list(REPLACES).index(name)]) > 0,
                     f"{name} was never launched in the resumed fit")
        ck = CheckpointConfig(checkpoint_dir=os.path.join(root, "ck_killed"),
                              save_every=MESH_SAVE_EVERY)
        t1 = time.perf_counter()
        km, counts = _counted(launches, lambda: NestedKMeans(
            FitConfig(k=K, checkpoint=ck, **MAIN_CONFIG), device=DEV).fit(
            X, X_val=Xv, resume=True))
        wall = time.perf_counter() - t1
        rel = abs(km.final_mse_ - float(b[0]["val"])) / float(b[0]["val"])
        log(f"        the same checkpoint resumed on the local engine: wall "
            f"{wall:.2f} s, {km.n_rounds_} records, final val MSE "
            f"{km.final_mse_!r} (relative gap to (b) {rel:.3g}), launches "
            f"{counts}; its schedule parts from (b)'s at round "
            f"{_parts_at(km, rec_b)} and from phase 4's at round "
            f"{_parts_at(km, untraced)}")
        log("        its schedule from the resume (b:n_recomputed): "
            + " ".join(f"{r.b}:{r.n_recomputed}"
                       for r in km.telemetry_[saved:]
                       if r.batch_mse is not None))
        need(km.labels_.min() >= 0, "the local resume left rows unlabelled")
        for name in ("assign_top2", "cluster_sum"):
            need(counts[name] > 0, f"{name} was never launched in the local "
                 f"resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"    launches in phase 11 (every process): {launches}; phase 11 "
        f"took {time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 11")
    return launches


# ---------------------------------------------------------------- phase 12

#: phase 12 at kmeans_xl width, (b) and (c): the rows and validation rows
#: made on the card, the first batch and the round cap (the cuts), and
#: the rows the kernels are checked on; (c) and (d)'s model ranks, the
#: degenerate ring's ranks and k, and the deadline of the ranks' join
XL_FIT_N, XL_FIT_NVAL = 2 ** 20, 2 ** 14
XL_FIT_B0, XL_FIT_ROUNDS = 2 ** 16, 40
XL_KERNEL_ROWS = 65_536
XL_RANKS, XL_RING_RANKS, XL_RING_K = 2, 4, 8
#: (d)'s shadowed families stop at this round (a cut: each shadowed round
#: runs two steps)
XL_SHADOW_ROUNDS = 200
XL_JOIN_S = 600.0

def xl_shadow(mesh, rank: int, root: str, tag: str, X, Xv, k: int,
              bounds: str, **kw) -> None:
    """A shadowed XL fit on this rank (phase 7's `shadow_bounds` on the
    ranks): each round's step is also taken with ``bounds="none"`` from
    the same state, and a label may differ from that step's only at a
    near-tie (float64 distances to the two centroids within 1e-3
    relative, under the whole C); ``kw`` goes over the config. Writes
    ``rank<r>_<tag>.npz``."""
    from repro_torch.api.engines.xl import XLEngine
    from repro_torch.api.loop import run_loop
    from repro_torch.core.distributed_xl import make_xl_nested_round
    from repro_torch.kernels import ops
    cfg = _xl_config(k, bounds=bounds, **kw).resolve(len(X))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = XLEngine(mesh).begin(X, cfg, X_val=Xv, device=DEV)
    step = run.nested_step
    seen = {"steps": 0, "rows": 0, "worst": 0, "top": 0.0}

    def both(state, b, capacity):
        out = step(state, b, capacity)
        alt = make_xl_nested_round(
            mesh, cfg.data_axes, model_axis=cfg.model_axis, b_local=b,
            rho=cfg.rho, bounds="none", capacity=capacity,
            use_shalf=cfg.use_shalf, n_real=run._n_real,
            plan=run.kernel_plan)(run._Xd, state)
        rows, _, gap = _near_ties(run._Xd[:b], run.fetch_stats(state).C,
                                  out[0].points.a[:b], alt[0].points.a[:b])
        seen["steps"] += 1
        seen["rows"] += rows
        seen["worst"] = max(seen["worst"], rows)
        seen["top"] = max(seen["top"], gap)
        return out

    run.nested_step = both
    out = run_loop(run, cfg)
    del run.nested_step       # the cycle run -> both -> run holds X
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pairs = sum(r.n_recomputed for r in out.telemetry
                if r.batch_mse is not None)
    np.savez(os.path.join(root, f"rank{rank}_{tag}.npz"),
             **_mesh_record(out, wall, ops.launch_counts(),
                               pairs=np.int64(pairs),
                               shadow=np.array([seen["steps"], seen["rows"],
                                                seen["worst"]]),
                               top=np.float64(seen["top"]),
                               peak=np.float64(
                                   torch.cuda.max_memory_allocated())))


def xl_rank(rank: int, world: int, root: str, addr: str) -> None:
    """One spawned rank of phase 12: a gloo ``(data=1, model=world)``
    group whose ranks all compute on the one card (NCCL refuses two ranks
    on one card). On `XL_RANKS` ranks, (c) at kmeans_xl width and then
    (d) on phase 4's rows; on `XL_RING_RANKS`, (d)'s degenerate exponion
    ring. Writes ``rank<r>_<fit>.npz`` under ``root``."""
    import shutil

    import torch.distributed as dist

    from repro_torch.api import CheckpointConfig, NestedKMeans
    from repro_torch.data.store import ChunkStore
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    if not torch.cuda.is_available():
        raise Failure(f"rank {rank} sees no CUDA device")
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh((1, world), ("data", "model"))

        def load(name, mmap_mode="r"):
            return np.load(os.path.join(root, f"{name}.npy"),
                           mmap_mode=mmap_mode)

        def fit(tag, X, Xv, k, on_round=None, resume=False, extra=dict,
                **kw):
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km = NestedKMeans(_xl_config(k, **kw), mesh=mesh, device=DEV,
                              on_round=on_round)
            km.fit(X, X_val=Xv, resume=resume)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            np.savez(os.path.join(root, f"rank{rank}_{tag}.npz"),
                     **_mesh_record(km.outcome_, wall, ops.launch_counts(),
                                    peak=np.float64(
                                        torch.cuda.max_memory_allocated()),
                                    **extra()))

        if world == XL_RING_RANKS:
            xl_shadow(mesh, rank, root, "ring", load("X"), load("Xv", None),
                      XL_RING_K, "exponion")
            return
        Xb, Xvb = load("Xb"), load("Xvb", None)
        kw = dict(b0=XL_FIT_B0, max_rounds=XL_FIT_ROUNDS)
        fit("c", Xb, Xvb, K_XL, **kw)
        with _TimedCollectives() as timed:
            fit("c2", Xb, Xvb, K_XL, extra=lambda: dict(
                **{f"coll_{name}_s": np.float64(v[0])
                   for name, v in timed.spent.items()},
                **{f"coll_{name}_n": np.int64(v[1])
                   for name, v in timed.spent.items()}), **kw)
        fit("c_ref", Xb, Xvb, K_XL, kernel_backend="ref", **kw)
        del Xb, Xvb
        torch.cuda.empty_cache()

        X, Xv = load("X"), load("Xv", None)
        fit("d", X, Xv, K)
        for bounds in ("elkan", "exponion"):
            xl_shadow(mesh, rank, root, f"d_{bounds}", X, Xv, K, bounds,
                      max_rounds=XL_SHADOW_ROUNDS)
        with ChunkStore(os.path.join(root, "store")) as st:
            fit("d_store", st, Xv, K, shuffle=False, extra=lambda: dict(
                bytes_read=np.int64(st.metrics.bytes_read)))
        ck = CheckpointConfig(checkpoint_dir=os.path.join(root, "ck"),
                              save_every=MESH_SAVE_EVERY)

        def kill(rec):
            if rec.round == KILL_ROUND:
                raise Killed

        try:
            fit("d_killed", X, Xv, K, on_round=kill, checkpoint=ck)
            raise Failure(f"the {world}-rank XL fit ended before round "
                          f"{KILL_ROUND}")
        except Killed:
            pass
        if rank == 0:
            shutil.copytree(os.path.join(root, "ck"),
                            os.path.join(root, "ck_killed"))
        dist.barrier()
        fit("d_resumed", X, Xv, K, resume=True, checkpoint=ck)
    finally:
        dist.destroy_process_group()


def _max_err(got, want):
    """The largest |got - want| over pairs of tensors, and the largest
    over max(|want|, 1)."""
    e = rel = 0.0
    for g, w in zip(got, want):
        err = torch.where(g == w, 0.0, (g - w).abs())
        e = max(e, float(err.max()))
        rel = max(rel, float((err / w.abs().clamp_min(1.0)).max()))
    return e, rel


def check_wide_kernels(x, C, ks, smi: str) -> None:
    """Kernels 1-3 on ``x``'s rows at each k of ``ks`` (the first k rows
    of ``C``), at a wide d: kmeans_xl's (phase 12) or tinyllama's
    embedding table (phase 13). Kernels 1 and 3 are held as phase 6
    holds kernel 4: d1 and d2 within FULL_RTOL of the
    scale |x|^2 + max |c|^2 of the top-2 of the ref expression with x.c,
    |x|^2 and |c|^2 taken in float64 and rounded once
    (`check_full_oracle`; the plain version's f32 product is ~0.1 off d1
    at kmeans_xl width, and its gap is logged), and labels equal but at
    ties within 100x f32's rtol 1e-5 of the distance (the lower index
    wins a tie). The ref expression resolves d1 only to a few f32 ulps of
    the scale (at kmeans_xl width d1 ~ 2e3 against ~5e4), so the largest
    error relative to d1 is logged, not held. Kernel 2 sums the rows by
    kernel 1's labels with +1/0/-1 weights (`_delta_sv_xl`'s adds and
    removes), held as phase 3 holds it: within rtol 1e-5 of each sum's
    L1 mass of the plain sums, and bit for bit to the order oracle.
    Kernel 3's passed-through rows keep their bits, its sums match plain
    sums over its own labels (rtol 1e-4 of their L1 mass) and the order
    oracle bit for bit. Each kernel gives the same bits twice and is
    timed (CUDA events, mean of 10) beside its plain version and its
    bound (kernel 2 also beside `index_add_`)."""
    from repro_torch.kernels import (cluster_sum, fused_round,
                                     kmeans_assign, ref)
    n, d = x.shape
    for k in ks:
        c = C[:k].contiguous()
        want = assign_top2_exact(x, c)
        pd = ref.pairwise_dist2(x, c)
        got = kmeans_assign.assign_top2_cuda(x, c)
        torch.cuda.synchronize()
        ties = _labels_ok(got[0], want[0], pd, TOL["f32"], relative=True)
        e, rel = _max_err(got[1:], want[1:])
        gap, plain_gap = check_full_oracle(
            *got, x, c, "assign_top2", plain=ref.assign_top2_ref(x, c)[1])
        need(same_bits(kmeans_assign.assign_top2_cuda(x, c), got),
             "assign_top2 is not deterministic")
        k_pad = 64 if k <= 64 else -(-k // 128) * 128
        tc_ops = 3 * 2.0 * n * k_pad * d
        b1, how1 = bound(n * d * 4 + k * d * 4 + n * 12, 0.0,
                         tf32_flops=tc_ops)
        ms1 = time_ms(lambda: kmeans_assign.assign_top2_cuda(x, c))
        plain1 = time_ms(lambda: ref.assign_top2_ref(x, c))
        log(f"    assign_top2 n={n} d={d} k={k}: max abs err {e:.3g} from "
            f"the once-rounded float64 top-2 ({rel:.3g} of the distance), "
            f"{gap:.3g} of the scale (held to {FULL_RTOL:g}; the plain f32 "
            f"product {plain_gap:.3g}), tied labels {ties}, second run "
            f"bit-identical; {ms1:.3f} ms, plain {plain1:.3f} ms, bound "
            f"{b1:.3f} ms ({how1}), {b1 / ms1 * 100:.1f} % of it ({smi})")

        a, w = got[0], _weights(n, k)
        S, v = cluster_sum.cluster_sum_cuda(x, a, k, weights=w)
        torch.cuda.synchronize()
        S_r, v_r = ref.cluster_sum_ref(x, a, k, weights=w)
        mass, vmass = ref.cluster_sum_ref(x.abs(), a, k, weights=w.abs())
        e2 = max(_mass_close(S, S_r, mass, "S"),
                 _mass_close(v, v_r, vmass, "v"))
        need(same_bits(cluster_sum.cluster_sum_cuda(x, a, k, weights=w),
                       (S, v)), "cluster_sum is not deterministic")
        need(same_bits((S, v), ref.ordered_sums(x, k, a, w)),
             "cluster_sum differs from the order oracle")
        nz = int((w != 0).sum())
        b2, how2 = bound(nz * d * 4 + n * 8 + (k * d + k) * 4,
                         2.0 * nz * d)
        ms2 = time_ms(lambda: cluster_sum.cluster_sum_cuda(x, a, k,
                                                           weights=w))
        plain2 = time_ms(lambda: ref.cluster_sum_ref(x, a, k, weights=w))
        a64, xw = a.long(), x * w[:, None]
        S0 = torch.zeros(k, d, device=DEV)
        lib2 = time_ms(lambda: S0.index_add_(0, a64, xw))
        log(f"    cluster_sum n={n} d={d} k={k} (kernel 1's labels, +1/0/-1"
            f" weights): max abs err {e2:.3g} (held to 1e-5 of the L1 "
            f"mass), second run and the order oracle bit-identical; "
            f"{ms2:.3f} ms, plain {plain2:.3f} ms, index_add_ {lib2:.3f} "
            f"ms, bound {b2:.3f} ms ({how2}), {b2 / ms2 * 100:.1f} % of it "
            f"({smi})")
        del S, v, S_r, v_r, mass, vmass, a64, xw, S0

        args = [x, c] + _nested_inputs(n, 1, k)[2:]
        a_prev, settled, d_keep, lb_keep, valid = args[2:]
        got = fused_round.fused_nested_round_cuda(*args)
        torch.cuda.synchronize()
        rows = valid & ~settled
        keep = valid & settled
        need(bool((got[0][~valid] == -1).all())
             and torch.equal(got[0][keep], a_prev[keep])
             and torch.equal(got[1][keep], d_keep[keep])
             and torch.equal(got[2][keep], lb_keep[keep]),
             "fused_nested_round: invalid or settled rows not as given")
        ties = _labels_ok(got[0][rows], want[0][rows], pd[rows], TOL["f32"],
                          relative=True)
        e, rel = _max_err((got[1][rows] ** 2, got[2][rows] ** 2),
                          (want[1][rows], want[2][rows]))
        gap, _ = check_full_oracle(got[0][rows], got[1][rows], got[2][rows],
                                   x[rows], c, "fused_nested_round",
                                   squared=False)
        sums = fused_round.delta_sums(x, a_prev, got[0], got[1], k)
        new, old = got[0].clamp(0, k - 1), a_prev.clamp(0, k - 1)
        mass = (ref.cluster_sum_ref(x.abs(), new, k)[0]
                + ref.cluster_sum_ref(x.abs(), old, k)[0],
                ref.cluster_sum_ref(x[:, :0], new, k)[1]
                + ref.cluster_sum_ref(x[:, :0], old, k)[1], sums[2])
        e_sums = max(_mass_close(g, w, m, what, rtol=1e-4) for g, w, m, what
                     in zip(got[3:], sums, mass, ("dS", "dv", "sse")))
        need(same_bits(fused_round.fused_nested_round_cuda(*args), got),
             "fused_nested_round is not deterministic")
        need(same_bits(got[3:], ref.ordered_sums(
            x, k, a_prev=a_prev, a_new=got[0], d_new=got[1])),
            "fused_nested_round's sums differ from the order oracle")
        moved = int((((a_prev < 0) & (got[0] >= 0))
                     | ((a_prev >= 0) & (got[0] != a_prev))).sum())
        b3, how3 = bound(n * d * 4 + k * d * 4 + n * (14 + 12)
                         + (k * d + 2 * k) * 4, 2.0 * moved * d,
                         tf32_flops=tc_ops)
        ms3 = time_ms(lambda: fused_round.fused_nested_round_cuda(*args))
        plain3 = time_ms(lambda: fused_round.fused_nested_round_ref(*args))
        log(f"    fused_nested_round n={n} d={d} k={k} "
            f"({int(rows.sum())} rows recomputed): max abs err {e:.3g} "
            f"(squared distances from the once-rounded float64 top-2: "
            f"{rel:.3g} of the distance; the sums {e_sums:.3g}, held to "
            f"1e-4 of their mass), "
            f"{gap:.3g} of the scale from the float64 oracle (held to "
            f"{FULL_RTOL:g}), tied labels {ties}, second run and the order "
            f"oracle "
            f"bit-identical; {ms3:.3f} ms, plain {plain3:.3f} ms, bound "
            f"{b3:.3f} ms ({how3}), {b3 / ms3 * 100:.1f} % of it ({smi})")
        del pd, want, got, sums, mass


def xl_one_rank(X, Xv, untraced, launches: dict, smi: str):
    """(a) and (b) over a one-rank NCCL ``(data=1, model=1)`` group.
    Returns (b)'s rows and validation rows on the host and its fit."""
    import torch.distributed as dist

    from repro_torch.api import NestedKMeans
    from repro_torch.launch.mesh import make_host_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"))
        need(dist.get_backend() == "nccl", "the one-rank group is not NCCL")

        def fit_predict():
            km = NestedKMeans(_xl_config(K), mesh=mesh, device=DEV)
            km.fit(X, X_val=Xv)
            return km, km.predict(X)

        t0 = time.perf_counter()
        (km, labels), counts = _counted(launches, fit_predict)
        wall = time.perf_counter() - t0
        same = _same_fit(km, untraced)
        log(f"    (a) one-rank NCCL (1, 1) XL fit of phase 4's rows + "
            f"predict: wall {wall:.2f} s (rounds {km.telemetry_[-1].t:.3f}"
            f" s), {km.n_rounds_} records, launches {counts}; C, labels and"
            f" telemetry (but t) bit-equal to phase 4's local fit: {same}; "
            f"predict equals the fit's labels on "
            f"{float((labels == km.labels_).mean()):.6f} of rows")
        need(same, "the one-rank XL fit differs from phase 4's local fit")
        for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
            need(counts[name] > 0, f"{name} was never launched in the "
                 f"one-rank XL fit")

        Xg = xl_data(seed=1, n=XL_FIT_N + XL_FIT_NVAL)[0]
        Xb, Xvb = Xg[:XL_FIT_N].cpu().numpy(), Xg[XL_FIT_N:].cpu().numpy()
        xk = Xg[:XL_KERNEL_ROWS].clone()
        del Xg
        torch.cuda.empty_cache()
        log(f"    (b) kmeans_xl width: d={D_XL}, k={K_XL}, tb, hamerly2, "
            f"rho=inf, the cuda plan, on {XL_FIT_N} blob rows made on the "
            f"card with phase 6's recipe (+{XL_FIT_NVAL} validation rows). "
            f"Cuts: n is one chip's share cut further ({N_XL} in phase 6) so"
            f" that each of (c)'s two processes holds a whole replica of X "
            f"beside the plain Hamerly step's (b, d) temporaries; b0="
            f"{XL_FIT_B0} and at most {XL_FIT_ROUNDS} rounds keep the phase "
            f"short")
        fits = {}
        for backend in ("xl", "local"):
            cfg = _xl_config(K_XL, backend=backend, b0=XL_FIT_B0,
                             max_rounds=XL_FIT_ROUNDS)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            km, counts = _counted(launches, lambda: NestedKMeans(
                cfg, mesh=mesh if backend == "xl" else None,
                device=DEV).fit(Xb, X_val=Xvb))
            wall = time.perf_counter() - t0
            tel = [r for r in km.telemetry_ if r.batch_mse is not None]
            log(f"        {backend} fit: {len(tel)} rounds, final b "
                f"{km.telemetry_[-1].b}, sum n_recomputed "
                f"{sum(r.n_recomputed for r in tel)}, converged "
                f"{km.converged_}, final val MSE {km.final_mse_!r}, wall "
                f"{wall:.2f} s (rounds {km.telemetry_[-1].t:.3f} s), peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                f"launches {counts}")
            fits[backend] = km
        same = _same_fit(fits["xl"], fits["local"])
        log(f"        the one-rank NCCL XL fit bit-equal to the local fit "
            f"(C, labels, telemetry but t): {same}")
        need(same, "the one-rank XL fit at kmeans_xl width differs from "
             "the local fit")
        C = torch.from_numpy(fits["xl"].cluster_centers_).to(DEV)
        need(C.shape == (K_XL, D_XL) and bool(torch.isfinite(C).all()),
             "(b)'s centroids are not finite (k, d)")
        check_wide_kernels(xk, C, (K_XL // XL_RANKS, K_XL), smi)
        return Xb, Xvb, fit_record(fits["xl"])
    finally:
        dist.destroy_process_group()


def xl_engine_phase(X, Xv, untraced, smi: str) -> dict:
    """Phase 12: the XL engine. Returns the launch counts of the phase's
    fits, summed over its processes."""
    import shutil
    import tempfile

    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    from repro_torch.data.pipeline import nested_shard_layout
    from repro_torch.data.store import write_store
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[12] the XL engine (centroids sharded over the model dim); "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held on the "
        f"card after phase 6's X and the caches were freed")
    launches = dict.fromkeys(REPLACES, 0)
    Xb, Xvb, rec_b = xl_one_rank(X, Xv, untraced, launches, smi)
    root = tempfile.mkdtemp(prefix="chip_smoke_xl_")
    try:
        for name, arr in (("Xb", Xb), ("Xvb", Xvb), ("X", X), ("Xv", Xv)):
            np.save(os.path.join(root, f"{name}.npy"), arr)
        # (d)'s store holds phase 4's rows in the (1, m) layout's order
        perm = nested_shard_layout(N, 1, seed=MAIN_CONFIG["seed"]).perm
        write_store(os.path.join(root, "store"), X[perm],
                    chunk_rows=-(-N // MESH_STORE_CHUNKS))
        t1 = time.perf_counter()
        _spawn_ranks(root, xl_rank, XL_RANKS, XL_JOIN_S)
        log(f"    (c)-(d): {XL_RANKS} spawned ranks, a gloo (data=1, model="
            f"{XL_RANKS}) group on one card: {time.perf_counter() - t1:.1f} "
            f"s in all, the processes' start included")
        fits = {tag: _rank_fits(root, tag, "ref" if tag == "c_ref"
                                else "cuda", XL_RANKS)
                for tag in ("c", "c2", "c_ref", "d", "d_elkan",
                            "d_exponion", "d_store", "d_resumed")}
        for ranks in fits.values():
            for r in ranks:
                for name, n in zip(REPLACES, r["counts"]):
                    launches[name] += int(n)

        c = fits["c"]
        rec_c = _rank_record(c[0])
        tel = [r for r in rec_c.telemetry_ if r.batch_mse is not None]
        one = [r for r in rec_b.telemetry_ if r.batch_mse is not None]
        log(f"    (c) {XL_RANKS} model ranks at kmeans_xl width (k_local="
            f"{K_XL // XL_RANKS}): {len(tel)} rounds (one rank: {len(one)}),"
            f" final b {rec_c.telemetry_[-1].b} (one rank: "
            f"{rec_b.telemetry_[-1].b}), sum n_recomputed "
            f"{sum(r.n_recomputed for r in tel)} (one rank: "
            f"{sum(r.n_recomputed for r in one)}), final val MSE "
            f"{float(c[0]['val'])!r} (one rank: "
            f"{rec_b.telemetry_[-1].val_mse!r}); wall by rank "
            f"{_by_rank(c, 'wall')} s, rounds {_by_rank(c, 'rounds_s')} s, "
            f"peak by rank {_by_rank(c, 'peak', 2 ** -30, 2)} GiB; launches "
            f"by rank "
            f"{[dict(zip(REPLACES, map(int, r['counts']))) for r in c]}")
        log(f"        the {XL_RANKS}-rank and one-rank schedules part at "
            f"round {_parts_at(rec_c, rec_b)}")
        for r in c:
            for name in ("assign_top2", "cluster_sum"):
                need(int(r["counts"][list(REPLACES).index(name)]) > 0,
                     f"{name} was never launched on a rank of (c)")
        a_c = torch.from_numpy(c[0]["labels"])
        a_b = torch.from_numpy(rec_b.labels_)
        both = (a_c >= 0) & (a_b >= 0)
        one_only = int(((a_c >= 0) != (a_b >= 0)).sum())
        # on the host: the rows that differ are few
        ties, nearer, gap = _near_ties(
            torch.from_numpy(Xb), torch.from_numpy(c[0]["C"]),
            torch.where(both, a_c, 0), torch.where(both, a_b, 0))
        log(f"        labels differ from (b)'s at {ties} of the "
            f"{int(both.sum())} rows both label, each a near-tie under "
            f"the {XL_RANKS}-rank C "
            f"(largest float64 gap {gap:.3g} relative; the {XL_RANKS}-rank "
            f"label the nearer at {nearer}); rows one labels and the other "
            f"not: {one_only}")
        need(one_only == 0, "(b) and (c) label different rows")
        rel_b = abs(float(c[0]["val"]) - rec_b.telemetry_[-1].val_mse) \
            / rec_b.telemetry_[-1].val_mse
        ref = fits["c_ref"][0]
        rel_ref = abs(float(ref["val"]) - float(c[0]["val"])) \
            / float(ref["val"])
        log(f"        val MSE relative gap to (b) {rel_b:.3g} (held to "
            f"1e-4); on the ref plan {float(ref['val'])!r}, relative gap "
            f"{rel_ref:.3g} (held to 1e-3), wall {float(ref['wall']):.2f} s")
        need(rel_b <= 1e-4, "(c)'s val MSE differs from (b)'s beyond 1e-4")
        need(rel_ref <= 1e-3, "(c)'s cuda and ref fits differ in val MSE "
             "beyond 1e-3")
        c2 = fits["c2"]
        same = _same_fit(_rank_record(c2[0]), rec_c)
        log(f"        second {XL_RANKS}-rank fit, each collective timed (the "
            f"stream drained before and after it): bit-identical to the "
            f"first: {same}; wall by rank {_by_rank(c2, 'wall')} s; "
            + "; ".join(
                f"{name} {_by_rank(c2, f'coll_{name}_s', 1e3, 1)} ms in "
                f"{int(c2[0][f'coll_{name}_n'])} calls a rank"
                for name in COLLECTIVES))
        need(same, f"a second {XL_RANKS}-rank XL fit is not bit-identical")

        d = fits["d"]
        rec_d = _rank_record(d[0])
        tel = [r for r in rec_d.telemetry_ if r.batch_mse is not None]
        log(f"    (d) {XL_RANKS} model ranks on phase 4's rows (k={K}, "
            f"k_local={K // XL_RANKS}): {len(tel)} rounds, sum n_recomputed "
            f"{sum(r.n_recomputed for r in tel)}, final val MSE "
            f"{float(d[0]['val'])!r} (phase 4: "
            f"{untraced.telemetry_[-1].val_mse!r}), parts from phase 4's "
            f"schedule at round {_parts_at(rec_d, untraced)}; wall by rank "
            f"{_by_rank(d, 'wall')} s, peak by rank "
            f"{_by_rank(d, 'peak', 2 ** -30, 2)} GiB")
        for bounds in ("elkan", "exponion"):
            sh = fits[f"d_{bounds}"]
            steps, rows, worst = (int(v) for v in sh[0]["shadow"])
            log(f"        tb-{bounds}, shadowed (each round's step also with"
                f" bounds='none' from the same state), at most "
                f"{XL_SHADOW_ROUNDS} rounds: {steps} steps, "
                f"{int(sh[0]['pairs'])} pairs computed, final val MSE "
                f"{float(sh[0]['val'])!r}, wall by rank "
                f"{_by_rank(sh, 'wall')} s; labels differ from the 'none' "
                f"step at {rows} rows in all (at most {worst} in a step), "
                f"each a near-tie (largest float64 gap "
                f"{float(sh[0]['top']):.3g} relative)")
            need(sh[0]["labels"].min() >= 0,
                 f"the tb-{bounds} XL fit left rows unlabelled")
        st = fits["d_store"]
        same = _same_fit(_rank_record(st[0], labels_perm=perm), rec_d)
        read = [int(r["bytes_read"]) for r in st]
        log(f"        from a {MESH_STORE_CHUNKS}-chunk store of the rows in "
            f"the layout's order (shuffle=False): bytes read by rank {read} "
            f"= {[round(x / X.nbytes, 3) for x in read]} of one pass; C, "
            f"labels and telemetry (but t) bit-equal to the in-memory fit: "
            f"{same}")
        need(same, "the XL store fit differs from the in-memory XL fit")
        res = fits["d_resumed"]
        same = _same_fit(_rank_record(res[0]), rec_d)
        saved = KILL_ROUND // MESH_SAVE_EVERY * MESH_SAVE_EVERY
        log(f"        checkpointed every {MESH_SAVE_EVERY} rounds, killed at "
            f"round {KILL_ROUND}, resumed from round {saved} on the "
            f"{XL_RANKS} ranks: launches by rank "
            f"{[dict(zip(REPLACES, map(int, r['counts']))) for r in res]};"
            f" bit-equal to the unbroken fit: {same}")
        need(same, "the resumed XL fit differs from the unbroken fit")
        ck = CheckpointConfig(checkpoint_dir=os.path.join(root, "ck_killed"),
                              save_every=MESH_SAVE_EVERY)
        km, counts = _counted(launches, lambda: NestedKMeans(
            FitConfig(k=K, checkpoint=ck, **MAIN_CONFIG), device=DEV).fit(
            X, X_val=Xv, resume=True))
        rel = abs(km.final_mse_ - float(d[0]["val"])) / float(d[0]["val"])
        log(f"        the same XL checkpoint resumed on the local engine: "
            f"{km.n_rounds_} records, converged {km.converged_}, final val "
            f"MSE {km.final_mse_!r} (relative gap to the XL fit's {rel:.3g}),"
            f" launches {counts}")
        need(km.labels_.min() >= 0, "the local resume left rows unlabelled")

        t1 = time.perf_counter()
        _spawn_ranks(root, xl_rank, XL_RING_RANKS, XL_JOIN_S)
        ring = _rank_fits(root, "ring", world=XL_RING_RANKS)
        for r in ring:
            for name, n in zip(REPLACES, r["counts"]):
                launches[name] += int(n)
        steps, rows, worst = (int(v) for v in ring[0]["shadow"])
        log(f"        the degenerate exponion ring: k={XL_RING_K} over "
            f"{XL_RING_RANKS} model ranks (k_local="
            f"{XL_RING_K // XL_RING_RANKS}), shadowed: "
            f"{time.perf_counter() - t1:.1f} s with the processes' start, "
            f"{steps} steps, {int(ring[0]['pairs'])} pairs computed, final "
            f"val MSE {float(ring[0]['val'])!r}; labels differ from the "
            f"'none' step at {rows} rows (at most {worst} in a step), each "
            f"a near-tie")
        need(ring[0]["labels"].min() >= 0,
             "the degenerate ring left rows unlabelled")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"    launches in phase 12 (every process): {launches}; peak in "
        f"this process {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; phase 12 took {time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 12")
    return launches


# ---------------------------------------------------------------- phase 13

#: phase 13: the serve CLI's defaults at tinyllama-1.1b's full width, the
#: codebook's k, the decode-against-prefill tolerance of
#: tests/test_models.py (bf16 activations), the rows each rank's service
#: is fed twice in (c), and the deadlines of (c)'s ranks and (d)'s CLI
LM_ARCH = "tinyllama-1.1b"
LM_REDUCED = False
LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = 4, 32, 16, 0
CODEBOOK_K = 1024
LM_TOL = 6e-2
#: the same property in f32 (the weights upcast, f32 activations and cache)
LM_TOL_F32 = 1e-3
CB_SERVED = 512
CB_JOIN_S = 600.0
CLI_TIMEOUT_S = 600.0
CB_BACKENDS = ("mesh", "xl")


def _lm_config():
    from repro_torch import configs
    return (configs.get_reduced(LM_ARCH) if LM_REDUCED
            else configs.get_config(LM_ARCH))


def _decode_vs_prefill(cfg, params, tokens, nxt, inputs=None):
    """Decode's logits at position ``len(prompt)`` (after the prompt's
    prefill) and the prefill's logits of the prompt one token longer, as
    float64 (B, vocab) each. ``inputs``: the frames or patches beside the
    tokens; the cache is sized as the serve CLI sizes it."""
    from repro_torch.launch.serve import cache_len
    from repro_torch.train import step as tstep
    inputs = inputs or {}
    prefill = tstep.make_prefill_step(
        cfg, cache_len=cache_len(cfg, LM_PROMPT, LM_GEN))
    logits_p, cache = prefill(params, {"tokens": tokens, **inputs})
    logits_d, _ = tstep.make_decode_step(cfg)(params, nxt, cache)
    logits_f, _ = prefill(params, {"tokens": torch.cat(
        [tokens, nxt.long()], dim=1), **inputs})
    need(bool(torch.isfinite(logits_p).all()
              and torch.isfinite(logits_d).all()),
         "the model's logits are not finite")
    return logits_d[:, 0].double(), logits_f[:, -1].double()


def _beyond(got, want, tol) -> int:
    return int(((got - want).abs() > tol + tol * want.abs()).sum())


def _f32_copy(tree):
    return ({k: _f32_copy(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.float())


def _init_model(cfg):
    """The model from `LM_SEED` on the card: (params, seconds, count)."""
    from repro_torch.models import model as M
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(LM_SEED, cfg, DEV)
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            sum(t.numel() for t in tree_leaves(params)))


def serve_model(cfg, params, smi: str, what: str, t_init: float,
                n_params: int, inputs=None) -> dict:
    """The CLI's prompt (its recipe and defaults), prefill and greedy
    decode through `launch.serve.generate`, twice: the same tokens.
    ``inputs``: the frames or patches beside the prompt. Logs prefill
    ms, ms a decode step, tokens/s and peak memory (since the caller's
    reset)."""
    from repro_torch.launch.serve import generate
    rng = np.random.default_rng(LM_SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (LM_BATCH, LM_PROMPT))).to(DEV)
    warm = generate(cfg, params, tokens, LM_GEN, inputs=inputs)
    res = generate(cfg, params, tokens, LM_GEN, inputs=inputs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    need(np.array_equal(res["gen"], warm["gen"]),
         f"{what}: two greedy decodes of one prompt gave different tokens")
    t_dec = res["t_decode"] / (LM_GEN - 1)
    shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
             + (f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
                if cfg.n_heads else "")
             + (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_ff "
                f"{cfg.moe.d_expert_ff} cf {cfg.moe.capacity_factor}, "
                if cfg.moe else f"d_ff {cfg.d_ff}, " if cfg.d_ff else "")
             + (f"SSD {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} "
                f"heads of {cfg.ssm.head_dim} d_state {cfg.ssm.d_state} "
                f"chunk {cfg.ssm.chunk}, " if cfg.ssm else "")
             + (f"encoder {cfg.encoder.n_layers} layers over "
                f"{cfg.encoder.n_ctx} frames, " if cfg.family == "encdec"
                else f"{cfg.encoder.n_ctx} patches before the prompt, "
                if cfg.family == "vlm" else ""))
    log(f"    {what} {cfg.arch_id} at {'reduced' if LM_REDUCED else 'full'} "
        f"width ({shape}vocab {cfg.vocab}; {n_params:,} parameters, made "
        f"from seed {LM_SEED} on the card in {t_init:.2f} s); batch "
        f"{LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} tokens (the same twice):"
        f" prefill {res['t_prefill'] * 1e3:.3f} ms, {t_dec * 1e3:.3f} ms a "
        f"decode step ({LM_BATCH / t_dec:.0f} tok/s; warm-up run: prefill "
        f"{warm['t_prefill'] * 1e3:.3f} ms, "
        f"{warm['t_decode'] / (LM_GEN - 1) * 1e3:.3f} ms a step), peak "
        f"{peak:.2f} GiB ({smi})")
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "gen": res["gen"], "inputs": inputs,
            "nxt": torch.from_numpy(res["gen"][:, :1]).to(DEV)}


def decode_checks(bf16, f32, what: str, prefix: int = 0) -> None:
    """Decode's logits at position `LM_PROMPT` (after a vlm's ``prefix``
    patches) against the prefill of the prompt one token longer
    (`_decode_vs_prefill` pairs): in f32 (the
    same weights upcast, f32 activations and cache) within `LM_TOL_F32`;
    in bf16, the served model, the greedy tokens wherever the prefill's
    top two logits are more than 2 `LM_TOL` apart, which must be so for
    at least half the rows."""
    (got, want), (got32, want32) = bf16, f32
    need(got.shape == (LM_BATCH, want.shape[1]),
         f"{what}: decode logits {got.shape}")
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * LM_TOL
    same_tok = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    log(f"        {what} decode at position {prefix + LM_PROMPT} against "
        f"the prefill of {prefix + LM_PROMPT + 1} positions: f32 max |diff| "
        f"{float((got32 - want32).abs().max()):.4g} ("
        f"{_beyond(got32, want32, LM_TOL_F32)} of {got.numel()} logits "
        f"beyond rtol=atol={LM_TOL_F32}); bf16 max |diff| "
        f"{float((got - want).abs().max()):.4g}, mean "
        f"{float((got - want).abs().mean()):.4g} "
        f"({_beyond(got, want, LM_TOL)} beyond {LM_TOL}); bf16 against "
        f"f32: prefill max {float((want - want32).abs().max()):.4g} "
        f"({_beyond(want, want32, LM_TOL)} beyond), decode max "
        f"{float((got - got32).abs().max()):.4g} "
        f"({_beyond(got, got32, LM_TOL)} beyond); logits' std "
        f"{float(want.std()):.3g}; bf16 greedy tokens equal at "
        f"{int(clear.sum())} of {LM_BATCH} rows whose top-2 gap exceeds "
        f"{2 * LM_TOL}: {same_tok}")
    need(_beyond(got32, want32, LM_TOL_F32) == 0,
         f"{what}: decode's logits differ from the prefill's beyond "
         f"{LM_TOL_F32} (f32)")
    need(int(clear.sum()) >= LM_BATCH // 2,
         f"{what}: only {int(clear.sum())} of {LM_BATCH} rows have a top-2 "
         f"gap over {2 * LM_TOL}: too few to compare the bf16 greedy tokens")
    need(same_tok, f"{what}: bf16 decode's greedy token differs from the "
         f"prefill's where their top two logits are apart")


def lm_model(smi: str) -> dict:
    """(a): the model at full width on the card from seed 0, served
    (`serve_model`), and decode's logits held to the prefill of the
    prompt one token longer in f32 and bf16 (`decode_checks`)."""
    cfg = _lm_config()
    torch.cuda.reset_peak_memory_stats()
    params, t_init, n_params = _init_model(cfg)
    need(n_params == cfg.param_count() + cfg.d_model,
         f"the model has {n_params} parameters, its config "
         f"{cfg.param_count()} (+ the final norm's {cfg.d_model})")
    model = serve_model(cfg, params, smi, "(a)", t_init, n_params)
    tokens, nxt = model["tokens"], model["nxt"]
    decode_checks(_decode_vs_prefill(cfg, params, tokens, nxt),
                  _decode_vs_prefill(cfg, _f32_copy(params), tokens, nxt),
                  "(a)")
    return model


def _codebook_mse(E, C) -> float:
    """Mean squared distance of E's rows to their nearest centroid,
    float64, on the card."""
    Ed = torch.from_numpy(E).to(DEV)
    Cd = torch.from_numpy(np.ascontiguousarray(C)).to(DEV)
    a = exact_labels(Ed, Cd)
    return float(((Ed.double() - Cd[a.long()].double()) ** 2).sum(1)
                 .mean())


def _served(svc, gen: np.ndarray, E, n0: float, km, what: str) -> dict:
    """The exactly-once checks of a service fed ``gen``'s decode tokens."""
    m = svc.export_metrics()
    ids = gen[:, 1:].ravel()
    unique = len(np.unique(ids))
    rise = float(np.sum(km.counts_, dtype=np.float64)) - n0
    need(m["refresh"]["rows"] == unique == rise
         and m["queue"]["deduped"] == ids.size - unique,
         f"{what}: {m['refresh']['rows']} rows folded in, {unique} unique "
         f"ids delivered of {ids.size}, sum(counts) rose by {rise}, "
         f"{m['queue']['deduped']} deduped")
    snap = svc.snapshot
    need(snap.verify(), f"{what}: the snapshot does not verify")
    return {"unique": unique, "delivered": int(ids.size),
            "refreshes": m["refresh"]["count"], "version": snap.version}


def codebook_fits(E, launches: dict, what: str):
    """`build_codebook` with k = `CODEBOOK_K` over the table ``E`` (the
    CLI's fit), launching kernels 1-3, then again (bit-equal) and on the
    ref plan (the table's float64 MSE within 1e-3). Returns the fit."""
    import dataclasses

    from repro_torch.api import NestedKMeans
    from repro_torch.launch.serve import build_codebook

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km = build_codebook(E, CODEBOOK_K, LM_SEED, device=DEV)
        torch.cuda.synchronize()
        return km, time.perf_counter() - t0

    (km, wall), counts = _counted(launches, fit)
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(counts[name] > 0, f"{name} was never launched in the codebook "
             f"fit")
    (km2, wall2), _ = _counted(launches, fit)
    same = _same_fit(km2, km)
    t0 = time.perf_counter()
    kr = NestedKMeans(dataclasses.replace(km.config, kernel_backend="ref"),
                      device=DEV).fit(E)
    wall_ref = time.perf_counter() - t0
    need(kr.outcome_.kernel_plan["backend"] == "ref",
         "the ref fit did not run the plain versions")
    mse, mse_ref = (_codebook_mse(E, k.cluster_centers_) for k in (km, kr))
    rel = abs(mse - mse_ref) / mse_ref
    log(f"    {what} build_codebook(k={CODEBOOK_K}) over the {E.shape} "
        f"embedding table (b0 {km.config.b0}, at most "
        f"{km.config.max_rounds} rounds): {km.n_rounds_} rounds, converged "
        f"{km.converged_}, wall {wall:.3f} s (repeat {wall2:.3f} s; rounds "
        f"{km.telemetry_[-1].t:.3f} s), launches {counts}; the repeat "
        f"bit-equal: {same}; the ref plan's fit: {kr.n_rounds_} rounds, "
        f"wall {wall_ref:.3f} s, parts at round {_parts_at(km, kr)}; MSE "
        f"of the table (float64) {mse!r} against the ref fit's {mse_ref!r}"
        f" (relative {rel:.3g})")
    need(same, "two codebook fits differ")
    need(rel <= 1e-3, f"the codebook's MSE is {rel:.3g} from the ref "
         f"fit's")
    return km


def codebook_local(model: dict, launches: dict) -> dict:
    """(b): the codebook over the embedding table through
    `build_codebook`, repeated, on the ref plan, then its service fed the
    served tokens of a greedy decode through `generate`."""
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import generate
    from repro_torch.serve import ClusterService, IngestQueue
    cfg, params = model["cfg"], model["params"]
    E = params["embed"].float().cpu().numpy()
    km = codebook_fits(E, launches, "(b)")
    C_fit, rounds = km.cluster_centers_, km.n_rounds_

    def serve():
        svc = ClusterService(
            km, micro_batch=256, flush_after_s=0.05,
            queue=IngestQueue(max_rows=4096, dedup=True)).start()
        n0 = float(np.sum(km.counts_, dtype=np.float64))
        try:
            res = generate(cfg, params, model["tokens"], LM_GEN,
                           service=svc, E=E)
            cells = svc.predict(E[res["gen"][0]])
        except BaseException:
            svc.stop(drain=False)
            raise
        svc.stop()
        return svc, res, cells, n0

    (svc, res, cells, n0), counts = _counted(launches, serve)
    need(np.array_equal(res["gen"], model["gen"]),
         "decoding with the service gave other tokens than (a)")
    got = _served(svc, res["gen"], E, n0, km, "(b)'s service")
    # the final snapshot's cells against its plain assignment
    snap = svc.snapshot
    Q = torch.from_numpy(E[res["gen"].ravel()]).to(DEV)
    Cs = torch.from_numpy(np.array(snap.centroids)).to(DEV)
    tags = torch.from_numpy(svc.predict(E[res["gen"].ravel()])).to(DEV)
    plain = ref.assign_top2_ref(Q, Cs)[0]
    ties = _near_ties(Q, Cs, tags, plain)
    log(f"        its ClusterService (micro_batch 256, dedup by token id) "
        f"fed {got['delivered']} decode tokens through generate: "
        f"{got['unique']} unique ids folded in once by "
        f"{got['refreshes']} refreshes (snapshot v{got['version']}, "
        f"verifies); launches {counts}; prefill "
        f"{res['t_prefill'] * 1e3:.3f} ms, "
        f"{res['t_decode'] / (LM_GEN - 1) * 1e3:.3f} ms a decode step "
        f"with ingestion; cells (row 0) {cells.tolist()}; the final "
        f"snapshot's cells of all {Q.shape[0]} served tokens equal the "
        f"plain assignment but at {ties[0]} near-ties")
    return {"E": E, "C": C_fit, "rounds": rounds, "b0": km.config.b0}


def codebook_kernels(local: dict, smi: str) -> None:
    """(b) continued: kernels 1-3 at the codebook fit's shapes (d = 2048,
    k = 1024; the first batch's b0 rows and the whole table's), on the
    table's rows and the fitted codebook, held and timed as phase 12
    holds them at kmeans_xl width (`check_wide_kernels`). These launches
    only compare, so they count in no phase."""
    E = torch.from_numpy(local["E"]).to(DEV)
    C = torch.from_numpy(np.ascontiguousarray(local["C"])).to(DEV)
    log(f"    (b) kernels 1-3 at the codebook fit's shapes, on the table's "
        f"rows and the fitted codebook:")
    for rows in (local["b0"], E.shape[0]):
        check_wide_kernels(E[:rows].contiguous(), C, (CODEBOOK_K,), smi)
    del E, C
    torch.cuda.empty_cache()


def codebook_rank(rank: int, world: int, root: str, addr: str) -> None:
    """One spawned rank of (c): a gloo group on the one card, the
    codebook built over it on each backend of `CB_BACKENDS`, its local
    service, and the refused service over a sharded estimator. Writes
    ``rank<r>_codebook.npz`` under ``root``."""
    import torch.distributed as dist

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import build_codebook
    from repro_torch.serve import ClusterService, IngestQueue
    if not torch.cuda.is_available():
        raise Failure(f"rank {rank} sees no CUDA device")
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    out = {}
    try:
        E = np.load(os.path.join(root, "E.npy"))
        for b in CB_BACKENDS:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km = build_codebook(E, CODEBOOK_K, LM_SEED, backend=b,
                                device=DEV)
            torch.cuda.synchronize()
            out[f"wall_{b}"] = np.float64(time.perf_counter() - t0)
            out[f"C_{b}"] = km.cluster_centers_
            out[f"rounds_{b}"] = np.int64(km.n_rounds_)
            out[f"engine_{b}"] = np.array(km.config.backend)
            out[f"device_{b}"] = np.array(str(km.stats_.C.device))
            n0 = float(np.sum(km.counts_, dtype=np.float64))
            svc = ClusterService(
                km, micro_batch=256, flush_after_s=0.05,
                queue=IngestQueue(max_rows=4096, dedup=True)).start()
            ids = np.arange(CB_SERVED)
            try:
                for _ in range(2):
                    svc.ingest(E[ids], ids=ids.tolist())
                deadline = time.monotonic() + 120.0
                while svc.queue.depth and time.monotonic() < deadline:
                    time.sleep(0.005)
                out[f"labels_{b}"] = svc.predict(E[:4096])
            finally:
                svc.stop()
            torch.cuda.synchronize()
            out[f"counts_{b}"] = np.array(
                [ops.launch_counts()[n] for n in REPLACES])
            out[f"folded_{b}"] = np.float64(
                np.sum(km.counts_, dtype=np.float64) - n0)
            out[f"rows_{b}"] = np.int64(
                svc.export_metrics()["refresh"]["rows"])
            out[f"verified_{b}"] = np.bool_(svc.snapshot.verify())
            sharded = NestedKMeans(FitConfig(k=CODEBOOK_K, backend=b),
                                   mesh=make_host_mesh((world,), ("data",))
                                   if b == "mesh" else
                                   make_host_mesh((1, world),
                                                  ("data", "model")),
                                   device=DEV)
            try:
                ClusterService(sharded)
                out[f"refused_{b}"] = np.array("")
            except ValueError as e:
                out[f"refused_{b}"] = np.array(str(e))
        np.savez(os.path.join(root, f"rank{rank}_codebook.npz"), **out)
    finally:
        dist.destroy_process_group()


def codebook_sharded(local: dict, launches: dict) -> None:
    """(c): the codebook on one NCCL rank (mesh and xl), bit-equal to
    (b)'s; then 2 gloo ranks sharing the card, whose adopted codebooks
    must be within 1e-4 relative (Frobenius) of (b)'s and serve."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.serve import build_codebook
    E, C = local["E"], local["C"]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        for b in CB_BACKENDS:
            t0 = time.perf_counter()
            km, counts = _counted(launches, lambda: build_codebook(
                E, CODEBOOK_K, LM_SEED, backend=b, device=DEV))
            same = np.array_equal(km.cluster_centers_, C)
            log(f"    (c) one {dist.get_backend()} rank, backend={b!r}: "
                f"{km.n_rounds_} rounds in {time.perf_counter() - t0:.3f} s"
                f", launches {counts}, adopted onto a "
                f"{km.config.backend!r} estimator; codebook bit-equal to "
                f"(b)'s: {same}")
            need(same, f"the one-rank {b} codebook differs from (b)'s")
    finally:
        dist.destroy_process_group()
    root = tempfile.mkdtemp(prefix="chip_smoke_cb_")
    try:
        np.save(os.path.join(root, "E.npy"), E)
        t0 = time.perf_counter()
        _spawn_ranks(root, codebook_rank, world=MESH_RANKS,
                     join_s=CB_JOIN_S)
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(root, f"rank{r}_codebook.npz")))
                 for r in range(MESH_RANKS)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    Cl = torch.from_numpy(C)
    for b in CB_BACKENDS:
        for r in ranks:
            need(str(r[f"engine_{b}"]) == "local"
                 and str(r[f"device_{b}"]).startswith(DEV),
                 f"a rank's {b} codebook was adopted onto "
                 f"{r[f'engine_{b}']} on {r[f'device_{b}']}")
            need(np.array_equal(r[f"C_{b}"], ranks[0][f"C_{b}"]),
                 f"the ranks hold different {b} codebooks")
            need(float(r[f"folded_{b}"]) == int(r[f"rows_{b}"]) == CB_SERVED
                 and bool(r[f"verified_{b}"]),
                 f"a rank's {b} service folded {r[f'folded_{b}']} rows in "
                 f"({r[f'rows_{b}']} by its metrics) of {CB_SERVED} unique")
            need("Adopt the sharded fit" in str(r[f"refused_{b}"]),
                 f"the {MESH_RANKS}-rank service over a {b} estimator was "
                 f"not refused: {str(r[f'refused_{b}'])!r}")
            for name, n in zip(REPLACES, r[f"counts_{b}"]):
                launches[name] += int(n)
        gap = _rel_gap(torch.from_numpy(ranks[0][f"C_{b}"]), Cl)
        split = (f"k_local {CODEBOOK_K // MESH_RANKS}" if b == "xl"
                 else "rows split")
        agree = float((ranks[0][f"labels_{b}"]
                       == ranks[1][f"labels_{b}"]).mean())
        log(f"    (c) {MESH_RANKS} gloo ranks on the card, backend={b!r} "
            f"({split}): "
            f"{int(ranks[0][f'rounds_{b}'])} rounds, wall "
            f"{_by_rank(ranks, f'wall_{b}')} s, launches by rank "
            f"{[r[f'counts_{b}'].tolist() for r in ranks]}; the adopted "
            f"codebook {gap:.3g} relative (Frobenius) from (b)'s; each "
            f"rank's service folded {CB_SERVED} unique rows in once of "
            f"{2 * CB_SERVED} delivered, labels of 4096 rows equal across "
            f"ranks on {agree:.6f}; a {MESH_RANKS}-rank ClusterService over "
            f"the sharded estimator refused")
        need(gap <= 1e-4, f"the {MESH_RANKS}-rank {b} codebook is {gap:.3g} "
             f"from (b)'s")
    log(f"        the {MESH_RANKS} ranks took {wall:.1f} s")


def run_serve_cli(arch: str, gen0: list, table: tuple, what: str):
    """``python -m repro_torch.launch.serve --arch ARCH`` at full width
    with the codebook, as a user runs it: rc 0, its lines parsed, row
    0's tokens ``gen0`` and its codebook over the ``table``-shaped
    embeddings. Returns (cmd, wall, codebook, timing and service
    matches)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           arch, "--reduced" if LM_REDUCED else "--no-reduced",
           "--codebook", str(CODEBOOK_K), "--device", DEV]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = p.stdout
    need(p.returncode == 0, f"{what}: the serve CLI exited {p.returncode}: "
         f"{p.stderr[-2000:]}")

    def line(pattern, name):
        m = re.search(pattern, out)
        need(m is not None, f"{what}: the serve CLI printed no {name} "
             f"line:\n{out}")
        return m

    cb = line(r"codebook: k=(\d+) over \((\d+), (\d+)\) embeddings in "
              r"([\d.]+)s \(rounds=(\d+), converged=(\w+)\)", "codebook")
    tm = line(r"prefill (\d+)x(\d+) in ([\d.]+)ms; (\d+) decode steps in "
              r"([\d.]+)ms \((\d+) tok/s\) on (\S+)", "timing")
    ids = json.loads(line(r"generated token ids \(row 0\): (\[.*\])",
                          "token")[1])
    cells = json.loads(line(r"codebook cells  \(row 0\): (\[.*\])",
                            "cells")[1])
    sv = line(r"codebook service: (\d+) background refreshes over (\d+) "
              r"embeddings, snapshot v(\d+) \(deduped=(\d+), batch MSE "
              r"([\d.]+)\)", "service")
    delivered = LM_BATCH * (LM_GEN - 1)
    need(int(cb[1]) == CODEBOOK_K and (int(cb[2]), int(cb[3])) == table,
         f"{what}: the CLI's codebook line: {cb[0]}")
    need(ids == gen0, f"{what}: the CLI generated {ids}, the in-process "
         f"run {gen0}")
    need(len(cells) == LM_GEN and all(0 <= c < CODEBOOK_K for c in cells),
         f"{what}: the CLI's cells {cells}")
    need(int(sv[2]) + int(sv[4]) == delivered,
         f"{what}: the CLI's service folded {sv[2]} and deduped {sv[4]} of "
         f"{delivered} delivered rows")
    return cmd, wall, cb, tm, sv


def serve_cli(model: dict, local: dict) -> None:
    """(d): ``python -m repro_torch.launch.serve`` at full width with the
    codebook, as a user runs it; its lines parsed and held to (a), (b)."""
    cmd, wall, cb, tm, sv = run_serve_cli(
        LM_ARCH, model["gen"][0].tolist(), local["E"].shape, "(d)")
    need(int(cb[5]) == local["rounds"],
         f"the CLI's codebook took {cb[5]} rounds, (b)'s fit "
         f"{local['rounds']}")
    log(f"    (d) {' '.join(cmd[1:])}: rc 0 in {wall:.1f} s; codebook "
        f"{cb[4]} s, {cb[5]} rounds (as (b)); prefill {tm[3]} ms, "
        f"{tm[4]} decode steps in {tm[5]} ms ({tm[6]} tok/s) on {tm[7]}; "
        f"row 0's tokens equal (a)'s; service: {sv[1]} refreshes over "
        f"{sv[2]} embeddings, {sv[4]} deduped, snapshot v{sv[3]}")


def lm_serve_phase(smi: str) -> dict:
    """Phase 13: the serve entry point at tinyllama-1.1b's full width
    with the k-means codebook over its embeddings. Returns the launch
    counts of (b) and (c) (every process)."""
    t0 = time.perf_counter()
    log(f"[13] serving {LM_ARCH} with a k={CODEBOOK_K} codebook over its "
        f"embeddings (repro_torch.launch.serve)")
    launches = dict.fromkeys(REPLACES, 0)
    model = lm_model(smi)
    local = codebook_local(model, launches)
    codebook_kernels(local, smi)
    codebook_sharded(local, launches)
    serve_cli(model, local)
    log(f"    launches in phase 13 (every process): {launches}; phase 13 "
        f"took {time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 13")
    del model, local
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 14

#: phase 14: the train CLI's defaults at tinyllama-1.1b's full width
#: (batch 8, seq 128, 2 microbatches, lr 3e-4 warmed up over 10 steps);
#: (a)'s steps, (c)'s steps and the step after which (c)'s run is killed,
#: (b)'s layers and tolerances (bf16 against the same weights in f32),
#: and (e)'s steps and its checkpoint interval
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_LR = 8, 128, 2, 3e-4
TRAIN_STEPS, TRAIN_DET_STEPS, TRAIN_KILL_AT = 10, 6, 3
TRAIN_GRAD_LAYERS, TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL = 2, 6e-2, 5e-2
TRAIN_CLI_STEPS, TRAIN_CLI_EVERY = 4, 2


def _train_state(cfg, seed: int = LM_SEED):
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    params = M.init_params(seed, cfg, DEV)
    return params, adamw.init(params)


def _train_steps(cfg, params, opt, steps, *, timed=None, store=None,
                 metrics=None, aux=None, inputs=None):
    """``steps`` of the train CLI's step on `LMBatches` from `LM_SEED`
    (its data as the CLI batches it, `lm_batch`, with ``inputs`` over its
    frame or patch stubs; its optimizer for a run of up to 100 steps);
    returns (params, opt, losses as 0-d tensors). ``timed`` collects each step's
    wall (the device drained); ``store`` takes a background checkpoint
    after step `TRAIN_KILL_AT` - 1, labelled `TRAIN_KILL_AT` (the steps
    it holds), as the CLI's ``--ckpt-every TRAIN_KILL_AT`` would;
    ``metrics`` collects each step's metrics; ``aux`` each step's MoE
    aux loss, `train_loss` on its first microbatch before the step (no
    gradient, outside ``timed``)."""
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    step = tstep.make_train_step(
        cfg, n_micro=TRAIN_MICRO,
        opt_cfg=adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=10,
                                  decay_steps=100))
    data = LMBatches(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     seed=LM_SEED)
    losses = []
    for s in steps:
        batch = dict(lm_batch(cfg, data.at(s), DEV), **(inputs or {}))
        if aux is not None:
            with torch.no_grad():
                mb = {k: v[:TRAIN_BATCH // TRAIN_MICRO]
                      for k, v in batch.items()}
                aux.append(float(M.train_loss(params, mb, cfg,
                                              remat=False)[1]["aux"]))
        if timed is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        if timed is not None:
            torch.cuda.synchronize()
            timed.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        if metrics is not None:
            metrics.append(m)
        if store is not None and s == TRAIN_KILL_AT - 1:
            store.save(TRAIN_KILL_AT, {"params": params, "opt": opt},
                       background=True)
    return params, opt, losses


def _state_leaves(params, opt):
    return (tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
            + [opt.count])


def train_steps_phase(smi: str) -> np.ndarray:
    """(a): `TRAIN_STEPS` steps at full width; the loss must fall from
    the first step to the last. Then two more steps, the second one
    profiled (device busy share, the ops that take the device and the
    host). Returns the trained embedding table (before the profiled
    steps)."""
    cfg = _lm_config()
    torch.cuda.reset_peak_memory_stats()
    params, opt = _train_state(cfg)
    walls = []
    params, opt, losses = _train_steps(cfg, params, opt, range(TRAIN_STEPS),
                                       timed=walls)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    ms = float(np.median(walls[1:])) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"    (a) {cfg.arch_id} at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, "
        f"{sum(t.numel() for t in tree_leaves(params)):,} bf16 parameters "
        f"from seed {LM_SEED}, f32 moments and accumulators), batch {TRAIN_BATCH} x seq {TRAIN_SEQ} in "
        f"{TRAIN_MICRO} microbatches, remat on: {TRAIN_STEPS} steps, "
        f"{ms:.3f} ms a step (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
        f"{walls[0] * 1e3:.3f} ms; min {min(walls[1:]) * 1e3:.3f}, max "
        f"{max(walls[1:]) * 1e3:.3f}), {tokens / ms * 1e3:.0f} tokens/s, "
        f"peak {peak:.2f} GiB ({smi}); loss by step "
        f"{[round(x, 4) for x in losses]}")
    need(all(math.isfinite(x) for x in losses), "a training loss is not "
         "finite")
    need(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} at "
         f"step 0, {losses[-1]} at step {TRAIN_STEPS - 1}")
    E = params["embed"].float().cpu().numpy()
    state = {"params": params, "opt": opt, "step": TRAIN_STEPS}

    def one_step():
        s = state["step"]
        state["params"], state["opt"], _ = _train_steps(
            cfg, state["params"], state["opt"], range(s, s + 1))
        torch.cuda.synchronize()
        state["step"] = s + 1

    t_prof = []

    def report(prof):            # the profiled step is the last one
        profile_report(prof, ms / 1e3, t_prof[-1], what="train step")

    def timed_step():
        t0 = time.perf_counter()
        one_step()
        t_prof.append(time.perf_counter() - t0)

    trace_again(timed_step, report)
    del state, params, opt
    torch.cuda.empty_cache()
    return E


def train_grads_phase() -> None:
    """(b): the first step's loss and gradients at full width but
    `TRAIN_GRAD_LAYERS` layers: bf16 against the same weights upcast to
    f32 (the model then runs in f32), on the first microbatch."""
    import dataclasses

    from repro_torch.data.pipeline import LMBatches
    from repro_torch.models import model as M
    cfg = dataclasses.replace(_lm_config(), n_layers=TRAIN_GRAD_LAYERS)
    params = M.init_params(LM_SEED, cfg, DEV)
    data = LMBatches(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     seed=LM_SEED)
    mb = {k: torch.from_numpy(v[:TRAIN_BATCH // TRAIN_MICRO]).to(DEV)
          for k, v in data.at(0).items()}
    out = {}
    for arm, tree in (("bf16", params),
                      ("f32", tree_map(lambda p: p.float(), params))):
        live = tree_map(lambda p: p.detach().requires_grad_(), tree)
        loss, _ = M.train_loss(live, mb, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        out[arm] = (float(loss.detach()), [g.double() for g in grads])
    errs = [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(out["bf16"][1], out["f32"][1])]
    gap = abs(out["bf16"][0] - out["f32"][0])
    log(f"    (b) the first step at full width, {TRAIN_GRAD_LAYERS} layers, "
        f"on a {TRAIN_BATCH // TRAIN_MICRO} x {TRAIN_SEQ} microbatch: loss "
        f"bf16 {out['bf16'][0]!r}, f32 {out['f32'][0]!r} (gap {gap:.3g}, "
        f"held to {TRAIN_LOSS_TOL}); each leaf's gradient, relative "
        f"(Frobenius) to the f32 arm's, held to {TRAIN_GRAD_RTOL}: max "
        f"{max(errs):.4g}, by leaf {[round(e, 5) for e in errs]}")
    need(gap <= TRAIN_LOSS_TOL, f"the bf16 loss is {gap} from the f32 one")
    need(max(errs) <= TRAIN_GRAD_RTOL, f"a bf16 gradient is {max(errs):.3g} "
         f"from the f32 one")
    del params, out
    torch.cuda.empty_cache()


def train_repeat_phase() -> None:
    """(c): the same `TRAIN_DET_STEPS` steps twice give the same bits;
    a run checkpointed after step `TRAIN_KILL_AT` (in the background),
    killed, and restored into a state made from another seed, resumed to
    `TRAIN_DET_STEPS`, gives them too."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.store import CheckpointStore
    cfg = _lm_config()
    p, o = _train_state(cfg)
    p, o, _ = _train_steps(cfg, p, o, range(TRAIN_DET_STEPS))
    want = _state_leaves(p, o)
    p2, o2 = _train_state(cfg)
    p2, o2, _ = _train_steps(cfg, p2, o2, range(TRAIN_DET_STEPS))
    twice = [bool(torch.equal(a, b)) for a, b in
             zip(want, _state_leaves(p2, o2))]
    del p2, o2
    log(f"    (c) {TRAIN_DET_STEPS} steps twice: every param, moment and "
        f"the count bit-equal: {all(twice)} ({sum(twice)} of {len(twice)} "
        f"leaves)")
    need(all(twice), "two runs of the same training steps differ")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        store = CheckpointStore(root)
        p3, o3 = _train_state(cfg)
        t0 = time.perf_counter()
        _train_steps(cfg, p3, o3, range(TRAIN_KILL_AT), store=store)
        t_save = time.perf_counter() - t0
        store.wait()
        size = sum(f.stat().st_size for f in Path(root).rglob("*"))
        del p3, o3                          # the killed run
        t0 = time.perf_counter()
        tp, to = _train_state(cfg, seed=LM_SEED + 1)
        got = store.restore({"params": tp, "opt": to}, device=DEV)
        del tp, to
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        p4, o4, _ = _train_steps(cfg, got["params"], got["opt"],
                                 range(TRAIN_KILL_AT, TRAIN_DET_STEPS))
        same = [bool(torch.equal(a, b)) for a, b in
                zip(want, _state_leaves(p4, o4))]
        del got, p4, o4
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"        killed after step {TRAIN_KILL_AT} (its background "
        f"checkpoint {size / 2 ** 30:.2f} GiB; {TRAIN_KILL_AT} steps and "
        f"the save's copy {t_save:.2f} s), restored into a state from seed "
        f"{LM_SEED + 1} in {t_restore:.2f} s and resumed: bit-equal at "
        f"step {TRAIN_DET_STEPS}: {all(same)}")
    need(all(same), "the resumed training run differs from the unbroken one")
    del p, o, want
    torch.cuda.empty_cache()


def train_cli() -> None:
    """(e): ``python -m repro_torch.launch.train --reduced`` as a user runs
    it: `TRAIN_CLI_STEPS` steps under a temp dir, a checkpoint every
    `TRAIN_CLI_EVERY`; step 0's loss and the last step's must be those of
    the same steps run in this process. Then its final checkpoint is
    taken away, as a kill before the final save leaves the directory,
    and the same command resumes from the mid-run checkpoint: its last
    step line must be the unbroken run's. The reduced width keeps the
    script inside its time limit: at full width the two runs' three
    10.25 GiB saves and a restore took 92-139 s; (a)-(c) train the full
    width in this process through the same step."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint.store import CheckpointStore
    cfg = configs.get_reduced(LM_ARCH)
    _, _, want = _train_steps(cfg, *_train_state(cfg),
                              range(TRAIN_CLI_STEPS))
    want = [float(x) for x in want]
    root = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    step_re = (r"step +(\d+) loss (\d+\.\d{4}) lr (\S+) gnorm (\S+) "
               r"\(([\d.]+)s\)")
    steps, every = TRAIN_CLI_STEPS, TRAIN_CLI_EVERY
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM_ARCH, "--reduced", "--steps", str(steps), "--ckpt-every",
           str(every), "--ckpt-dir", root, "--device", DEV]

    def run():
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           env=env, timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        need(p.returncode == 0, f"the train CLI exited {p.returncode}: "
             f"{p.stderr[-2000:]}")
        lines = p.stdout.splitlines()
        got = {int(m[1]): m for m in (re.fullmatch(step_re, ln)
                                      for ln in lines) if m}
        need(f"final checkpoint at step {steps}" in lines,
             f"the train CLI printed no final checkpoint:\n{p.stdout}")
        return wall, lines, got

    try:
        wall, lines, got = run()
        last = steps - 1
        need(sorted(got) == [0, last]
             and got[0][2] == f"{want[0]:.4f}"
             and got[last][2] == f"{want[last]:.4f}",
             f"the CLI's steps {sorted(got)}, its losses "
             f"{[m[2] for m in got.values()]} against this process's "
             f"{want[0]:.4f} at step 0 and {want[last]:.4f} at step "
             f"{last}")
        saved = CheckpointStore(root).steps()
        need(saved[-2:] == [steps - every, steps], f"the CLI saved steps "
             f"{saved}")
        for d in Path(root).glob(f"step_{steps:09d}*"):
            shutil.rmtree(d)
        wall2, lines2, got2 = run()
        need(f"resumed from checkpoint at step {steps - every}" in lines2
             and sorted(got2) == [last]
             and got2[last].groups()[:4] == got[last].groups()[:4],
             f"the resumed CLI printed {lines2}; the unbroken run's step "
             f"{last}: {got[last][0]}")
        log(f"    (e) {' '.join(cmd[1:])}: rc 0 in {wall:.1f} s; "
            f"{lines[0]}; {' / '.join(m[0] for m in got.values())} (the "
            f"in-process run's losses); checkpoints {saved}. "
            f"Its final checkpoint taken away, the same command: rc 0 in "
            f"{wall2:.1f} s, resumed from step {steps - every}, "
            f"{' / '.join(m[0] for m in got2.values())} (the unbroken "
            f"run's loss, lr and gnorm)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def lm_train_phase(smi: str) -> dict:
    """Phase 14: LM training at tinyllama-1.1b's full width, then the
    codebook over the trained table. Returns the launch counts of (d)."""
    t0 = time.perf_counter()
    log(f"[14] training {LM_ARCH} (repro_torch.launch.train's step), then "
        f"a k={CODEBOOK_K} codebook over the trained embeddings")
    launches = dict.fromkeys(REPLACES, 0)
    E = train_steps_phase(smi)
    train_grads_phase()
    train_repeat_phase()
    km = codebook_fits(E, launches, "(d) on (a)'s trained table:")
    codebook_kernels({"E": E, "C": km.cluster_centers_, "b0": km.config.b0},
                     smi)
    del km
    train_cli()
    log(f"    launches in phase 14: {launches}; phase 14 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 14")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 15

#: phase 15: the MoE, SSD and hybrid families at full width from seed 0.
#: The MoE capacity factor of the decode-against-prefill checks (no drops:
#: decode routes B tokens, prefill B * S, so their capacities differ, as
#: tests/test_models.py holds it), (b)'s steps and repeated steps, (d)'s
#: training steps, and the hybrid's depth: one period (jamba's 32 layers
#: are 51.5 B parameters, 103 GB in bf16, more than the card holds)
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = ("granite-moe-1b-a400m", "mamba2-2.7b",
                                   "jamba-v0.1-52b")
CHECK_CF = 8.0
MOE_STEPS, DET_STEPS, SSM_STEPS = 10, 3, 6


def _family_config(arch: str):
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = (configs.get_reduced(arch) if LM_REDUCED
           else configs.get_config(arch))
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=M.period_len(cfg))
    return cfg


def _with_cf(cfg, cf: float):
    import dataclasses
    return (cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))


def _upcast_in_place(tree) -> None:
    """Each leaf of ``tree`` replaced by its f32 copy, one at a time, so
    the bf16 leaf is freed as its copy lands."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _upcast_in_place(v)
        else:
            tree[k] = v.float()


def _repeat_steps(cfg, what: str, inputs=None, on_host=False) -> None:
    """`DET_STEPS` train steps from seed 0, twice: every param, moment
    and the count bit-equal, every loss finite; each step's wall is
    logged. ``on_host`` keeps the first run's state in host memory while
    the second runs (two states do not fit on the card)."""
    runs, losses, walls = [], [], []
    for _ in range(2):
        p, o = _train_state(cfg)
        p, o, ls = _train_steps(cfg, p, o, range(DET_STEPS), inputs=inputs,
                                timed=walls)
        losses.append([float(x) for x in ls])
        leaves = _state_leaves(p, o)
        runs.append([t.cpu() for t in leaves] if on_host else leaves)
        del p, o, leaves
        torch.cuda.empty_cache()
    same = [bool(torch.equal(a.to(b.device), b)) for a, b in zip(*runs)]
    log(f"        {DET_STEPS} steps twice: every param, moment and the "
        f"count bit-equal: {all(same)} ({sum(same)} of {len(same)} "
        f"leaves); losses {losses[0]}; ms a step "
        f"{[round(w * 1e3, 3) for w in walls]}")
    need(all(math.isfinite(x) for x in losses[0] + losses[1]),
         f"{what}: a loss is not finite")
    need(all(same), f"{what}: two runs of the same training steps differ")


def moe_drops(cfg, params, tokens, nxt) -> tuple:
    """The shares of (token, choice) pairs the MoE layers drop at the
    config's own capacity factor in the prompt's prefill and one decode
    step, recounted from each layer's router on its input
    (`layers.moe_route`)."""
    from repro_torch.models import layers as L
    from repro_torch.train import step as tstep
    seen = []
    orig = L.moe_fwd

    def counting(p, x, moe):
        valid = L.moe_route(p, x.reshape(-1, x.shape[-1]), moe)[3]
        seen.append((valid.numel(), int((~valid).sum())))
        return orig(p, x, moe)

    L.moe_fwd = counting
    try:
        _, cache = tstep.make_prefill_step(
            cfg, cache_len=LM_PROMPT + LM_GEN)(params, {"tokens": tokens})
        n_pre = len(seen)
        tstep.make_decode_step(cfg)(params, nxt, cache)
    finally:
        L.moe_fwd = orig
    return tuple(sum(d for _, d in part) / sum(n for n, _ in part)
                 for part in (seen[:n_pre], seen[n_pre:]))


def moe_serve(smi: str) -> dict:
    """(a): granite-moe served twice (the same tokens); decode against
    the prefill one token longer at capacity factor `CHECK_CF`, in f32
    and bf16 (`decode_checks`); the drop shares at the config's own."""
    cfg = _family_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, t_init, n_params = _init_model(cfg)
    need(n_params == cfg.param_count() + cfg.d_model,
         f"(a): the model has {n_params} parameters, its config "
         f"{cfg.param_count()} (+ the final norm's {cfg.d_model})")
    model = serve_model(cfg, params, smi, "(a)", t_init, n_params)
    tokens, nxt = model["tokens"], model["nxt"]
    check = _with_cf(cfg, CHECK_CF)
    decode_checks(_decode_vs_prefill(check, params, tokens, nxt),
                  _decode_vs_prefill(check, _f32_copy(params), tokens, nxt),
                  f"(a) at capacity factor {CHECK_CF}:")
    pre, dec = moe_drops(cfg, params, tokens, nxt)
    log(f"        dropped at capacity factor {cfg.moe.capacity_factor}: "
        f"{pre:.4%} of the prefill's (token, choice) pairs ({LM_BATCH} x "
        f"{LM_PROMPT} tokens, {cfg.n_layers} layers), {dec:.4%} of one "
        f"decode step's ({LM_BATCH} tokens)")
    gen = model["gen"]
    del model, params
    torch.cuda.empty_cache()
    return {"gen": gen}


def moe_train(smi: str) -> np.ndarray:
    """(b): `MOE_STEPS` steps of the train CLI's step on granite-moe
    (the loss must fall, the aux loss stay finite), a profiled step, and
    `MOE_DET_STEPS` steps twice, bit-equal. Returns the trained
    embedding table."""
    cfg = _family_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, opt = _train_state(cfg)
    walls, aux = [], []
    params, opt, losses = _train_steps(cfg, params, opt, range(MOE_STEPS),
                                       timed=walls, aux=aux)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    ms = float(np.median(walls[1:])) * 1e3
    log(f"    (b) {cfg.arch_id} training, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ} in {TRAIN_MICRO} microbatches, remat on, f32 moments "
        f"and accumulators: {MOE_STEPS} steps, {ms:.3f} ms a step (median "
        f"of steps 1-{MOE_STEPS - 1}; step 0 {walls[0] * 1e3:.3f} ms; min "
        f"{min(walls[1:]) * 1e3:.3f}, max {max(walls[1:]) * 1e3:.3f}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak "
        f"{peak:.2f} GiB ({smi}); loss by step "
        f"{[round(x, 4) for x in losses]}; aux (the first microbatch, "
        f"before the step) {[round(x, 4) for x in aux]}")
    need(all(math.isfinite(x) for x in losses + aux),
         "(b): a loss or aux loss is not finite")
    need(losses[-1] < losses[0], f"(b): the loss did not fall: {losses[0]}"
         f" at step 0, {losses[-1]} at step {MOE_STEPS - 1}")
    E = params["embed"].float().cpu().numpy()
    state = {"params": params, "opt": opt, "step": MOE_STEPS}
    t_prof = []

    def timed_step():
        t0 = time.perf_counter()
        s = state["step"]
        state["params"], state["opt"], _ = _train_steps(
            cfg, state["params"], state["opt"], range(s, s + 1))
        torch.cuda.synchronize()
        state["step"] = s + 1
        t_prof.append(time.perf_counter() - t0)

    trace_again(timed_step, lambda prof: profile_report(
        prof, ms / 1e3, t_prof[-1], what="MoE train step"))
    del state, params, opt
    torch.cuda.empty_cache()
    _repeat_steps(cfg, "(b)")
    return E


def ssm_phase(smi: str) -> None:
    """(d): mamba2 served as (a) is, then `SSM_STEPS` training steps:
    every gradient finite (the grad norm), the loss falling."""
    cfg = _family_config(SSM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, t_init, n_params = _init_model(cfg)
    model = serve_model(cfg, params, smi, "(d)", t_init, n_params)
    tokens, nxt = model["tokens"], model["nxt"]
    decode_checks(_decode_vs_prefill(cfg, params, tokens, nxt),
                  _decode_vs_prefill(cfg, _f32_copy(params), tokens, nxt),
                  "(d)")
    del model, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = _train_state(cfg)
    walls, metrics = [], []
    params, opt, _ = _train_steps(cfg, params, opt, range(SSM_STEPS),
                                  timed=walls, metrics=metrics)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    ms = float(np.median(walls[1:])) * 1e3
    log(f"        training, batch {TRAIN_BATCH} x seq {TRAIN_SEQ} (one SSD "
        f"chunk of {min(cfg.ssm.chunk, TRAIN_SEQ)}) in {TRAIN_MICRO} "
        f"microbatches: {SSM_STEPS} steps, {ms:.3f} ms a step (median of "
        f"steps 1-{SSM_STEPS - 1}; step 0 {walls[0] * 1e3:.3f} ms), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak "
        f"{peak:.2f} GiB ({smi}); loss by step "
        f"{[round(x, 4) for x in losses]}; grad norm by step "
        f"{[round(x, 4) for x in norms]}")
    need(all(math.isfinite(x) for x in losses + norms),
         "(d): a loss or gradient norm is not finite")
    need(losses[-1] < losses[0], f"(d): the loss did not fall: {losses[0]}"
         f" at step 0, {losses[-1]} at step {SSM_STEPS - 1}")
    del params, opt
    torch.cuda.empty_cache()


def hybrid_phase(smi: str) -> None:
    """(e): jamba at full width, one period: served twice in bf16 (the
    same tokens); decode against the prefill one token longer at
    capacity factor `CHECK_CF` in bf16, then, the bf16 model's leaves
    upcast one by one in place, in f32 (`decode_checks`)."""
    cfg = _family_config(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, t_init, n_params = _init_model(cfg)
    model = serve_model(cfg, params, smi, "(e)", t_init, n_params)
    tokens, nxt = model["tokens"], model["nxt"]
    del model
    check = _with_cf(cfg, CHECK_CF)
    bf16 = _decode_vs_prefill(check, params, tokens, nxt)
    torch.cuda.empty_cache()
    _upcast_in_place(params)
    f32 = _decode_vs_prefill(check, params, tokens, nxt)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    decode_checks(bf16, f32, f"(e) at capacity factor {CHECK_CF}:")
    log(f"        the f32 model ({n_params:,} parameters upcast leaf by "
        f"leaf): peak {peak:.2f} GiB over (e) ({smi})")
    del params, bf16, f32
    torch.cuda.empty_cache()


def families_phase(smi: str) -> dict:
    """Phase 15: the MoE, Mamba2-SSD and hybrid families at full width,
    serving and training, the codebook over granite's trained table, and
    the serve CLI on granite. Returns the launch counts of (c)."""
    t0 = time.perf_counter()
    log(f"[15] the moe, ssm and hybrid families: {MOE_ARCH} served and "
        f"trained with a k={CODEBOOK_K} codebook over its trained "
        f"embeddings, {SSM_ARCH} served and trained, {HYBRID_ARCH} (one "
        f"period) served")
    launches = dict.fromkeys(REPLACES, 0)
    served = moe_serve(smi)
    E = moe_train(smi)
    km = codebook_fits(E, launches, "(c) on (b)'s trained table:")
    codebook_kernels({"E": E, "C": km.cluster_centers_, "b0": km.config.b0},
                     smi)
    del km, E
    ssm_phase(smi)
    hybrid_phase(smi)
    cfg = _family_config(MOE_ARCH)
    cmd, wall, cb, tm, sv = run_serve_cli(
        MOE_ARCH, served["gen"][0].tolist(), (cfg.vocab, cfg.d_model), "(f)")
    log(f"    (f) {' '.join(cmd[1:])}: rc 0 in {wall:.1f} s; codebook "
        f"{cb[4]} s, {cb[5]} rounds; prefill {tm[3]} ms, {tm[4]} decode "
        f"steps in {tm[5]} ms ({tm[6]} tok/s) on {tm[7]}; row 0's tokens "
        f"equal (a)'s; service: {sv[1]} refreshes over {sv[2]} embeddings,"
        f" {sv[4]} deduped, snapshot v{sv[3]}")
    log(f"    launches in phase 15: {launches}; phase 15 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 15")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 16

#: phase 16: `benchmarks/common.py::dataset("rcv1")`'s rows (60,000 train
#: + 6,000 validation at d = 2048, seed 0) under `KMEANS_RCV1`'s
#: algorithm; its 781,265 rows are cut (one Python draw a row: ~170 s of
#: host time)
RCV1_N, RCV1_D = 60_000, 2048


def _rcv1_fit(X, Xv, **kw):
    """`KMEANS_RCV1`'s fit (tb, hamerly2, k = 50, b0 = 5000), seed 0,
    with ``kw`` over its config."""
    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.configs import get_kmeans_config
    w = get_kmeans_config("kmeans_rcv1")
    cfg = FitConfig(**dict(dict(k=w.k, b0=w.b0, algorithm=w.algorithm,
                                rho=w.rho, bounds=w.bounds, seed=0), **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    km = NestedKMeans(cfg, device=DEV).fit(X, X_val=Xv)
    torch.cuda.synchronize()
    return km, time.perf_counter() - t0


def rcv1_phase(smi: str) -> dict:
    """Phase 16: the paper's RCV1 fit on the card, held as phase 4 holds
    infMNIST; kernels 1-3 held and timed at d = 2048, k = 50 on its rows
    and centroids. Returns the fit's launch counts (fit + predict)."""
    from repro_torch.data.synthetic import rcv1_like
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    X = rcv1_like(RCV1_N + RCV1_N // 10, dim=RCV1_D, seed=0)
    X, Xv = X[:RCV1_N], X[RCV1_N:]
    log(f"[16] the paper's RCV1 fit: rcv1_like {X.shape} + {Xv.shape} "
        f"(seed 0) in {time.perf_counter() - t0:.1f} s (host); "
        f"{(X.nbytes + Xv.nbytes) / 1e6:.0f} MB of f32")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    km, wall = _rcv1_fit(X, Xv)
    labels = km.predict(X)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tel = [r for r in km.telemetry_ if r.batch_mse is not None]
    k = km.config.k
    log(f"    cuda fit (k={k}, b0 {km.config.b0}, {km.config.algorithm}, "
        f"{km.config.bounds}): {len(tel)} rounds, final b "
        f"{km.telemetry_[-1].b}, sum n_recomputed "
        f"{sum(r.n_recomputed for r in tel)}, converged {km.converged_}, "
        f"final val MSE {km.final_mse_!r}, wall {wall:.2f} s (rounds "
        f"{km.telemetry_[-1].t:.3f} s), peak device memory "
        f"{peak / 2 ** 30:.2f} GiB ({smi})")
    log(f"    launches (fit + predict): {launches}")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in the RCV1 "
             f"fit")
    C = km.cluster_centers_
    need(C.shape == (k, RCV1_D) and bool(np.isfinite(C).all()),
         "RCV1: centroids are not finite (k, d)")
    need(labels.shape == (RCV1_N,) and labels.min() >= 0
         and labels.max() < k, "RCV1: predict labels")
    need(km.converged_ is False or np.array_equal(labels, km.labels_),
         "RCV1: a converged fit's labels differ from predict")
    km2, wall2 = _rcv1_fit(X, Xv)
    same = np.array_equal(km2.cluster_centers_, C) \
        and np.array_equal(km2.labels_, km.labels_)
    kmr, wallr = _rcv1_fit(X, Xv, kernel_backend="ref")
    kmr2, wallr2 = _rcv1_fit(X, Xv, kernel_backend="ref")
    rel = abs(kmr.final_mse_ - km.final_mse_) / abs(kmr.final_mse_)
    same_ref = np.array_equal(kmr2.cluster_centers_, kmr.cluster_centers_) \
        and np.array_equal(kmr2.labels_, kmr.labels_)
    log(f"    second cuda fit: wall {wall2:.2f} s, bit-identical: {same}; "
        f"ref fit (plain versions on the card): "
        f"{sum(r.batch_mse is not None for r in kmr.telemetry_)} rounds, "
        f"final val MSE {kmr.final_mse_!r}, wall {wallr:.2f} s, relative "
        f"gap {rel:.3g}; a second ref fit (wall {wallr2:.2f} s) "
        f"bit-identical: {same_ref}; the cuda and ref schedules part at "
        f"round {_parts_at(km, kmr)}")
    need(same, "RCV1: a second identical fit is not bit-identical")
    need(rel <= 1e-3, "RCV1: cuda and ref fits differ in val MSE beyond "
         "1e-3")
    need(same_ref, "RCV1: two ref fits on the card differ")
    del km2, kmr, kmr2
    log(f"    kernels 1-3 at d = {RCV1_D}, k = {k} on the {RCV1_N} rows "
        f"and the fitted centroids:")
    check_wide_kernels(torch.from_numpy(X).to(DEV),
                       torch.from_numpy(C).to(DEV), (k,), smi)
    torch.cuda.empty_cache()
    log(f"    phase 16 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 17

#: phase 17: the encdec and vlm families from seed 0, phase 13's prompt
#: and phase 14's training defaults. internvl2-76b's 80 layers are 70.55 B
#: parameters (131.4 GiB in bf16, more than the card holds): served at 8
#: layers (8.95 B) and trained at 1 (2.96 B: bf16 weights, f32 moments
#: and accumulators).
ENCDEC_ARCH, VLM_ARCH = "whisper-tiny", "internvl2-76b"
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS = 8, 1
ENCDEC_STEPS = 10


def _cut(cfg, n_layers: int):
    import dataclasses
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, n_layers))


def _modality_inputs(cfg, batch: int) -> dict:
    """Normal frame (encdec) or patch (vlm) embeddings from the numpy
    seed `LM_SEED`, bf16 on the card: zeros, the CLIs' stubs, would
    leave the encoder's input to the sinusoid alone."""
    e = cfg.encoder
    name, width = (("frames", e.d_frontend) if cfg.family == "encdec"
                   else ("patches", cfg.d_model))
    x = np.random.default_rng(LM_SEED).standard_normal(
        (batch, e.n_ctx, width), dtype=np.float32)
    return {name: torch.from_numpy(x).to(DEV, torch.bfloat16)}


def encdec_serve(smi: str) -> dict:
    """(a): whisper-tiny served twice on normal frames (the same
    tokens); decode against the prefill one token longer in f32 and
    bf16 (`decode_checks`: decode adds `sinusoid_at(32)` where that
    prefill adds `sinusoid`'s row 32); then served once more on the
    serve CLI's zero frames, whose tokens (e) holds the CLI to."""
    from repro_torch.launch.serve import generate, modality_stubs
    cfg = _family_config(ENCDEC_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, t_init, n_params = _init_model(cfg)
    d = cfg.d_model
    # ModelConfig.param_count() counts neither the decoder's cross
    # attention and its norm (4 d^2 + d a layer) nor the final norm (d)
    # nor enc_in
    extra = cfg.n_layers * (4 * d * d + d) + d + (
        cfg.encoder.d_frontend * d if cfg.encoder.d_frontend != d else 0)
    need(n_params == cfg.param_count() + extra,
         f"(a): the model has {n_params} parameters, its config "
         f"{cfg.param_count()} + {extra} (cross attention, ln_x, ln_f)")
    inputs = _modality_inputs(cfg, LM_BATCH)
    model = serve_model(cfg, params, smi, "(a)", t_init, n_params, inputs)
    tokens, nxt = model["tokens"], model["nxt"]
    decode_checks(
        _decode_vs_prefill(cfg, params, tokens, nxt, inputs),
        _decode_vs_prefill(cfg, _f32_copy(params), tokens, nxt, inputs),
        "(a)")
    stub = generate(cfg, params, tokens, LM_GEN,
                    inputs=modality_stubs(cfg, LM_BATCH, DEV))
    log(f"        on the CLI's zero frames: row 0's tokens "
        f"{stub['gen'][0].tolist()} (normal frames: "
        f"{model['gen'][0].tolist()})")
    E = params["embed"].float().cpu().numpy()
    del model, params
    torch.cuda.empty_cache()
    return {"gen_stub": stub["gen"], "E": E}


def encdec_train(smi: str) -> None:
    """(b): `ENCDEC_STEPS` steps of the train CLI's step on whisper-tiny
    (normal frames over the CLI's stubs): the loss falls; then
    `DET_STEPS` steps twice, bit-equal."""
    cfg = _family_config(ENCDEC_ARCH)
    inputs = _modality_inputs(cfg, TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    params, opt = _train_state(cfg)
    walls, metrics = [], []
    params, opt, _ = _train_steps(cfg, params, opt, range(ENCDEC_STEPS),
                                  timed=walls, metrics=metrics,
                                  inputs=inputs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    ms = float(np.median(walls[1:])) * 1e3
    log(f"    (b) {cfg.arch_id} training, batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ} (+ {cfg.encoder.n_ctx} frames a row through the "
        f"encoder) in {TRAIN_MICRO} microbatches, remat on, f32 moments and "
        f"accumulators: {ENCDEC_STEPS} steps, {ms:.3f} ms a step (median "
        f"of steps 1-{ENCDEC_STEPS - 1}; step 0 {walls[0] * 1e3:.3f} ms; "
        f"min {min(walls[1:]) * 1e3:.3f}, max {max(walls[1:]) * 1e3:.3f}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak "
        f"{peak:.2f} GiB ({smi}); loss by step "
        f"{[round(x, 4) for x in losses]}; grad norm by step "
        f"{[round(x, 4) for x in norms]}")
    need(all(math.isfinite(x) for x in losses + norms),
         "(b): a loss or gradient norm is not finite")
    need(losses[-1] < losses[0], f"(b): the loss did not fall: {losses[0]}"
         f" at step 0, {losses[-1]} at step {ENCDEC_STEPS - 1}")
    del params, opt
    torch.cuda.empty_cache()
    _repeat_steps(cfg, "(b)", inputs)


def vlm_serve(smi: str) -> None:
    """(c): internvl2-76b at `VLM_SERVE_LAYERS` layers served twice in
    bf16 on normal patches (the same tokens), its cache sized as the
    serve CLI sizes it (patches + prompt + generated tokens); decode
    against the prefill one token longer in bf16, then, the model's
    leaves upcast one by one in place, in f32 (`decode_checks`)."""
    from repro_torch.launch.serve import cache_len
    cfg = _cut(_family_config(VLM_ARCH), VLM_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params, t_init, n_params = _init_model(cfg)
    need(n_params == cfg.param_count() + cfg.d_model,
         f"(c): the model has {n_params} parameters, its config "
         f"{cfg.param_count()} (+ the final norm's {cfg.d_model})")
    inputs = _modality_inputs(cfg, LM_BATCH)
    model = serve_model(cfg, params, smi, "(c)", t_init, n_params, inputs)
    tokens, nxt = model["tokens"], model["nxt"]
    del model
    bf16 = _decode_vs_prefill(cfg, params, tokens, nxt, inputs)
    torch.cuda.empty_cache()
    _upcast_in_place(params)
    f32 = _decode_vs_prefill(cfg, params, tokens, nxt, inputs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    decode_checks(bf16, f32, "(c)", prefix=cfg.encoder.n_ctx)
    log(f"        cache of {cache_len(cfg, LM_PROMPT, LM_GEN)} positions "
        f"({cfg.encoder.n_ctx} patches + {LM_PROMPT} + {LM_GEN}); the f32 "
        f"model ({n_params:,} parameters upcast leaf by leaf): peak "
        f"{peak:.2f} GiB over (c) ({smi})")
    del params, bf16, f32
    torch.cuda.empty_cache()


def vlm_train(smi: str) -> None:
    """(d): internvl2-76b at `VLM_TRAIN_LAYERS` layer(s): the train CLI's
    step over the patches and the CLI's batch (seq 128 is not longer
    than the 256 patches, so every token stays, as in JAX); the loss is
    taken after the patch prefix is stripped. `DET_STEPS` steps twice,
    bit-equal, the first run's state held in host memory."""
    cfg = _cut(_family_config(VLM_ARCH), VLM_TRAIN_LAYERS)
    n = cfg.param_count() + cfg.d_model
    p = cfg.encoder.n_ctx
    seq = TRAIN_SEQ - p if TRAIN_SEQ > p else TRAIN_SEQ   # `lm_batch`
    log(f"    (d) {cfg.arch_id} training at {cfg.n_layers} layer(s) "
        f"({n:,} parameters), batch {TRAIN_BATCH} x ({p} patches + {seq} "
        f"tokens) in "
        f"{TRAIN_MICRO} microbatches; reckoned states: bf16 weights "
        f"{2 * n / 2 ** 30:.2f} GiB, f32 moments {8 * n / 2 ** 30:.2f} GiB,"
        f" f32 accumulators {4 * n / 2 ** 30:.2f} GiB, bf16 gradients "
        f"{2 * n / 2 ** 30:.2f} GiB: {16 * n / 2 ** 30:.2f} GiB")
    inputs = _modality_inputs(cfg, TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _repeat_steps(cfg, "(d)", inputs, on_host=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"        the two runs with their host copies in "
        f"{time.perf_counter() - t0:.1f} s; peak {peak:.2f} GiB ({smi})")


def encdec_vlm_phase(smi: str) -> dict:
    """Phase 17: the encdec and vlm families at full width (internvl2 cut
    in depth), serving and training, the codebook over whisper's table
    and the serve CLI on whisper. Returns the launch counts of (e)."""
    t0 = time.perf_counter()
    log(f"[17] the encdec and vlm families: {ENCDEC_ARCH} served and "
        f"trained, a k={CODEBOOK_K} codebook over its embeddings and the "
        f"serve CLI; {VLM_ARCH} served at {VLM_SERVE_LAYERS} layers and "
        f"trained at {VLM_TRAIN_LAYERS}")
    launches = dict.fromkeys(REPLACES, 0)
    served = encdec_serve(smi)
    E = served["E"]
    km = codebook_fits(E, launches, f"(e) on {ENCDEC_ARCH}'s table:")
    codebook_kernels({"E": E, "C": km.cluster_centers_, "b0": km.config.b0},
                     smi)
    cmd, wall, cb, tm, sv = run_serve_cli(
        ENCDEC_ARCH, served["gen_stub"][0].tolist(), E.shape, "(e)")
    need(int(cb[5]) == km.n_rounds_, f"(e): the CLI's codebook took "
         f"{cb[5]} rounds, the in-process fit {km.n_rounds_}")
    log(f"    (e) {' '.join(cmd[1:])}: rc 0 in {wall:.1f} s; codebook "
        f"{cb[4]} s, {cb[5]} rounds (the in-process fit's); prefill {tm[3]}"
        f" ms, {tm[4]} decode steps in {tm[5]} ms ({tm[6]} tok/s) on "
        f"{tm[7]}; row 0's tokens equal (a)'s on the zero frames; service: "
        f"{sv[1]} refreshes over {sv[2]} embeddings, {sv[4]} deduped, "
        f"snapshot v{sv[3]}")
    del km, E, served
    encdec_train(smi)
    vlm_serve(smi)
    vlm_train(smi)
    log(f"    launches in phase 17: {launches}; phase 17 took "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("assign_top2", "cluster_sum", "fused_nested_round"):
        need(launches[name] > 0, f"{name} was never launched in phase 17")
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------- phase 18

#: phase 18: the sharded train step. (a) granite-moe at full width on a
#: one-rank NCCL (1, 1) mesh against the local step, `SHARD_STEPS` steps;
#: (b) granite on 2 gloo ranks sharing the card, (1, 2): EP + TP; (c)
#: whisper-tiny at full width on 4 gloo ranks, (1, 4): context-parallel
#: decoder attention, the bidirectional encoder's attention whole on every
#: rank, TP MLPs; (d) tinyllama-1.1b cut to `SHARD_D_LAYERS` layers on
#: (2, 2): FSDP + TP + data parallelism, `SHARD_D_STEPS` steps
SHARD_STEPS, SHARD_D_STEPS, SHARD_D_LAYERS = 2, 2, 2
SHARD_JOIN_S = 600.0
SHARD_F32_TOL, SHARD_BF16_TOL = 1e-5, 6e-2
SHARD_ARCHS = {"b": MOE_ARCH, "c": ENCDEC_ARCH, "d": LM_ARCH}
SHARD_MESHES = {"b": (1, 2), "c": (1, 4), "d": (2, 2)}


def _shard_config(part: str):
    cfg = _family_config(SHARD_ARCHS[part])
    return _cut(cfg, SHARD_D_LAYERS) if part == "d" else cfg


def _spent(timed) -> float:
    return 0.0 if timed is None else sum(v[0] for v in timed.spent.values())


def _shard_run(cfg, steps: int, *, mesh=None, f32=False, walls=None,
               timed=None):
    """``steps`` train steps of the train CLI's batch (`lm_batch` on
    `LMBatches` from `LM_SEED`, normal frame stubs for whisper) and
    optimizer from `_train_state`'s weights, upcast in the f32 arm: the
    local step, or the sharded step on ``mesh`` (the params laid out by
    `param_specs`, each step's batch by `batch_specs`). Returns (every
    param, moment and the count, then the losses: this rank's blocks,
    whole on a one-rank mesh; the seconds ``timed``, a
    `_TimedCollectives`, spent inside the steps)."""
    from repro_torch.data.pipeline import LMBatches
    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    params = M.init_params(LM_SEED, cfg, DEV)
    if f32:
        _upcast_in_place(params)
    specs = None
    if mesh is not None:
        specs = S.param_specs(cfg, mesh, abstract_params(cfg))
        params = S.shard_tree(params, specs, mesh)
        torch.cuda.empty_cache()
    opt = adamw.init(params)
    step = tstep.make_train_step(
        cfg, n_micro=TRAIN_MICRO, mesh=mesh, device=DEV,
        opt_cfg=adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=10,
                                  decay_steps=100))
    data = LMBatches(vocab=cfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     seed=LM_SEED)
    extra = (_modality_inputs(cfg, TRAIN_BATCH)
             if cfg.family in ("encdec", "vlm") else {})
    losses, coll = [], 0.0
    for s in range(steps):
        batch = dict(lm_batch(cfg, data.at(s), DEV), **extra)
        if f32:
            batch = {k: v.float() if v.is_floating_point() else v
                     for k, v in batch.items()}
        if mesh is not None:
            batch = S.shard_tree(batch, S.batch_specs(cfg, mesh, batch),
                                 mesh)
        torch.cuda.synchronize()
        c0, t0 = _spent(timed), time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        if walls is not None:
            walls.append(time.perf_counter() - t0)
        coll += _spent(timed) - c0
        losses.append(m["loss"])
    return _state_leaves(params, opt) + losses, coll


def shard_rank(rank: int, world: int, root: str, addr: str) -> None:
    """One spawned rank of phase 18's (b), or of (c) and (d): a gloo
    group whose ranks all compute on the one card. Each run: its losses,
    each step's wall, the peak memory and the time in collectives (a
    second run timed with `_TimedCollectives`; two runs must repeat the
    bits of the rank's blocks); writes ``rank<r>_<part>.npz`` under
    ``root``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    if not torch.cuda.is_available():
        raise Failure(f"rank {rank} sees no CUDA device")
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for part in (("b",) if world == 2 else ("c", "d")):
            cfg = _shard_config(part)
            mesh = make_host_mesh(SHARD_MESHES[part], ("data", "model"))
            steps = SHARD_D_STEPS if part == "d" else SHARD_STEPS
            arms = {"b": (False, False), "c": (True, False),
                    "d": (True, True)}[part]
            out = {}
            for i, f32 in enumerate(arms):
                walls = []
                torch.cuda.reset_peak_memory_stats()
                if i == len(arms) - 1:
                    with _TimedCollectives() as timed:
                        got, coll = _shard_run(cfg, steps, mesh=mesh,
                                               f32=f32, walls=walls,
                                               timed=timed)
                    out["coll_s"] = np.float64(coll)
                    out["coll_n"] = np.int64(sum(
                        v[1] for v in timed.spent.values()))
                    out["timed_walls"] = np.array(walls)
                else:
                    got, _ = _shard_run(cfg, steps, mesh=mesh, f32=f32,
                                        walls=walls)
                    out["walls"] = np.array(walls)
                out["peak"] = np.float64(torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
                out[f"losses{i}"] = np.array([float(x)
                                              for x in got[-steps:]])
                if part in ("b", "d"):
                    if i == 0:
                        first = got
                    else:
                        out["same"] = np.array(all(
                            torch.equal(a, b) for a, b in zip(first, got)))
                        del first
                del got
                torch.cuda.empty_cache()
            np.savez(os.path.join(root, f"rank{rank}_{part}.npz"), **out)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _shard_report(root: str, part: str, world: int, steps: int) -> list:
    """Logs each rank's ms a step, tokens/s, peak and the collectives'
    share of the timed run; returns the ranks' records."""
    ranks = [dict(np.load(os.path.join(root, f"rank{r}_{part}.npz")))
             for r in range(world)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = [float(np.median(r["walls"][1:] if "walls" in r
                          else r["timed_walls"][1:])) * 1e3 for r in ranks]
    share = [float(r["coll_s"]) / float(r["timed_walls"].sum())
             for r in ranks]
    log(f"        ms a step by rank (median of steps 1-{steps - 1}) "
        f"{[round(x, 3) for x in ms]}; {tokens / max(ms) * 1e3:.0f} "
        f"tokens/s; peak by rank "
        f"{[round(float(r['peak']), 2) for r in ranks]} GiB; collectives "
        f"{[int(r['coll_n']) for r in ranks]} calls, "
        f"{[round(x * 100, 1) for x in share]} % of the timed run's "
        f"steps (each drained before and after; that run's ms a step "
        f"{[round(float(np.median(r['timed_walls'][1:])) * 1e3, 3) for r in ranks]})")
    return ranks


def sharded_train_phase(smi: str) -> None:
    """Phase 18: the sharded train step (`make_train_step(...,
    mesh=...)`) on one NCCL rank and on 2 and 4 gloo ranks sharing the
    card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    log(f"[18] sharded training: {MOE_ARCH} on a one-rank NCCL (1, 1) mesh "
        f"and on 2 gloo ranks (1, 2), {ENCDEC_ARCH} on 4 gloo ranks (1, 4), "
        f"{LM_ARCH} cut to {SHARD_D_LAYERS} layers on (2, 2); batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ} in {TRAIN_MICRO} microbatches "
        f"({smi})")
    cfg = _shard_config("b")
    walls = []
    local, _ = _shard_run(cfg, SHARD_STEPS, walls=walls)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    backend = "nccl" if DEV == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"))
        need(dist.get_backend() == backend, "the one-rank group is not "
             f"{backend}")
        torch.cuda.reset_peak_memory_stats()
        swalls = []
        sharded, _ = _shard_run(cfg, SHARD_STEPS, mesh=mesh, walls=swalls)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        dist.destroy_process_group()
    same = [bool(torch.equal(a, b)) for a, b in zip(local, sharded)]
    a_losses = [float(x) for x in sharded[-SHARD_STEPS:]]
    ms = float(np.median(swalls[1:])) * 1e3
    log(f"    (a) {cfg.arch_id} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}) "
        f"on one NCCL rank: {ms:.3f} ms a step (the local step "
        f"{float(np.median(walls[1:])) * 1e3:.3f}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s, peak "
        f"{peak:.2f} GiB; losses {a_losses}; every param, moment, the count "
        f"and the losses bit-equal to the local step's: {all(same)} "
        f"({sum(same)} of {len(same)})")
    need(all(same), "(a): the one-rank sharded step differs from the local "
         "step")
    del local, sharded
    torch.cuda.empty_cache()

    # the one-rank references of (c) and (d)
    refs = {}
    for part, arms in (("c", (True, False)), ("d", (True,))):
        steps = SHARD_D_STEPS if part == "d" else SHARD_STEPS
        for f32 in arms:
            got, _ = _shard_run(_shard_config(part), steps, f32=f32)
            refs[part, f32] = [float(x) for x in got[-steps:]]
            del got
            torch.cuda.empty_cache()

    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        for world, parts in ((2, ("b",)), (4, ("c", "d"))):
            t1 = time.perf_counter()
            _spawn_ranks(root, shard_rank, world, SHARD_JOIN_S)
            log(f"    {world} spawned gloo ranks took "
                f"{time.perf_counter() - t1:.1f} s")
            for part in parts:
                cfg = _shard_config(part)
                steps = SHARD_D_STEPS if part == "d" else SHARD_STEPS
                log(f"    ({part}) {cfg.arch_id} ({cfg.n_layers} layers) on "
                    f"{world} gloo ranks, ('data', 'model') = "
                    f"{SHARD_MESHES[part]}:")
                ranks = _shard_report(root, part, world, steps)
                for r in ranks:
                    need(np.array_equal(r["losses0"], ranks[0]["losses0"]),
                         f"({part}): the ranks' losses differ")
                got = [float(x) for x in ranks[0]["losses0"]]
                if part == "b":
                    gap = max(abs(a - b) for a, b in zip(got, a_losses))
                    log(f"        losses {got}; (a)'s {a_losses}: largest "
                        f"gap {gap:.3e} (tolerance {SHARD_BF16_TOL})")
                    need(gap <= SHARD_BF16_TOL, "(b): the losses are not "
                         "within tolerance of (a)'s")
                else:
                    gap = max(abs(a - b) for a, b in zip(got, refs[part,
                                                                  True]))
                    log(f"        f32 arm losses {got}; one rank's "
                        f"{refs[part, True]}: largest gap {gap:.3e} "
                        f"(tolerance {SHARD_F32_TOL})")
                    need(gap <= SHARD_F32_TOL, f"({part}): the f32 arm is "
                         f"not within tolerance of its one-rank step")
                if part == "c":
                    got = [float(x) for x in ranks[0]["losses1"]]
                    gap = max(abs(a - b) for a, b in zip(got, refs["c",
                                                                  False]))
                    log(f"        bf16 arm losses {got}; one rank's "
                        f"{refs['c', False]}: largest gap {gap:.3e} "
                        f"(tolerance {SHARD_BF16_TOL})")
                    need(gap <= SHARD_BF16_TOL, "(c): the bf16 arm is not "
                         "within tolerance of its one-rank step")
                if part in ("b", "d"):
                    same = [bool(r["same"]) for r in ranks]
                    log(f"        two runs: every block of every param and "
                        f"moment, the count and the losses bit-equal on "
                        f"every rank: {all(same)}")
                    need(all(same), f"({part}): two runs of the sharded "
                         f"steps differ")
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    log(f"    phase 18 took {time.perf_counter() - t0:.1f} s")

# ---------------------------------------------------------------- phase 19

#: phase 19: the sharded serving steps and the dry run. (a) LM_ARCH and
#: MOE_ARCH at full width on a one-rank NCCL (1, 1) mesh against the
#: unsharded steps, phase 13's prompt and `SERVE_GEN` greedy steps; (b)
#: LM_ARCH cut to `SERVE_B_LAYERS` layers, f32, on 2 gloo ranks sharing
#: the card, (1, 2), against its one-rank run; (c) the dry run's
#: `DRY_CELLS` and its kmeans cells, each a `python -m
#: repro_torch.launch.dryrun` subprocess started with the script (no card
#: needed) and read here; (d) the counter against the card.
SERVE_GEN, SERVE_B_LAYERS = 4, 2
SERVE_F32_RTOL = 1e-5        # tests/test_torch_sharded_serve.py's F32_RTOL
SERVE_JOIN_S = 300.0
DRY_CELLS = ((LM_ARCH, "prefill_32k", False), (LM_ARCH, "decode_32k", False),
             ("mamba2-2.7b", "long_500k", True))
DRY_TIMEOUT_S = 900.0


def start_dry_runs() -> dict:
    """(c)'s subprocesses, started at once: one a cell of `DRY_CELLS`
    and one for ``--kmeans``, each writing its records to a directory of
    its own. They need no card, so they run beside the earlier phases."""
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    runs = {}
    for i, (arch, shape, mp) in enumerate(DRY_CELLS + ((None, None, None),)):
        out = os.path.join(root, str(i))
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--out", out]
        cmd += (["--kmeans"] if arch is None else
                ["--arch", arch, "--shape", shape]
                + (["--multi-pod"] if mp else []))
        runs[i] = (cmd, out, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), time.perf_counter())
    return {"root": root, "runs": runs}


def stop_dry_runs(dry) -> None:
    """Kill (c)'s subprocesses that are still running and remove their
    records."""
    import shutil
    for _, _, proc, _ in dry["runs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(dry["root"], ignore_errors=True)


def _serve_run(cfg, params, tokens, gen: int, mesh=None):
    """The prefill of ``tokens`` and ``gen`` greedy decode steps through
    `make_prefill_step`/`make_decode_step` (with ``mesh``, the sharded
    steps on this rank's blocks, the logits put together by
    `whole_logits`): (the last position's logits of each step, the
    tokens, the prefill's ms, the decode steps' ms)."""
    from repro_torch.launch.serve import cache_len
    from repro_torch.models import sharding as S
    from repro_torch.train import step as tstep
    kw = {} if mesh is None else {"mesh": mesh, "device": DEV}
    pre = tstep.make_prefill_step(
        cfg, cache_len=cache_len(cfg, tokens.shape[1], gen), **kw)
    dec = tstep.make_decode_step(cfg, **kw)
    rows = tokens
    if mesh is not None:
        rows = S.shard_tree({"t": tokens}, {"t": (S.data_axes(mesh), None)},
                            mesh)["t"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre(params, {"tokens": rows})
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    whole = tstep.whole_logits(logits, cfg, mesh)[:, -1]
    out, toks, t_dec = [whole], [], []
    for _ in range(gen):
        tok = whole.argmax(-1, keepdim=True).int()
        toks.append(tok)
        if mesh is not None:
            tok = S.shard_tree({"t": tok}, {"t": (S.data_axes(mesh), None)},
                               mesh)["t"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = dec(params, tok, cache)
        torch.cuda.synchronize()
        t_dec.append(time.perf_counter() - t0)
        whole = tstep.whole_logits(logits, cfg, mesh)[:, -1]
        out.append(whole)
    return (torch.stack(out), torch.cat(toks, dim=1), t_pre * 1e3,
            [t * 1e3 for t in t_dec])


def _prompt(cfg, batch: int = LM_BATCH):
    rng = np.random.default_rng(LM_SEED)
    return torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (batch, LM_PROMPT))).to(DEV)


def _flops_counted(cfg, params, tokens, mesh):
    """(d): FlopCounterMode's FLOPs over the sharded prefill and one
    decode step on the card, and `op_cost`'s over the same steps traced
    on fake tensors of the same shapes (FakeTensorMode on the card's
    device); the cost of each, the fake trace's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.serve import cache_len
    from repro_torch.roofline import op_cost
    from repro_torch.train import step as tstep
    pre = tstep.make_prefill_step(
        cfg, cache_len=cache_len(cfg, tokens.shape[1], SERVE_GEN),
        mesh=mesh, device=DEV)
    dec = tstep.make_decode_step(cfg, mesh=mesh, device=DEV)
    real = {}
    with FlopCounterMode(display=False) as fc:
        _, cache = pre(params, {"tokens": tokens})
    real["prefill"] = fc.get_total_flops()
    tok = tokens[:, :1].int()
    with FlopCounterMode(display=False) as fc:
        dec(params, tok, cache)
    real["decode"] = fc.get_total_flops()
    del cache
    with FakeTensorMode() as fm:
        fp = tree_map(fm.from_tensor, params)
        ft = fm.from_tensor(tokens)
        c_pre, (_, fcache), _ = op_cost.analyze(pre, fp, {"tokens": ft})
        c_dec, _, _ = op_cost.analyze(dec, fp, fm.from_tensor(tok), fcache)
    return real, {"prefill": c_pre, "decode": c_dec}


def serve_one_rank(smi: str) -> dict:
    """(a) and (d): the sharded serving steps on a one-rank NCCL mesh
    against the unsharded ones, bit for bit; the counts and bounds of
    tinyllama's prefill and decode step."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as S
    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.roofline.analysis import roofline_terms as terms
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    backend = "nccl" if DEV == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{_free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=120))
    counted = {}
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"))
        need(dist.get_backend() == backend, f"the one-rank group is not "
             f"{backend}")
        for arch in (LM_ARCH, MOE_ARCH):
            cfg = _family_config(arch)
            torch.cuda.reset_peak_memory_stats()
            params, t_init, n_params = _init_model(cfg)
            tokens = _prompt(cfg)
            _serve_run(cfg, params, tokens, 1)            # warm-up
            want = _serve_run(cfg, params, tokens, SERVE_GEN)
            local = S.shard_tree(params, S.param_specs(
                cfg, mesh, abstract_params(cfg)), mesh)
            got = _serve_run(cfg, local, tokens, SERVE_GEN, mesh)
            same_l = torch.equal(got[0], want[0])
            same_t = torch.equal(got[1], want[1])
            log(f"    (a) {cfg.arch_id} at full width ({n_params:,} "
                f"parameters from seed {LM_SEED}), batch {LM_BATCH}, prompt "
                f"{LM_PROMPT}, {SERVE_GEN} greedy steps on a one-rank NCCL "
                f"(1, 1) mesh: prefill {got[2]:.3f} ms (unsharded "
                f"{want[2]:.3f}), {np.median(got[3]):.3f} ms a decode step "
                f"(unsharded {np.median(want[3]):.3f}), peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
                f"tokens {got[1][0].tolist()} (row 0); logits bit-equal to "
                f"the unsharded steps': {same_l}, tokens: {same_t}")
            need(same_l and same_t, f"(a) {arch}: the one-rank sharded "
                 f"serving steps differ from the unsharded ones")
            if arch == LM_ARCH:
                real, fake = _flops_counted(cfg, local, tokens, mesh)
                counted = {"real": real, "fake": fake,
                           "ms": {"prefill": got[2],
                                  "decode": float(np.median(got[3]))}}
            del params, local, want, got
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for what in ("prefill", "decode"):
        c = counted["fake"][what]
        r = terms(c.flops_by_dtype.get("f32", 0.0), c.bytes,
                  bf16_flops=c.flops_by_dtype.get("bf16", 0.0))
        ms, bound = counted["ms"][what], r.step_time_s() * 1e3
        log(f"    (d) {LM_ARCH} {what} (one rank): FlopCounterMode over the "
            f"CUDA run {counted['real'][what]:.6g} FLOPs, op_cost over the "
            f"fake trace {c.flops:.6g} ({c.flops_by_dtype}); bytes "
            f"{c.bytes:.6g}, peak {c.peak_bytes / 2 ** 30:.2f} GiB; bound "
            f"{bound:.4f} ms ({r.bottleneck}) against {ms:.3f} ms measured: "
            f"{bound / ms * 100:.3f} % of it ({smi})")
        need(c.flops == counted["real"][what], f"(d) {what}: the fake trace "
             f"counts other FLOPs than the CUDA run")
        need(bound <= ms, f"(d) {what}: the measured time is below the "
             f"counted bound (a wrong count or rate)")
    return counted


def serve_rank(rank: int, world: int, root: str, addr: str) -> None:
    """One of (b)'s 2 gloo ranks on the card: LM_ARCH cut to
    `SERVE_B_LAYERS` layers, f32, on (1, 2); writes its logits and
    tokens to ``rank<r>_serve.npz``."""
    import torch.distributed as dist

    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    if not torch.cuda.is_available():
        raise Failure(f"rank {rank} sees no CUDA device")
    dist.init_process_group("gloo", init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh((1, world), ("data", "model"))
        cfg = _cut(_family_config(LM_ARCH), SERVE_B_LAYERS)
        params = M.init_params(LM_SEED, cfg, DEV)
        _upcast_in_place(params)
        local = S.shard_tree(params, S.param_specs(
            cfg, mesh, abstract_params(cfg)), mesh)
        del params
        logits, toks, t_pre, t_dec = _serve_run(cfg, local, _prompt(cfg),
                                                SERVE_GEN, mesh)
        np.savez(os.path.join(root, f"rank{rank}_serve.npz"),
                 logits=logits.cpu().numpy(), toks=toks.cpu().numpy(),
                 t_pre=np.float64(t_pre), t_dec=np.array(t_dec))
    finally:
        dist.destroy_process_group()


def serve_two_ranks() -> None:
    """(b): 2 gloo ranks on the card against the one-rank run."""
    import shutil
    import tempfile

    from repro_torch.models import model as M
    cfg = _cut(_family_config(LM_ARCH), SERVE_B_LAYERS)
    params = M.init_params(LM_SEED, cfg, DEV)
    _upcast_in_place(params)
    want = _serve_run(cfg, params, _prompt(cfg), SERVE_GEN)
    del params
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        t1 = time.perf_counter()
        _spawn_ranks(root, serve_rank, 2, SERVE_JOIN_S)
        ranks = [dict(np.load(os.path.join(root, f"rank{r}_serve.npz")))
                 for r in range(2)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ref = want[0].cpu().numpy().astype(np.float64)
    rels = [float(np.linalg.norm(r["logits"] - ref) / np.linalg.norm(ref))
            for r in ranks]
    same = [bool(np.array_equal(r["toks"], want[1].cpu().numpy()))
            for r in ranks]
    log(f"    (b) {cfg.arch_id} cut to {SERVE_B_LAYERS} layers, f32, on 2 "
        f"gloo ranks sharing the card, ('data', 'model') = (1, 2), "
        f"{time.perf_counter() - t1:.1f} s with the processes' start: "
        f"prefill {[round(float(r['t_pre']), 3) for r in ranks]} ms by "
        f"rank (one rank {want[2]:.3f}), "
        f"{[round(float(np.median(r['t_dec'])), 3) for r in ranks]} ms a "
        f"decode step (one rank {np.median(want[3]):.3f}); logits "
        f"relative (Frobenius) to one rank's {rels} (held to "
        f"{SERVE_F32_RTOL}); tokens one rank's: {same}")
    need(all(same), "(b): the 2-rank tokens differ from the one-rank run's")
    need(max(rels) <= SERVE_F32_RTOL, "(b): the 2-rank logits are not within "
         "tolerance of the one-rank run's")


def dry_run_records(dry, kernel4_ms: float, smi: str) -> None:
    """(c): wait for the dry run's subprocesses, log each record's line,
    and (d) set kmeans_xl's ``kernel_analytic`` bound beside phase 6's
    kernel-4 time."""
    recs = {}
    for i, (cmd, out, proc, t0) in dry["runs"].items():
        try:
            text, _ = proc.communicate(timeout=DRY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise Failure(f"(c) {' '.join(cmd[2:])} did not end in "
                          f"{DRY_TIMEOUT_S:.0f} s")
        lines = [ln for ln in text.splitlines() if ln.startswith("[")]
        for ln in lines:
            log(f"    (c) {ln}")
        log(f"        ({' '.join(cmd[3:])}: rc {proc.returncode}, read "
            f"{time.perf_counter() - t0:.1f} s after its start)")
        need(proc.returncode == 0, f"(c) {' '.join(cmd[2:])} failed:\n"
             + text[-3000:])
        for f in sorted(Path(out).glob("*.json")):
            recs[f.stem] = json.loads(f.read_text())
    need(len(recs) == len(DRY_CELLS) + 3, f"(c): {len(recs)} records")
    for cell, r in recs.items():
        need(r.get("ok") is True, f"(c) {cell}: {r.get('error')}")
        if r["kind"] != "kmeans":
            log(f"        {cell}: peak {r['memory']['peak_bytes'] / 1e9:.2f} "
                f"GB a device (fits 80 GB: {r['memory']['fits_hbm']}), "
                f"wire {r['collectives']}, model FLOPs "
                f"{r['model_flops_per_device']:.4g} a device")
    ka = recs["kmeans_xl__round__pod16x16"]["kernel_analytic"]
    log(f"    (d) kmeans_xl__round__pod16x16's kernel_analytic bound "
        f"{ka['bound_ms']:.3f} ms ({ka['bottleneck']}; PERF.md's kernel-4 "
        f"row: 213.303) against phase 6's kernel-4 time {kernel4_ms:.3f} ms "
        f"in this run: {ka['bound_ms'] / kernel4_ms * 100:.1f} % of it "
        f"({smi})")
    need(round(ka["bound_ms"], 3) == 213.303, "(d): kmeans_xl's "
         "kernel_analytic bound is not the kernel-4 row's 213.303 ms")
    need(ka["bound_ms"] <= kernel4_ms, "(d): phase 6's kernel 4 ran below "
         "its bound")


def sharded_serve_phase(dry, kernel4_ms: float, smi: str) -> None:
    """Phase 19: the sharded prefill and decode steps and the dry run."""
    t0 = time.perf_counter()
    log(f"[19] sharded serving (make_prefill_step/make_decode_step with "
        f"mesh=): {LM_ARCH} and {MOE_ARCH} on a one-rank NCCL (1, 1) mesh, "
        f"{LM_ARCH} cut to {SERVE_B_LAYERS} layers on 2 gloo ranks (1, 2); "
        f"the dry run (python -m repro_torch.launch.dryrun) on the host "
        f"({smi})")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        del FakeStore
    except ImportError as e:
        raise Failure(f"(c): this torch has no fake process group: {e}")
    serve_one_rank(smi)
    serve_two_ranks()
    dry_run_records(dry, kernel4_ms, smi)
    log(f"    phase 19 took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    lap = [t0]

    def took(n: int) -> None:
        # phases 8-15 log their own time
        now = time.perf_counter()
        log(f"    phase {n} took {now - lap[0]:.1f} s")
        lap[0] = now

    dev = device_phase()
    took(1)
    dry = start_dry_runs()
    try:
        return _phases(dev, dry, t0, took)
    finally:
        stop_dry_runs(dry)


def _phases(dev, dry, t0, took) -> int:
    build_phase()
    took(2)
    errs = compare_phase()
    took(3)
    main = main_path_phase()
    took(4)
    times = timing_phase(main["X"])
    took(5)
    xl = xl_phase()
    took(6)
    X, Xv = main.pop("X"), main.pop("Xv")
    untraced = main.pop("fit")
    unbroken = other_paths_phase(X, Xv, main.pop("curve"))
    took(7)
    resume_phase(X, Xv, dict(unbroken, **{"tb-hamerly2": untraced}))
    serve_phase(X, main.pop("outcome"))
    obs_phase(X, Xv, untraced)
    mesh_phase(X, Xv, untraced)
    xl_engine_phase(X, Xv, untraced, dev["smi"])
    del X, Xv, untraced
    lm = lm_serve_phase(dev["smi"])
    train = lm_train_phase(dev["smi"])
    families = families_phase(dev["smi"])
    rcv1 = rcv1_phase(dev["smi"])
    encdec = encdec_vlm_phase(dev["smi"])
    sharded_train_phase(dev["smi"])
    sharded_serve_phase(dry, xl["times"]["ms"], dev["smi"])
    # each kernel's launches come from the run of the path it serves
    launches = dict(main["launches"], fused_round=xl["launches"][
        "fused_round"])
    errs["fused_round"] = xl["err"]
    times["fused_round"] = xl["times"]
    kernels = [dict(name=name, route="cuda", source=SOURCE.format(name),
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], **times[name],
                    launches_phase13=lm[name],
                    launches_phase14=train[name],
                    launches_phase15=families[name],
                    launches_phase16=rcv1[name],
                    launches_phase17=encdec[name])
               for name in REPLACES]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    log(dev["smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
