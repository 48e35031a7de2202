"""Chip smoke test of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, and trains word2vec at full width on one
NVIDIA GPU through the port's normal entry points, on each of its six
paths: packed+pool, fused-hogwild (``fused: 1``), fused-grouped
(``fused: 1, grouped: 1``), and on top of fused-grouped fused-resident
(``resident: 1``), fused-dedup (``dedup: 1``) and fused-dedup-res (both),
and the per-pair rungs ``packed: 0`` (the 2-D plane) and ``neg_mode:
per_pair``, all on the native batch producer; then the CTR families on the
small-row plane with AdaGrad, and Wide & Deep at ``examples/widedeep.conf``'s
full width, on the small-row plane and at ``packed: 0``, and FFM over 39
fields (table dim 157, the 2-D plane); then the native producer against the
numpy one, ``stream: 1``, and the quality probe on every path; then the
bulk-copy completion
probes through ``python -m swiftsnails_tpu_torch.tools.sem_probe``'s ``main``;
then ``python -m swiftsnails_tpu_torch train`` on ``examples/word2vec.conf``
and ``examples/word2vec_fast.conf``, stopped by a real SIGTERM and resumed,
the training fault drill, and the guardrail's cost; then the loop's
telemetry (run ledger, spans, goodput, the ``torch.profiler`` window,
resume from the ledger, the drift drill); then the serving read path
(``Servant``, ``Fleet`` and ``python -m swiftsnails_tpu_torch serve`` over
checkpoints of ``examples/word2vec.conf`` at capacity 1,048,576 and of
``examples/widedeep.conf``); then the tiered parameter store
(``table_tier: host``: host masters behind a 64 MB cache on the card); last
the freshness pipeline and the TCP network plane (hot-row deltas from a
resumed run to an in-process fleet over the file log, and to two replica
processes on the card over ``freshness_listen``, with the gap, int8 and
``proc_kill`` drills); last the cluster plane and the chaos lanes (the
simulated 3-worker async-SGD fleet at full width under a kill, a straggler
and a partition, the cluster drills, the training drill matrix, the
chaos-serve and fleet lanes, ``supervisor-status`` and the gates of
``ledger-report --check-regression``); last the sequence model
(``model: seqlm`` at its full width: card against CPU, four optimizers,
ring and Ulysses attention under a one-rank NCCL group, the CLI killed
and resumed); last word2vec under a ``(data, model)`` mesh (a one-rank
NCCL mesh at full width against the unmeshed run, the grouped collective
plane with its dedup and bucketed collectives and ``overlap`` there, and a
``(2, 2)`` gloo mesh of four processes against one device and against
the one-rank mesh), and the loop's guards there (the guardrail, the tier's
sweep, freshness publishing and cluster leases); last the multi-host
launcher, starting two ranks on this host.

    python3 chip_smoke.py [--seed N] [--only tiered|freshness|cluster|seqlm|mesh|launch]

Run from the root of the repository on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. The
kernels build at first use into ``swiftsnails_tpu_torch/build/``. Each phase
prints one JSON line; any failure exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the repository,
it exits non-zero and prints no result.

Time budget. The script must end within 1,200 s, the build included, on a
slow host as on a fast one: one tree has taken 870–1,206 s as the host
went. So its ``total`` stays under 900 s. Every line carries ``t_s``, the
seconds since the script started; every top-level phase prints a
``phase_seconds`` line when it ends (also when it fails); the ``total`` line
carries ``phases``, each top-level phase's seconds in the order they ran
(the ``--only`` modes print the same for theirs). A change that adds to the
script first finds its own seconds in ``phases``, and takes as many out
elsewhere if the sum would pass 900 s: fewer full-width runs, a run or a
save that another phase already made at the same config and seed reused,
fewer saves and process spawns where a gate needs only one.

Phases:

1. ``env``: the card, its power limit, TF32 off for matmul and cuDNN.
2. ``build``: compile ``csrc/rowdma.cu``, ``csrc/fused_sgns.cu``,
   ``csrc/fused_sgns_merged.cu`` and ``csrc/sem_probe.cu``, one ``nvcc``
   each, started together; their ptxas register and spill lines. While
   they compile: the CUDA context, the profiler's first window (CUPTI's
   set-up) and the two corpora.
3. ``kernel``: each row kernel at the main path's shapes (f32 and bf16; the
   in-table pull and push of 16,384 rows, the out-table ones of 18,432),
   bit-equal to its plain version, timed beside the plain version, one
   PyTorch library call and its bound (least bytes / the card's memory
   rate); ``gather_rows`` and ``index_select`` timed in turns (kernel,
   library, library, kernel). Each fused kernel (f32 and bf16; flat: 16,384
   pairs in 32 blocks of 512 sharing 64 pool rows; grouped: 8,192 centers
   in 32 blocks of 256, windows of 10 slots): on block-local ids (each
   block's rows drawn zipf-wise from its own range) within rtol 1e-5 /
   atol 1e-6 of its plain version in f32, one bf16 rounding in bf16, and
   bit-identical across two runs; on zipf ids over the whole vocabulary
   (hogwild) finite, with a loss within 1e-2 of the plain version's; timed
   beside the plain version and the unfused packed substep on the same
   pairs and pool (no PyTorch call computes a fused SGNS step), against its
   bound (the larger of least bytes / memory rate and f32 flops / the f32
   rate); one launch a substep on the card (the profiler's count, held),
   its host time a call, its cluster size, CTAs, and the clusters of each
   size 1..8 that the card holds at once, from which its rule picked the
   size. Each merged kernel
   (f32 and bf16; the grouped shape, ``hot_rows`` 2,048 resident, ``u_cap``
   384 dedup, both 384 and 256 composed): on zipf ids over the whole
   vocabulary within rtol 1e-5 / atol 1e-6 of its plain version in f32; in
   bf16 within one bf16 rounding on block-local ids, and on zipf ids the
   elements beyond it counted (see ``_merged_case``); bit-identical across
   two runs; timed and bounded as the fused ones; one launch a substep on
   the card (the profiler's count, held), its time alone put beside the
   grouped kernel's alone from the same call.
   Then ``gather_rows`` and ``scatter_add_rows`` at the ``neg_mode:
   per_pair`` out-table shape (98,304 zipf ids, 16,384 contexts and 81,920
   negatives; the push's ids merged first), f32, the same checks and times.
4. ``slice_parity``: 4 substeps of a small config of each path with injected
   negative pools (per-pair negatives, ``[b, 5]``, on ``dense`` and
   ``perpair``) on the card and on the CPU (one kernel block a substep on
   the hogwild fused paths, where the card runs blocks concurrently and the
   CPU in order; 8 on the merged paths, whose blocks run in order on both);
   the tables agree within rtol 1e-5 / atol 1e-6 (reduction order),
   and two runs on the card are bit-identical.
5. ``train``, ``train_fused``, ``train_grouped``: ``Word2VecTrainer`` ->
   ``TrainLoop.run`` at vocab 1,048,576, dim 200, window 5, negatives 5,
   pool 64, f32 tables, 30 steps: packed+pool at batch 16,384 pairs and
   512 pairs a pool on the zipf corpus, lr 100 (see ``LR``), one substep a
   step; fused-hogwild at the same batch and fused-grouped at 8,192 centers
   and 256 centers a block on the paired corpus, lr 1,600, 8 substeps a
   step (see ``FUSED_LR``), each held to the plain version's blocks run in
   order at the same lr (``HOGWILD_FALL_SHARE``); ``train_resident``,
   ``train_dedup``,
   ``train_dedup_res`` as fused-grouped with their keys, at ``MERGED_LR``
   (410, 100, 410); ``train_dense`` (``packed: 0``: two ``[1,048,576,
   200]`` f32 tables, 1.68 GB, no kernel of the port) and ``train_perpair``
   (``neg_mode: per_pair``: two ``[1,048,576, 2, 128]``, 2.15 GB) as
   packed+pool, K = 5 independent negatives a pair.
   Every kernel's launch counter
   is set to 0 just before each run and read just after: the path's kernels
   must read 2 (row kernels) or 1 (a fused kernel) per substep, every other
   kernel 0; the loss must be finite and falling.
6. ``profile``: after each train phase, device time by kernel over 5 more
   train steps (``torch.profiler``) and the card's busy share of their wall
   time.
7. ``kernel`` (CTR): the pull's ``gather_rows`` of a batch's 212,992 tile
   ids from the slot-fused ``[262,144, 2, 128]`` table, then
   ``scatter_adagrad_fused_rows`` on that table, ``scatter_adagrad_rows``
   and ``scatter_write_rows`` on ``[262,144, 1, 128]`` and its accumulator,
   at the Wide & Deep push shape (the same ids merged by tile, the tail
   padding kept; ~136,700 unique tiles), f32 and bf16: bit-equal to the
   plain version and bit-identical across two runs, timed beside the plain
   version and, for the gather and the write, ``index_select`` and
   ``index_copy_``, against the bound (unique tiles' bytes read and
   written, the gradients and ids read, over the memory rate).
8. ``ctr_parity``: 4 steps of ``logreg`` (SGD, and AdaGrad), ``fm``, ``ffm``
   (8 fields, table dim 33) and ``widedeep`` at capacity 16,384 on the card
   against the port on the CPU from one state: losses within rtol 1e-5,
   each array's change within 1e-4 of the CPU's largest change, and a step
   launching one ``gather_rows`` and one ``scatter_adagrad_fused_rows``
   (AdaGrad) or ``scatter_add_rows`` (SGD), nothing else. Then one push of
   each store route no family takes, within rtol 1e-5 / atol 1e-6 of the
   CPU: ``push_packed`` with AdaGrad (2 ``gather_rows``, 2
   ``scatter_write_rows``), ``push_packed_small`` with a split accumulator
   (1 ``scatter_adagrad_rows``) and with bf16 slots (2 and 2).
9. ``train_widedeep``: ``examples/widedeep.conf`` through ``get_model`` ->
   ``TrainLoop.run`` for 30 steps of 8,192 ``synth_ctr`` records (26
   fields, 40,000 ids a field, from ``--seed``): one ``gather_rows`` and
   one ``scatter_adagrad_fused_rows`` a step and nothing else, a finite
   loss whose last 5 steps average below its first 5, examples/sec over
   steps 6–30, and ``eval_auc`` on 20,000 held-out records; then its
   ``profile`` line. ``ctr_parity`` also runs Wide & Deep at ``packed: 0``
   and FFM at ``factor_dim`` 20 (table dim 161), both on the 2-D plane (no
   kernel of the port), the accumulator slot compared too.
   ``train_widedeep_2d`` (the conf at ``packed: 0``: ``[1,048,576, 17]`` and
   its accumulator) and ``train_ffm_wide`` (FFM, 39 fields, ``factor_dim``
   4: ``[1,048,576, 157]`` and its accumulator, 1.32 GB, on ``synth_ctr``
   with 39 fields) the same way, no launch of the port's kernels, their AUC
   beside the packed phase's; each with its ``profile`` line.
   ``native_producer``: ``batches()`` alone on the host, the native
   producer against the numpy one, on the zipf corpus (2,000,000 tokens,
   window 5, batch 16,384, flat and grouped): words/sec of a whole pass;
   gate: a second native run of the seed gives the same first 8 batches.
   Then ``train`` and ``train_grouped`` end to end on each producer, in
   turns (native, python, python, native): words/sec over steps 6–30.
   ``stream``: ``stream: 1`` for ``examples/word2vec.conf`` (capacity
   1,048,576) on a written 300,000-token corpus and for
   ``examples/widedeep.conf`` on a written file of 98,304 ``synth_ctr``
   records; gates: the first 8 batches equal the whole-file run's (one
   chunk), the producer is native, 10 steps train with finite losses.
   ``quality``: ``framework/quality.probe_top1`` on the card for each path
   of the JAX package's ``tests/test_path_quality.py`` (the fused ones
   through their kernels); hard gate at ``MIN_TOP1`` (0.75) on ``dense``,
   ``packed_perpair`` and ``packed_pool``, the fused scores printed.
10. ``sem_probe``: the probe tool's ``main`` at ``--dim 200`` (not
    ``--quick``), its three kernels' counters set to 0 just before and read
    just after. Unit: each of the five tags accounts exactly its copy's
    bytes, exact arming completes, arming 16 bytes above stays pending
    within the poll bound, and for ``f32[8,2,128]`` eight single-row copies
    complete one 8-row phase and seven do not. Chunk: the 64 gathered rows
    bit-equal to ``x[rows]`` (``max_abs_err`` 0) and the flag 65,536. Pipe
    (64 blocks of 1,856 ids into ``[100,000, 2, 128]`` f32): per-copy and
    chunked both bit-equal to the plain version and bit-identical across
    two runs; ms a call, µs a block and ns a copy of each, the speedup, and
    beside them ``index_select``, ``gather_rows`` and the byte bound. The
    launch geometry is printed with them, as the library reports the
    launches it builds (``chunk_plan``, ``pipe_plan``): the chunk probe's
    CTAs and issuing lanes; the pipe's cluster of G CTAs a block (G = 2, 128
    CTAs at this shape), its stages, issuing lanes and consumer warps, and
    ns a copy a CTA over the K / G copies each CTA takes.
11. ``cli_resume``: ``examples/word2vec.conf`` as it stands (dim 200,
    window 5, 5 negatives, batch 16,384, ``guardrail: 1``, ``resume:
    auto``) over a zipf text corpus from ``--seed`` (260,000 tokens over
    65,536 ids), with ``-capacity 1048576`` (two 1 GiB tables),
    ``-num_iters 1``, ``-min_count 1``, ``-param_backup_period 8``,
    ``-param_backup_root``/``-output`` in a temporary directory, ``-log_every
    1`` and ``-seed``, each listed in the phase's line. First an
    uninterrupted control through ``cli.main`` in this process, every launch
    counter set to 0 just before and read just after (``gather_rows`` and
    ``scatter_add_rows`` 2 a substep, every other kernel 0). Beside it (the
    two share only the corpus), ``python -m swiftsnails_tpu_torch train`` in
    a subprocess, sent a real SIGTERM after its second periodic manifest,
    mid-period: it must exit 0, say it was preempted and leave a final step
    past the last periodic one. Then the same command again, through ``cli.main`` in this process (only
    the SIGTERM needs a process of its own): it must say it restored that
    step and run to the end of the data. Every step both runs committed must carry the
    control's CRCs and data cursor (bit-equal tables; every kernel of the
    path is bit-identical run to run), and ``vectors.txt`` must be the
    control's byte for byte. The line gives each run's save time split into
    the enqueue, the wait for the copy to the host, the CRC and the write,
    their GB/s, the restore time, the bytes of a step on disk and the
    words/sec of each run. Needs ``CLI_DISK_BYTES`` free; deletes its files.
12. ``cli_fast``: the same with ``examples/word2vec_fast.conf``
    (fused-dedup-res: 8 substeps a step), a paired corpus (5,000,000 tokens
    over 32,768 pairs), ``-param_backup_period 3`` and ``-learning_rate
    410`` (``MERGED_LR``; the conf's 0.025 moves no loss in 19 steps);
    ``fused_sgns_dedup_resident_step`` launches 1 a substep, every other
    kernel 0.
13. ``chaos``: ``examples/word2vec.conf`` in this process at its width with
    a 65,536-row table, ``chaos_spec: nan_grad@5-6,row_poison@9,
    ckpt_corrupt@12,preempt@17``, ``guard_max_consecutive: 3``,
    ``param_backup_period: 4``: trips rolled back and reported at steps 5,
    6 and 9, every table finite, the run preempted and drained at step 18,
    step 12 rejected by ``restore_checkpoint``; then the drain's save is
    corrupted and a run with ``resume: auto`` must reject it, report it,
    restore the newest step that verifies and finish; then
    ``chaos_spec: nan_grad@1-6`` with ``guard_max_consecutive: 2`` must
    raise ``GuardrailExhausted``.
14. ``guardrail_cost``: packed+pool at ``cli_resume``'s shape, 30 steps with
    ``guardrail: 1`` and without: step ms (median of steps 6-30), the
    overhead in ms and percent, the tables of the two runs bit-equal (no
    fault, so trust stays 1.0), and the guardrail's own device time a step
    by ``torch.profiler`` (snapshot copy, norm).
15. ``telemetry``: the loop's telemetry at full width on packed+pool (the
    ``train`` phase's config and zipf corpus) and fused-resident
    (``train_resident``'s, ``hot_rows`` 2,048, the paired corpus): 30 steps
    with ``telemetry: 1``, ``trace_path``, ``ledger_path``, ``profile_dir``
    (``profile_steps: 10,20``), ``profile_cadence: 4``, ``drift_detect: 1``,
    ``param_backup_period: 10`` and the loss read every step. Gates: the
    losses equal a telemetry-off run's bit for bit (else within the spread
    of two telemetry-off runs); the trace has one ``prefetch-wait``,
    ``h2d``, ``step`` and ``metrics-flush`` span a step; the capture holds
    steps 10-19 (their ``record_function`` ranges) and the path's hand
    kernels with device time (``gather_rows_kernel`` and
    ``scatter_add_rows_kernel``; ``merged_sgns_kernel``); the ledger holds
    three ``checkpoint`` events, then the ``run`` record, whose goodput
    names the H100 peak row, carries ``step_cost``'s counts, 0 < ``mfu`` <= 1
    and 0 < ``vs_roofline`` <= 1, and whose ``step_seconds`` (and the
    median step span of the captured steps) is at least 0.95 x the
    capture's kernel time a step; ``env`` names the card and its power
    limit; a ``resume: auto`` run on the ledger restores a step the ledger
    knows (the telemetry-off run is the path's train phase run, the same
    config and seed); ``ledger-report``, ``--failures`` and ``trace-summary`` on the
    files exit 0. Printed: items/sec with telemetry on and off (the loss
    read every 5 steps, in turns off, on, on, off), so the step span's
    synchronization is priced. Then the drift drill on the card (gated:
    detected, one ``drift`` event, a complete bundle, ``--diff`` naming
    host_blocked) and ``profiler_overhead`` at packed+pool's full width
    (printed beside the JAX lane's rule, not gated).
16. ``serve``: the serving read path at the bench's width. ``train_widedeep``'s
    state is saved (the trainer's AUC on the first 8,192 held-out records
    taken first); ``examples/word2vec.conf`` at ``-capacity 1048576`` trains
    4 steps on the zipf corpus and saves step 4, then the same tables with
    ``in_table`` doubled (exact) as steps 5 and 6, and step 5 is corrupted.
    ``Servant.from_checkpoint`` on the card serves step 4 (two normalized
    ``[1,048,576, 200]`` tables); every launch counter is set to 0, then:
    2,000 zipf ids pulled in requests of 5, 40 and 70 ids (buckets 8, 64
    and 64 + 8), each row bit-equal to step 4 restored and normalized on the
    CPU, ``gather_rows``' launches, the rows and pad rows as the bucket
    arithmetic over the cache's misses gives them; 8 topk queries (k 10)
    within 1e-5 of a float64 numpy scan, the ids equal where the scores are
    1e-5 apart, and the zero query ranking ids 0..9 (JAX's tie order); the
    W&D checkpoint scoring 8,192 held-out records on the card and on the
    CPU within rtol 1e-5, its AUC within 1e-4 of the trainer's; one
    ``apply_rows`` of 4,096 distinct rows (one ``scatter_write_rows``
    launch, the version bumped, the cached old rows missed, every delta row
    pulled back bit-equal); ``reload_from_checkpoint`` of step 5 rejected
    with the live bytes kept, then of the newest step (6) swapped in; a
    ``Fleet`` of two replicas sharing the planes answering 50 pulls and the
    8 topk as the servant, and again after ``drain``. The counters are read
    there: ``gather_rows`` launched, ``scatter_write_rows`` once, every
    other kernel 0. Then ``python -m swiftsnails_tpu_torch serve`` in a
    subprocess over step 4 (``pull``, ``topk``, ``stats``, ``health``,
    ``quit``): exit 0, five JSON lines, the rows as pulled. Printed beside
    the card's name and power limit: qps and p50/p95/p99 a kernel and
    bucket (the serve lane's ``_drive``; W&D score on held-out records),
    ``run_open_loop`` at 400 offered qps for 5 s, and the serve lane's
    block (``serve_bench``, its own sizes). Last, ``gather_rows`` at the
    serving pull (8 and 64 zipf ids of the served table) and
    ``scatter_write_rows`` at one ``apply_rows`` (4,096 distinct rows),
    bit-equal to plain, timed beside it and ``index_select`` /
    ``index_copy_`` against the byte bound.
17. ``tiered``: the tiered parameter store (``table_tier: host``) at the
    bench's width, each leg's host arrays freed before the next. (1) The
    ``train`` phase's packed+pool config, resident, 30 steps: the control's
    losses, a CPU copy of both tables, and the card's allocated bytes when
    the loop asks for its batches. (2) The same with a 64 MB cache
    (``tier_hbm_budget_mb`` 64, ``tier_async_flush`` 1,
    ``tier_prefetch_depth`` 2; 32,768 slots a table): every loss and both
    master tables bit-equal to the control; evictions, flushed rows and
    faults > 0; the card holding at least the two tables' bytes less the
    caches' fewer bytes after ``adopt`` (>= 1.9 GiB); ``scatter_write_rows``
    launched once a fault, ``gather_rows`` for the pulls plus one a flush
    snapshot, ``scatter_add_rows`` 2 a step, nothing else. (3) A 2,048 MB
    budget: transparent, bit-equal. (5) Leg 2 with ``tier_master_dtype:
    int8``: each table's largest error within 0.05 of its largest value
    against the control, ``verify()`` clean, its step-30 checkpoint f32.
    (6) Leg 2 for 12 steps with ``param_backup_period`` 5,
    ``tier_verify_period`` 5 and ``chaos_spec: tier_bitflip@7``: one
    ``cache_error`` event with ``source: "tier"`` at step index 9, rebuilt
    from step 5, ``verify()`` clean after. (4) ``examples/widedeep.conf``
    resident and with a 192 MB cache (raised in 32 MB steps, below 256,
    while a step's distinct tiles exceed it), 30 steps: table, dense
    parameters, AdaGrad state and eval AUC bit-equal, evictions > 0, the
    launches as in (2) with ``scatter_adagrad_fused_rows`` one a step.
    (7) The serve phase's step-4 checkpoint through ``Servant.from_checkpoint``
    with ``table_tier: host`` at 64 MB: 2,000 zipf ids in requests of 5,
    40 and 70 bit-equal to the resident servant's, faults > 0; 8 topk
    (k 10) streamed through the master, the resident ids and scores within
    1e-6; 4,096 rows through ``apply_rows`` pulled back bit for bit. (8)
    ``tiered_bench(small=False)``: parity, round trip and int8 leg true.
    (9) ``tiered_timing``: words/sec and median step ms of legs 1–3,
    examples/sec of leg 4, the breakdown a step (plan, fault, flush, remap,
    H2D, flush wait), hit rate, bytes each way, ``adopt`` s, a 1 GiB
    table's digest s. Then the kernels at the tiered shapes:
    ``scatter_write_rows`` installing the median faulted rows a step into
    the ``[32,768, 2, 128]`` cache beside ``index_copy_``, ``gather_rows``
    snapshotting the median dirty victims an eviction beside
    ``index_select``, ``scatter_add_rows`` and ``scatter_adagrad_fused_rows``
    at the cache planes' push shapes; bit-equal to plain, against the byte
    bound. ``--only tiered`` runs this phase alone (with the build and a
    serve checkpoint of its own) and prints no result line.
18. ``freshness``: first ``freshness_fused_resident``: ``train_resident``'s
    fused-resident config trained 8 steps publishing every step from its
    start state (``freshness_log_mb`` 4096) to a ``Servant`` of that state;
    the servant's whole planes equal the trained ones bit for bit after
    the deltas (the collector's plan holds the pool rows the step draws),
    and the trained tables equal a run's with publishing off; the fused
    kernel launched once a substep. Then the serve phase's step-4
    checkpoint of ``examples/word2vec.conf`` (capacity 1,048,576, dim 200,
    packed+pool) under a fresh root. (a) ``freshness_file``: a 2-replica ``Fleet`` on the
    card at step 4 and a ``DeltaSubscriber`` poll thread on the file log
    while the run resumes 4 -> 20 with ``freshness_publish: 1`` (the
    publisher gathers each step's touched tiles with ``gather_rows``) under
    an open loop of 8-id pulls; at step 20 the fleet's whole planes equal
    ``Servant.from_checkpoint`` of step 20 bit for bit (mismatch 0.0), the
    replicas on one version; publish ms a step split into gather, D2H and
    write, rows and bytes a batch, lag p50/p99, apply ms a batch, pull
    p50/p99 under apply, prunes and fallbacks (both 0: ``freshness_log_mb``
    4096). ``freshness_gap_drill``: five batches of step-20 rows, the third
    deleted: one fallback reload, the rest re-applied, parity 0.0.
    ``freshness_int8``: 20 -> 24 with ``freshness_delta_dtype: int8``: the
    touched rows equal the quantizer's round trip of step 24's, the rest
    equal step 24's, the relative error within the tiered lane's 0.05. (b)
    ``freshness_tcp``: two ``python -m swiftsnails_tpu_torch.net.replica_server``
    processes on the card (step 24) behind a ``NetFleet``: a TCP pull equal
    to the in-process one; 24 -> 28 with ``freshness_listen: 127.0.0.1:0``
    and a ``TcpDeltaSource`` applying over RPC under an open loop of pulls;
    every applied row and 65,536 others pulled from each replica equal
    step 28's. ``freshness_proc_kill``: one replica SIGKILL'd under load;
    lease expiry (3 s) drains it and a fresh process rejoins at parity;
    availability % and respawn s. ``freshness_launches``: ``gather_rows``
    and ``scatter_write_rows`` in process and in the replicas (their
    ``stats`` RPC), each > 0. Then both kernels at the freshness shapes:
    ``gather_rows`` of a step's touched out-table tiles beside
    ``index_select``, ``scatter_write_rows`` of a batch into a
    ``[1,048,576, 200]`` plane beside ``index_copy_``. ``--only freshness``
    runs this phase alone (with the build and a serve checkpoint of its
    own) and prints no result line.
19. ``cluster``: (a) ``cluster_sim``: ``chaos_cluster_bench`` on the
    ``train`` phase's trainer (packed+pool, vocab 1,048,576, dim 200, batch
    16,384, lr 100, the zipf corpus from ``--seed``): 96 batches, 3
    workers, ``STORM_SPEC`` (``worker_dead@10,worker_slow@16-26,
    partition@30``); the in-order control, the protected leg under the
    supervisor and the unprotected static-shard leg, one leg's 2.15 GB of
    tables on the card at a time. Gates: the protected leg's accounting
    exact (0 lost, 0 duplicated), a worker lost and its range reassigned,
    finite tables, eval-loss parity with the control within
    ``LOSS_PARITY_BAR`` (0.05), the unprotected leg losing batches, and
    ``gather_rows`` and ``scatter_add_rows`` launched 2 times each a batch
    applied across the legs (every other kernel 0). It prints the fleet's
    ticks, virtual s, refused stale commits, flagged stragglers, and host
    ms a batch under the sim beside a plain ``TrainLoop`` step of the same
    trainer. (b) ``cluster_drills``: ``run_cluster_drills`` (worker_kill,
    straggler, partition, storm on the drill trainer), each passing its
    checks. (c) ``cluster_drill_matrix``: ``run_drill_matrix``, every drill
    recovered. (d) ``cluster_chaos_serve``: ``chaos_serve_bench``
    (availability >= 99%, the unprotected leg failing hard, the corrupt
    reload rejected, the ``tier_bitflip`` drill recovered). (e)
    ``cluster_fleet``: ``fleet_bench`` (``scaling_x`` >= 1.6 at 2
    replicas, affinity's hit rate above random's, hedging cutting p99) and
    ``fleet_chaos_drill`` (availability >= 99% through each drill). The
    bench runs with the objects of the earlier phases frozen out of the
    cyclic collector's reach (``_HostPauses``: a full collection over them
    stalls the process past the SLO's slack); ``bench_host`` gives the
    collector's pauses during it and the threads alive at its start, with
    the tier flush workers and servant micro-batchers among them counted:
    the earlier phases close what they open, so both counts must be 0. (f)
    ``cluster_ledger``: the blocks in one bench record of the phase's
    ledger; ``supervisor-status`` over it names the lost worker, and
    ``ledger-report --check-regression`` reports the chaos-cluster,
    chaos-serve and fleet gates ok, no gate failing (it exits 2, the
    headline's code when a ledger holds no measured bench value).
    ``cluster_baseline_file``: one cacheable ``bench`` record of the fleet's
    qps appended, ``derive_last_good`` writes the last-good file from it,
    and ``ledger-report --check-regression 5 --baseline-file`` exits 0 on
    that file and 2 on a truncated copy. Then
    ``kernel_one_row``: one-row calls of ``gather_rows``,
    ``scatter_add_rows`` and ``scatter_write_rows`` on a ``[1,048,576, 2,
    128]`` f32 table, bit-equal to plain, timed: the fixed cost of a launch.
    ``--only cluster`` runs this phase alone (with the build and the
    kernels' phase 3) and prints no result line.
20. ``seqlm``: the sequence model at the JAX trainer's defaults (seq_len
    256, 2 layers, 4 heads, d_model 128, batch 8) on a paired text corpus
    over 32,768 words (``_write_text_corpus``) read through ``data``. (a)
    One step of each optimizer on the card against the same step on the
    CPU from one state: the loss within rtol 1e-5; sgd's and momentum's
    parameters, adam's and adamw's moments and their parameters whose
    gradient is at least 1e-6, within rtol 1e-4 / atol 1e-6 (see
    ``SEQLM_LOSS_RTOL``). (b) Each optimizer 60 steps under
    ``TrainLoop`` at the JAX tests' rates (sgd 0.1, momentum 0.05, adam and
    adamw 0.003): finite losses, the last 5 below the first 5; median step
    ms and tokens/sec. (c) ``attention: ring`` and ``ulysses`` under a
    one-rank NCCL group: logits, one step's parameters and its loss within
    2e-4 of dense, the group's calls counted (Ulysses' all-to-alls > 0).
    (d) ``python -m swiftsnails_tpu_torch train -config seqlm.conf`` (adam,
    a save every 8 steps, ``resume: auto``): a control in process, a
    subprocess stopped by a real SIGTERM mid-period after its first save,
    the same command again in process; the losses of the steps before the
    drain and after the resume equal the control's bit for bit. One
    ``seqlm`` line. ``--only seqlm`` runs this phase alone and prints no
    result line.
21. ``mesh``: word2vec through ``Word2VecTrainer(mesh=...)`` and
    ``TrainLoop``. (a) A ``(1, 1)`` mesh of a one-rank NCCL group at full
    width (packed+pool and ``packed: 0``, the ``train`` phases' config,
    ``MESH_STEPS`` steps) against the unmeshed run of the same steps: the
    tables bit-equal (the collectives over one rank are identities; the
    largest difference printed), the row kernels launched as often; step
    ms, the collectives' calls and result bytes (``parallel.transfer.COMM``).
    Then the grouped collective plane there (``fused: 1, grouped: 1``
    under the mesh) at ``train_grouped``'s width on the paired corpus, at
    ``MESH_GROUPED_LR``: the plain plane ``MESH_STEPS`` steps (finite,
    falling, ``gather_rows`` and ``scatter_add_rows`` 2 a substep, the
    collectives' bytes equal to ``step_cost``'s), the unmeshed
    fused-grouped kernel the same steps for its step ms; dedup at
    ``U_CAP``'s auto cap (its ``dedup_dropped`` printed), dedup at a cap
    covering a substep's out slots and the bucketed push (slack 2)
    ``MESH_GROUPED_SHORT`` steps from the same start, each within rtol
    2e-4 / atol 2e-6 of the plain plane's; ``overlap`` 1 and 2
    ``MESH_STEPS`` steps (finite, falling, one more pull a step each a
    depth); the median step ms of each run.
    (b) A ``(2, 2)`` gloo mesh of four processes, spawned when the phase
    starts and run beside (a) (``MESH_GLOO_*``:
    dim 200, vocabulary 65,536, batch 2,048, 5 steps, the cuts listed as
    ``reduced``) on ``MESH_GLOO_DEVICE``, its tables within rtol 1e-5 /
    atol 1e-6 of the one-device port's, each rank's launches counted; the
    same ranks then train the grouped plane's plain, dedup (a covering cap)
    and ``overlap: 1`` routes (2,048 centers, 2 substeps a step), each
    within rtol 1e-5 / atol 1e-6 of the same route on the (1, 1) NCCL mesh,
    nothing dropped, each rank's launches counted; the same ranks then
    train the grouped plane's dedup and bucketed routes and W&D
    ``WIRE_GLOO_STEPS`` steps under ``comm_dtype`` int8 and int4 (on the
    card, or on the CPU where gloo refuses a codec's dtype there: the
    ``wire`` entry's ``device``), every element within one quantization
    step a push of the same route on the (1, 1) NCCL mesh. (e) The
    ``wire`` leg on the (1, 1) NCCL mesh at full width: packed+pool, W&D
    at ``examples/widedeep.conf`` and the grouped plane, ``WIRE_STEPS``
    steps under f32, bf16, int8 and int4: the codecs on the card bit-equal
    to the CPU's on a full-width pull's rows and a push's gradients
    (deterministic and dithered), each meshed pull the unmeshed pull
    through ``_wire_cast``, word2vec's losses within ``WIRE_LOSS_BARS`` of
    f32's and falling (W&D's gap reported: the JAX package sets it no
    bar), launches as f32's, the counted bytes ``step_cost``'s, the
    grouped exchange's scoped bytes ``WIRE_BYTE_FLOORS`` below f32's;
    each path's bytes and ms a step and the codec's launches and device
    ms a step (a profiled step's non-NCCL kernels beyond f32's). (f)
    Hybrid placement, ZeRO and ``dense_tp``: on the (1, 1) NCCL mesh the
    grouped plane with ``MESH_HYBRID`` (a head of ``HOT_ROWS`` rows, the
    tail at a covering cap) ``MESH_GROUPED_SHORT`` steps from the plain
    plane's start, within rtol 2e-4 / atol 2e-6 of it, nothing dropped,
    launches as the plain plane's, the counted bytes ``step_cost``'s;
    ``placement: auto``'s decision (cut, coverage, predicted against
    counted bytes); the bytes a step of uniform, hybrid and auto; W&D at
    ``examples/widedeep.conf`` under ``placement: hybrid``,
    ``optimizer_sharding: zero`` and ``dense_tp: 1`` (trivial on one rank)
    against the uniform meshed run (``_ctr_close``: bit equality
    reported). On the four gloo ranks: the grouped plane hybrid against
    uniform (within rtol 2e-4 / atol 2e-6) and hybrid with zero bit-equal
    to it; W&D under zero bit-equal to the replicated run, each rank
    holding ``1 / data`` of each sharded AdaGrad sum; ``dense_tp: 1``
    against ``dense_tp: 0`` (``_ctr_close``); a start state saved uniform
    and through the hybrid split and zero's slices, the same CRCs; a
    hybrid + zero run saved at ``MESH_GLOO_CTR_SAVE`` and resumed,
    bit-equal to the straight run. (g) The tier and serving under a mesh:
    on the (1, 1) NCCL mesh packed+pool behind ``TIER``'s 64 MB
    ``MESH_STEPS`` steps, its tables bit-equal to the unmeshed tier's and
    to the resident meshed run's, its losses the resident meshed run's,
    with evictions, the launches of ``gather_rows``, ``scatter_add_rows``
    and ``scatter_write_rows`` the unmeshed tier's; W&D behind
    ``TIER_WD_BUDGET_MB`` ``MESH_CTR_STEPS`` steps bit-equal to the
    unmeshed tier; from the serve phase's step-4 checkpoint a meshed
    servant, a fleet of ``MESH_TIER_REPLICAS`` and a tiered servant behind
    64 MB (``serving/mesh_serve.py``'s leader on a mesh of one), each
    pulling ``SERVE_PULL_IDS`` zipf ids in requests of
    ``SERVE_REQUEST_IDS`` bit-equal to the unmeshed servant, its
    ``SERVE_TOPK_QUERIES`` topk the same ids (scores within
    ``TIER_TOPK_ATOL``), ``SERVE_DELTA_ROWS`` rows through ``apply_rows``
    pulled back. On the four gloo ranks packed+pool and ``packed: 0``
    tiered ``MESH_GLOO_TIER_STEPS`` steps (async flush, the budget
    ``MESH_GLOO_TIER_SLACK`` x a step's distinct units) bit-equal to the
    resident meshed run on every rank, with evictions, the slot maps and
    counters the same on every rank; packed+pool tiered saved at
    ``MESH_GLOO_TIER_SAVE`` and resumed bit-equal; a servant on a
    ``MESH_GLOO_SERVE`` mesh of the ranks (rank 0 leading, the others
    following) pulling ``MESH_GLOO_SERVE_IDS`` ids bit-equal to one rank's
    and its ``MESH_GLOO_SERVE_TOPK`` topk the same ids. (h) The loop's
    guards under the mesh, each agreed by a vote of the ranks: on the
    (1, 1) NCCL mesh at full width, packed+pool with ``guardrail: 1`` and
    ``GUARDS_NAN`` meshed and unmeshed ``MESH_STEPS`` steps (one trip at
    step 4, tables bit-equal, rows 1–2 launched as often; the step ms with
    the guardrail on and off, a vote's ms alone); the tier's sweep
    (``TIER``'s 64 MB, ``TIER_HEAL``, ``TIER_HEAL_STEPS`` steps) meshed,
    healed once from the step-5 save, bit-equal to the unmeshed drill (the
    tiered phase's, phase 17 (6.); run in the leg under ``--only mesh``);
    ``freshness_publish`` every ``GUARDS_FRESH_EVERY`` steps under the mesh
    into a directory a 2-replica ``Fleet`` follows, its planes and its
    pulls of the published rows bit-equal to the trained tables;
    ``GUARDS_CLUSTER`` (``cluster_workers: 3``, ``preempt@6``) drained with
    a final save and resumed, every index committed once, the tables
    bit-equal to (a)'s resident meshed run; W&D with the guardrail and
    ``GUARDS_WD_NAN`` meshed and unmeshed, bit-equal. On the four gloo
    ranks (``MESH_GLOO_GUARDS``): a NaN on rank 2 alone rolls back every
    rank at that step, a bit flipped in rank 2's master alone heals every
    rank from the same save, only rank 0 writes delta files, every rank
    takes the same leased indices. One ``mesh`` line (its ``guards``
    block). Then
    ``gather_rows`` and ``scatter_add_rows`` at the grouped plane's shapes
    (``kernel`` lines, ``path: "mesh_grouped"``): its pulls of 8,192 centers
    and 83,968 out rows and its pushes of the merged rows, on a step of its
    batches, bit-equal to plain, timed beside it and ``index_select`` /
    ``index_add_``, against the byte bound; and the hybrid tail's
    (``path: "mesh_hybrid"``: the tail lists of a step's centers and out
    rows at ``MESH_HYBRID``'s cap; ``"mesh_hybrid_ctr"``: W&D's tail
    ``gather_rows`` and ``scatter_adagrad_fused_rows``); and the tier's
    under the mesh (``path: "mesh_tier"``: the tiered path's four kernels
    at the meshed tier's shapes, its median install and evicted-slot read
    into the ``[32,768, 2, 128]`` cache shard, a step's push into it, a
    W&D step's tiles into its cache shard) and the meshed pull's owned
    gather (``path: "mesh_serve"``: 8 and 64 zipf ids of the meshed
    servant's ``[1,048,576, 200]`` shard); and the guards' (``path:
    "mesh_guards"``: the meshed publisher's owned ``gather_rows`` of a
    publish's touched in-table rows from the trained shard, the fleet's
    ``scatter_write_rows`` of a delta batch's rows into a ``[1,048,576,
    200]`` serving plane). ``--only mesh`` runs this phase
    alone (with the build, the kernels' phase 3 and a serve checkpoint of
    its own) and prints no result line.
22. ``launch``: ``python -m swiftsnails_tpu_torch.tools.launch_pod`` on a
    hosts file of two ``localhost`` lines starts two ``train`` ranks of leg
    2's config on gloo at ``-device cpu`` (one card holds no two NCCL
    ranks; see ``phase_launch``): exit 0, both ranks' ``joined cluster``
    lines, the same finite loss from both at each step, rank 0's
    ``-output``. ``--only launch`` runs this phase alone.
23. ``kernels``: one line for every ported kernel, with its launches in the
    run of its path (``path``) and its f32 numbers from phases 3, 7, 10, 16,
    17 and 18 (``gather_rows`` and ``scatter_add_rows`` also at
    ``train_perpair``'s shape and launches, with the ``cluster`` and
    ``mesh`` paths' launches, and at the grouped plane's shapes with its
    launches, ``path: "mesh_grouped"``, and at the hybrid tail's shapes
    with leg 1's hybrid runs' launches, ``path: "mesh_hybrid"`` /
    ``"mesh_hybrid_ctr"`` with ``scatter_adagrad_fused_rows``;
    ``gather_rows`` and ``scatter_write_rows`` also at the serving
    shapes with the ``serve`` path's launches, and at the freshness shapes
    with the ``freshness`` path's, the replicas' included; all four row
    kernels of the tiered runs with ``path: "tiered"``, and at the meshed
    tier's shapes with leg 1's launches, ``path: "mesh_tier"``;
    ``gather_rows`` at the meshed pull with the meshed servant's launches,
    ``path: "mesh_serve"``; ``gather_rows`` and ``scatter_write_rows`` at
    the meshed publisher's and the apply's shapes with the guards
    freshness run's launches, ``path: "mesh_guards"``); then ``total``, the
    script's seconds, with ``phases``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# Peak device-memory rate, and f32 rate without tensor cores, by card
# (NVIDIA data sheets), bytes/s and flop/s. The H100 SXM figures are the
# default for an H100 that names no other form factor.
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100", 3.35e12))
_F32_RATE = (("H100 PCIe", 51.2e12), ("H100", 67e12))

# The main path's shapes (bench.py's north-star word2vec rung, packed+pool).
VOCAB = 1 << 20
DIM = 200
BATCH = 16_384
WINDOW = 5
NEGATIVES = 5
POOL_SIZE = 64
POOL_BLOCK = 512
# The loss is a mean over the batch's pairs, so each pair's step is lr / B.
# At bench.py's 0.025 and B = 16,384 that is 1.5e-6: after 30 steps the f32
# loss has not moved from its zero-table value 6 ln 2 (in the JAX package's
# math as in the port's). 100 moves it within 30 steps; word2vec.c's own
# per-pair step (lr = 0.025 B) diverges on the merged updates of the zipf head.
LR = 100.0
# The fused paths are hogwild: within a kernel block the last slot's write
# of a row wins and the blocks of a substep race, so a row keeps about one
# update a substep where the merged push sums them all (~1,100 for the head
# of the zipf corpus). On the zipf corpus, whose ids are drawn independently
# and so hold nothing to learn but the head's frequency, their loss does not
# fall at any lr (PERF.md, Findings). Their train phases use the paired corpus
# instead (word 2p always beside 2p + 1, as in the JAX package's quality
# probe; pairs zipf-distributed), bench.py's 8 substeps a call, and this lr
# (a sweep on the card, train_sweep.py: it falls at 410-3200, diverges at
# 4,800 grouped).
FUSED_LR = 1600.0
FUSED_STEPS_PER_CALL = 8
# The hogwild kernels race where blocks share a row; the plain version runs
# the blocks in order, as the TPU kernel does. Over the 30 steps the
# kernel's loss must fall (mean of the first 5 steps less the mean of the
# last 5) by at least this share of the plain version's fall at the same
# lr, seed and batches: a schedule that keeps fewer of the blocks' steps of
# a shared row learns less a step, and fails it.
HOGWILD_FALL_SHARE = 0.75
# The merged paths sum a hot or unique row's updates in a block, as the
# packed push does, so they take a smaller lr than the hogwild paths.
# train_sweep.py on the card (PERF.md, Findings) chose, on the paired corpus
# with 8 substeps a step: fused-resident and fused-dedup-res fall at 100-1,600
# and diverge at 1,600 on the zipf corpus, so 410; fused-dedup falls at
# 100-410, barely at 410, and rises at 1,600, so 100.
MERGED_LR = {"train_resident": 410.0, "train_dedup": 100.0, "train_dedup_res": 410.0}
HOT_ROWS = 2048  # fused-resident (bench.py:70-72)
U_CAP = 384  # fused-dedup (bench.py:73-75), and fused-dedup-res
COMPOSED_HOT_ROWS = 256  # fused-dedup-res (examples/word2vec_fast.conf)
# merged kernel -> its keys
MERGED = {"fused_sgns_resident_step": {"hot_rows": HOT_ROWS},
          "fused_sgns_dedup_step": {"u_cap": U_CAP},
          "fused_sgns_dedup_resident_step": {"u_cap": U_CAP, "hot_rows": COMPOSED_HOT_ROWS}}
N_TOKENS = 2_000_000
STEPS = 30
GROUPED_BATCH = 8_192  # centers a substep (bench.py's grouped rung)
CENTERS_PER_BLOCK = 256
CW = 2 * WINDOW
GATHER_ROWS = (BATCH, BATCH + (BATCH // POOL_BLOCK) * POOL_SIZE)  # in, out pulls
ROW_SETS = 8  # rotated between timed runs so most rows come from HBM, not L2

# Wide & Deep at examples/widedeep.conf's full width (26 fields, capacity
# 2^20, embed_dim 16 so table dim 17, hidden 256,128, AdaGrad at lr 0.05,
# batch 8,192): the small-row table is [262,144, 2, 128] f32, its accumulator
# fused in, and a step pulls and pushes 212,992 ids. The data: synth_ctr
# with 40,000 ids a field, 30 batches to train on and 20,000 records held
# out for eval_auc.
WIDEDEEP_CONF = "examples/widedeep.conf"  # from the root of the repository
CTR_IDS_PER_FIELD = 40_000
CTR_STEPS = 30
CTR_EVAL = 20_000
CTR_ROW_SETS = 4  # push id sets rotated between timed runs (~150k tiles each)
# ctr_parity: each family at small capacity, card against CPU. ffm at 8
# fields and factor_dim 4 has table dim 33.
CTR_PARITY = {
    "logreg_sgd": ("logreg", {"optimizer": "sgd"}),
    "logreg_adagrad": ("logreg", {}),
    "fm": ("fm", {"factor_dim": 8}),
    "ffm": ("ffm", {"factor_dim": 4}),
    "widedeep": ("widedeep", {"embed_dim": 16, "hidden_dims": "64,32"}),
    # the 2-D plane: packed: 0, and ffm at factor_dim 20 (table dim 161)
    "widedeep_2d": ("widedeep", {"embed_dim": 16, "hidden_dims": "64,32", "packed": 0}),
    "ffm_wide": ("ffm", {"factor_dim": 20}),
}


T0 = time.monotonic()  # the script's start: every line's ``t_s`` counts from it
PHASES: dict = {}  # each top-level phase's seconds, in the order they ran


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "t_s": time.monotonic() - T0}), flush=True)


@contextlib.contextmanager
def clocked(name: str):
    """Time one top-level phase: one ``phase_seconds`` line, and its seconds
    in ``PHASES`` (the ``total`` line's ``phases``), also when it fails."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        PHASES[name] = time.monotonic() - t0
        emit("phase_seconds", name=name, seconds=PHASES[name])


def emit_total(t_start: float) -> None:
    emit("total", seconds=time.monotonic() - t_start, phases=PHASES)


def _rate(table, name: str, what: str) -> float:
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no {what} rate on record for {name!r}")


def mem_rate(name: str) -> float:
    return _rate(_MEM_RATE, name, "memory")


def f32_rate(name: str) -> float:
    return _rate(_F32_RATE, name, "f32")


def zipf_ids(n: int, vocab: int, rng: np.random.Generator, s: float = 1.05) -> np.ndarray:
    """Zipf-ish ids over [0, vocab), as bench.py's synth_corpus draws them."""
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w) / w.sum()
    return np.minimum(np.searchsorted(cdf, rng.random(n)), vocab - 1).astype(np.int32)


# ---------------------------------------------------------------- phases ---


def phase_env() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    name = torch.cuda.get_device_name(0)
    env = {"device": name, "count": torch.cuda.device_count(),
           "nvidia_smi": smi_line, "torch": torch.__version__,
           "cuda": torch.version.cuda, "mem_rate_Bps": mem_rate(name),
           "f32_rate_flops": f32_rate(name),
           "host_available_bytes": _host_available(),
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    emit("env", **env)
    return env


def phase_build(seed: int) -> dict:
    """Compile the kernels, one ``nvcc`` a source, all started together,
    and meanwhile on this thread make what later phases need that the build
    does not: the CUDA context, the profiler's first window (CUPTI's set-up,
    which the first window pays) and the two corpora. Returns the corpora."""
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.ops import _build

    t0 = time.monotonic()
    built: dict = {}

    def compile_all():
        try:
            built["results"] = _build.build_all(
                ["rowdma", "fused_sgns", "fused_sgns_merged", "sem_probe"])
        except BaseException as e:  # raised again on this thread
            built["error"] = e

    compiler = threading.Thread(target=compile_all, name="nvcc")
    compiler.start()
    try:
        t1 = time.monotonic()
        torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(1_000)
            torch.cuda.synchronize()
        profiler_s = time.monotonic() - t1
        t1 = time.monotonic()
        corpora = {False: _corpus(seed), True: _corpus(seed, paired=True)}
        corpora_s = time.monotonic() - t1
    finally:
        compiler.join()
    if "error" in built:
        raise built["error"]
    for name, result in built["results"].items():
        ptxas = [ln.strip() for ln in result["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", seconds=result["seconds"], source=f"{name}.cu",
             cached=result["cached"], ptxas=ptxas)
    emit("build", seconds=time.monotonic() - t0, source="all",
         meanwhile={"context_and_profiler_s": profiler_s, "corpora_s": corpora_s})
    return corpora


def _gather_case(table, rows_sets, rate):
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    rows = rows_sets[0]
    got = rowdma.gather_rows(table, rows)
    want = rowdma.gather_rows_plain(table, rows)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"gather_rows differs from its plain version: {err}")
    row_bytes = table.stride(0) * table.element_size()
    distinct = int(torch.unique(rows).numel())
    nbytes = distinct * row_bytes + rows.numel() * (row_bytes + 4)
    pick = lambda i: rows_sets[i % len(rows_sets)]  # noqa: E731
    kernel = lambda: time_ms(lambda i: rowdma.gather_rows(table, pick(i)))  # noqa: E731
    library = lambda: time_ms(lambda i: torch.index_select(table, 0, pick(i)))  # noqa: E731
    # in turns (kernel, index_select, index_select, kernel): the two are close
    turns = [kernel(), library(), library(), kernel()]
    kernel_ms, library_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    return {
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda i: rowdma.gather_rows_plain(table, pick(i))),
        "library_ms": library_ms, "turns_ms": turns,
        "over_index_select": kernel_ms / library_ms,
        "bytes": nbytes, "distinct_rows": distinct,
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def _scatter_case(table, rows_sets, deltas_sets, n_valid, rate):
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    rows, deltas = rows_sets[0], deltas_sets[0]
    want = rowdma.scatter_add_rows_plain(table.clone(), rows, deltas)
    got = rowdma.scatter_add_rows(table.clone(), rows, deltas)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"scatter_add_rows differs from its plain version: {err}")
    del got, want
    row_bytes = table.stride(0) * table.element_size()
    nbytes = n_valid[0] * 3 * row_bytes + rows.numel() * 4
    k = len(rows_sets)
    return {
        "kernel_ms": time_ms(lambda i: rowdma.scatter_add_rows(
            table, rows_sets[i % k], deltas_sets[i % k])),
        "plain_ms": time_ms(lambda i: rowdma.scatter_add_rows_plain(
            table, rows_sets[i % k], deltas_sets[i % k])),
        "library_ms": time_ms(lambda i: table.index_add_(
            0, rows_sets[i % k][: n_valid[i % k]],
            deltas_sets[i % k][: n_valid[i % k]])),
        "bytes": nbytes, "unique_rows": n_valid[0],
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def phase_kernels(seed: int, rate: float) -> dict:
    """Each kernel at the main path's shapes; returns the f32 out-table
    numbers per kernel for the summary line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (VOCAB, -(-DIM // 128), 128)
    base = torch.randn(shape, generator=gen, device=dev)
    n_out = GATHER_ROWS[1]
    scatter = {}  # pushed rows: the unique rows of a zipf draw, padded to n
    for n in GATHER_ROWS:
        sets, n_valid = [], []
        for _ in range(ROW_SETS):
            uniq = torch.unique(torch.from_numpy(zipf_ids(n, VOCAB, rng)).to(dev))
            n_valid.append(int(uniq.numel()))
            pad = torch.full((n - uniq.numel(),), VOCAB, dtype=torch.int32, device=dev)
            sets.append(torch.cat([uniq.to(torch.int32), pad]))
        scatter[n] = (sets, n_valid)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        table = base.to(dtype)
        for n in GATHER_ROWS:
            sets = [torch.from_numpy(zipf_ids(n, VOCAB, rng)).to(dev)
                    for _ in range(ROW_SETS)]
            case = _gather_case(table, sets, rate)
            emit("kernel", name="gather_rows", dtype=str(dtype), rows=n, **case)
            if dtype == torch.float32 and n == n_out:
                summary["gather_rows"] = {"shape": [n, *shape[1:]], **case}
        for n, (sets, n_valid) in scatter.items():
            deltas = [torch.randn((n, *shape[1:]), generator=gen, device=dev)
                      .mul_(1e-3).to(dtype) for _ in range(ROW_SETS)]
            case = _scatter_case(table, sets, deltas, n_valid, rate)
            emit("kernel", name="scatter_add_rows", dtype=str(dtype), rows=n, **case)
            if dtype == torch.float32 and n == n_out:
                summary["scatter_add_rows"] = {"shape": [n, *shape[1:]], **case}
            del deltas
        del table
        torch.cuda.synchronize()
    del base
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------- fused kernels ---


def _block_local(nblocks: int, per_block: int, rng) -> np.ndarray:
    """Ids for ``nblocks`` kernel blocks, block b's drawn zipf-wise from its
    own range of VOCAB / nblocks ids: duplicates within a block (and the
    same head ids in its context and pool slots), none across blocks."""
    span = VOCAB // nblocks
    ids = zipf_ids(nblocks * per_block, span, rng).reshape(nblocks, per_block)
    return (ids + span * np.arange(nblocks)[:, None]).reshape(-1).astype(np.int32)


def _window_mask(n: int, rng) -> np.ndarray:
    """Real slots of ``n`` windows as skipgram_windows draws them (b ~ U(1,
    WINDOW), offsets -b..-1, 1..b), without the corpus edges."""
    offsets = np.concatenate([np.arange(-WINDOW, 0), np.arange(1, WINDOW + 1)])
    b = rng.integers(1, WINDOW + 1, size=n)
    return np.abs(offsets)[None, :] <= b[:, None]


def _fused_ids(kind: str, block_local: bool, rng) -> dict:
    """One step's ids at the main path's shapes, on the card."""
    if kind == "flat":
        nb = BATCH // POOL_BLOCK
        if block_local:
            ids = dict(in_rows=_block_local(nb, POOL_BLOCK, rng),
                       pos_rows=_block_local(nb, POOL_BLOCK, rng))
        else:
            ids = dict(in_rows=zipf_ids(BATCH, VOCAB, rng),
                       pos_rows=zipf_ids(BATCH, VOCAB, rng))
    else:
        nb = GROUPED_BATCH // CENTERS_PER_BLOCK
        if block_local:
            centers = _block_local(nb, CENTERS_PER_BLOCK, rng)
            ctxs = _block_local(nb, CENTERS_PER_BLOCK * CW, rng).reshape(-1, CW)
        else:
            centers = zipf_ids(GROUPED_BATCH, VOCAB, rng)
            ctxs = zipf_ids(GROUPED_BATCH * CW, VOCAB, rng).reshape(-1, CW)
        ctxs[~_window_mask(GROUPED_BATCH, rng)] = -1
        ids = dict(centers=centers, ctxs=ctxs)
    pool = (_block_local(nb, POOL_SIZE, rng) if block_local
            else zipf_ids(nb * POOL_SIZE, VOCAB, rng))
    ids["pool_rows"] = pool
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in ids.items()}


def _fused_call(kind: str):
    from swiftsnails_tpu_torch.ops import fused_sgns

    lam = NEGATIVES / POOL_SIZE
    if kind == "flat":
        kw = dict(lr=LR, lam=lam, pairs_per_block=POOL_BLOCK, pool_size=POOL_SIZE)
        return fused_sgns.fused_sgns_step, fused_sgns.fused_sgns_step_plain, kw
    kw = dict(lr=LR, lam=lam, window=WINDOW, centers_per_block=CENTERS_PER_BLOCK,
              pool_size=POOL_SIZE)
    return fused_sgns.fused_sgns_grouped_step, fused_sgns.fused_sgns_grouped_step_plain, kw


def _fused_work(kind: str, ids: dict, row_bytes: int, d: int):
    """Least bytes (each distinct row read once and written once, the ids
    read once) and f32 flops of one step on these ids."""
    if kind == "flat":
        rows_in = ids["in_rows"]
        rows_out = torch.cat([ids["pos_rows"], ids["pool_rows"]])
        pairs, units = BATCH, BATCH  # units: rows that meet the pool
    else:
        real = ids["ctxs"] >= 0
        rows_in = ids["centers"]
        rows_out = torch.cat([ids["ctxs"][real], ids["pool_rows"]])
        pairs, units = int(real.sum()), GROUPED_BATCH
    distinct = int(torch.unique(rows_in).numel()) + int(torch.unique(rows_out).numel())
    id_bytes = 4 * sum(v.numel() for v in ids.values())
    nbytes = 2 * distinct * row_bytes + id_bytes
    # scores, dV and dQ against the pool: 3 products of 2 * PN * d flops a
    # row that meets the pool; the positive term, its two gradients and the
    # updates: ~8 d a real pair
    flops = 6 * units * POOL_SIZE * d + 8 * pairs * d
    return nbytes, flops, distinct, pairs


def _yardstick(kind: str, id_sets, tables):
    """``_substep_packed`` (pull, autograd, merged push) on the same pairs
    and pool: the unfused path that the fused kernel replaces. For grouped,
    the windows' real pairs, cut to a multiple of the 32 pool blocks."""
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import W2VState, Word2VecTrainer
    from swiftsnails_tpu_torch.parallel.store import PackedTableState
    from swiftsnails_tpu_torch.utils.config import Config
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    sets = []
    for ids in id_sets:
        pools = ids["pool_rows"].view(-1, POOL_SIZE)
        if kind == "flat":
            sets.append((ids["in_rows"], ids["pos_rows"], pools))
            continue
        real = ids["ctxs"] >= 0
        centers = ids["centers"].repeat_interleave(real.sum(1))
        sets.append((centers, ids["ctxs"][real], pools))
    nb = sets[0][2].shape[0]
    n = min(s[0].numel() for s in sets) // nb * nb
    sets = [(c[:n].contiguous(), x[:n].contiguous(), p) for c, x, p in sets]
    cfg = Config({"dim": str(DIM), "window": str(WINDOW), "negatives": str(NEGATIVES),
                  "learning_rate": str(LR), "batch_size": str(n),
                  "pool_size": str(POOL_SIZE), "pool_block": str(n // nb),
                  "capacity": str(VOCAB), "subsample": "0"})
    tr = Word2VecTrainer(cfg, corpus_ids=np.zeros(4, np.int32),
                         vocab=Vocab(["a", "b"], np.array([2, 2])))
    state = W2VState(PackedTableState(tables[0], {}), PackedTableState(tables[1], {}))
    gen = torch.Generator(device="cuda")

    def run(i):
        c, x, p = sets[i % len(sets)]
        tr._substep_packed(state, c, x, gen, LR, negs=p)

    return time_ms(run), n


def _host_ms(fn, runs: int = 10) -> float:
    """Median host time of ``fn(i)``: the enqueue, without waiting for the
    card (which is synchronised between runs)."""
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _kernel_only(fn, id_sets, tables, kw, name: str, calls: int = 5,
                 windows: int = 3) -> tuple:
    """Device time of the CUDA kernel alone (no prep) a call, by
    torch.profiler, and its launches on the card a call (events named
    ``name``). The time comes only from a window in which the profiler saw
    every launch the wrapper's counter made, each of which returned success,
    since a window with records lost would give a short time too. CUPTI now
    and then drops one record of a window, so a window that lost one is
    reported on stderr and taken again, up to ``windows`` times; the run
    fails if none saw them all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, windows + 1):
        torch.cuda.synchronize()
        made = fn.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # ~1 ms of spinning first, so that no measured launch starts at the
            # window's edge (the profiler now and then lost the first record of
            # a window that began with one)
            torch.cuda._sleep(2_000_000)
            for i in range(calls):
                fn(*tables, *id_sets[i % len(id_sets)].values(), **kw)
            torch.cuda.synchronize()
        made = fn.launches - made
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and name in e.key]
        seen = sum(e.count for e in events)
        if seen >= made:
            us = sum(e.self_device_time_total for e in events)
            return us / 1e3 / calls, seen / calls
        print(f"profiler window {window} of {windows} saw {seen} {name} launches of the "
              f"{made} that {fn.__name__} made: records lost, window taken again",
              file=sys.stderr)
    raise AssertionError(f"the profiler saw {seen} {name} launches of the {made} that "
                         f"{fn.__name__} made in each of {windows} windows: records lost")


def _max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def _fused_case(kind: str, dtype, base, rng, env) -> dict:
    from swiftsnails_tpu_torch.ops import fused_sgns
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    fn, plain, kw = _fused_call(kind)
    tables = [t.to(dtype, copy=True) for t in base]  # timing updates them
    # block-local ids: the kernel equals its plain version and repeats exactly
    ids = _fused_ids(kind, True, rng)
    want = plain(*[t.clone() for t in tables], *ids.values(), **kw)
    got = [fn(*[t.clone() for t in tables], *ids.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    err = _max_err(got[0], want)
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0**-7, 1e-6)
    for g, w in zip(got[0], want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol)
    if not all(torch.equal(a, b) for a, b in zip(got[0], got[1])):
        raise AssertionError(f"{fn.__name__}: two runs on the card differ")
    if any(t.reshape(t.shape[0], -1)[:, DIM:].any() for t in got[0][:2]):
        raise AssertionError(f"{fn.__name__}: padding lanes changed")
    del want, got
    # zipf ids over the whole vocabulary: blocks share rows and race (hogwild)
    id_sets = [_fused_ids(kind, False, rng) for _ in range(ROW_SETS)]
    want = plain(*[t.clone() for t in tables], *id_sets[0].values(), **kw)
    got = fn(*[t.clone() for t in tables], *id_sets[0].values(), **kw)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in got):
        raise AssertionError(f"{fn.__name__}: non-finite result on zipf ids")
    loss_gap = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
    if loss_gap > 1e-2:
        raise AssertionError(f"{fn.__name__}: loss {float(got[2])} vs plain "
                             f"{float(want[2])} on zipf ids")
    zipf_err = _max_err(got[:2], want[:2])
    del want, got
    row_bytes = tables[0].stride(0) * tables[0].element_size()
    nbytes, flops, distinct, pairs = _fused_work(kind, id_sets[0], row_bytes,
                                                 tables[0].stride(0))
    bytes_ms = nbytes / env["mem_rate_Bps"] * 1e3
    flops_ms = flops / env["f32_rate_flops"] * 1e3
    pick = lambda i: id_sets[i % len(id_sets)].values()  # noqa: E731
    kernel = "fused_sgns_kernel" if kind == "flat" else "fused_sgns_grouped_kernel"
    grouped = kind == "grouped"
    nb = (GROUPED_BATCH // CENTERS_PER_BLOCK) if grouped else BATCH // POOL_BLOCK
    plan = fused_sgns.cluster_plan(grouped, nb, CENTERS_PER_BLOCK if grouped else POOL_BLOCK,
                                   CW if grouped else 0, POOL_SIZE, tables[0])
    case = {
        "ms": time_ms(lambda i: fn(*tables, *pick(i), **kw)),
        **dict(zip(("kernel_only_ms", "card_launches_per_substep"), _kernel_only(
            fn, id_sets, tables, kw, kernel))),
        "host_ms": _host_ms(lambda i: fn(*tables, *pick(i), **kw)),
        "plain_ms": time_ms(lambda i: plain(*tables, *pick(i), **kw), runs=5),
        "cluster": plan["cluster"], "ctas": plan["ctas"],
        "max_active_clusters": plan["max_active_clusters"],
        "active_by_cluster": plan["active_by_cluster"], "tile": plan["tile"],
        "ring": plan["ring"], "smem_bytes": plan["smem_bytes"],
        "max_abs_err": err, "zipf_loss_gap": loss_gap, "zipf_max_abs_diff": zipf_err,
        "bytes": nbytes, "flops": flops, "distinct_rows": distinct, "real_pairs": pairs,
        "bytes_ms": bytes_ms, "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
    }
    if case["card_launches_per_substep"] != 1:
        raise AssertionError(f"{fn.__name__}: {case['card_launches_per_substep']} launches "
                             "a substep on the card, want 1")
    if dtype == torch.float32:
        case["yardstick_ms"], case["yardstick_pairs"] = _yardstick(kind, id_sets, tables)
    return case


def _merged_run(fn, plain, tables, ids, kw, rtol, atol):
    """Two kernel runs and the plain version on ``ids``: raises unless the
    runs are bit-identical and keep the padding lanes zero; returns the
    largest difference from the plain version, the count of elements
    outside ``rtol`` / ``atol`` of it, and the two losses."""
    want = plain(*[t.clone() for t in tables], *ids.values(), **kw)
    got = [fn(*[t.clone() for t in tables], *ids.values(), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    name = fn.__name__
    if not all(torch.equal(a, b) for a, b in zip(got[0], got[1])):
        raise AssertionError(f"{name}: two runs on the card differ")
    if any(t.reshape(t.shape[0], -1)[:, DIM:].any() for t in got[0][:2]):
        raise AssertionError(f"{name}: padding lanes changed")
    if not all(torch.isfinite(t).all() for t in got[0]):
        raise AssertionError(f"{name}: non-finite result")
    outside = sum(int((g.float() - w.float()).abs().gt(atol + rtol * w.float().abs()).sum())
                  for g, w in zip(got[0][:2], want[:2]))
    return _max_err(got[0], want), outside, float(got[0][2]), float(want[2])


def _merged_case(name: str, dtype, base, rng, env, grouped: dict) -> dict:
    """A merged kernel at the main shape. Its blocks run in order, so on zipf
    ids over the whole vocabulary it equals its plain version in f32 within
    rtol 1e-5 / atol 1e-6 and repeats bit for bit. In bf16 a row that several
    blocks write passes through one bf16 rounding a block, and the kernel's
    f32 values differ from the plain version's in the last bits, so a
    rounding can flip and the flip carries into the next block: one bf16
    rounding is held on block-local ids (each row written by one block), and
    on zipf ids the elements beyond it are counted. One launch a substep on
    the card (the profiler's count); its time alone is put beside the
    grouped kernel's alone, ``grouped`` (this call, same dtype)."""
    from swiftsnails_tpu_torch.ops import fused_sgns
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    fn, plain = getattr(fused_sgns, name), getattr(fused_sgns, name + "_plain")
    kw = {**_fused_call("grouped")[2], **MERGED[name]}
    tables = [t.to(dtype, copy=True) for t in base]  # timing updates them
    id_sets = [_fused_ids("grouped", False, rng) for _ in range(ROW_SETS)]
    f32 = dtype == torch.float32
    rtol, atol = (1e-5, 1e-6) if f32 else (2.0**-7, 1e-6)
    exact_ids = id_sets[0] if f32 else _fused_ids("grouped", True, rng)
    err, outside, _, _ = _merged_run(fn, plain, tables, exact_ids, kw, rtol, atol)
    if outside:
        raise AssertionError(f"{name} ({dtype}): {outside} elements outside rtol {rtol} / "
                             f"atol {atol} of the plain version (largest {err})")
    case = {"max_abs_err": err, "exact_ids": "zipf" if f32 else "block-local"}
    if not f32:
        zerr, zout, loss, want_loss = _merged_run(fn, plain, tables, id_sets[0], kw, rtol, atol)
        case.update(zipf_max_abs_diff=zerr, zipf_beyond_one_rounding=zout,
                    zipf_loss_gap=abs(loss - want_loss) / abs(want_loss))
    row_bytes = tables[0].stride(0) * tables[0].element_size()
    nbytes, flops, distinct, pairs = _fused_work("grouped", id_sets[0], row_bytes,
                                                 tables[0].stride(0))
    bytes_ms = nbytes / env["mem_rate_Bps"] * 1e3
    flops_ms = flops / env["f32_rate_flops"] * 1e3
    pick = lambda i: id_sets[i % len(id_sets)].values()  # noqa: E731
    hot_n = fused_sgns.effective_hot_rows(kw.get("hot_rows", 0), VOCAB)[0]
    prep = lambda i: fused_sgns.merged_prep(  # noqa: E731
        *pick(i), CENTERS_PER_BLOCK, POOL_SIZE, hot_n, kw.get("u_cap", 0), VOCAB)
    case.update({
        "ms": time_ms(lambda i: fn(*tables, *pick(i), **kw)),
        **dict(zip(("kernel_only_ms", "card_launches_per_substep"),
                   _kernel_only(fn, id_sets, tables, kw, "merged_"))),
        "prep_ms": time_ms(prep),
        "host_ms": _host_ms(lambda i: fn(*tables, *pick(i), **kw)),
        "plain_ms": time_ms(lambda i: plain(*tables, *pick(i), **kw), runs=5),
        "bytes": nbytes, "flops": flops, "distinct_rows": distinct,
        "real_pairs": pairs, "bytes_ms": bytes_ms, "flops_ms": flops_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations", **MERGED[name],
    })
    if case["card_launches_per_substep"] != 1:
        raise AssertionError(f"{name}: {case['card_launches_per_substep']} launches a "
                             "substep on the card, want 1")
    case["grouped_kernel_only_ms"] = grouped["kernel_only_ms"]
    case["kernel_only_over_grouped"] = case["kernel_only_ms"] / grouped["kernel_only_ms"]
    if f32:
        case["yardstick_ms"], case["yardstick_pairs"] = _yardstick("grouped", id_sets, tables)
    return case


def phase_fused_kernels(seed: int, env: dict) -> dict:
    """Each fused kernel at the main path's shapes; returns the f32 numbers
    per kernel for the summary line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 7)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    shape = (VOCAB, -(-DIM // 128), 128)
    lanes = (torch.arange(shape[1] * 128, device=dev) < DIM).view(shape[1:])
    base = [torch.randn(shape, generator=gen, device=dev).mul_(0.1).mul_(lanes)
            for _ in range(2)]
    summary, grouped = {}, {}
    for kind, name in (("flat", "fused_sgns_step"), ("grouped", "fused_sgns_grouped_step")):
        for dtype in (torch.float32, torch.bfloat16):
            case = _fused_case(kind, dtype, base, rng, env)
            emit("kernel", name=name, dtype=str(dtype), **case)
            if dtype == torch.float32:
                summary[name] = case
            if kind == "grouped":
                grouped[dtype] = case
            torch.cuda.empty_cache()
    for name in MERGED:
        for dtype in (torch.float32, torch.bfloat16):
            case = _merged_case(name, dtype, base, rng, env, grouped[dtype])
            emit("kernel", name=name, dtype=str(dtype), **case)
            if dtype == torch.float32:
                summary[name] = case
            torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return summary


def _small_trainer(device, seed, **over):
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    v = 4096
    rng = np.random.default_rng(seed)
    ids = zipf_ids(60_000, v, rng)
    counts = np.maximum(np.bincount(ids, minlength=v), 1)
    cfg = Config({"dim": str(DIM), "window": str(WINDOW),
                  "negatives": str(NEGATIVES), "learning_rate": str(LR),
                  "batch_size": "2048", "subsample": "0", "pool_size": str(POOL_SIZE),
                  "pool_block": str(POOL_BLOCK), "seed": str(seed),
                  **{k: str(v) for k, v in over.items()}})
    return Word2VecTrainer(cfg, corpus_ids=ids, vocab=Vocab(
        [f"w{i}" for i in range(v)], counts), device=device)


# path -> (config keys, substep method). The hogwild paths run one kernel
# block a substep here: the card runs their blocks concurrently, the CPU in
# order, and the two agree only where no block races another. The merged
# paths run their blocks in order on both: 8 kernel blocks a substep.
_GROUPED = {"fused": 1, "grouped": 1, "centers_per_block": CENTERS_PER_BLOCK}
PATHS = {
    "packed": ({}, "_substep_packed"),
    "fused": ({"fused": 1, "batch_size": POOL_BLOCK}, "_substep_fused"),
    "grouped": ({**_GROUPED, "batch_size": CENTERS_PER_BLOCK}, "_substep_grouped"),
    "resident": ({**_GROUPED, "resident": 1, "hot_rows": COMPOSED_HOT_ROWS},
                 "_substep_grouped"),
    "dedup": ({**_GROUPED, "dedup": 1, "u_cap": U_CAP}, "_substep_grouped"),
    "dedup_res": ({**_GROUPED, "dedup": 1, "u_cap": U_CAP, "resident": 1,
                   "hot_rows": COMPOSED_HOT_ROWS}, "_substep_grouped"),
    # per-pair negatives ([b, K] word ids injected): the 2-D plane, and the
    # packed tables through gather_rows / scatter_add_rows
    "dense": ({"packed": 0}, "_substep_dense"),
    "perpair": ({"neg_mode": "per_pair"}, "_substep_packed_perpair"),
}
PER_PAIR = ("dense", "perpair")


def phase_slice_parity(seed: int, path: str) -> None:
    from swiftsnails_tpu_torch import convert

    over, method = PATHS[path]
    cpu = _small_trainer("cpu", seed, **over)
    cuda = _small_trainer("cuda", seed, **over)
    init = cpu.init_state()
    tables = [t.table.numpy().copy() for t in init]
    batches = [b for _, b in zip(range(4), cpu.batches())]
    rng = np.random.default_rng(seed + 1)
    n = batches[0]["centers"].shape[0]
    nb = n // cpu._effective_pc(n) if cpu.grouped else cpu.pool_geometry(n)[1]
    shape = (n, NEGATIVES) if path in PER_PAIR else (nb, POOL_SIZE)
    pools = [rng.integers(0, 4096, shape).astype(np.int32) for _ in batches]

    def run(tr, device):
        state = convert.w2v_state_from_numpy(*tables, device=device)
        gen = torch.Generator(device=device)
        losses = []
        for batch, pool in zip(batches, pools):
            state, loss = getattr(tr, method)(
                state, torch.from_numpy(batch["centers"]).to(device),
                torch.from_numpy(batch["contexts"]).to(device), gen, tr.lr,
                negs=torch.from_numpy(pool).to(device))
            losses.append(float(loss))
        return state, losses

    s_cpu, l_cpu = run(cpu, "cpu")
    s_gpu, l_gpu = run(cuda, "cuda")
    s_gpu2, l_gpu2 = run(cuda, "cuda")
    worst = 0.0
    for a, b, c in zip(s_cpu, s_gpu, s_gpu2):
        ga, gb = a.table.numpy(), b.table.cpu().numpy()
        np.testing.assert_allclose(gb, ga, rtol=1e-5, atol=1e-6)
        worst = max(worst, float(np.abs(gb - ga).max()))
        if not torch.equal(b.table, c.table):
            raise AssertionError("two runs on the card differ")
        if b.table.reshape(b.capacity, -1)[:, DIM:].any():
            raise AssertionError("padding lanes changed")
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5, atol=1e-6)
    if l_gpu != l_gpu2:
        raise AssertionError("losses of two runs on the card differ")
    emit("slice_parity", path=path, substeps=len(batches), batch=n,
         kernel_blocks=None if path in PER_PAIR else nb,
         table=list(s_gpu[0].table.shape), max_abs_err_vs_cpu=worst, losses_cuda=l_gpu, losses_cpu=l_cpu,
         repeat_bit_identical=True)


def _corpus(seed: int, paired: bool = False):
    """A train phase's corpus: N_TOKENS ids over VOCAB, its vocab, and
    skip-gram pairs per token (6.00 at window 5) counted on its first 2^20
    by the native producer, which makes the phases' batches. Zipf ids, or
    with ``paired`` zipf-distributed pairs (2p, 2p + 1)."""
    from swiftsnails_tpu_torch.data import native
    from swiftsnails_tpu_torch.data.vocab import Vocab

    rng = np.random.default_rng(seed)
    if paired:
        p = zipf_ids(N_TOKENS // 2, VOCAB // 2, rng)
        ids = np.stack([2 * p, 2 * p + 1], 1).reshape(-1).astype(np.int32)
    else:
        ids = zipf_ids(N_TOKENS, VOCAB, rng)
    counts = np.maximum(np.bincount(ids, minlength=VOCAB), 1)
    vocab = Vocab([f"w{i}" for i in range(VOCAB)], counts)
    pairs, _ = native.skipgram_pairs(ids[: 1 << 20], WINDOW, seed=seed)
    return ids, vocab, len(pairs) / (1 << 20)


def _counters() -> dict:
    from swiftsnails_tpu_torch.ops import fused_sgns, rowdma, sem_probe

    return {f.__name__: f for f in (rowdma.gather_rows, rowdma.scatter_add_rows,
                                     rowdma.scatter_write_rows, rowdma.scatter_adagrad_rows,
                                     rowdma.scatter_adagrad_fused_rows,
                                     fused_sgns.fused_sgns_step,
                                     fused_sgns.fused_sgns_grouped_step,
                                     *(getattr(fused_sgns, name) for name in MERGED),
                                     sem_probe.unit_probe, sem_probe.chunk_probe,
                                     sem_probe.pipe_probe)}


# train phase -> (config keys, launches a substep of each kernel, paired
# corpus); every phase at vocab 2^20, dim 200, window 5, 5 negatives, pool 64
_FUSED = {"learning_rate": FUSED_LR, "steps_per_call": FUSED_STEPS_PER_CALL,
          "fused": 1}
HOGWILD_TRAIN = ("train_fused", "train_grouped")
TRAIN = {
    "train": ({"learning_rate": LR, "batch_size": BATCH},
              {"gather_rows": 2, "scatter_add_rows": 2}, False),
    "train_fused": ({**_FUSED, "batch_size": BATCH}, {"fused_sgns_step": 1}, True),
    "train_grouped": ({**_FUSED, "grouped": 1, "batch_size": GROUPED_BATCH,
                       "centers_per_block": CENTERS_PER_BLOCK},
                      {"fused_sgns_grouped_step": 1}, True),
}
# packed: 0 (two [1,048,576, 200] f32 tables, 1.68 GB) and neg_mode:
# per_pair (two [1,048,576, 2, 128], 2.15 GB): K = 5 independent negatives
# a pair, the packed+pool phase's batch, lr and corpus
TRAIN["train_dense"] = ({"learning_rate": LR, "batch_size": BATCH, "packed": 0}, {}, False)
TRAIN["train_perpair"] = ({"learning_rate": LR, "batch_size": BATCH, "neg_mode": "per_pair"},
                          {"gather_rows": 2, "scatter_add_rows": 2}, False)
_MERGED_TRAIN = {**_FUSED, "grouped": 1, "batch_size": GROUPED_BATCH,
                 "centers_per_block": CENTERS_PER_BLOCK}
for _phase, _keys, _kernel in (
        ("train_resident", {"resident": 1, "hot_rows": HOT_ROWS}, "fused_sgns_resident_step"),
        ("train_dedup", {"dedup": 1, "u_cap": U_CAP}, "fused_sgns_dedup_step"),
        ("train_dedup_res", {"dedup": 1, "u_cap": U_CAP, "resident": 1,
                             "hot_rows": COMPOSED_HOT_ROWS}, "fused_sgns_dedup_resident_step")):
    TRAIN[_phase] = ({**_MERGED_TRAIN, **_keys, "learning_rate": MERGED_LR[_phase]},
                     {_kernel: 1}, True)


def _train_loop(phase: str, seed: int, corpora, mesh=None, **extra):
    """A train phase's trainer and loop (``extra`` config keys on top;
    under ``mesh``, a ``parallel.mesh.Mesh``), and the list its records go
    to."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    over, _, paired = TRAIN[phase]
    ids, vocab, _ = corpora[paired]
    cfg = Config({"dim": str(DIM), "window": str(WINDOW),
                  "negatives": str(NEGATIVES), "subsample": "0", "num_iters": "1",
                  "pool_size": str(POOL_SIZE), "pool_block": str(POOL_BLOCK),
                  "table_dtype": "float32", "seed": str(seed),
                  **{k: str(v) for k, v in {**over, **extra}.items()}})
    trainer = Word2VecTrainer(cfg, mesh=mesh, corpus_ids=ids, vocab=vocab)
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    return trainer, TrainLoop(trainer, metrics=Recorder(), log_every=1), records


def _plain_in_order_losses(phase: str, seed: int, corpora) -> list:
    """The losses of ``phase`` (fused-hogwild or fused-grouped) with its
    kernel replaced by the plain version, whose blocks run in order as the
    TPU kernel's do: the same seed, batches and lr."""
    from swiftsnails_tpu_torch.models import word2vec
    from swiftsnails_tpu_torch.ops import fused_sgns

    trainer, loop, records = _train_loop(phase, seed, corpora)
    kernel = word2vec.fused_sgns_step
    word2vec.fused_sgns_step = fused_sgns.fused_sgns_step_plain
    if trainer.grouped:
        trainer.grouped_step = (fused_sgns.fused_sgns_grouped_step_plain, {})
    try:
        loop.run(seed=seed, max_steps=STEPS)
    finally:
        word2vec.fused_sgns_step = kernel
    return [r["loss"] for r in records]


def _fall(losses) -> float:
    return float(np.mean(losses[:5]) - np.mean(losses[-5:]))


def phase_train(phase: str, seed: int, corpora, device_name: str, smi: str):
    _, per_substep, paired = TRAIN[phase]
    pairs_per_token = corpora[paired][2]
    t0 = time.monotonic()
    trainer, loop, records = _train_loop(phase, seed, corpora)
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=STEPS))
    substeps = len(records) * trainer.steps_per_call
    _check_launches(phase, launches, {k: n * substeps for k, n in per_substep.items()})
    losses = [r["loss"] for r in records]
    if len(losses) != STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    for t in state:
        if not torch.isfinite(t.table).all():
            raise AssertionError("non-finite table")
    steady = records[5:]  # past the first chunk's pair generation and warm-up
    items = sum(r["items"] for r in steady)
    seconds = sum(r["seconds"] for r in steady)
    step_ms = [r["seconds"] * 1e3 for r in steady]
    # a flat batch counts pairs, a grouped one words (corpus positions)
    words = items if trainer.grouped else items / pairs_per_token
    out = {"steps": len(records), "substeps": substeps,
           "producer": records[0].get("producer"),
           "table": list(state.in_table.table.shape),
           "batch": trainer.batch_size, "steps_per_call": trainer.steps_per_call,
           "lr": trainer.lr, "corpus": "paired" if paired else "zipf",
           "launches": launches, "setup_s": setup_s,
           "first_step_ms": records[0]["seconds"] * 1e3,
           "step_ms_median": statistics.median(step_ms),
           "items_per_sec": items / seconds, "words_per_sec": words / seconds,
           "pairs_per_token": pairs_per_token,
           "loss_first5": losses[:5], "loss_last5": losses[-5:],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": device_name, "nvidia_smi": smi}
    if phase in HOGWILD_TRAIN:
        plain = _plain_in_order_losses(phase, seed, corpora)
        fall, plain_fall = _fall(losses), _fall(plain)
        out["plain_in_order"] = {"loss_first5": plain[:5], "loss_last5": plain[-5:],
                                 "fall": plain_fall, "kernel_fall": fall,
                                 "fall_share": fall / plain_fall if plain_fall else None,
                                 "limit": HOGWILD_FALL_SHARE}
    emit(phase, **out)
    out["losses"] = losses  # the telemetry phase's telemetry-off run
    if phase in HOGWILD_TRAIN:
        ref = out["plain_in_order"]
        if not ref["fall"] > 0 or ref["fall_share"] < HOGWILD_FALL_SHARE:
            raise AssertionError(f"{phase}: the loss fell {ref['kernel_fall']}, "
                                 f"{ref['fall_share']} of the plain version's {ref['fall']} "
                                 f"(blocks in order), below {HOGWILD_FALL_SHARE}")
    return out, trainer, state


def phase_profile(path: str, trainer, state, seed: int, steps: int = 5) -> None:
    """Device time by kernel over ``steps`` more train steps, by
    ``torch.profiler``, and the card's busy share of their wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.framework.trainer import step_generator

    dev = torch.device("cuda")
    it = iter(trainer.batches())
    batches = [{k: torch.from_numpy(v).to(dev) if np.ndim(v) else v
                for k, v in next(it).items()} for _ in range(steps + 1)]
    it.close()  # stops the native producer's threads
    trainer.train_step(state, batches[0], step_generator(seed, 0, dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, batch in enumerate(batches[1:]):
            trainer.train_step(state, batch, step_generator(seed, i + 1, dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    emit("profile", path=path, steps=steps,
         substeps_per_step=getattr(trainer, "steps_per_call", 1),
         wall_ms_per_step=wall_ms / steps,
         device_ms_per_step=busy_ms, device_busy_share=busy_ms * steps / wall_ms,
         kernels_per_step=sum(n for _, _, n in kernels),
         top=[{"kernel": k[:90], "ms_per_step": ms, "launches_per_step": n}
              for k, ms, n in kernels[:14]])


# ------------------------------------------------------------------ CTR ---


def _widedeep_config(seed: int):
    from swiftsnails_tpu_torch.utils.config import load_config

    cfg = load_config(Path(__file__).resolve().parent / WIDEDEEP_CONF)
    cfg.set("seed", str(seed))
    return cfg


def _ctr_data(seed: int, fields: int = 0):
    """synth_ctr records at Wide & Deep's width (or ``fields`` fields):
    ``CTR_STEPS`` batches to train on, then ``CTR_EVAL`` held out (the same
    planted weights)."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    cfg = _widedeep_config(seed)
    n = CTR_STEPS * cfg.get_int("batch_size")
    labels, feats, _ = synth_ctr(n + CTR_EVAL, fields or cfg.get_int("num_fields"),
                                 CTR_IDS_PER_FIELD, seed=seed)
    return (labels[:n], feats[:n]), (labels[n:], feats[n:])


def _push_case(kernel, plain, buffers, sets, library, nbytes, n_valid, rate):
    """``kernel`` and ``plain`` (each ``(buffers, uniq, values) -> updated
    buffers``) on the first id set: bit-equal, and two kernel runs
    bit-identical; then both timed on the sets in rotation, beside
    ``library`` where one torch call computes the same function."""
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    uniq, vals = sets[0][:2]
    want = plain([b.clone() for b in buffers], uniq, vals)
    got = [kernel([b.clone() for b in buffers], uniq, vals) for _ in range(2)]
    torch.cuda.synchronize()
    err = _max_err(got[0], want)
    for g, w in zip(got[0], want):
        if not torch.equal(g, w):
            ulps = float(((g.float() - w.float()).abs()
                          / (w.float().abs() * torch.finfo(w.dtype).eps)).nan_to_num().max())
            raise AssertionError(f"differs from its plain version: {err} ({ulps} ulps)")
    if not all(torch.equal(a, b) for a, b in zip(*got)):
        raise AssertionError("two runs on the card differ")
    del want, got
    pick = lambda i: sets[i % len(sets)]  # noqa: E731
    return {
        "ms": time_ms(lambda i: kernel(buffers, *pick(i)[:2])),
        "plain_ms": time_ms(lambda i: plain(buffers, *pick(i)[:2])),
        "library_ms": time_ms(lambda i: library(buffers, pick(i))) if library else None,
        "bytes": nbytes, "unique_rows": n_valid, "ids": int(uniq.numel()),
        "bound_ms": nbytes / rate * 1e3, "max_abs_err": err,
    }


def phase_ctr_kernels(seed: int, rate: float) -> dict:
    """The Wide & Deep step's row kernels at its shapes, from the trainer's
    first batches (212,992 ids each, hashed): the pull's ``gather_rows`` of
    every id's tile from the ``[262,144, 2, 128]`` slot-fused table, and the
    three push kernels on the same ids merged by tile (the tail padding
    kept) with merged random gradients, on the slot-fused table
    (``scatter_adagrad_fused_rows``) and on ``[262,144, 1, 128]`` and its
    accumulator (``scatter_adagrad_rows``, ``scatter_write_rows``), in f32
    and bf16. Returns the f32 numbers per kernel for the summary line, the
    pull's under ``gather_rows_widedeep``."""
    from swiftsnails_tpu_torch.data.ctr import ctr_batches
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.ops.hashing import hash_row
    from swiftsnails_tpu_torch.parallel.store import merge_small_rows, small_group

    dev = torch.device("cuda")
    cfg = _widedeep_config(seed)
    dim, cap = 1 + cfg.get_int("embed_dim"), cfg.get_int("capacity")
    lr = cfg.get_float("learning_rate")
    g = small_group(dim)
    tiles = cap // g
    (labels, feats), _ = _ctr_data(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    batches = ctr_batches(labels, feats, cfg.get_int("batch_size"),
                          np.random.default_rng(seed))  # the trainer's first batches
    merged_sets, tile_sets = [], []
    for _, b in zip(range(CTR_ROW_SETS), batches):
        rows = hash_row(torch.from_numpy(b["feats"]).to(dev).clamp_min(0), cap).reshape(-1)
        tile_sets.append(rows // g)  # the pull's ids, as pull_packed_small makes them
        grads = torch.randn(rows.shape[0], dim, generator=gen, device=dev).mul_(0.01)
        uniq, merged = merge_small_rows(rows, grads, dim, tiles)
        n_valid = int((uniq < tiles).sum())
        merged_sets.append((uniq, merged, uniq[:n_valid].long(), n_valid))
    live = (torch.arange(128, device=dev) % (128 // g)) < dim
    param = torch.randn(tiles, 1, 128, generator=gen, device=dev).mul_(0.01).mul_(live)
    accum = torch.rand(tiles, 1, 128, generator=gen, device=dev).mul_(0.1).mul_(live)
    n_valid, n_ids = merged_sets[0][3], merged_sets[0][0].numel()
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        half = 128 * torch.finfo(dtype).bits // 8  # bytes of one sublane
        sets = [(u, m.to(dtype), idx, nv) for u, m, idx, nv in merged_sets]
        # param and accum read and written, the gradient read: 5 sublanes a
        # unique tile; the write: a value read and a row written
        adagrad_bytes = n_valid * 5 * half + n_ids * 4
        write_bytes = n_valid * 2 * half + n_ids * 4
        fused = torch.cat([param, accum], dim=1).to(dtype)
        pull = _gather_case(fused, tile_sets, rate)
        if not torch.equal(*(rowdma.gather_rows(fused, tile_sets[0]) for _ in range(2))):
            raise AssertionError("gather_rows: two runs on the card differ")
        emit("kernel", name="gather_rows", dtype=str(dtype), path="train_widedeep",
             rows=int(tile_sets[0].numel()), **pull)
        if dtype == torch.float32:
            summary["gather_rows_widedeep"] = {"shape": [int(tile_sets[0].numel()),
                                                         *fused.shape[1:]], **pull}
        cases = {
            "scatter_adagrad_fused_rows": (
                lambda b, u, v: (rowdma.scatter_adagrad_fused_rows(b[0], u, v, lr),),
                lambda b, u, v: (rowdma.scatter_adagrad_fused_rows_plain(b[0], u, v, lr),),
                [fused], None, adagrad_bytes),
            "scatter_adagrad_rows": (
                lambda b, u, v: rowdma.scatter_adagrad_rows(b[0], b[1], u, v, lr),
                lambda b, u, v: rowdma.scatter_adagrad_rows_plain(b[0], b[1], u, v, lr),
                [param.to(dtype), accum.to(dtype)], None, adagrad_bytes),
            "scatter_write_rows": (
                lambda b, u, v: (rowdma.scatter_write_rows(b[0], u, v),),
                lambda b, u, v: (rowdma.scatter_write_rows_plain(b[0], u, v),),
                [param.to(dtype)],
                lambda b, st: b[0].index_copy_(0, st[2], st[1][: st[3]]), write_bytes),
        }
        for name, (kernel, plain, buffers, library, nbytes) in cases.items():
            case = _push_case(kernel, plain, buffers, sets, library, nbytes, n_valid, rate)
            emit("kernel", name=name, dtype=str(dtype), **case)
            if dtype == torch.float32:
                summary[name] = {"shape": list(buffers[0].shape), **case}
            del buffers
        del fused, sets
        torch.cuda.empty_cache()
    return summary


def _ctr_trainer(case: str, device: str, seed: int):
    from swiftsnails_tpu_torch.data.ctr import PAD, synth_ctr
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import Config

    name, over = CTR_PARITY[case]
    labels, feats, _ = synth_ctr(4 * 1024, 8, 1000, seed=seed)
    feats[::5, 3] = PAD  # padding fields, masked out of forward and push
    conf = {"num_fields": "8", "capacity": str(1 << 14), "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "1024", "seed": str(seed),
            **{k: str(v) for k, v in over.items()}}
    return get_model(name)(Config(conf), data=(labels, feats), device=device)


def _assert_moves_close(start: dict, got: dict, want: dict) -> float:
    """Each array's change on the card within 1e-4 of the largest change of
    the CPU's (the CPU tests' tolerance); returns the largest gap. A change
    must be above 1e-4, but a slot's (an AdaGrad accumulator of the 2-D
    plane adds squares of gradients of order 1e-3) only above 0."""
    worst = 0.0
    for k, w in want.items():
        moved = w - start[k]
        scale = float(np.abs(moved).max())
        if not scale > (0.0 if k.startswith("slot.") else 1e-4):
            raise AssertionError(f"{k} barely moved: {scale}")
        np.testing.assert_allclose(got[k] - start[k], moved, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
        worst = max(worst, float(np.abs(got[k] - w).max()))
    return worst


def _run_counted(fn) -> tuple:
    """``fn()`` with every launch counter set to 0 just before and read just
    after; returns its result and the counts."""
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: f.launches for name, f in counters.items()}


def _check_launches(what: str, launches: dict, want: dict) -> None:
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{what}: {name}: {n} launches, want {want.get(name, 0)}")


def phase_ctr_parity(seed: int) -> None:
    """4 steps of each CTR family on the card against the port on the CPU
    from one state."""
    from swiftsnails_tpu_torch import convert

    for case in CTR_PARITY:
        cpu = _ctr_trainer(case, "cpu", seed)
        gpu = _ctr_trainer(case, "cuda", seed)
        init = cpu.init_state()
        table = init.table.table.numpy().copy()
        slots = {k: v.numpy().copy() for k, v in init.table.slots.items()}
        dense = {k: v.numpy().copy() for k, v in init.dense.items()}
        sums = ({k: v.numpy().copy() for k, v in init.opt["sum_of_squares"].items()}
                if init.opt else None)
        batches = [b for _, b in zip(range(4), cpu.batches())]

        def run(tr, device):
            state = convert.ctr_state_from_numpy(table, dense, sums, device=device,
                                                 table_slots=slots)
            losses = []
            for b in batches:
                state, m = tr.train_step(state, {k: torch.from_numpy(v).to(device)
                                                 for k, v in b.items()})
                losses.append(float(m["loss"]))
            return state, losses

        s_cpu, l_cpu = run(cpu, "cpu")
        (s_gpu, l_gpu), launches = _run_counted(lambda: run(gpu, "cuda"))
        push = ("scatter_adagrad_fused_rows" if sums is not None else "scatter_add_rows")
        # the 2-D plane is index_select and index_put_: no kernel of the port
        _check_launches(case, launches, {"gather_rows": 4, push: 4} if cpu.packed else {})
        np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
        start = {"table": table, **{f"slot.{k}": v for k, v in slots.items()},
                 **{f"dense.{k}": v for k, v in dense.items()}}

        def arrays(state):
            return {"table": state.table.table.cpu().numpy(),
                    **{f"slot.{k}": v.cpu().numpy() for k, v in state.table.slots.items()},
                    **{f"dense.{k}": v.cpu().numpy() for k, v in state.dense.items()}}

        worst = _assert_moves_close(start, arrays(s_gpu), arrays(s_cpu))
        emit("ctr_parity", case=case, table=list(table.shape), table_dim=cpu.table_dim,
             plane="packed_small" if cpu.packed else "2-D",
             steps=len(batches), launches={k: n for k, n in launches.items() if n},
             losses_cuda=l_gpu, losses_cpu=l_cpu, max_abs_diff_vs_cpu=worst)


def phase_store_routes(seed: int) -> dict:
    """One push of each store route that no CTR family takes, on the card
    against the CPU: ``push_packed`` with AdaGrad on word2vec-width rows
    (gather, apply, ``scatter_write_rows``), and ``push_packed_small`` with a
    split accumulator of the table's dtype (``scatter_adagrad_rows``) and
    with bf16 slots on an f32 table (gather, apply, ``scatter_write_rows``).
    Returns the launches of each route's push kernel (its ``ctr_parity``
    line)."""
    from swiftsnails_tpu_torch.ops.rowdma import pack_rows
    from swiftsnails_tpu_torch.parallel import store
    from swiftsnails_tpu_torch.parallel.access import AdaGradAccess, SgdAccess

    rng = np.random.default_rng(seed + 3)
    rows = rng.integers(0, 4096, 3000).astype(np.int32)
    rows[:600] = rows[0]  # a hot row
    split = store.create_packed_small_table(4096, 17, SgdAccess(), seed=seed,
                                            device="cpu")
    split = split._replace(slots={"accum": torch.zeros_like(split.table)})
    bf16 = AdaGradAccess(slot_dtype=torch.bfloat16)
    routes = {
        "push_packed_adagrad": (
            store.create_packed_table(4096, DIM, AdaGradAccess(), seed=seed, device="cpu"),
            lambda st, r, g: store.push_packed(st, r, pack_rows(g), AdaGradAccess(), 0.05),
            DIM, {"gather_rows": 2, "scatter_write_rows": 2}),
        "push_packed_small_split": (
            split, lambda st, r, g: store.push_packed_small(st, r, g, AdaGradAccess(), 0.05, 17),
            17, {"scatter_adagrad_rows": 1}),
        "push_packed_small_bf16_slots": (
            store.create_packed_small_table(4096, 17, bf16, seed=seed, device="cpu"),
            lambda st, r, g: store.push_packed_small(st, r, g, bf16, 0.05, 17),
            17, {"gather_rows": 2, "scatter_write_rows": 2}),
    }
    launches = {}
    for route, (state, push, dim, want) in routes.items():
        grads = torch.from_numpy(rng.normal(size=(rows.shape[0], dim)).astype(np.float32))

        def on(device, st=state):
            return store.PackedTableState(
                st.table.clone().to(device), {k: v.clone().to(device) for k, v in st.slots.items()})

        want_state = push(on("cpu"), torch.from_numpy(rows), grads)
        got, counts = _run_counted(lambda: push(on("cuda"), torch.from_numpy(rows).cuda(),
                                                 grads.cuda()))
        _check_launches(route, counts, want)
        worst = 0.0
        for w, g in zip((want_state.table, *want_state.slots.values()),
                        (got.table, *got.slots.values())):
            g = g.cpu()
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=1e-5, atol=1e-6)
            worst = max(worst, float((g.float() - w.float()).abs().max()))
        emit("ctr_parity", route=route, ids=int(rows.shape[0]),
             launches={k: n for k, n in counts.items() if n}, max_abs_diff_vs_cpu=worst)
        for name, n in counts.items():
            if n and name != "gather_rows":
                launches.setdefault(name, n)
    return launches


# CTR train phases -> (config keys over examples/widedeep.conf, launches a
# step of each kernel). train_widedeep is the conf as it stands (the
# small-row plane); train_widedeep_2d the conf at packed: 0, a [1,048,576,
# 17] table and its accumulator; train_ffm_wide FFM over Criteo's 39 fields
# (13 integer, 26 categorical) at libffm's Criteo factor_dim 4 (Juan et al.,
# RecSys 2016): table dim 1 + 39 * 4 = 157, above a 128-lane tile, so the
# 2-D plane, [1,048,576, 157] and its accumulator. The 2-D plane launches no
# kernel of the port (index_select, index_put_).
CTR_TRAIN = {
    "train_widedeep": ({}, {"gather_rows": 1, "scatter_adagrad_fused_rows": 1}),
    "train_widedeep_2d": ({"packed": 0}, {}),
    "train_ffm_wide": ({"model": "ffm", "num_fields": 39, "factor_dim": 4}, {}),
}


def phase_train_widedeep(seed: int, env: dict, phase: str = "train_widedeep",
                         packed_auc=None):
    """A ``CTR_TRAIN`` phase through ``get_model`` -> ``TrainLoop.run`` for
    ``CTR_STEPS`` steps on synth_ctr data, then ``eval_auc`` on the
    held-out records (beside the packed phase's, ``packed_auc``)."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    over, per_step = CTR_TRAIN[phase]
    t0 = time.monotonic()
    cfg = _widedeep_config(seed)
    for k, v in over.items():
        cfg.set(k, str(v))
    (labels, feats), (eval_labels, eval_feats) = _ctr_data(seed, cfg.get_int("num_fields"))
    trainer = get_model(cfg.get_str("model"))(cfg, data=(labels, feats))
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    loop = TrainLoop(trainer, metrics=Recorder(), log_every=1)
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=CTR_STEPS))
    _check_launches(phase, launches, {k: n * CTR_STEPS for k, n in per_step.items()})
    losses = [r["loss"] for r in records]
    if len(losses) != CTR_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    if not torch.isfinite(state.table.table).all():
        raise AssertionError("non-finite table")
    steady = records[5:]
    seconds = sum(r["seconds"] for r in steady)
    step_ms = [r["seconds"] * 1e3 for r in steady]
    t_eval = time.perf_counter()
    auc = trainer.eval_auc(state, labels=eval_labels, feats=eval_feats)
    eval_s = time.perf_counter() - t_eval
    out = {"config": WIDEDEEP_CONF, "over": over, "model": trainer.name,
           "plane": "packed_small" if trainer.packed else "2-D",
           "steps": len(records), "batch": trainer.batch_size,
           "num_fields": trainer.num_fields, "capacity": trainer.capacity,
           "table": list(state.table.table.shape), "table_dim": trainer.table_dim,
           "table_bytes": sum(t.numel() * t.element_size()
                              for t in (state.table.table, *state.table.slots.values())),
           "hidden_dims": getattr(trainer, "hidden_dims", None), "lr": trainer.lr,
           "ids_per_field": CTR_IDS_PER_FIELD, "launches": launches, "setup_s": setup_s,
           "first_step_ms": records[0]["seconds"] * 1e3,
           "step_ms_median": statistics.median(step_ms),
           "examples_per_sec": sum(r["items"] for r in steady) / seconds,
           "loss_first5": losses[:5], "loss_last5": losses[-5:],
           "loss_first5_mean": float(np.mean(losses[:5])),
           "loss_last5_mean": float(np.mean(losses[-5:])),
           "eval_auc": auc, "eval_auc_packed_phase": packed_auc,
           "eval_records": len(eval_labels), "eval_s": eval_s,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    emit(phase, **out)
    return out, trainer, state


# ------------------------------------------ per_pair shapes, producer ---


def phase_perpair_kernels(seed: int, rate: float) -> dict:
    """``gather_rows`` and ``scatter_add_rows`` at the ``neg_mode: per_pair``
    substep's out-table shape: 16,384 contexts and 81,920 negatives, 98,304
    zipf ids of 1 KB rows from ``[1,048,576, 2, 128]`` f32 (the in-table pull
    is the packed+pool phase's 16,384), the push merged first. Returns the
    numbers for the summary line."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 9)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    shape = (VOCAB, -(-DIM // 128), 128)
    table = torch.randn(shape, generator=gen, device=dev)
    n = PERPAIR_OUT_ROWS
    sets = [torch.from_numpy(zipf_ids(n, VOCAB, rng)).to(dev) for _ in range(ROW_SETS)]
    gather = _gather_case(table, sets, rate)
    emit("kernel", name="gather_rows", dtype="torch.float32", rows=n, path="train_perpair",
         **gather)
    scatter_sets, n_valid = [], []
    for ids in sets:
        uniq = torch.unique(ids).to(torch.int32)
        n_valid.append(int(uniq.numel()))
        pad = torch.full((n - uniq.numel(),), VOCAB, dtype=torch.int32, device=dev)
        scatter_sets.append(torch.cat([uniq, pad]))
    deltas = [torch.randn((n, *shape[1:]), generator=gen, device=dev).mul_(1e-3)
              for _ in range(ROW_SETS)]
    scatter = _scatter_case(table, scatter_sets, deltas, n_valid, rate)
    emit("kernel", name="scatter_add_rows", dtype="torch.float32", rows=n,
         path="train_perpair", **scatter)
    del table, deltas
    torch.cuda.empty_cache()
    return {"gather_rows_perpair": {"shape": [n, *shape[1:]], **gather},
            "scatter_add_rows_perpair": {"shape": [n, *shape[1:]], **scatter}}


PERPAIR_OUT_ROWS = BATCH * (1 + NEGATIVES)  # 98,304
PRODUCER_BATCHES_HELD = 8
PRODUCER_TRAIN = ("train", "train_grouped")  # trained on each producer in turns


def _producer_trainer(ids, vocab, use_native: int, grouped: bool, **over):
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    keys = {"dim": str(DIM), "window": str(WINDOW), "negatives": str(NEGATIVES),
            "batch_size": str(BATCH), "subsample": "0", "num_iters": "1",
            "use_native": str(use_native), **{k: str(v) for k, v in over.items()}}
    if grouped:
        keys.update({"fused": "1", "grouped": "1", "centers_per_block": str(CENTERS_PER_BLOCK)})
    return Word2VecTrainer(Config(keys), corpus_ids=ids, vocab=vocab)


def _first_batches(trainer, n: int = PRODUCER_BATCHES_HELD) -> list:
    it = iter(trainer.batches())
    out = [b for _, b in zip(range(n), it)]
    it.close()
    return out


def _same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def phase_native_producer(seed: int, corpora, env: dict) -> dict:
    """``batches()`` alone on the card machine's host, the native producer
    against the numpy one, over the zipf corpus (2,000,000 tokens, window 5,
    batch 16,384, flat and grouped): words/sec of one whole pass. Gate: a
    second native run of the seed gives the same first 8 batches. Then the
    ``PRODUCER_TRAIN`` phases end to end on each producer, in turns."""
    ids, vocab, _ = corpora[False]
    out = {}
    for path, grouped in (("flat", False), ("grouped", True)):
        row = {}
        for producer, use_native in (("native", 1), ("python", 0)):
            trainer = _producer_trainer(ids, vocab, use_native, grouped)
            t0 = time.perf_counter()
            n_batches = sum(1 for _ in trainer.batches())
            seconds = time.perf_counter() - t0
            row[producer] = {"batches": n_batches, "seconds": seconds,
                             "words_per_sec": len(ids) / seconds}
        again = [_first_batches(_producer_trainer(ids, vocab, 1, grouped)) for _ in range(2)]
        if not _same_batches(*again):
            raise AssertionError(f"native_producer {path}: two runs of one seed differ")
        row["native_over_python"] = (row["native"]["words_per_sec"]
                                     / row["python"]["words_per_sec"])
        out[path] = row
    # end to end: the train phase on each producer, in turns (native,
    # python, python, native), words/sec over steps 6-30 as phase_train
    for phase in PRODUCER_TRAIN:
        runs = {"native": [], "python": []}
        for producer in ("native", "python", "python", "native"):
            trainer, loop, records = _train_loop(phase, seed, corpora,
                                                 use_native=int(producer == "native"))
            loop.run(seed=seed, max_steps=STEPS)
            steady = records[5:]
            items = sum(r["items"] for r in steady)
            words = items if trainer.grouped else items / corpora[TRAIN[phase][2]][2]
            runs[producer].append(words / sum(r["seconds"] for r in steady))
            del trainer, loop
            torch.cuda.empty_cache()
        out[f"{phase}_words_per_sec"] = runs
        out[f"{phase}_native_over_python"] = (statistics.mean(runs["native"])
                                              / statistics.mean(runs["python"]))
    emit("native_producer", tokens=len(ids), window=WINDOW, batch=BATCH, subsample=0,
         repeat_batches_equal=PRODUCER_BATCHES_HELD, **out,
         host_cpus=os.cpu_count(), device=env["device"], nvidia_smi=env["nvidia_smi"])
    return out


STREAM_STEPS = 10
STREAM_W2V = {"tokens": 300_000, "ids": 1 << 16}  # cli_resume's corpus
STREAM_CTR_RECORDS = 12 * 8192


def _loop_records(trainer, steps: int, seed: int) -> list:
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    state = TrainLoop(trainer, metrics=Recorder(), log_every=1).run(seed=seed,
                                                                    max_steps=steps)
    if not _finite(state):
        raise AssertionError("non-finite state")
    return records


def phase_stream(seed: int, env: dict) -> None:
    """``stream: 1`` for word2vec (``examples/word2vec.conf`` at capacity
    1,048,576 on a written zipf corpus) and for Wide & Deep
    (``examples/widedeep.conf`` on a written ``synth_ctr`` file), both on
    the native producer: the first 8 batches equal the whole-file run's (one
    chunk), and the streamed run trains 10 steps on the card."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.config import load_config

    tmp = tempfile.mkdtemp(prefix="ssn_stream_")
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        tokens = _write_text_corpus(corpus, STREAM_W2V["tokens"], STREAM_W2V["ids"], False,
                                    seed)
        records_path = os.path.join(tmp, "ctr.txt")
        labels, feats, _ = synth_ctr(STREAM_CTR_RECORDS, 26, CTR_IDS_PER_FIELD, seed=seed)
        with open(records_path, "w") as f:
            f.write("\n".join(f"{int(y)} " + " ".join(map(str, row))
                              for y, row in zip(labels, feats.tolist())) + "\n")
        cases = (
            ("word2vec", W2V_CONF, {"data": corpus, "capacity": CLI_CAPACITY, "min_count": 1,
                                    "num_iters": 1, "param_backup_root": "", "seed": seed}),
            ("widedeep", WIDEDEEP_CONF, {"data": records_path, "seed": seed}))
        for model, conf, over in cases:
            def make(stream: int):
                cfg = load_config(REPO / conf)
                for k, v in {**over, "stream": stream}.items():
                    cfg.set(k, str(v))
                return get_model(model)(cfg)

            t0 = time.perf_counter()
            whole = _first_batches(make(0))
            streamed_trainer = make(1)
            streamed = _first_batches(streamed_trainer)
            compare_s = time.perf_counter() - t0
            if not _same_batches(streamed, whole):
                raise AssertionError(f"stream {model}: the streamed batches differ from "
                                     "the whole file's")
            if streamed_trainer.producer != "native":
                raise AssertionError(f"stream {model}: producer {streamed_trainer.producer}")
            records = _loop_records(streamed_trainer, STREAM_STEPS, seed)
            losses = [r["loss"] for r in records]
            if len(losses) != STREAM_STEPS or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"stream {model}: losses {losses}")
            emit("stream", model=model, config=conf, over={k: str(v) for k, v in over.items()},
                 data_bytes=os.path.getsize(over["data"]),
                 tokens=tokens if model == "word2vec" else None,
                 records=STREAM_CTR_RECORDS if model == "widedeep" else None,
                 batches_equal_whole_file=len(whole), compare_s=compare_s,
                 producer=records[0].get("producer"), steps=len(records), losses=losses,
                 step_ms_median=statistics.median(r["seconds"] * 1e3 for r in records[1:]),
                 device=env["device"], nvidia_smi=env["nvidia_smi"])
            del streamed_trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the JAX package's tests/test_path_quality.py PATHS; the first three gated
QUALITY_PATHS = {
    "dense": {"packed": "0"},
    "packed_perpair": {"packed": "1", "neg_mode": "per_pair"},
    "packed_pool": {"packed": "1", "neg_mode": "pool"},
    "fused": {"packed": "1", "neg_mode": "pool", "fused": "1"},
    "fused_grouped": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1"},
    "fused_resident": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1",
                       "resident": "1"},
    "fused_dedup": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1",
                    "dedup": "1"},
    "fused_dedup_res": {"packed": "1", "neg_mode": "pool", "fused": "1", "grouped": "1",
                        "dedup": "1", "resident": "1"},
}
QUALITY_GATED = ("dense", "packed_perpair", "packed_pool")


def phase_quality(env: dict) -> dict:
    """``probe_top1`` on the card for each path of the JAX package's quality
    test, the fused ones through their real kernels: hard gate at
    ``MIN_TOP1`` on the three gated paths, the fused scores printed."""
    from swiftsnails_tpu_torch.framework.quality import MIN_TOP1, probe_top1

    scores, seconds = {}, {}
    for name, over in QUALITY_PATHS.items():
        t0 = time.perf_counter()
        scores[name] = probe_top1(over)
        seconds[name] = time.perf_counter() - t0
    below = [n for n in QUALITY_GATED if not scores[n] >= MIN_TOP1]
    emit("quality", min_top1=MIN_TOP1, top1=scores, seconds=seconds, gated=list(QUALITY_GATED),
         fused_below=[n for n in scores if n not in QUALITY_GATED and scores[n] < MIN_TOP1],
         device=env["device"], nvidia_smi=env["nvidia_smi"])
    if below:
        raise AssertionError(f"quality: {below} below MIN_TOP1 {MIN_TOP1}: {scores}")
    return scores


SEM_PROBE_DIM = 200  # a row of [2, 128] f32: 1,024 B
SEM_PROBES = ("unit_probe", "chunk_probe", "pipe_probe")


def phase_sem_probe(rate: float) -> dict:
    """The probe tool's ``main`` at ``--dim 200``, held to what each probe
    must observe; returns the kernels line's entries of its three kernels."""
    from swiftsnails_tpu_torch.tools import sem_probe as tool

    res, launches = _run_counted(lambda: tool.main(["--dim", str(SEM_PROBE_DIM)]))
    unit, chunk, pipe = res["unit"], res.get("chunk"), res.get("pipe")
    for tag, f in unit["tags"].items():
        # held: every verdict as the plain version states it (the unit its
        # bytes, exact arming complete, over-arming pending, additivity)
        if not f["held"]:
            raise AssertionError(f"unit probe {tag}: {f}")
    if not unit["linear"] or chunk is None:
        raise AssertionError(f"unit probe: not row-additive: {unit}")
    row_bytes = unit["row_unit"]
    if not (chunk["bit_equal"] and chunk["max_abs_err"] == 0.0
            and chunk["flag"] == 64 * row_bytes == 65_536):
        raise AssertionError(f"chunk probe: {chunk}")
    if pipe is None or not pipe["ok"]:
        raise AssertionError(f"pipe probe: {pipe}")
    for name in SEM_PROBES:
        if not launches[name]:
            raise AssertionError(f"sem_probe: {name} was not launched")
    row = unit["tags"][unit["row_tag"]]
    bound = lambda nbytes: nbytes / rate * 1e3  # noqa: E731
    # The unit and chunk probes move a few KB: their bytes bound is far below
    # one copy's issue-to-complete latency, which limits them (bound_by).
    out = {
        "unit_probe": {
            "launches": launches["unit_probe"], "ms": unit["ms"],
            "plain_ms": unit["plain_ms"], "bound_ms": bound(unit["bytes"]),
            "bound_by": "latency", "library_ms": None,
            "max_abs_err": max(abs(f["unit"] - f["plain_unit"])
                               for f in unit["tags"].values()),
            "shape": [8, 2, 128], "copy_ns": row["exact_ns"],
            "copy_cycles": row["exact_cycles"], "copy_polls": row["exact_polls"]},
        "chunk_probe": {
            "launches": launches["chunk_probe"], "ms": chunk["ms"],
            "plain_ms": chunk["plain_ms"], "bound_ms": bound(chunk["bytes"]),
            "bound_by": "latency", "library_ms": chunk["library_ms"],
            "max_abs_err": chunk["max_abs_err"],
            "shape": chunk["shape"], "ids": chunk["rows"], "flag": chunk["flag"],
            "issue_to_complete_ns": chunk["ns"],
            "issue_to_complete_cycles": chunk["cycles"], "ctas": chunk["ctas"],
            "issuing_lanes": chunk["issuing_lanes"]},
        "pipe_probe": {
            "launches": launches["pipe_probe"], "ms": pipe["chunked"]["ms"],
            "per_copy_ms": pipe["per_copy"]["ms"], "speedup": pipe["speedup"],
            "plain_ms": pipe["plain_ms"], "bound_ms": bound(pipe["bytes"]),
            "bound_by": "bytes", "copy_bound_ms": bound(pipe["copy_bytes"]),
            "library_ms": pipe["index_select_ms"],
            "gather_rows_ms": pipe["gather_rows_ms"], "max_abs_err": pipe["max_abs_err"],
            "shape": pipe["shape"], "ids": pipe["blocks"] * pipe["copies"],
            "stages": pipe["stages"], "cluster": pipe["chunked"]["cluster"],
            "ctas": pipe["chunked"]["ctas"], "issuing_lanes": pipe["issuing_lanes"],
            "consumer_warps": pipe["consumer_warps"],
            "ns_per_copy_per_cta": pipe["chunked"]["ns_per_copy_per_cta"],
            "per_copy_ns_per_copy_per_cta": pipe["per_copy"]["ns_per_copy_per_cta"]},
    }
    emit("sem_probe", launches={k: launches[k] for k in SEM_PROBES}, **out)
    return out


# ------------------------------------------ the CLI, checkpoints, chaos ---

REPO = Path(__file__).resolve().parent
W2V_CONF = "examples/word2vec.conf"  # from the root of the repository
W2V_FAST_CONF = "examples/word2vec_fast.conf"
CLI_CAPACITY = 1 << 20  # bench.py's table size: two [1,048,576, 2, 128] f32 tables, 1 GiB each
# Free space a CLI phase needs under the temporary directory: two roots at a
# time (the control's and the interrupted run's, which run side by side),
# each up to 5 step directories of 2 GiB (3 kept, the protected one, the one
# being written).
CLI_DISK_BYTES = 22 << 30
# phase -> its config, corpus (tokens, zipf id range, paired), backup period,
# overrides beyond the common ones, and launches a substep of each kernel.
# The id ranges keep the vocabularies at ~31k and ~65k words, so that the
# text export of `output` takes seconds; the tables stay at CLI_CAPACITY.
CLI = {
    "cli_resume": {"conf": W2V_CONF, "tokens": 260_000, "ids": 1 << 16, "paired": False,
                   "period": 8, "over": {},
                   "per_substep": {"gather_rows": 2, "scatter_add_rows": 2}},
    # word2vec_fast.conf's lr 0.025 moves no loss in 19 steps: the merged
    # phases' lr and a paired corpus, as train_dedup_res
    "cli_fast": {"conf": W2V_FAST_CONF, "tokens": 5_000_000, "ids": 1 << 15, "paired": True,
                 "period": 3, "over": {"learning_rate": MERGED_LR["train_dedup_res"]},
                 "per_substep": {"fused_sgns_dedup_resident_step": 1}},
}
CHAOS_SPEC = "nan_grad@5-6,row_poison@9,ckpt_corrupt@12,preempt@17"
# the chaos drill's table rows: the corpus's ~31k words, at 128 MiB a save
# instead of the 2 GiB of CLI_CAPACITY (whose saves cli_resume times)
CHAOS_CAPACITY = 1 << 16
GUARD_STEPS = 30
_COMMIT_RE = re.compile(r"checkpoint: committed step_(\d+) \((\d+) bytes: snapshot ([\d.]+) s, "
                        r"d2h wait ([\d.]+) s, crc ([\d.]+) s, write ([\d.]+) s\)")
_RESTORE_RE = re.compile(r"resume: restored step (\d+) from \S+ in ([\d.]+) s")
_DRAIN_RE = re.compile(r"preemption \((.*)\): drained at step (\d+)")


def _write_text_corpus(path: str, tokens: int, ids: int, paired: bool, seed: int) -> int:
    """A whitespace-separated corpus of zipf ids as words ``w<id>``, or with
    ``paired`` zipf-distributed pairs (``w<2p> w<2p+1>``); returns its length."""
    rng = np.random.default_rng(seed)
    if paired:
        p = zipf_ids(tokens // 2, ids, rng)
        x = np.stack([2 * p, 2 * p + 1], 1).reshape(-1)
    else:
        x = zipf_ids(tokens, ids, rng)
    with open(path, "w", encoding="utf-8") as f:
        f.write(" ".join(np.char.add("w", x.astype(str)).tolist()))
    return len(x)


class _ManifestWatch:
    """Every manifest committed under ``root`` while it runs, by step, read
    as it appears: retention prunes older steps before a run ends."""

    def __init__(self, root: str):
        self.root, self.manifests = root, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _scan(self) -> None:
        from swiftsnails_tpu_torch.framework import checkpoint as ckpt

        for s in ckpt.all_steps(self.root):
            if s not in self.manifests:
                m = ckpt.read_manifest(self.root, s)
                if m is not None:
                    self.manifests[s] = m

    def _poll(self) -> None:
        while not self._stop.wait(0.02):
            self._scan()

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join()
        self._scan()
        return self.manifests


def _crcs(manifest: dict) -> dict:
    return {k: (v["crc"], v["algo"]) for k, v in manifest["arrays"].items()}


def _metric_records(text: str) -> list:
    out = []
    for line in text.splitlines():
        if line.startswith("{") and '"items"' in line:
            out.append(json.loads(line))
    return out


def _last_logged_step(path: str):
    """The step of the last metrics line a run has written to ``path``."""
    with open(path) as f:
        records = _metric_records(f.read().rsplit("\n", 1)[0])
    return records[-1]["step"] if records else None


def _rates(records: list, words_per_item: float) -> dict:
    """Items/sec, words/sec and step ms over the records past the first 5."""
    steady = records[5:] or records
    items = sum(r["items"] for r in steady)
    seconds = sum(r["seconds"] for r in steady)
    return {"steps": len(records), "items_per_sec": items / seconds,
            "words_per_sec": items * words_per_item / seconds,
            "step_ms_median": statistics.median(r["seconds"] * 1e3 for r in steady)}


def _save_stats(stderr: str) -> dict:
    saves = [tuple(float(x) for x in m) for m in _COMMIT_RE.findall(stderr)]
    if not saves:
        return {"saves": 0}
    nbytes = saves[0][1]
    med = {name: statistics.median(s[i] for s in saves)
           for i, name in ((2, "snapshot_s"), (3, "d2h_wait_s"), (4, "crc_s"), (5, "write_s"))}
    busy = med["d2h_wait_s"] + med["crc_s"] + med["write_s"]
    return {"saves": len(saves), "bytes": int(nbytes), **med,
            "writer_s": busy, "writer_GBps": nbytes / busy / 1e9,
            "crc_GBps": nbytes / med["crc_s"] / 1e9, "write_GBps": nbytes / med["write_s"] / 1e9}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _cli_args(spec: dict, corpus: str, root: str, out: str, seed: int) -> list:
    over = {"data": corpus, "capacity": CLI_CAPACITY, "num_iters": 1, "min_count": 1,
            "param_backup_period": spec["period"], "param_backup_root": root,
            "output": out, "log_every": 1, "seed": seed, **spec["over"]}
    return ["train", "-config", str(REPO / spec["conf"]),
            *(x for k, v in over.items() for x in (f"-{k}", str(v)))]


def _in_process_cli(args: list) -> tuple:
    """``cli.main(args)`` in this process, its output captured, every launch
    counter set to 0 just before and read just after."""
    from swiftsnails_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc, launches = _run_counted(lambda: cli.main(args))
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"cli {args[0]} exited {rc}: {err.getvalue()[-3000:]}")
    return out.getvalue(), err.getvalue(), launches, seconds


def _subprocess_cli(args: list, workdir: str, tag: str, until=None) -> tuple:
    """``python -m swiftsnails_tpu_torch`` with ``args``; with ``until``, a
    SIGTERM once ``until()`` holds. Returns its exit code, stdout, stderr
    and seconds; never leaves the process behind."""
    paths = [os.path.join(workdir, f"{tag}.{s}") for s in ("out", "err")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p))
    t0 = time.perf_counter()
    with open(paths[0], "w") as fo, open(paths[1], "w") as fe:
        proc = subprocess.Popen([sys.executable, "-m", "swiftsnails_tpu_torch", *args],
                                stdout=fo, stderr=fe, cwd=str(REPO), env=env)
        try:
            if until is not None:
                deadline = time.monotonic() + 600
                while not until():
                    if proc.poll() is not None or time.monotonic() > deadline:
                        raise AssertionError(f"{tag}: exited ({proc.returncode}) or timed out "
                                             "before the SIGTERM was due")
                    time.sleep(0.02)
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out, err = (Path(p).read_text() for p in paths)
    return rc, out, err, time.perf_counter() - t0


def phase_cli(name: str, seed: int, env: dict) -> dict:
    """``python -m swiftsnails_tpu_torch train`` at full width: an
    uninterrupted control in this process and, beside it, a run in a
    subprocess stopped by a real SIGTERM after its second periodic manifest;
    then the same command again, which resumes. The resumed run's periodic
    checkpoints must carry the control's CRCs (bit-equal tables) and its
    ``vectors.txt`` must be the control's, byte for byte."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.utils.config import load_config

    spec = CLI[name]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < CLI_DISK_BYTES:
            raise AssertionError(f"{name}: {free} bytes free under {tmp}, need {CLI_DISK_BYTES}")
        corpus = os.path.join(tmp, "corpus.txt")
        n_tokens = _write_text_corpus(corpus, spec["tokens"], spec["ids"], spec["paired"], seed)
        period = spec["period"]

        # the run a real SIGTERM stops after its second periodic manifest, in
        # a process of its own beside the control (they share only the corpus)
        root, vec = os.path.join(tmp, "run"), os.path.join(tmp, "run.txt")
        args = _cli_args(spec, corpus, root, vec, seed)
        watch = _ManifestWatch(root)
        log = os.path.join(tmp, "first.out")

        def sigterm_due() -> bool:
            # after two periodic manifests, and mid-period: a step logged
            # at k*P - 1 or k*P means the loop is about to wait, or waits,
            # for the writer at a periodic save, and would drain there
            last = _last_logged_step(log)
            return len(watch.manifests) >= 2 and last is not None and 0 < last % period < period - 1

        join_first, _ = _in_thread(lambda: _subprocess_cli(args, tmp, "first", until=sigterm_due))

        # the control, in process: its launches and every manifest it commits
        ctl_root, ctl_out = os.path.join(tmp, "control"), os.path.join(tmp, "control.txt")
        ctl_watch = _ManifestWatch(ctl_root)
        try:
            out, err, launches, ctl_s = _in_process_cli(
                _cli_args(spec, corpus, ctl_root, ctl_out, seed))
        finally:  # the first run ends by itself: at its SIGTERM or at the end of the data
            rc, out1, err1, first_s = join_first(1300)
        control = ctl_watch.stop()
        records = _metric_records(out)
        steps = records[-1]["step"]
        spc = load_config(REPO / spec["conf"]).get_int("steps_per_call", 1)
        _check_launches(name, launches, {k: n * steps * spc for k, n in spec["per_substep"].items()})
        words_per_item = n_tokens / sum(r["items"] for r in records)
        ctl_rates = _rates(records, words_per_item)
        ctl_saves = _save_stats(err)
        ctl_sha = _sha256(ctl_out)
        periodic = sorted(s for s in control if s % period == 0)
        if periodic != list(range(period, steps + 1, period)):
            raise AssertionError(f"{name}: control committed {sorted(control)} in {steps} steps")
        shutil.rmtree(ctl_root)

        if rc != 0 or "preempted (SIGTERM)" not in err1:
            raise AssertionError(f"{name}: SIGTERM run exited {rc}: {err1[-3000:]}")
        drain = _DRAIN_RE.findall(err1)
        if len(drain) != 1:
            raise AssertionError(f"{name}: drain lines {drain}: {err1[-3000:]}")
        final = int(drain[0][1])
        before = sorted(s for s in ckpt.intact_steps(root) if s % period == 0)
        if ckpt.intact_steps(root)[0] != final or final <= before[-1] or final <= 2 * period:
            raise AssertionError(f"{name}: drained at {final}, intact {ckpt.intact_steps(root)}")

        # the same command again, in this process (only the SIGTERM needs a
        # process of its own): it resumes from the drain's save
        out2, err2, resumed_launches, resumed_s = _in_process_cli(args)
        run = watch.stop()
        restored = _RESTORE_RE.findall(err2)
        if not restored or int(restored[0][0]) != final or "preempted" in err2:
            raise AssertionError(f"{name}: resumed run restored {restored}: {err2[-3000:]}")
        after = sorted(s for s in run if s > final and s % period == 0)
        if len(after) < 2 or after[-1] != periodic[-1]:
            raise AssertionError(f"{name}: periodic saves after the resume {after}, "
                                 f"control {periodic}")
        # bit-equal: every kernel of the path is bit-identical run to run
        differ = [s for s in sorted(run) if s in control and (
            _crcs(run[s]) != _crcs(control[s])
            or run[s]["data_cursor"] != control[s]["data_cursor"])]
        vectors_equal = _sha256(vec) == ctl_sha
        out = {"config": spec["conf"],
               "overrides": {k: v for k, v in zip(args[3::2], args[4::2])},
               "corpus": {"tokens": n_tokens, "zipf_ids": spec["ids"], "paired": spec["paired"]},
               "steps": steps, "substeps_per_step": spc, "launches": launches,
               "control": {"s": ctl_s, **ctl_rates, "save": ctl_saves},
               "sigterm_after": sorted(watch.manifests)[:2], "drained_at": final,
               "periodic_before": before, "periodic_after_resume": after,
               "compared_steps": sorted(s for s in run if s in control),
               "differing_steps": differ, "vectors_equal": vectors_equal,
               "first": {"s": first_s, **_rates(_metric_records(out1), words_per_item),
                         "save": _save_stats(err1)},
               "resumed": {"s": resumed_s, **_rates(_metric_records(out2), words_per_item),
                           "save": _save_stats(err2), "restore_s": float(restored[0][1]),
                           "launches": resumed_launches},
               "step_dir_bytes": _dir_bytes(os.path.join(root, f"step_{after[-1]}")),
               "disk_free_bytes": free, "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
        emit(name, **out)
        if differ or not vectors_equal:
            raise AssertionError(f"{name}: the resumed run differs from the control at steps "
                                 f"{differ}; vectors.txt equal: {vectors_equal}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _chaos_loop(args: list, **over):
    """A trainer and loop of ``python -m swiftsnails_tpu_torch train args``,
    built in this process, with ``over`` set after the command line."""
    from swiftsnails_tpu_torch import cli
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.flags import parse_role_argv

    cfg = parse_role_argv(args[1:])
    for k, v in over.items():
        cfg.set(k, str(v))
    trainer = cli._build_trainer(cfg)
    return trainer, TrainLoop(trainer, log_every=0)


def _finite(state) -> bool:
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    return all(bool(torch.isfinite(t).all()) for _, t in tensor_items(state))


def phase_chaos(seed: int, env: dict) -> dict:
    """The training drill at ``examples/word2vec.conf``'s width, in process:
    NaN updates and a poisoned row rolled back, a corrupted checkpoint
    rejected, a preemption drained; then a resumed run that walks back past
    a corrupted final save; then a run that gives up."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.resilience import GuardrailExhausted, corrupt_checkpoint_dir

    spec = CLI["cli_resume"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        _write_text_corpus(corpus, spec["tokens"], spec["ids"], spec["paired"], seed)
        root = os.path.join(tmp, "ck")
        args = _cli_args({**spec, "period": 4}, corpus, root, os.path.join(tmp, "v.txt"), seed)
        args[args.index("-capacity") + 1] = str(CHAOS_CAPACITY)
        trainer, loop = _chaos_loop(args, chaos_spec=CHAOS_SPEC, guard_max_consecutive=3,
                                    chaos_seed=seed)
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            state = loop.run(seed=seed)
        run_s = time.perf_counter() - t0
        err = err.getvalue()
        trips = [int(s) for s in re.findall(r"guardrail: step (\d+) rolled back", err)]
        finite = _finite(state)
        events = loop.chaos.events
        corrupted = [e["step"] for e in events if e["fault"] == "ckpt_corrupt"]
        intact = ckpt.intact_steps(root)
        final = intact[0]
        try:
            ckpt.restore_checkpoint(root, trainer.init_state(), step=12)
            hit_rejected = False
        except ckpt.CheckpointError:
            hit_rejected = True
        ckpt.restore_checkpoint(root, trainer.init_state(), step=final)  # the drain's save verifies
        preempted = loop.preempted
        del state, trainer, loop
        torch.cuda.empty_cache()
        corrupt_checkpoint_dir(root, step=final, rng=np.random.default_rng(seed))

        trainer2, loop2 = _chaos_loop(args, resume="auto")
        err2 = io.StringIO()
        with contextlib.redirect_stderr(err2):
            state2 = loop2.run(seed=seed, max_steps=final + 8)
        err2 = err2.getvalue()
        rejected = [int(s) for s in re.findall(r"resume: rejected step (\d+)", err2)]
        finite2 = _finite(state2)
        want_restored = max(s for s in intact if s not in (12, final))
        restored, preempted2 = loop2._restored_step, loop2.preempted
        del state2, trainer2, loop2
        torch.cuda.empty_cache()

        trainer3, loop3 = _chaos_loop(args, chaos_spec="nan_grad@1-6", guard_max_consecutive=2,
                                      param_backup_root="", chaos_seed=seed)
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                loop3.run(seed=seed, max_steps=8)
            gave_up = None
        except GuardrailExhausted as e:
            gave_up = str(e)
        del trainer3, loop3
        torch.cuda.empty_cache()
        out = {"config": W2V_CONF, "chaos_spec": CHAOS_SPEC, "param_backup_period": 4,
               "guard_max_consecutive": 3, "capacity": CHAOS_CAPACITY, "run_s": run_s,
               "trips": trips, "finite": finite, "preempted": preempted,
               "corrupted_by_chaos": corrupted, "intact_after_run": intact,
               "corrupt_step_rejected": hit_rejected, "drained_at": final,
               "second_run": {"rejected": rejected, "restored": restored,
                              "want_restored": want_restored, "finite": finite2},
               "give_up": gave_up, "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
        emit("chaos", **out)
        problems = []
        if trips != [5, 6, 9]:
            problems.append(f"trips {trips}, want [5, 6, 9]")
        if not (finite and finite2):
            problems.append("a non-finite table")
        if not preempted or final != 18:
            problems.append(f"preempted {preempted}, drained at {final}")
        if corrupted != [12] or not hit_rejected:
            problems.append(f"ckpt_corrupt at {corrupted}, rejected on restore: {hit_rejected}")
        if rejected != [final] or restored != want_restored or preempted2:
            problems.append(f"second run rejected {rejected}, restored {restored}")
        if gave_up is None:
            problems.append("nan_grad@1-6 with guard_max_consecutive 2 did not give up")
        if problems:
            raise AssertionError("chaos: " + "; ".join(problems))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_guardrail_cost(seed: int, env: dict) -> dict:
    """Step ms of packed+pool at the ``cli_resume`` shape with
    ``guardrail: 1`` and without (median of steps 6-30), the tables of the
    two runs bit-equal (trust stays 1.0), and the guardrail's own device time
    a step by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    spec = CLI["cli_resume"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_guard_")
    runs = {}
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        _write_text_corpus(corpus, spec["tokens"], spec["ids"], spec["paired"], seed)
        args = _cli_args({**spec, "period": 0}, corpus, "", os.path.join(tmp, "v.txt"), seed)
        for guard in (0, 1):
            _, loop = _chaos_loop(args, guardrail=guard, resume=0, param_backup_root="")
            records = []

            class Recorder(MetricsLogger):
                def log(self, record):
                    records.append(record)

            loop.metrics, loop.log_every = Recorder(), 1
            state = loop.run(seed=seed, max_steps=GUARD_STEPS)
            runs[guard] = (statistics.median(r["seconds"] * 1e3 for r in records[5:]),
                           state, loop)
        equal = all(torch.equal(a.table, b.table) for a, b in zip(runs[0][1], runs[1][1]))
        g = runs[1][2].guardrail
        state = runs[1][1]
        dev = state.in_table.table.device
        metrics = {"loss": torch.tensor(0.5, device=dev)}
        g.commit(g.snapshot(state), state, metrics)  # warm
        calls = 5
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                g.commit(g.snapshot(state), state, metrics)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        kernels = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                         key=lambda k: -k[1])
        off, on = runs[0][0], runs[1][0]
        state_bytes = sum(t.table.numel() * t.table.element_size() for t in state)
        out = {"path": "packed+pool", "config": W2V_CONF, "capacity": CLI_CAPACITY,
               "steps": GUARD_STEPS, "step_ms_median_off": off, "step_ms_median_on": on,
               "overhead_ms": on - off, "overhead_pct": 100.0 * (on - off) / off,
               "tables_bit_equal": equal, "trips": g.trips_total,
               "guard_device_ms": sum(ms for _, ms in kernels), "guard_wall_ms": wall_ms,
               "state_bytes": state_bytes,
               "top": [{"kernel": k[:90], "ms": ms} for k, ms in kernels[:6]],
               "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
        emit("guardrail_cost", **out)
        if not equal or g.trips_total:
            raise AssertionError("guardrail_cost: the guarded run's tables differ from the "
                                 f"unguarded run's (trips {g.trips_total})")
        return out
    finally:
        del runs
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ telemetry ---

# telemetry phase: path -> its train phase (config, corpus) and the hand
# kernels its profile_dir capture must list
TELEMETRY_PATHS = {
    "packed+pool": ("train", ("gather_rows_kernel", "scatter_add_rows_kernel")),
    "fused-resident": ("train_resident", ("merged_sgns_kernel",)),
}
TELEMETRY_WINDOW = (10, 20)  # profile_steps
TELEMETRY_SPANS = ("prefetch-wait", "h2d", "step", "metrics-flush")
SPEED_LOG_EVERY = 5  # the speed legs read the loss (a sync) every 5 steps
OVERHEAD_STEPS = 60  # profiler_overhead: steps a repetition at full width


def _tel_config(tmp: str) -> dict:
    return {"telemetry": 1, "trace_path": os.path.join(tmp, "trace.json"),
            "ledger_path": os.path.join(tmp, "ledger.jsonl"),
            "profile_dir": os.path.join(tmp, "prof"),
            "profile_steps": "{},{}".format(*TELEMETRY_WINDOW), "profile_cadence": 4,
            "drift_detect": 1, "param_backup_period": 10,
            "param_backup_root": os.path.join(tmp, "ck"),
            "blackbox_dir": os.path.join(tmp, "bb"), "incident_dir": os.path.join(tmp, "inc")}


def _losses(phase: str, seed: int, corpora, **extra) -> tuple:
    """A 30-step run of ``phase`` with ``extra`` keys: its per-step losses and
    its loop."""
    _, loop, records = _train_loop(phase, seed, corpora, **extra)
    loop.run(seed=seed, max_steps=STEPS)
    return [r["loss"] for r in records if "loss" in r], loop


def _words_per_sec(phase: str, seed: int, corpora, telemetry: int, tmp: str) -> float:
    """Items/sec over steps 6-30 with the loss read every ``SPEED_LOG_EVERY``
    steps, ``telemetry`` on (each step span synchronizes) or off."""
    _, loop, records = _train_loop(phase, seed, corpora, telemetry=telemetry,
                                   blackbox_dir=os.path.join(tmp, "bb"))
    loop.log_every = SPEED_LOG_EVERY
    loop.run(seed=seed, max_steps=STEPS)
    windows = [r for r in records if "items_per_sec" in r][1:]
    return sum(r["items"] for r in windows) / sum(r["seconds"] for r in windows)


def _capture(path: str, name: str) -> dict:
    """Device time by kernel in a ``profile_dir`` capture, and the steps its
    ``record_function`` ranges (``<name>#<step>``) hold."""
    events = json.load(open(path))["traceEvents"]
    steps = sorted({int(e["name"].split("#")[1]) for e in events
                    if str(e.get("name", "")).startswith(name + "#")})
    kernels: dict = {}
    memcpy_us = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + float(e.get("dur", 0.0))
        elif e.get("cat") in ("gpu_memcpy", "gpu_memset"):
            memcpy_us += float(e.get("dur", 0.0))
    return {"steps": steps, "kernels_us": kernels, "memcpy_us": memcpy_us,
            "device_ms_per_step": sum(kernels.values()) / 1e3 / max(len(steps), 1)}


def _cli_ok(args: list) -> tuple:
    """``cli.main(args)`` in this process, its output captured."""
    from swiftsnails_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(args)
    if rc != 0:
        raise AssertionError(f"{' '.join(args[:1])} exited {rc}: {out.getvalue()[-2000:]}")
    return rc, out.getvalue()


def phase_telemetry(seed: int, corpora, env: dict, off_losses: dict) -> dict:
    """The loop's telemetry at full width on packed+pool and fused-resident:
    30 steps with ``telemetry: 1``, ``trace_path``, ``ledger_path``,
    ``profile_dir`` (``profile_steps: 10,20``), ``profile_cadence: 4``,
    ``drift_detect: 1``, ``param_backup_period: 10`` and the loss read every
    step, against the same run with telemetry off (``off_losses``: the
    losses of the train phase's run of the path, the same config and seed);
    then ``resume: auto`` on the ledger, the reports, the drift drill and the
    continuous profiler's cost."""
    from swiftsnails_tpu_torch.telemetry.drift_lane import (
        OVERHEAD_CEIL_PCT, drift_drill, profiler_overhead)
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    t_phase = time.monotonic()
    out: dict = {}
    name = torch.cuda.get_device_name(0)
    for path, (phase, hand_kernels) in TELEMETRY_PATHS.items():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_tel_")
        try:
            t0 = time.monotonic()
            off = off_losses[phase]
            on, loop = _losses(phase, seed, corpora, **_tel_config(tmp))
            spread = None
            if on != off:
                # a path whose sums are not bit-reproducible run to run: two
                # telemetry-off runs set the tolerance
                off2, _ = _losses(phase, seed, corpora)
                spread = max(abs(a - b) for a, b in zip(off, off2))
            led = Ledger(os.path.join(tmp, "ledger.jsonl"))
            kinds = [r["kind"] for r in led.records()]
            run = led.latest("run")
            gp = run["goodput"]
            doc = json.load(open(os.path.join(tmp, "trace.json")))
            spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
            per_step = {s: sum(1 for e in spans if e["name"] == s) for s in TELEMETRY_SPANS}
            cap = _capture(loop.profiler.trace_path, loop.trainer.name)
            window = [e["dur"] / 1e3 for e in spans if e["name"] == "step"
                      and e.get("args", {}).get("step") in cap["steps"]]
            window_step_ms = statistics.median(window) if window else None
            known = [r["step"] for r in led.records("checkpoint")]
            reports = {label: len(_cli_ok(args)[1].splitlines()) for label, args in (
                ("ledger-report", ["ledger-report", led.path]),
                ("ledger-report --failures", ["ledger-report", led.path, "--failures"]),
                ("trace-summary", ["trace-summary", os.path.join(tmp, "trace.json")]))}
            # resume: auto on the same ledger, one step past the run (the
            # paired corpus holds 30 steps of fused-resident: none is left)
            _, rloop, _ = _train_loop(phase, seed, corpora, resume="auto",
                                      **_tel_config(tmp))
            rloop.run(seed=seed, max_steps=STEPS + 1)
            speed = {}
            for tel in (0, 1, 1, 0):  # in turns
                speed.setdefault(tel, []).append(_words_per_sec(phase, seed, corpora, tel, tmp))
            wps_off, wps_on = (statistics.mean(speed[0]), statistics.mean(speed[1]))
            res = {
                "path": path, "steps": STEPS, "losses_bit_equal": on == off,
                "loss_spread_off_off": spread,
                "loss_max_abs_diff": max(abs(a - b) for a, b in zip(on, off)),
                "ledger_kinds": kinds, "checkpoint_steps": known,
                "resumed_from": rloop._restored_step,
                "spans_per_step": {s: n / STEPS for s, n in per_step.items()},
                "capture": {"steps": cap["steps"],
                            "device_ms_per_step": cap["device_ms_per_step"],
                            "memcpy_ms": cap["memcpy_us"] / 1e3,
                            "hand_kernels_us": {k: sum(us for n, us in cap["kernels_us"].items()
                                                       if k in n) for k in hand_kernels},
                            "top": sorted(((n[:80], us) for n, us in cap["kernels_us"].items()),
                                          key=lambda x: -x[1])[:6]},
                "window_step_ms_median": window_step_ms,
                "goodput": {k: gp.get(k) for k in (
                    "step_seconds", "mfu", "vs_roofline", "flops_per_step",
                    "hbm_bytes_per_step", "roofline_step_seconds", "items_per_sec", "goodput")},
                "decomposition": {k: v for k, v in gp["decomposition"].items()
                                  if k.endswith("_frac") or k in ("wall_s", "steps")},
                "peaks_source": gp["peaks"]["source"], "env_devices": run["env"]["devices"],
                "reports_lines": reports,
                "items_per_sec_telemetry_off": wps_off, "items_per_sec_telemetry_on": wps_on,
                "telemetry_cost_pct": 100.0 * (wps_off - wps_on) / wps_off,
                "speed_turns": speed, "speed_log_every": SPEED_LOG_EVERY,
                "seconds": time.monotonic() - t0,
                "device": env["device"], "nvidia_smi": env["nvidia_smi"]}
            emit("telemetry", **res)
            problems = []
            if not (on == off or (spread is not None and res["loss_max_abs_diff"] <= spread)):
                problems.append(f"telemetry changed the losses by {res['loss_max_abs_diff']} "
                                f"(off-off spread {spread})")
            if any(n != STEPS for n in per_step.values()):
                problems.append(f"spans a step: {per_step}")
            if kinds != ["checkpoint"] * 3 + ["run"]:
                problems.append(f"ledger kinds {kinds}")
            if cap["steps"] != list(range(*TELEMETRY_WINDOW)):
                problems.append(f"capture steps {cap['steps']}")
            if not all(us > 0 for us in res["capture"]["hand_kernels_us"].values()):
                problems.append(f"capture lacks a hand kernel: {res['capture']}")
            if "h100" not in gp["peaks"]["source"] or "H100" not in name:
                problems.append(f"peaks {gp['peaks']['source']} on {name}")
            if gp["flops_per_step"] is None or gp["hbm_bytes_per_step"] is None:
                problems.append("no step_cost counts")
            if not (0 < (gp["mfu"] or 0) <= 1 and 0 < (gp.get("vs_roofline") or 0) <= 1):
                problems.append(f"mfu {gp['mfu']}, vs_roofline {gp.get('vs_roofline')}")
            dev_ms = cap["device_ms_per_step"]
            if not (gp["step_seconds"] * 1e3 >= 0.95 * dev_ms
                    and window_step_ms is not None and window_step_ms >= 0.95 * dev_ms):
                problems.append(f"step {gp['step_seconds'] * 1e3} ms (window median "
                                f"{window_step_ms}) < 0.95 x device {dev_ms} ms")
            devices = run["env"]["devices"]
            if devices.get("kind") != name or not devices.get("power_limit"):
                problems.append(f"env devices {devices}")
            if rloop._restored_step not in known:
                problems.append(f"resumed from {rloop._restored_step}, ledger knows {known}")
            if problems:
                raise AssertionError(f"telemetry {path}: " + "; ".join(problems))
            out[path] = res
            del loop, rloop
        finally:
            torch.cuda.empty_cache()
            shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drift_")
    try:
        drill = drift_drill(os.path.join(tmp, "drill"))
        emit("telemetry_drift_drill", **{k: v for k, v in drill.items() if k != "ledger"},
             device=env["device"], nvidia_smi=env["nvidia_smi"])
        if not (drill["detected"] and drill["drift_events"] == 1 and drill["bundle_complete"]
                and drill["attribution"].get("dominant") == "host_blocked"):
            raise AssertionError(f"drift drill: {drill}")
        over_cfg, _, paired = TRAIN["train"]
        ids, vocab, _ = corpora[paired]

        def make(extra):
            from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
            from swiftsnails_tpu_torch.utils.config import Config

            keys = {"dim": DIM, "window": WINDOW, "negatives": NEGATIVES, "subsample": 0,
                    "num_iters": 1, "pool_size": POOL_SIZE, "pool_block": POOL_BLOCK,
                    "table_dtype": "float32", "seed": seed, **over_cfg, **extra}
            return Word2VecTrainer(Config({k: str(v) for k, v in keys.items()}),
                                   corpus_ids=ids, vocab=vocab)

        over = profiler_overhead(os.path.join(tmp, "overhead"), make=make,
                                 steps=OVERHEAD_STEPS)
        over["rule"] = (f"fails when overhead_pct > max({OVERHEAD_CEIL_PCT}, noise_pct) "
                        "(the JAX lane's gate; printed here, not gated)")
        emit("telemetry_profiler_overhead", path="packed+pool", **over,
             device=env["device"], nvidia_smi=env["nvidia_smi"])
        out["profiler_overhead"] = over
    finally:
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("telemetry_total", seconds=time.monotonic() - t_phase)
    return out


# --------------------------------------------------------------- serving ---

# The serving read path at the bench's width: examples/word2vec.conf at
# CLI_CAPACITY (two [1,048,576, 2, 128] f32 tables, 1 GiB each; served as
# two normalized [1,048,576, 200] tables, 800 MB each) and the Wide & Deep
# table of train_widedeep (examples/widedeep.conf: [262,144, 2, 128], served
# as [1,048,576, 17]).
SERVE_BUCKETS = (8, 64)  # Servant's default serve_batch_buckets
SERVE_TRAIN_STEPS = 4  # steps of examples/word2vec.conf before the save
SERVE_PULL_IDS = 2_000  # zipf ids pulled, in requests of SERVE_REQUEST_IDS
SERVE_REQUEST_IDS = (5, 40, 70)  # in turns: bucket 8, bucket 64, two chunks
SERVE_TOPK_QUERIES = 8
SERVE_K = 10
SERVE_TOPK_TOL = 1e-5  # scores against a float64 numpy scan
SERVE_SCORE_RECORDS = 8_192  # held-out W&D records scored
SERVE_SCORE_RTOL = 1e-5
SERVE_AUC_TOL = 1e-4
SERVE_DELTA_ROWS = 4_096  # one apply_rows
SERVE_TIMED_REQUESTS = {"pull": 200, "topk": 40, "score": 200}  # a bucket
SERVE_OFFERED_QPS = 400.0  # run_open_loop's offered rate over SERVE_LOAD_S
SERVE_LOAD_S = 5.0


def save_widedeep_for_serving(seed: int, trainer, state, root: str) -> dict:
    """The ``train_widedeep`` state as the serve phase's checkpoint, with
    the trainer's eval AUC on the first ``SERVE_SCORE_RECORDS`` held-out
    records (taken before the state changes)."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint

    _, (labels, feats) = _ctr_data(seed)
    labels, feats = labels[:SERVE_SCORE_RECORDS], feats[:SERVE_SCORE_RECORDS]
    auc = trainer.eval_auc(state, labels=labels, feats=feats)
    save_checkpoint(root, state, step=CTR_STEPS)
    return {"root": root, "auc": auc, "labels": labels, "feats": feats}


def _serve_config(device: str):
    from swiftsnails_tpu_torch.utils.config import load_config

    cfg = load_config(REPO / W2V_CONF)
    for k, v in {"capacity": CLI_CAPACITY, "resume": 0, "guardrail": 0,
                 "param_backup_root": "", "device": device}.items():
        cfg.set(k, str(v))
    return cfg


def _corrupt_step(root: str, step: int) -> str:
    """Flip one byte in the middle of the step's largest tensor file."""
    victim = max((p for p in Path(root, f"step_{step}").iterdir()
                  if p.name != "manifest.json"), key=lambda p: p.stat().st_size)
    with open(victim, "r+b") as f:
        f.seek(victim.stat().st_size // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    return victim.name


def _build_serve_checkpoint(seed: int, corpora, root: str, device: str) -> dict:
    """examples/word2vec.conf trained SERVE_TRAIN_STEPS steps and saved as
    step 4; the same tables with in_table doubled (exact) as steps 5 and 6,
    step 5 then corrupted."""
    from swiftsnails_tpu_torch.framework.checkpoint import save_checkpoint
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    cfg = _serve_config(device)
    ids, vocab, _ = corpora[False]
    t0 = time.perf_counter()
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device)
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    state = TrainLoop(trainer, metrics=Recorder(), log_every=1).run(
        seed=seed, max_steps=SERVE_TRAIN_STEPS)
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_checkpoint(root, state, step=SERVE_TRAIN_STEPS)
    state.in_table.table.mul_(2)  # exact: step 6 serves 2x step 4's in_table
    for step in (5, 6):
        save_checkpoint(root, state, step=step)
    save_s = time.perf_counter() - t0
    corrupted = _corrupt_step(root, 5)
    return {"cfg": cfg, "losses": [r["loss"] for r in records], "train_s": train_s,
            "save_s": save_s, "corrupted": f"step_5/{corrupted}",
            "table": list(state.in_table.table.shape)}


def _topk_check(got, q: np.ndarray, ref64: np.ndarray, k: int) -> dict:
    """``got`` ([(id, score)] from ``Servant.topk``) against a float64 scan
    of the normalized CPU table ``ref64``: every score within
    SERVE_TOPK_TOL of the row's float64 score; every row scoring more than
    SERVE_TOPK_TOL above the (k+1)-th present; and the id at each rank equal
    wherever its score is SERVE_TOPK_TOL apart from its neighbours'."""
    qn = q.astype(np.float64)
    qn = qn / max(np.linalg.norm(qn), 1e-9)
    scores = ref64 @ qn
    order = np.argsort(-scores, kind="stable")[: k + 1]
    ids = np.array([i for i, _ in got])
    s = np.array([v for _, v in got])
    err = float(np.abs(s - scores[ids]).max())
    if len(got) != k or err > SERVE_TOPK_TOL:
        raise AssertionError(f"topk: {len(got)} rows, score error {err}")
    kth1 = scores[order[k]]
    must = set(int(i) for i in order[:k] if scores[i] - kth1 > SERVE_TOPK_TOL)
    if not must <= set(ids.tolist()):
        raise AssertionError(f"topk: rows {sorted(must - set(ids.tolist()))} missing")
    ref_s = scores[order]
    for j in range(k):
        apart = all(abs(ref_s[j] - ref_s[n]) > SERVE_TOPK_TOL for n in (j - 1, j + 1)
                    if 0 <= n <= k)
        if apart and ids[j] != order[j]:
            raise AssertionError(f"topk: rank {j} is row {ids[j]}, want {order[j]}")
    return {"max_abs_err": err, "ids_gated": len(must)}


def _drive_score(servant, bucket: int, requests: int, feats: np.ndarray) -> dict:
    """The serve lane's ``_drive`` for ``score`` at a model's own width:
    ``requests`` back-to-back requests of ``bucket`` held-out records."""
    servant.reset_metrics()
    t0 = time.perf_counter()
    for n in range(requests):
        lo = (n * bucket) % (len(feats) - bucket)
        servant.score(feats[lo:lo + bucket])
    dt = time.perf_counter() - t0
    stats = servant.stats()["kernels"]["score"]
    return {"requests": requests, "bucket": bucket, "qps": requests / dt,
            **{k: stats[k] for k in ("p50_ms", "p95_ms", "p99_ms")}}


def _cli_serve(args: list, script: str, env_extra: dict) -> tuple:
    """``python -m swiftsnails_tpu_torch serve`` with ``script`` on stdin;
    returns its exit code, stdout lines and stderr."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p), **env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "swiftsnails_tpu_torch", "serve", *args],
                          input=script, capture_output=True, text=True, cwd=str(REPO),
                          env=env, timeout=600)
    return proc.returncode, proc.stdout.splitlines(), proc.stderr, time.perf_counter() - t0


def phase_serve(seed: int, corpora, env: dict, widedeep: dict, device: str = "cuda") -> dict:
    """The serving read path through its entry points at full width (see
    the module docstring, phase 16). Returns the launches of the serve path
    and the served word2vec table's geometry for the kernel timings."""
    from swiftsnails_tpu_torch.framework.checkpoint import CheckpointError, load_tables
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.models.sparse_base import auc_score
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.serving import Fleet, Servant, normalize_table
    from swiftsnails_tpu_torch.serving.engine import bucket_for
    from swiftsnails_tpu_torch.serving.cache import HotRowCache
    from swiftsnails_tpu_torch.utils.config import Config

    t_phase = time.monotonic()
    card = {"device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    tmp = tempfile.mkdtemp(prefix="ssn-serve-")
    try:
        root = os.path.join(tmp, "ckpt")
        built = _build_serve_checkpoint(seed, corpora, root, device)
        cfg = built["cfg"]
        dim = cfg.get_int("dim")
        t0 = time.perf_counter()
        ref_tree, _ = load_tables(root, step=SERVE_TRAIN_STEPS, device="cpu")
        ref = {name: normalize_table(ref_tree[name]["table"], dim, "packed").numpy()
               for name in ("in_table", "out_table")}
        del ref_tree
        ref_load_s = time.perf_counter() - t0
        emit("serve_checkpoint", config=W2V_CONF, capacity=CLI_CAPACITY, dim=dim,
             table=built["table"], steps=SERVE_TRAIN_STEPS, losses=built["losses"],
             train_s=built["train_s"], save_s=built["save_s"], corrupted=built["corrupted"],
             cpu_load_normalize_s=ref_load_s, **card)

        t0 = time.perf_counter()
        sv = Servant.from_checkpoint(root, cfg, step=SERVE_TRAIN_STEPS, device=device)
        load_s = time.perf_counter() - t0
        counters = _counters()
        for f in counters.values():
            f.launches = 0
        rng = np.random.default_rng(seed + 12)
        try:
            # 1. pulls: zipf ids in requests of 5, 40 and 70 (buckets 8, 64,
            # and 64 + 8), bit-equal to the CPU copy; launches, rows and pads
            # as the bucket arithmetic over the cache's misses gives them
            ids_all = zipf_ids(SERVE_PULL_IDS, CLI_CAPACITY, rng)
            shadow = HotRowCache(sv.cache.capacity)
            want = {"chunks": 0, "rows": 0, "pad_rows": 0, "requests": 0}
            lo = 0
            while lo < len(ids_all):
                n = SERVE_REQUEST_IDS[want["requests"] % len(SERVE_REQUEST_IDS)]
                ids = ids_all[lo:lo + n]
                lo += n
                got = sv.pull(ids)
                if not np.array_equal(got, ref["in_table"][ids]):
                    raise AssertionError("serve pull differs from the CPU copy")
                _, missing = shadow.get_many("in_table", 0, ids)
                if missing:
                    shadow.put_many("in_table", 0, np.asarray(missing),
                                    np.zeros((len(missing), 1), np.float32))
                for c in range(0, len(missing), SERVE_BUCKETS[-1]):
                    chunk = len(missing[c:c + SERVE_BUCKETS[-1]])
                    want["chunks"] += 1
                    want["rows"] += chunk
                    want["pad_rows"] += bucket_for(chunk, SERVE_BUCKETS) - chunk
                want["requests"] += 1
            st = sv.stats()
            pulled = {"chunks": counters["gather_rows"].launches,
                      "rows": int(sv.registry.counter("serve.pull.rows").value),
                      "pad_rows": st["pad_rows"]["pull"], "requests": st["kernels"]["pull"]["count"]}
            if device == "cpu":
                pulled["chunks"] = want["chunks"]  # the plain version counts nothing
            if pulled != want:
                raise AssertionError(f"serve pull counts {pulled}, want {want}")
            out_ids = ids_all[:64]
            if not np.array_equal(sv.pull(out_ids, table="out_table"), ref["out_table"][out_ids]):
                raise AssertionError("serve pull of out_table differs from the CPU copy")
            emit("serve_pull", ids=SERVE_PULL_IDS, request_ids=list(SERVE_REQUEST_IDS),
                 buckets=list(SERVE_BUCKETS), load_normalize_s=load_s, bit_equal=True,
                 counts=pulled, cache=st["cache"], **card)

            # 2. topk: 8 queries (rows of in_table) against a float64 scan;
            # the zero query ties every row at 0: ids 0..9, JAX's tie order
            ref64 = ref["in_table"].astype(np.float64)
            ref64 /= np.maximum(np.linalg.norm(ref64, axis=1, keepdims=True), 1e-9)
            q_ids = rng.integers(0, CLI_CAPACITY, SERVE_TOPK_QUERIES)
            topk_out, checks = [], []
            for qi in q_ids:
                got = sv.topk(ref["in_table"][qi], k=SERVE_K)
                checks.append(_topk_check(got, ref["in_table"][qi], ref64, SERVE_K))
                topk_out.append(got)
            del ref64
            zero = sv.topk(np.zeros(dim, np.float32), k=SERVE_K)
            if [i for i, _ in zero] != list(range(SERVE_K)) or any(s != 0 for _, s in zero):
                raise AssertionError(f"zero query: {zero}")
            emit("serve_topk", queries=SERVE_TOPK_QUERIES, k=SERVE_K, tol=SERVE_TOPK_TOL,
                 max_abs_err=max(c["max_abs_err"] for c in checks),
                 ids_gated=sum(c["ids_gated"] for c in checks),
                 zero_query_ids=[i for i, _ in zero], **card)

            # 3. score: the W&D checkpoint, 8,192 held-out records, on the
            # card and on the CPU; AUC against the trainer's on the records
            wd_cfg = _widedeep_config(seed)
            t0 = time.perf_counter()
            with Servant.from_checkpoint(widedeep["root"], wd_cfg, device=device) as wsv, \
                    Servant.from_checkpoint(widedeep["root"], wd_cfg, device="cpu") as wcpu:
                wd_load_s = time.perf_counter() - t0
                scores = wsv.score(widedeep["feats"])
                cpu_scores = wcpu.score(widedeep["feats"])
                wd_tables = wsv.stats()["tables"]
                wd_pads = wsv.stats()["pad_rows"]["score"]
            np.testing.assert_allclose(scores, cpu_scores, rtol=SERVE_SCORE_RTOL, atol=1e-7)
            auc = auc_score(widedeep["labels"], scores)
            if not abs(auc - widedeep["auc"]) <= SERVE_AUC_TOL:
                raise AssertionError(f"served AUC {auc}, trainer's {widedeep['auc']}")
            emit("serve_score", config=WIDEDEEP_CONF, records=len(scores), tables=wd_tables,
                 pad_rows=wd_pads, load_normalize_s=wd_load_s,
                 max_rel_err=float(np.max(np.abs(scores - cpu_scores)
                                          / np.maximum(np.abs(cpu_scores), 1e-30))),
                 auc=auc, trainer_auc=widedeep["auc"], **card)

            # 4. apply_rows: 4,096 distinct rows; the next pulls see them, the
            # version bumps, the cache misses on the old rows
            delta_ids = rng.choice(CLI_CAPACITY, SERVE_DELTA_ROWS, replace=False)
            delta = rng.standard_normal((SERVE_DELTA_ROWS, dim)).astype(np.float32)
            cached = delta_ids[:64]
            sv.pull(cached)  # in the cache at the old version
            misses0, writes0, v0 = sv.cache.misses, counters["scatter_write_rows"].launches, sv.version
            v1 = sv.apply_rows({"in_table": (delta_ids, delta)})
            writes = counters["scatter_write_rows"].launches - writes0
            if v1 != v0 + 1 or (device != "cpu" and writes != 1):
                raise AssertionError(f"apply_rows: version {v0} -> {v1}, {writes} writes")
            if not np.array_equal(sv.pull(cached), delta[:64]):
                raise AssertionError("apply_rows: cached rows not replaced")
            if sv.cache.misses - misses0 != len(cached):
                raise AssertionError("apply_rows: the old rows' cache entries still hit")
            for c in range(0, SERVE_DELTA_ROWS, 512):
                if not np.array_equal(sv.pull(delta_ids[c:c + 512]), delta[c:c + 512]):
                    raise AssertionError("apply_rows: a pull missed the delta")
            emit("serve_apply_rows", rows=SERVE_DELTA_ROWS, version=[v0, v1],
                 scatter_write_rows=writes, bit_equal=True, **card)

            # 5. reload_from_checkpoint: corrupt step 5 rejected, the live
            # bytes kept; then the newest clean step (6: 2x step 4's in_table)
            probe = np.concatenate([delta_ids[:32], ids_all[:32]])
            live = sv.pull(probe)
            try:
                sv.reload_from_checkpoint(root, cfg, step=5)
                raise AssertionError("a corrupt step was swapped in")
            except CheckpointError as e:
                rejected = str(e)[:200]
            if sv.version != v1 or not np.array_equal(sv.pull(probe), live):
                raise AssertionError("the rejected reload changed the live tables")
            t0 = time.perf_counter()
            v2 = sv.reload_from_checkpoint(root, cfg)
            reload_s = time.perf_counter() - t0
            if v2 != v1 + 1 or sv.step != 6:
                raise AssertionError(f"reload: version {v2}, step {sv.step}")
            if not np.array_equal(sv.pull(probe), 2 * ref["in_table"][probe]):
                raise AssertionError("reload: step 6's rows not served")
            emit("serve_reload", rejected=rejected, version=[v1, v2], step=sv.step,
                 reload_s=reload_s, **card)

            # 6. a fleet of two replicas answers as the servant, and after
            # drain as well
            t0 = time.perf_counter()
            with Fleet.from_checkpoint(root, cfg, device=device, replicas=2) as fleet:
                fleet_load_s = time.perf_counter() - t0
                shared = len({r.servant._tables["in_table"].data_ptr()
                              for r in fleet.replicas()}) == 1
                reqs = [ids_all[i:i + 8] for i in range(0, 400, 8)]

                def same(tag):
                    for ids in reqs:
                        if not np.array_equal(fleet.pull(ids), sv.pull(ids)):
                            raise AssertionError(f"fleet pull differs ({tag})")
                    for qi in q_ids:
                        q = 2 * ref["in_table"][qi]
                        a, b = fleet.topk(q, k=SERVE_K), sv.topk(q, k=SERVE_K)
                        if [i for i, _ in a] != [i for i, _ in b] or \
                                max(abs(x - y) for (_, x), (_, y) in zip(a, b)) > 1e-6:
                            raise AssertionError(f"fleet topk differs ({tag}): {a} {b}")

                same("two replicas")
                served = {r.id: r.requests for r in fleet.replicas()}
                drained = fleet.drain("r0")
                same("after drain")
                fleet_health = fleet.health()["status"]
            if not shared or not all(served.values()):
                raise AssertionError(f"fleet: shared planes {shared}, served {served}")
            emit("serve_fleet", replicas=2, served=served, drained=drained,
                 health=fleet_health, load_normalize_s=fleet_load_s, **card)
            if device != "cpu":
                torch.cuda.synchronize()
            launches = {name: f.launches for name, f in counters.items()}
            for name, n in launches.items():
                ok = (n > 0 if name == "gather_rows" else n == 1 if name == "scatter_write_rows"
                      else n == 0)
                if device != "cpu" and not ok:
                    raise AssertionError(f"serve path: {name} launched {n} times")

            # 7. the CLI over step 4 (its own root), a scripted stdin
            cli_root = os.path.join(tmp, "cli")
            os.makedirs(cli_root)
            os.symlink(os.path.join(root, f"step_{SERVE_TRAIN_STEPS}"),
                       os.path.join(cli_root, f"step_{SERVE_TRAIN_STEPS}"))
            cli_ids = ids_all[:6]
            script = (f"pull {' '.join(str(i) for i in cli_ids)}\ntopk {int(q_ids[0])} 5\n"
                      "stats\nhealth\nquit\n")
            args = ["-config", str(REPO / W2V_CONF), "-capacity", str(CLI_CAPACITY),
                    "-checkpoint", cli_root]
            if device == "cpu":
                args += ["-device", "cpu"]
            rc, lines, err, cli_s = _cli_serve(args, script, {})
            if rc != 0:
                raise AssertionError(f"serve CLI exited {rc}: {err[-2000:]}")
            out = [json.loads(line) for line in lines]
            rows = np.asarray(out[0]["rows"], np.float32)
            if not np.allclose(rows, ref["in_table"][cli_ids], rtol=0, atol=5e-7):
                raise AssertionError("serve CLI rows differ from the pulls")
            if not (len(out[1]["topk"]) == 5 and "kernels" in out[2]
                    and out[3]["status"] == "ok" and "final_stats" in out[4] and len(out) == 5):
                raise AssertionError(f"serve CLI lines: {lines}")
            emit("serve_cli", rc=rc, lines=len(out), seconds=cli_s,
                 banner=err.strip().splitlines()[-1][:200], **card)

            # 8. timing: qps and p50/p95/p99 a kernel and bucket (the serve
            # lane's _drive), the serve lane at its own size, and an
            # open-loop pull load at a fixed offered rate
            from swiftsnails_tpu_torch.serving.bench_lane import _drive, serve_bench
            from swiftsnails_tpu_torch.serving.loadgen import run_open_loop

            timing = {"pull": {}, "topk": {}, "score": {}}
            for b in SERVE_BUCKETS:
                timing["pull"][f"b{b}"] = _drive(sv, "pull", b, SERVE_TIMED_REQUESTS["pull"],
                                                 rng, CLI_CAPACITY)
                timing["topk"][f"b{b}"] = _drive(sv, "topk", b, SERVE_TIMED_REQUESTS["topk"],
                                                 rng, CLI_CAPACITY)
            with Servant.from_checkpoint(widedeep["root"], wd_cfg, device=device) as wsv:
                for b in SERVE_BUCKETS:
                    timing["score"][f"b{b}"] = _drive_score(
                        wsv, b, SERVE_TIMED_REQUESTS["score"], widedeep["feats"])
            emit("serve_timing", legs=timing, **card)
            sv.reset_metrics()
            load = run_open_loop(lambda anchor, ids: sv.pull(ids), qps=SERVE_OFFERED_QPS,
                                 duration_s=SERVE_LOAD_S, seed=seed, id_space=CLI_CAPACITY,
                                 batch=SERVE_BUCKETS[0])
            emit("serve_open_loop", **load, servant=sv.stats()["kernels"]["pull"], **card)
            lane = serve_bench(small=False, workdir=os.path.join(tmp, "lane"), device=device)
            if lane["shed_count"] or not lane["qps"] > 0:
                raise AssertionError(f"serve lane: {lane}")
            emit("serve_bench", serving=lane, **card)
            table = sv._tables["in_table"]
            # the checkpoint stays for the tiered phase, which removes `tmp`
            return {"launches": launches, "table": table, "ids": ids_all,
                    "seconds": time.monotonic() - t_phase, "tmp": tmp, "root": root,
                    "cfg": cfg}
        finally:
            sv.close()
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def phase_serve_kernels(served: dict, seed: int, rate: float) -> dict:
    """``gather_rows`` at the serving pull (8 and 64 zipf ids from the served
    ``[1,048,576, 200]`` table) and ``scatter_write_rows`` at one
    ``apply_rows`` (4,096 distinct rows into a copy of it): bit-equal to the
    plain version, timed beside it and ``index_select`` / ``index_copy_``,
    against the byte bound. Not counted: the serve path's launches were read
    before."""
    from swiftsnails_tpu_torch.ops import rowdma

    dev = torch.device("cuda")
    table = served["table"]
    rng = np.random.default_rng(seed + 13)
    summary = {}
    for n in SERVE_BUCKETS:
        sets = [torch.from_numpy(zipf_ids(n, CLI_CAPACITY, rng)).to(dev)
                for _ in range(ROW_SETS)]
        case = _gather_case(table, sets, rate)
        emit("kernel", name="gather_rows", dtype="torch.float32", path="serve", rows=n, **case)
        summary[f"gather_rows_serve_b{n}"] = {"shape": [n, table.shape[1]], **case}
    row_bytes = table.shape[1] * table.element_size()
    sets = []
    for _ in range(ROW_SETS):
        uniq = torch.from_numpy(rng.choice(CLI_CAPACITY, SERVE_DELTA_ROWS, replace=False)
                                .astype(np.int32)).to(dev)
        vals = torch.randn((SERVE_DELTA_ROWS, table.shape[1]), device=dev)
        sets.append((uniq, vals, uniq.long(), SERVE_DELTA_ROWS))
    buffers = [table.clone()]
    case = _push_case(
        lambda b, u, v: (rowdma.scatter_write_rows(b[0], u, v),),
        lambda b, u, v: (rowdma.scatter_write_rows_plain(b[0], u, v),),
        buffers, sets, lambda b, st: b[0].index_copy_(0, st[2], st[1]),
        SERVE_DELTA_ROWS * (2 * row_bytes + 4), SERVE_DELTA_ROWS, rate)
    emit("kernel", name="scatter_write_rows", dtype="torch.float32", path="serve", **case)
    summary["scatter_write_rows_serve"] = {"shape": list(table.shape), **case}
    del buffers, sets
    torch.cuda.empty_cache()
    return summary


# ------------------------------------------------------------ tiered store ---

# table_tier: host at the bench's width (phase 17): the packed+pool `train`
# config over two [1,048,576, 2, 128] f32 tables (1 GiB each) under the key's
# default budget, 64 MB: 32,768 slots a table, 1/32 of it.
TIER = {"table_tier": "host", "tier_hbm_budget_mb": 64, "tier_async_flush": 1,
        "tier_prefetch_depth": 2}
TIER_TRANSPARENT_MB = 2048  # covers both tables: the pass-through mode
TIER_WD_BUDGET_MB = 192  # 3/4 of Wide & Deep's 256 MiB small-row table
TIER_WD_STEP_MB = 32  # raised by this while a step's tiles exceed the budget
TIER_HEAL_STEPS = 12
TIER_HEAL = {"param_backup_period": 5, "tier_verify_period": 5,
             "chaos_spec": "tier_bitflip@7"}
QUANTIZED_REL_ERR_MAX = 0.05  # the JAX lane's int8-master bound
TIER_TOPK_ATOL = 1e-6
TIER_MEM_FLOOR = int(1.9 * (1 << 30))  # bytes the tier must free on the card


def _host_available() -> int:
    """The host's available RAM in bytes (``MemAvailable``), or -1."""
    try:
        with open("/proc/meminfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return -1


def _tier_probe(loop, trainer) -> dict:
    """Instrument a run from outside the package: device memory when the
    loop asks for its batches (after ``init_state``, and on the tier after
    ``adopt``, whose full-size planes are then unreferenced), ``adopt``'s
    seconds, and each table's install and snapshot sizes (one
    ``scatter_write_rows`` / ``gather_rows`` a plane each)."""
    probe = {"mem": [], "adopt_s": None, "installs": [], "evict_snapshots": [],
             "flush_snapshots": []}
    batches = trainer.batches

    def counted_batches():
        torch.cuda.synchronize()
        probe["mem"].append(torch.cuda.memory_allocated())
        return batches()

    trainer.batches = counted_batches
    tier = loop.tier
    if tier is None:
        return probe
    adopt = tier.adopt

    def timed_adopt(state):
        t0 = time.perf_counter()
        out = adopt(state)
        probe["adopt_s"] = time.perf_counter() - t0
        for tt in tier.tables.values():
            write, flush = tt._write_state, tt._flush_slots

            def write_state(cache, slots, *a, _w=write):
                probe["installs"].append(int(np.size(slots)))
                return _w(cache, slots, *a)

            def flush_slots(cache, slots, sync=False, _f=flush):
                probe["flush_snapshots" if sync else "evict_snapshots"].append(int(slots.size))
                return _f(cache, slots, sync=sync)

            tt._write_state, tt._flush_slots = write_state, flush_slots
        return out

    tier.adopt = timed_adopt
    return probe


def _tier_w2v(seed: int, corpora, steps: int = STEPS, mesh=None, **extra) -> dict:
    """The ``train`` phase's packed+pool config (``extra`` on top; under
    ``mesh`` where given) for ``steps`` steps, counted and probed."""
    trainer, loop, records = _train_loop("train", seed, corpora, mesh=mesh, **extra)
    probe = _tier_probe(loop, trainer)
    t0 = time.perf_counter()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=steps))
    seconds = time.perf_counter() - t0
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tiered: losses {losses}")
    steady = records[5:]
    step_ms = [r["seconds"] * 1e3 for r in steady]
    words = sum(r["items"] for r in steady) / corpora[False][2]
    return {"trainer": trainer, "loop": loop, "state": state, "launches": launches,
            "probe": probe, "losses": losses, "seconds": seconds,
            "words_per_sec": words / sum(r["seconds"] for r in steady),
            "step_ms_median": statistics.median(step_ms)}


def _tier_timing(run: dict, steps: int) -> dict:
    """The tier's step-time breakdown a step, hit rate, bytes and rates."""
    s = run["loop"].tier.summary()
    bd = s["breakdown"]
    per_step = {k: bd[k] / steps for k in ("plan_ns", "fault_ns", "flush_ns", "remap_ns",
                                           "h2d_ns", "flush_wait_ns")}
    return {"words_per_sec": run.get("words_per_sec"), "step_ms_median": run["step_ms_median"],
            "breakdown_per_step_ns": per_step, "hit_rate": s["hit_rate"],
            "faults": s["faults"], "faulted_rows": s["faulted_rows"],
            "evictions": s["evictions"], "flushed_rows": s["flushed_rows"],
            "h2d_bytes": bd["h2d_bytes"], "d2h_bytes": bd["d2h_bytes"],
            # bytes over the host time that moved them: the staging copies'
            # dispatch (h2d_ns), the flush landings (flush_ns: D2H + scatter)
            "h2d_GBps_over_h2d_ns": bd["h2d_bytes"] / bd["h2d_ns"] if bd["h2d_ns"] else None,
            "d2h_GBps_over_flush_ns": bd["d2h_bytes"] / bd["flush_ns"] if bd["flush_ns"] else None,
            "adopt_s": run["probe"]["adopt_s"], "run_s": run["seconds"],
            "prefetch_depth": s["prefetch_depth"], "transparent": s["transparent"]}


def _same_run(what: str, run: dict, control: dict) -> None:
    """Every step's loss and both final tables bit-equal to the control."""
    if run["losses"] != control["losses"]:
        diff = [i for i, (a, b) in enumerate(zip(run["losses"], control["losses"])) if a != b]
        raise AssertionError(f"{what}: losses differ from the resident run at steps {diff}")
    for name in ("in_table", "out_table"):
        got = getattr(run["state"], name).table
        if got.device.type != "cpu" or not torch.equal(got, control[name]):
            raise AssertionError(f"{what}: {name} differs from the resident run's")


def _wd_tiles(seed: int, trainer) -> list:
    """Distinct small-row tiles each of the first CTR_STEPS batches touches."""
    from swiftsnails_tpu_torch.ops.hashing import hash_row_np
    from swiftsnails_tpu_torch.parallel.store import small_group

    g = small_group(trainer.table_dim)
    out = []
    for _, b in zip(range(CTR_STEPS), trainer.batches()):
        rows = hash_row_np(np.maximum(b["feats"], 0), trainer.capacity)
        out.append(int(np.unique(rows // g).size))
    return out


def _wd_run(seed: int, budget_mb=None) -> dict:
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    cfg = _widedeep_config(seed)
    if budget_mb is not None:
        cfg.set("table_tier", "host")
        cfg.set("tier_hbm_budget_mb", str(budget_mb))
    (labels, feats), (eval_labels, eval_feats) = _ctr_data(seed)
    trainer = get_model(cfg.get_str("model"))(cfg, data=(labels, feats))
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    loop = TrainLoop(trainer, metrics=Recorder(), log_every=1)
    probe = _tier_probe(loop, trainer)
    t0 = time.perf_counter()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=CTR_STEPS))
    seconds = time.perf_counter() - t0
    steady = records[5:]
    return {"trainer": trainer, "loop": loop, "state": state, "launches": launches,
            "probe": probe, "losses": [r["loss"] for r in records], "seconds": seconds,
            "examples_per_sec": sum(r["items"] for r in steady)
            / sum(r["seconds"] for r in steady),
            "step_ms_median": statistics.median(r["seconds"] * 1e3 for r in steady),
            "auc": trainer.eval_auc(state, labels=eval_labels, feats=eval_feats)}


def _tier_launches(what: str, run: dict, pulls: int, pushes: dict) -> None:
    """On a tiered run: one ``scatter_write_rows`` a fault (the prewarm's
    included), ``gather_rows`` for the step's pulls plus one a flush
    snapshot, the push kernels a step, nothing else."""
    s = run["loop"].tier.summary()
    p = run["probe"]
    snaps = len(p["evict_snapshots"]) + len(p["flush_snapshots"])
    want = {"scatter_write_rows": s["faults"], "gather_rows": pulls + snaps, **pushes}
    _check_launches(what, run["launches"], want)


def phase_tiered(seed: int, corpora, env: dict, serve: dict) -> dict:
    """The tiered parameter store at full width (see the module docstring,
    phase 17). Returns the launches and shapes for the kernel timings."""
    import gc

    from swiftsnails_tpu_torch.framework.checkpoint import load_tables
    from swiftsnails_tpu_torch.parallel.store import PackedTableState
    from swiftsnails_tpu_torch.serving import Servant
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger
    from swiftsnails_tpu_torch.tiered import HostMaster
    from swiftsnails_tpu_torch.tiered.bench_lane import tiered_bench
    from swiftsnails_tpu_torch.utils.config import Config

    t_phase = time.monotonic()
    card = {"device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    tmp = tempfile.mkdtemp(prefix="ssn-tiered-")
    table_bytes = VOCAB * 2 * 128 * 4
    # the card's allocated bytes are compared across legs: start them from
    # what the earlier phases left reachable, their garbage collected
    gc.collect()
    torch.cuda.empty_cache()
    try:
        # 1. the resident control
        run = _tier_w2v(seed, corpora)
        control = {"losses": run["losses"], "mem": run["probe"]["mem"][0],
                   "in_table": run["state"].in_table.table.cpu(),
                   "out_table": run["state"].out_table.table.cpu()}
        timing = {"resident": {"words_per_sec": run["words_per_sec"],
                               "step_ms_median": run["step_ms_median"],
                               "run_s": run["seconds"]}}
        del run
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        master = HostMaster(PackedTableState(table=control["in_table"], slots={}), "packed",
                            checksums=False)
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        master._init_digests()
        digest_s = time.perf_counter() - t0  # the digests of one 1 GiB table
        del master

        # 2. over budget: 64 MB of cache over 2 GiB of masters
        run = _tier_w2v(seed, corpora, **TIER)
        _same_run("tiered over budget", run, control)
        s = run["loop"].tier.summary()
        if not (s["evictions"] > 0 and s["flushed_rows"] > 0 and s["faults"] > 0):
            raise AssertionError(f"tiered over budget: {s}")
        cache_bytes = sum(t["budget_slots"] * t["unit_bytes"] for t in s["tables"].values())
        freed = control["mem"] - run["probe"]["mem"][0]
        if freed < 2 * table_bytes - cache_bytes or freed < TIER_MEM_FLOOR:
            raise AssertionError(f"tiered: the card holds {freed} bytes less than the "
                                 f"resident run, want >= {2 * table_bytes - cache_bytes}")
        _tier_launches("tiered over budget", run, 2 * STEPS, {"scatter_add_rows": 2 * STEPS})
        p = run["probe"]
        shapes = {"install_rows_median": statistics.median(p["installs"]),
                  "snapshot_rows_median": statistics.median(p["evict_snapshots"]),
                  "cache": [s["tables"]["in_table"]["budget_slots"],
                            *run["state"].in_table.table.shape[1:]]}
        launches = {k: run["launches"][k] for k in ("scatter_write_rows", "gather_rows",
                                                    "scatter_add_rows")}
        timing["over_budget"] = _tier_timing(run, STEPS)
        emit("tiered_over_budget", steps=STEPS, budget_mb=TIER["tier_hbm_budget_mb"],
             tables={k: v for k, v in s["tables"].items()}, bit_equal=True,
             mem_resident=control["mem"], mem_tiered=run["probe"]["mem"][0], freed=freed,
             freed_floor=2 * table_bytes - cache_bytes, launches=run["launches"],
             installs=len(p["installs"]), evict_snapshots=len(p["evict_snapshots"]),
             flush_snapshots=len(p["flush_snapshots"]), **shapes, **card)
        del run
        gc.collect()
        torch.cuda.empty_cache()

        # 3. transparent: a budget over both tables
        run = _tier_w2v(seed, corpora, **{**TIER, "tier_hbm_budget_mb": TIER_TRANSPARENT_MB})
        _same_run("tiered transparent", run, control)
        s = run["loop"].tier.summary()
        if not s["transparent"] or s["faulted_rows"] or s["evictions"]:
            raise AssertionError(f"tiered transparent: {s}")
        _check_launches("tiered transparent", run["launches"],
                        {"gather_rows": 2 * STEPS, "scatter_add_rows": 2 * STEPS})
        timing["transparent"] = _tier_timing(run, STEPS)
        emit("tiered_transparent", budget_mb=TIER_TRANSPARENT_MB, bit_equal=True,
             transparent_steps=s["transparent_steps"], **card)
        del run
        gc.collect()
        torch.cuda.empty_cache()

        # 5. int8 masters on leg 2's schedule, one checkpoint at the end
        q_root = os.path.join(tmp, "q8")
        run = _tier_w2v(seed, corpora, **TIER, tier_master_dtype="int8",
                        param_backup_root=q_root, param_backup_period=STEPS)
        s = run["loop"].tier.summary()
        rel = {}
        for name in ("in_table", "out_table"):
            got, want = getattr(run["state"], name).table, control[name]
            rel[name] = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
        verify = run["loop"].tier.verify()
        ck, _ = load_tables(q_root, step=STEPS, device="cpu")
        dtypes = {name: str(ck[name]["table"].dtype) for name in ck}
        if (max(rel.values()) > QUANTIZED_REL_ERR_MAX or verify or s["master_dtype"] != "int8"
                or set(dtypes.values()) != {"torch.float32"}):
            raise AssertionError(f"tiered int8: rel {rel} verify {verify} ckpt {dtypes}")
        timing["int8"] = _tier_timing(run, STEPS)
        emit("tiered_int8", max_rel_err=rel, limit=QUANTIZED_REL_ERR_MAX,
             verify_clean=True, checkpoint_dtypes=dtypes,
             host_unit_bytes=s["tables"]["in_table"]["host_unit_bytes"],
             unit_bytes=s["tables"]["in_table"]["unit_bytes"], **card)
        del run, ck
        shutil.rmtree(q_root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # 6. the heal drill: a bit flipped at step 7, swept at step index 9
        h_root = os.path.join(tmp, "heal")
        ledger_path = os.path.join(tmp, "heal.jsonl")
        run = _tier_w2v(seed, corpora, TIER_HEAL_STEPS, **TIER, **TIER_HEAL,
                        chaos_seed=seed, param_backup_root=h_root, ledger_path=ledger_path)
        events = [e for e in Ledger(ledger_path).records("cache_error")
                  if e.get("source") == "tier"]
        verify = run["loop"].tier.verify()
        if (len(events) != 1 or events[0]["step"] != 9
                or events[0]["rebuilt_from_step"] != 5 or verify):
            raise AssertionError(f"tiered heal: events {events}, verify {verify}")
        emit("tiered_heal", steps=TIER_HEAL_STEPS, chaos=TIER_HEAL["chaos_spec"],
             event=events[0], final_loss=run["losses"][-1], verify_clean=True,
             run_s=run["seconds"], **card)
        # the unmeshed drill the mesh phase's sweep is held to
        heal_drill = _sweep_result(run, events, heals=None)
        del run
        shutil.rmtree(h_root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        del control
        gc.collect()

        # 4. Wide & Deep on the small-row plane, 3/4 of its table
        res = _wd_run(seed)
        wd_control = {"table": res["state"].table.table.cpu(),
                      "dense": {k: v.clone() for k, v in res["state"].dense.items()},
                      "opt": {k: v.clone() for k, v in
                              res["state"].opt["sum_of_squares"].items()},
                      "auc": res["auc"], "losses": res["losses"]}
        tiles = _wd_tiles(seed, res["trainer"])
        wd_timing = {"examples_per_sec": res["examples_per_sec"],
                     "step_ms_median": res["step_ms_median"]}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        budget = TIER_WD_BUDGET_MB
        while max(tiles) > budget * (1 << 20) // 1024 and budget + TIER_WD_STEP_MB < 256:
            budget += TIER_WD_STEP_MB
        run = _wd_run(seed, budget)
        s = run["loop"].tier.summary()
        st = run["state"]
        same = (run["losses"] == wd_control["losses"]
                and torch.equal(st.table.table, wd_control["table"])
                and all(torch.equal(st.dense[k], v) for k, v in wd_control["dense"].items())
                and all(torch.equal(st.opt["sum_of_squares"][k], v)
                        for k, v in wd_control["opt"].items())
                and run["auc"] == wd_control["auc"])
        if not same or not s["evictions"] > 0:
            raise AssertionError(f"tiered widedeep: bit-equal {same}, {s}")
        _tier_launches("tiered widedeep", run, CTR_STEPS,
                       {"scatter_adagrad_fused_rows": CTR_STEPS})
        launches["scatter_adagrad_fused_rows"] = run["launches"]["scatter_adagrad_fused_rows"]
        shapes["wd_cache"] = [s["tables"]["table"]["budget_slots"], *st.table.table.shape[1:]]
        shapes["wd_pushed_tiles"] = tiles[0]
        timing["widedeep"] = {"resident": wd_timing,
                              "tiered": {"examples_per_sec": run["examples_per_sec"],
                                         "step_ms_median": run["step_ms_median"],
                                         **{k: v for k, v in _tier_timing(run, CTR_STEPS).items()
                                            if k not in ("words_per_sec", "step_ms_median")}}}
        emit("tiered_widedeep", config=WIDEDEEP_CONF, budget_mb=budget,
             budget_raised=budget != TIER_WD_BUDGET_MB, max_step_tiles=max(tiles),
             budget_tiles=s["tables"]["table"]["budget_slots"],
             master_tiles=s["tables"]["table"]["master_units"], bit_equal=True,
             eval_auc=run["auc"], launches=run["launches"], **card)
        del run, wd_control
        gc.collect()
        torch.cuda.empty_cache()

        # 7. tiered serving of the serve phase's checkpoint
        cfg = serve["cfg"]
        tcfg = Config({**cfg.as_dict(), "table_tier": "host",
                       "tier_hbm_budget_mb": str(TIER["tier_hbm_budget_mb"])})
        rng = np.random.default_rng(seed + 17)
        with Servant.from_checkpoint(serve["root"], cfg, step=SERVE_TRAIN_STEPS) as res_sv, \
                Servant.from_checkpoint(serve["root"], tcfg, step=SERVE_TRAIN_STEPS) as tier_sv:
            if not tier_sv.tier:
                raise AssertionError("tiered serving: no tier")
            ids_all = zipf_ids(SERVE_PULL_IDS, CLI_CAPACITY, rng)
            lo, k = 0, 0
            counters = _counters()
            g0 = counters["gather_rows"].launches
            while lo < len(ids_all):
                n = SERVE_REQUEST_IDS[k % len(SERVE_REQUEST_IDS)]
                ids = ids_all[lo:lo + n]
                lo, k = lo + n, k + 1
                if not np.array_equal(tier_sv.pull(ids), res_sv.pull(ids)):
                    raise AssertionError("tiered serving: a pull differs from the resident one")
            serve_gathers = counters["gather_rows"].launches - g0
            ts = tier_sv.stats()
            if not ts["tiered"]["faults"] > 0:
                raise AssertionError(f"tiered serving: {ts['tiered']}")
            topk = []
            for qi in rng.integers(0, CLI_CAPACITY, SERVE_TOPK_QUERIES):
                q = res_sv.pull([int(qi)])[0]
                a, b = res_sv.topk(q, k=SERVE_K), tier_sv.topk(q, k=SERVE_K)
                err = max(abs(x[1] - y[1]) for x, y in zip(a, b))
                if [x[0] for x in a] != [y[0] for y in b] or err > TIER_TOPK_ATOL:
                    raise AssertionError(f"tiered topk: {a} vs {b}")
                topk.append(err)
            dids = rng.choice(CLI_CAPACITY, SERVE_DELTA_ROWS, replace=False)
            vals = rng.standard_normal((SERVE_DELTA_ROWS, cfg.get_int("dim"))).astype(np.float32)
            tier_sv.apply_rows({"in_table": (dids, vals)})
            for c in range(0, SERVE_DELTA_ROWS, SERVE_BUCKETS[-1]):
                if not np.array_equal(tier_sv.pull(dids[c:c + SERVE_BUCKETS[-1]]),
                                      vals[c:c + SERVE_BUCKETS[-1]]):
                    raise AssertionError("tiered serving: apply_rows not pulled back")
            emit("tiered_serve", ids=SERVE_PULL_IDS, bit_equal=True,
                 tiered=ts["tiered"], gather_rows_launches=serve_gathers,
                 topk_max_abs_err=max(topk), topk_atol=TIER_TOPK_ATOL,
                 apply_rows=SERVE_DELTA_ROWS,
                 pull_ms={"tiered": ts["kernels"]["pull"],
                          "resident": res_sv.stats()["kernels"]["pull"]},
                 **card)
        gc.collect()
        torch.cuda.empty_cache()

        # 8. the lane, as the JAX package defines it
        os.makedirs(os.path.join(tmp, "lane"))
        lane = tiered_bench(small=False, workdir=os.path.join(tmp, "lane"))
        if not (lane["parity_bit_identical"] and lane["round_trip_ok"]
                and lane["quantized_ok"]):
            raise AssertionError(f"tiered lane: {lane}")
        emit("tiered_lane", tiered=lane, **card)

        # 9. the timings
        emit("tiered_timing", legs=timing, digest_build_s=digest_s, master_copy_s=copy_s,
             host_available_bytes=_host_available(), **card)
        return {"launches": launches, "shapes": shapes, "heal_drill": heal_drill,
                "seconds": time.monotonic() - t_phase}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_tiered_kernels(tiered: dict, seed: int, rate: float,
                         path: str = "tiered") -> dict:
    """The kernels of the tiered path at its shapes: ``scatter_write_rows``
    installing the run's median faulted rows a step into the ``[32,768, 2,
    128]`` cache (distinct slots), beside ``index_copy_``;
    ``gather_rows`` snapshotting the median dirty victims an eviction,
    beside ``index_select``; ``scatter_add_rows`` pushing a step's merged
    out-table rows into the cache; ``scatter_adagrad_fused_rows`` pushing a
    Wide & Deep step's tiles into its cache. Bit-equal to the plain
    versions, timed, against the byte bound. Not counted: the tiered runs'
    launches were read before. ``path`` names the lines and the summary's
    keys (``mesh_tier``: the meshed tier's shapes)."""
    from swiftsnails_tpu_torch.ops import rowdma

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 19)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    sh = tiered["shapes"]
    slots = sh["cache"][0]
    cache = torch.randn(sh["cache"], generator=gen, device=dev)
    row_bytes = cache.stride(0) * cache.element_size()
    summary = {}
    n = int(sh["install_rows_median"])
    sets = []
    for _ in range(ROW_SETS):
        uniq = torch.from_numpy(rng.choice(slots, n, replace=False).astype(np.int32)).to(dev)
        sets.append((uniq, torch.randn((n, *sh["cache"][1:]), generator=gen, device=dev),
                     uniq.long(), n))
    case = _push_case(
        lambda b, u, v: (rowdma.scatter_write_rows(b[0], u, v),),
        lambda b, u, v: (rowdma.scatter_write_rows_plain(b[0], u, v),),
        [cache.clone()], sets, lambda b, st: b[0].index_copy_(0, st[2], st[1]),
        n * (2 * row_bytes + 4), n, rate)
    emit("kernel", name="scatter_write_rows", dtype="torch.float32", path=path, **case)
    summary[f"scatter_write_rows_{path}"] = {"shape": list(cache.shape), **case}
    n = int(sh["snapshot_rows_median"])
    gsets = [torch.from_numpy(rng.choice(slots, n, replace=False).astype(np.int32)).to(dev)
             for _ in range(ROW_SETS)]
    case = _gather_case(cache, gsets, rate)
    emit("kernel", name="gather_rows", dtype="torch.float32", path=path, rows=n, **case)
    summary[f"gather_rows_{path}"] = {"shape": [n, *sh["cache"][1:]], **case}
    n = GATHER_ROWS[1]  # a step's out-table push: contexts + pool rows, merged
    ssets, n_valid = [], []
    for _ in range(ROW_SETS):
        uniq = torch.unique(torch.from_numpy(zipf_ids(n, slots, rng)).to(dev))
        n_valid.append(int(uniq.numel()))
        pad = torch.full((n - uniq.numel(),), slots, dtype=torch.int32, device=dev)
        ssets.append(torch.cat([uniq.to(torch.int32), pad]))
    deltas = [torch.randn((n, *sh["cache"][1:]), generator=gen, device=dev).mul_(1e-3)
              for _ in range(ROW_SETS)]
    case = _scatter_case(cache, ssets, deltas, n_valid, rate)
    emit("kernel", name="scatter_add_rows", dtype="torch.float32", path=path, rows=n, **case)
    summary[f"scatter_add_rows_{path}"] = {"shape": [n, *sh["cache"][1:]], **case}
    del cache, deltas, ssets, gsets, sets
    wd = sh["wd_cache"]
    lr = _widedeep_config(seed).get_float("learning_rate")
    fused = torch.cat([torch.randn((wd[0], 1, 128), generator=gen, device=dev).mul_(0.01),
                       torch.rand((wd[0], 1, 128), generator=gen, device=dev).mul_(0.1)], 1)
    n = int(sh["wd_pushed_tiles"])
    sets = []
    for _ in range(CTR_ROW_SETS):
        uniq = torch.from_numpy(rng.choice(wd[0], n, replace=False).astype(np.int32)).to(dev)
        sets.append((uniq, torch.randn((n, 1, 128), generator=gen, device=dev).mul_(0.01),
                     uniq.long(), n))
    half = 128 * 4
    case = _push_case(
        lambda b, u, v: (rowdma.scatter_adagrad_fused_rows(b[0], u, v, lr),),
        lambda b, u, v: (rowdma.scatter_adagrad_fused_rows_plain(b[0], u, v, lr),),
        [fused], sets, None, n * 5 * half + n * 4, n, rate)
    emit("kernel", name="scatter_adagrad_fused_rows", dtype="torch.float32", path=path, **case)
    summary[f"scatter_adagrad_fused_rows_{path}"] = {"shape": list(fused.shape), **case}
    del fused, sets
    torch.cuda.empty_cache()
    return summary


def _tiered_kernel_entries(summary: dict, tiered: dict, path: str = "tiered") -> list:
    """The ``kernels`` line's ``path: "tiered"`` entries: each kernel at the
    tiered path's shapes (``phase_tiered_kernels``) with its launches in the
    tiered runs (over budget; Wide & Deep for the AdaGrad push)."""
    out = []
    for key, name, replaces in (
            ("scatter_write_rows", "scatter_write_rows", "swiftsnails_tpu/ops/rowdma.py:289"),
            ("gather_rows", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("scatter_add_rows", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213"),
            ("scatter_adagrad_fused_rows", "scatter_adagrad_fused_rows",
             "swiftsnails_tpu/ops/rowdma.py:552")):
        s = summary[f"{key}_{path}"]
        out.append({
            "name": name, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": tiered["launches"][key],
            "max_abs_err": s["max_abs_err"], "ms": s.get("ms", s.get("kernel_ms")),
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["library_ms"], "shape": s["shape"], "dtype": "float32",
            "path": path})
    return out


# ------------------------------------------------------------- freshness ---

# the freshness phase (18): resume examples/word2vec.conf at capacity 2^20
# from the serve phase's step-4 checkpoint, publishing every step
FRESH_STEPS = 16  # the file-log leg: steps 4 -> 20
FRESH_FUSED_STEPS = 8  # the fused-resident leg, from its start state
FRESH_INT8_STEPS = 4  # the int8 wire: 20 -> 24
FRESH_TCP_STEPS = 4  # freshness_listen to the replica processes: 24 -> 28
# retention must prune nothing outside the gap drill: 16 batches of ~30 MB
FRESH_LOG_MB = 4096
FRESH_LOAD_QPS = 200.0  # open-loop pulls of 8 zipf ids while deltas apply
FRESH_KILL_LOAD_S = 8.0  # the proc_kill drill's load; the kill lands at 30%
FRESH_KILL_QPS = 100.0
FRESH_LEASE_MS = 3_000.0  # the net plane's default lease
FRESH_PROBE_MS = 1_000.0
FRESH_SAMPLE_ROWS = 65_536  # untouched rows pulled over TCP beside the applied ones
FRESH_PULL_CHUNK = 8_192  # ids a parity pull
FRESH_REPLICA_BUCKETS = "8,64,8192"  # the replicas' serve_batch_buckets
FRESH_SPAWN_S = 300.0  # a replica's ready line: interpreter, CUDA context, 2 GiB load
FRESH_WAIT_S = 300.0


class _Applied:
    """A subscriber target forwarding to a fleet: the rows each table got
    from deltas, and each batch's apply time (the cutover included; on the
    card synchronized, so the time is the device's too)."""

    def __init__(self, inner, cuda: bool):
        self._inner = inner
        self._cuda = cuda
        self.rows = {}
        self.apply_ms = []

    @property
    def step(self) -> int:
        return self._inner.step

    @property
    def version(self) -> int:
        return self._inner.version

    def apply_rows(self, updates, **kw):
        t0 = time.perf_counter()
        out = self._inner.apply_rows(updates, **kw)
        if self._cuda:
            torch.cuda.synchronize()
        self.apply_ms.append((time.perf_counter() - t0) * 1e3)
        for name, (ids, _vals) in updates.items():
            self.rows.setdefault(name, set()).update(np.asarray(ids).tolist())
        return out

    def reload_from_checkpoint(self, root, config, **kw):
        return self._inner.reload_from_checkpoint(root, config, **kw)


def _fresh_config(device: str, root: str, **extra):
    cfg = _serve_config(device)
    for k, v in {"param_backup_root": root, "resume": "auto", "param_backup_keep": 0,
                 "freshness_log_mb": FRESH_LOG_MB, **extra}.items():
        cfg.set(k, str(v))
    return cfg


def _fresh_run(seed: int, corpora, device: str, root: str, start: int, steps: int, **extra):
    """Resume the serve config from ``root``'s newest step ``start`` for
    ``steps`` steps, publishing every step and saving at the last; returns
    the trainer, its loop and the recorded losses (run it with ``.run``)."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    cfg = _fresh_config(device, root, param_backup_period=start + steps,
                        freshness_publish=1, **extra)
    ids, vocab, _ = corpora[False]
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab, device=device)
    records = []

    class Recorder(MetricsLogger):
        def log(self, record):
            records.append(record)

    return trainer, TrainLoop(trainer, metrics=Recorder(), log_every=1), records


def _in_thread(fn):
    """Run ``fn`` on a thread; returns ``(join, thread)``, where
    ``join(timeout)`` re-raises the thread's exception."""
    out, err = [], []

    def body():
        try:
            out.append(fn())
        except BaseException as e:  # re-raised by join
            err.append(e)

    th = threading.Thread(target=body, daemon=True)
    th.start()

    def join(timeout: float):
        th.join(timeout)
        if th.is_alive():
            raise AssertionError(f"a run outlived its {timeout} s")
        if err:
            raise err[0]
        return out[0]

    return join, th


def _wait_for(cond, timeout_s: float, what: str) -> float:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"freshness: {what} within {timeout_s} s")
        time.sleep(0.02)
    return time.monotonic() - t0


def _plane_mismatch(want: dict, got: dict) -> float:
    """Mismatched-element fraction over whole planes (on their device)."""
    bad = total = 0
    for name, w in want.items():
        bad += int((got[name] != w).sum())
        total += w.numel()
    return bad / total


def _pull_mismatch(servant, ref: dict, ids: dict) -> float:
    """Mismatched-element fraction of ``servant.pull`` (a replica over TCP,
    or in process) against the reference planes on the ids of each table."""
    bad = total = 0
    for name, rows in ids.items():
        for c in range(0, len(rows), FRESH_PULL_CHUNK):
            r = rows[c:c + FRESH_PULL_CHUNK]
            got = np.asarray(servant.pull(r, table=name))
            want = ref[name][torch.from_numpy(r).to(ref[name].device)].cpu().numpy()
            bad += int((got != want).sum())
            total += want.size
    return bad / total


def _fresh_ids(applied: dict, rng) -> dict:
    """Per table: every delta-applied row and FRESH_SAMPLE_ROWS others."""
    out = {}
    for name, rows in applied.items():
        rows = np.fromiter(sorted(rows), np.int64)
        others = np.setdiff1d(rng.choice(CLI_CAPACITY, FRESH_SAMPLE_ROWS, replace=False), rows)
        out[name] = np.concatenate([rows, others])
    return out


def _replica_launches(fleet) -> dict:
    """Each live replica's row-kernel launches, over its ``stats`` RPC."""
    return {r.id: r.servant.stats().get("launches", {}) for r in fleet.replicas()}


def _fresh_fused_leg(seed: int, corpora, env: dict, device: str, tmp: str) -> dict:
    """fused-resident (``train_resident``'s config) publishing every step
    from its start state to a ``Servant`` of that state: after
    FRESH_FUSED_STEPS steps the servant's whole planes equal the trained
    ones bit for bit, and the trained tables equal those of a run with
    publishing off (module docstring, phase 18)."""
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
    from swiftsnails_tpu_torch.serving import Servant
    from swiftsnails_tpu_torch.serving.engine import normalize_table

    t_leg = time.monotonic()
    names = ("in_table", "out_table")
    trainer, loop, _ = _train_loop("train_resident", seed, corpora)
    off = loop.run(seed=seed, max_steps=FRESH_FUSED_STEPS)
    off = {n: getattr(off, n).table for n in names}
    del trainer, loop
    d = os.path.join(tmp, "fused")
    trainer, loop, records = _train_loop("train_resident", seed, corpora,
                                         freshness_publish=1, freshness_dir=d,
                                         freshness_log_mb=FRESH_LOG_MB)
    start = trainer.init_state()
    trainer.init_state = lambda: start
    servant = Servant({n: normalize_table(getattr(start, n).table, DIM, "packed").clone()
                       for n in names}, device=device)
    try:
        before = {n: t.clone() for n, t in servant._tables.items()}
        on, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=FRESH_FUSED_STEPS))
        sub = DeltaSubscriber(servant, d)
        applied = sub.poll()
        want = {n: normalize_table(getattr(on, n).table, DIM, "packed") for n in names}
        parity = _plane_mismatch(want, servant._tables)
        moved = all(not torch.equal(before[n], want[n]) for n in names)
        same_as_off = all(torch.equal(off[n], getattr(on, n).table) for n in names)
        pub = loop.freshness.stats()
        n = pub["published_batches"]
        out = {"steps": FRESH_FUSED_STEPS, "losses": [r["loss"] for r in records],
               "batches_applied": applied, "bit_parity": parity, "whole_planes": True,
               "planes_moved": moved, "tables_equal_publishing_off": same_as_off,
               "published_batches": n, "rows_per_batch": pub["published_rows"] / n,
               "publish_ms_per_step": {"step_wait": pub["step_wait_ms"] / n,
                                       "gather": pub["gather_ms"] / n,
                                       "d2h": pub["d2h_ms"] / n, "write": pub["write_ms"] / n},
               "launches": {k: v for k, v in launches.items() if v},
               "seconds": time.monotonic() - t_leg}
        emit("freshness_fused_resident", **out, device=env["device"],
             nvidia_smi=env["nvidia_smi"])
        substeps = FRESH_FUSED_STEPS * trainer.steps_per_call
        if (parity != 0.0 or not moved or not same_as_off or n != FRESH_FUSED_STEPS
                or applied != n or loop.freshness.errors
                or launches["fused_sgns_resident_step"] != substeps):
            raise AssertionError(f"freshness fused-resident: {out}")
        return out
    finally:
        servant.close()


def phase_freshness(seed: int, corpora, env: dict, serve: dict, device: str = "cuda") -> dict:
    """The freshness pipeline and the TCP network plane at full width (see
    the module docstring, phase 18). Returns the launches and the delta
    batches' rows for the kernel timings."""
    import gc

    from swiftsnails_tpu_torch.freshness.log import list_seqs, read_batch, seg_path
    from swiftsnails_tpu_torch.freshness.publisher import DeltaPublisher
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
    from swiftsnails_tpu_torch.net.delta_stream import TcpDeltaSource
    from swiftsnails_tpu_torch.net.fleet import NetFleet, ReplicaManager, ReplicaSpawner
    from swiftsnails_tpu_torch.serving import Fleet, Servant
    from swiftsnails_tpu_torch.serving.loadgen import run_open_loop
    from swiftsnails_tpu_torch.tiered.store import _np_dequant_unit_rows, _np_quant_unit_rows

    t_phase = time.monotonic()
    card = {"device": env["device"], "nvidia_smi": env["nvidia_smi"]}
    cuda = device != "cpu"
    rng = np.random.default_rng(seed + 23)
    tmp = tempfile.mkdtemp(prefix="ssn-fresh-")
    s1 = SERVE_TRAIN_STEPS
    s2 = s1 + FRESH_STEPS
    s3 = s2 + FRESH_INT8_STEPS
    s4 = s3 + FRESH_TCP_STEPS
    counters = _counters()
    fleet = netfleet = manager = None
    procs = [None, None]
    try:
        root = os.path.join(tmp, "ckpt")
        os.makedirs(root)
        os.symlink(os.path.join(serve["root"], f"step_{s1}"), os.path.join(root, f"step_{s1}"))
        serve_cfg = _fresh_config(device, root)
        logs = {k: os.path.join(tmp, k) for k in ("deltas", "gap", "int8", "tcp")}
        fused = _fresh_fused_leg(seed, corpora, env, device, tmp)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        for f in counters.values():
            f.launches = 0

        # (a) the file log, in process: a 2-replica fleet at step 4 follows
        # the resumed run's deltas under an open loop of pulls
        t0 = time.perf_counter()
        fleet = Fleet.from_checkpoint(root, serve_cfg, device=device, replicas=2)
        fleet_load_s = time.perf_counter() - t0
        target = _Applied(fleet, cuda)
        sub = DeltaSubscriber(target, logs["deltas"], config=serve_cfg, checkpoint_root=root,
                              max_lag_ms=FRESH_WAIT_S * 1e3)
        fleet.attach_freshness(sub)
        trainer, loop, records = _fresh_run(seed, corpora, device, root, s1, FRESH_STEPS,
                                            freshness_dir=logs["deltas"])
        t_run = time.perf_counter()
        join, th = _in_thread(lambda: loop.run(seed=seed, max_steps=s2))
        _wait_for(lambda: sub.subscribe() or not th.is_alive(), FRESH_WAIT_S,
                  "the publisher opened no log")
        if not th.is_alive():
            join(0)  # the run ended (or failed) before it published
        sub.start(interval_s=0.02)
        load = run_open_loop(lambda anchor, ids: fleet.pull(ids), qps=FRESH_LOAD_QPS,
                             duration_s=3.0, seed=seed, id_space=CLI_CAPACITY,
                             batch=SERVE_BUCKETS[0])
        state = join(FRESH_WAIT_S)
        run_s = time.perf_counter() - t_run
        _wait_for(lambda: sub.status()["applied_step"] >= s2, FRESH_WAIT_S,
                  f"the subscriber reached no step {s2}")
        sub.stop()
        st = sub.status()
        pub = loop.freshness.stats()
        losses = [r["loss"] for r in records]
        if len(losses) != FRESH_STEPS or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"freshness: losses {losses}")
        if pub["published_batches"] != FRESH_STEPS or pub["pruned"] or st["fallbacks"] \
                or loop.freshness.errors:
            raise AssertionError(f"freshness: publisher {pub}, subscriber {st}")
        ref = Servant.from_checkpoint(root, serve_cfg, step=s2, device=device)
        first = fleet.replicas()[0].servant
        parity = _plane_mismatch(ref._tables, first._tables)
        applied = {k: len(v) for k, v in target.rows.items()}
        versions = {r.id: r.servant.version for r in fleet.replicas()}
        shared = len({r.servant._tables["in_table"].data_ptr() for r in fleet.replicas()}) == 1
        if parity != 0.0 or len(set(versions.values())) != 1 or not shared:
            raise AssertionError(f"freshness: parity {parity}, versions {versions}")
        health = fleet.health()["freshness"]
        seqs = list_seqs(logs["deltas"])
        batches = [read_batch(seg_path(logs["deltas"], s))[1] for s in seqs]
        n = pub["published_batches"]
        emit("freshness_file", steps=[s1, s2], losses=losses, run_s=run_s,
             fleet_load_normalize_s=fleet_load_s, bit_parity=parity, whole_planes=True,
             applied_rows=applied, replica_versions=versions, shared_planes=shared,
             publish_ms_per_step={"step_wait": pub["step_wait_ms"] / n,
                                  "gather": pub["gather_ms"] / n, "d2h": pub["d2h_ms"] / n,
                                  "write": pub["write_ms"] / n},
             rows_per_batch=pub["published_rows"] / pub["published_batches"],
             bytes_per_batch=pub["published_bytes"] / pub["published_batches"],
             rows_per_batch_by_table={name: statistics.median(len(b[name]["rows"])
                                                              for b in batches)
                                      for name in batches[0]},
             lag_p50_ms=st["lag_p50_ms"], lag_p99_ms=st["lag_p99_ms"],
             apply_ms_per_batch={"median": statistics.median(target.apply_ms),
                                 "max": max(target.apply_ms), "batches": len(target.apply_ms)},
             pull_under_apply={k: load[k] for k in ("p50_ms", "p99_ms", "achieved_qps",
                                                    "requests", "errors")},
             pruned=pub["pruned"], fallbacks=st["fallbacks"], health=health,
             step_ms_median=statistics.median(r["seconds"] * 1e3 for r in records[1:]),
             **card)
        timing = {"gather_table": state.out_table.table, "batches": batches}
        del state, trainer, loop

        # the gap drill: a deleted segment -> a full reload of step 20 ->
        # the batches past the gap re-apply on it; whole planes equal again
        gpub = DeltaPublisher(logs["gap"], base_step=s2, log_mb=FRESH_LOG_MB)
        gsub = DeltaSubscriber(fleet, logs["gap"], config=serve_cfg, checkpoint_root=root)
        grows = {}
        for k in range(1, 6):
            rows = np.sort(rng.choice(CLI_CAPACITY, 512, replace=False))
            idx = torch.from_numpy(rows).to(ref._tables["in_table"].device)
            grows[k] = rows
            gpub.publish({name: (rows, plane[idx].cpu().numpy())
                          for name, plane in ref._tables.items()}, s2 + k)
            if k == 2:
                gsub.subscribe()
                gsub.poll()
        os.remove(seg_path(logs["gap"], 3))
        t0 = time.perf_counter()
        gsub.poll()  # the gap at seq 3: reload, resubscribe at 4
        gsub.poll()  # 4 and 5 on the reloaded planes
        gap_s = time.perf_counter() - t0
        gst = gsub.status()
        gparity = _plane_mismatch(ref._tables, fleet.replicas()[0].servant._tables)
        if not (gst["fallbacks"] == 1 and gst["applied_seq"] == 5 and gparity == 0.0):
            raise AssertionError(f"freshness gap drill: {gst}, parity {gparity}")
        emit("freshness_gap_drill", fallbacks=gst["fallbacks"], applied_seq=gst["applied_seq"],
             skipped_batches=gst["skipped_batches"], bit_parity=gparity,
             reload_and_reapply_s=gap_s, pruned=gpub.pruned, **card)
        ref.close()  # the reference servants' micro-batchers end with their use
        del ref
        gc.collect()
        # back to step 20's watermark (the drill's batches carried later
        # steps), so the int8 run's batches apply
        fleet.reload_from_checkpoint(root, serve_cfg, step=s2)

        # the int8 wire: resume 20 -> 24 publishing int8; the fleet's
        # touched rows equal the quantizer's round trip of step 24's, the
        # rest equal step 24's
        t8 = _Applied(fleet, cuda)
        sub8 = DeltaSubscriber(t8, logs["int8"], config=serve_cfg, checkpoint_root=root)
        _, loop8, _ = _fresh_run(seed, corpora, device, root, s2, FRESH_INT8_STEPS,
                                 freshness_dir=logs["int8"], freshness_delta_dtype="int8")
        loop8.run(seed=seed, max_steps=s3)
        sub8.poll()
        pub8 = loop8.freshness.stats()
        del loop8
        ref8 = Servant.from_checkpoint(root, serve_cfg, step=s3, device=device)
        got8 = fleet.replicas()[0].servant._tables
        rel, exact_elsewhere = {}, True
        for name, want in ref8._tables.items():
            rows = np.fromiter(sorted(t8.rows[name]), np.int64)
            idx = torch.from_numpy(rows).to(want.device)
            w = want[idx].cpu().numpy()
            codes, scales = _np_quant_unit_rows(w)
            if not np.array_equal(got8[name][idx].cpu().numpy(),
                                  _np_dequant_unit_rows(codes, scales, np.float32)):
                raise AssertionError(f"int8 wire: {name} rows are not the quantizer's")
            rel[name] = float((got8[name] - want).abs().max() / want.abs().max())
            keep = torch.ones(want.shape[0], dtype=torch.bool, device=want.device)
            keep[idx] = False
            exact_elsewhere &= bool(torch.equal(got8[name][keep], want[keep]))
        if max(rel.values()) > QUANTIZED_REL_ERR_MAX or not exact_elsewhere \
                or sub8.status()["applied_step"] != s3:
            raise AssertionError(f"int8 wire: rel {rel}, elsewhere {exact_elsewhere}")
        emit("freshness_int8", steps=[s2, s3], max_rel_err=rel, limit=QUANTIZED_REL_ERR_MAX,
             quantizer_round_trip_exact=True, exact_elsewhere=exact_elsewhere,
             bytes_per_batch=pub8["published_bytes"] / pub8["published_batches"],
             f32_bytes_per_batch=pub["published_bytes"] / pub["published_batches"], **card)
        ref8.close()
        del ref8, got8
        in_process = {name: f.launches for name, f in counters.items()}
        fleet.close()
        fleet = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (b) TCP: two replica processes on the card behind a NetFleet; they
        # load the newest checkpoint (step 24)
        rcfg = _fresh_config(device, root, serve_batch_buckets=FRESH_REPLICA_BUCKETS)
        spawner = ReplicaSpawner(root, rcfg, device=None if cuda else "cpu",
                                 startup_timeout_s=FRESH_SPAWN_S)
        t0 = time.perf_counter()
        joins = [_in_thread(lambda i=i: procs.__setitem__(i, spawner.spawn()))[0]
                 for i in (0, 1)]
        for j in joins:
            j(FRESH_SPAWN_S + 30)
        spawn_s = time.perf_counter() - t0
        netfleet = NetFleet.connect([(p.host, p.port) for p in procs], rcfg,
                                    checkpoint_root=root)
        manager = ReplicaManager(netfleet, spawner=spawner, lease_ms=FRESH_LEASE_MS,
                                 probe_timeout_ms=FRESH_PROBE_MS)
        for rep, proc in zip(netfleet.replicas(), procs):
            manager.attach_process(rep.id, proc)
        local = Servant.from_checkpoint(root, serve_cfg, device=device)
        ids = zipf_ids(FRESH_PULL_CHUNK, CLI_CAPACITY, rng)
        for rep in netfleet.replicas():
            if not np.array_equal(rep.servant.pull(ids), local.pull(ids)):
                raise AssertionError("freshness: a TCP pull differs from the in-process one")
        local.close()
        del local

        # freshness_listen: resume 24 -> 28 streaming to a TcpDeltaSource
        # that applies to the NetFleet (an apply RPC to each replica)
        tt = _Applied(netfleet, False)
        tsub = DeltaSubscriber(tt, logs["tcp"], config=rcfg, checkpoint_root=root)
        netfleet.attach_freshness(tsub)
        _, tloop, _ = _fresh_run(seed, corpora, device, root, s3, FRESH_TCP_STEPS,
                                 freshness_dir=logs["tcp"], freshness_listen="127.0.0.1:0")
        tjoin, tth = _in_thread(lambda: tloop.run(seed=seed, max_steps=s4))
        _wait_for(lambda: tloop.freshness.stream_server is not None or not tth.is_alive(),
                  FRESH_WAIT_S, "no freshness_listen server")
        if tloop.freshness.stream_server is None:
            tjoin(0)  # the run ended (or failed) before it listened
            raise AssertionError("freshness_listen: the run ended before it listened")
        src = TcpDeltaSource(tsub, *tloop.freshness.stream_server.address, config=rcfg).start()
        try:
            tload = run_open_loop(lambda anchor, ids: netfleet.pull(ids), qps=FRESH_LOAD_QPS,
                                  duration_s=3.0, seed=seed + 1, id_space=CLI_CAPACITY,
                                  batch=SERVE_BUCKETS[0])
            tjoin(FRESH_WAIT_S)
            _wait_for(lambda: tsub.status()["applied_step"] >= s4, FRESH_WAIT_S,
                      f"the TCP subscriber reached no step {s4}")
        finally:
            src.stop()
        tst = tsub.status()
        tpub = tloop.freshness.stats()
        del tloop
        ref4 = Servant.from_checkpoint(root, serve_cfg, step=s4, device=device)
        pids = _fresh_ids(tt.rows, rng)
        tparity = {r.id: _pull_mismatch(r.servant, ref4._tables, pids)
                   for r in netfleet.replicas()}
        if any(tparity.values()) or tst["fallbacks"] or src.status()["batches"] < FRESH_TCP_STEPS:
            raise AssertionError(f"freshness tcp: parity {tparity}, {tst}, {src.status()}")
        emit("freshness_tcp", replicas=len(procs), spawn_s=spawn_s, steps=[s3, s4],
             tcp_pull_equals_in_process=True, bit_parity=tparity,
             rows_compared={k: len(v) for k, v in pids.items()}, source=src.status(),
             lag_p50_ms=tst["lag_p50_ms"], lag_p99_ms=tst["lag_p99_ms"],
             apply_ms_per_batch={"median": statistics.median(tt.apply_ms),
                                 "max": max(tt.apply_ms), "batches": len(tt.apply_ms)},
             pull_under_apply={k: tload[k] for k in ("p50_ms", "p99_ms", "achieved_qps",
                                                     "requests", "errors")},
             fallbacks=tst["fallbacks"], **card)

        # proc_kill: SIGKILL one replica under load; lease expiry drains it
        # and a fresh process (loading step 28) rejoins at parity
        victim = netfleet.replicas()[0]
        vproc = manager.process_of(victim.id)
        old_inc = victim.servant.incarnation
        launches_before = _replica_launches(netfleet)
        manager.start(interval_s=0.2)
        t_kill = [None]

        def _kill():
            t_kill[0] = time.monotonic()
            vproc.kill()

        timer = threading.Timer(FRESH_KILL_LOAD_S * 0.3, _kill)
        timer.start()
        kload = run_open_loop(lambda anchor, ids: netfleet.pull(ids), qps=FRESH_KILL_QPS,
                              duration_s=FRESH_KILL_LOAD_S, seed=seed + 2,
                              id_space=CLI_CAPACITY, batch=SERVE_BUCKETS[0])
        timer.join()
        _wait_for(lambda: manager.respawns >= 1 and len(netfleet.replicas()) == 2
                  and victim.id not in {r.id for r in netfleet.replicas()},
                  FRESH_SPAWN_S + 60, "no respawn")
        respawn_s = time.monotonic() - t_kill[0]
        manager.stop()
        reps = netfleet.replicas()
        incs = {r.id: r.servant.incarnation for r in reps}
        kparity = {r.id: _pull_mismatch(r.servant, ref4._tables, pids) for r in reps}
        availability = 100.0 - float(kload["error_rate_pct"])
        if any(kparity.values()) or old_inc in incs.values():
            raise AssertionError(f"proc_kill: parity {kparity}, incarnations {incs}")
        replicas = _replica_launches(netfleet)
        emit("freshness_proc_kill", killed=victim.id, availability_pct=availability,
             requests=kload["requests"], errors=kload["errors"], p99_ms=kload["p99_ms"],
             respawn_s=respawn_s, respawns=manager.respawns, incarnations=incs,
             bit_parity=kparity, lease_ms=FRESH_LEASE_MS,
             supervisor_lost=manager.supervisor.status()["workers_lost"], **card)
        ref4.close()
        del ref4
        in_total = {name: f.launches for name, f in counters.items()}
        replica_sum = {}
        for per in (launches_before[victim.id], *replicas.values()):
            for k, v in per.items():
                replica_sum[k] = replica_sum.get(k, 0) + int(v)
        # in process: the training steps (gather_rows, scatter_add_rows),
        # the publisher's gathers, the fleet's pulls and applies
        launches = {"in_process": {k: in_total[k] for k in ("gather_rows", "scatter_write_rows")},
                    "file_log_leg": {k: in_process[k] for k in ("gather_rows",
                                                                "scatter_write_rows")},
                    "replicas": replica_sum,
                    "publisher_gathers": 2 * (pub["published_batches"]
                                              + pub8["published_batches"]
                                              + tpub["published_batches"])}
        for k in ("gather_rows", "scatter_write_rows"):
            if cuda and not (launches["in_process"][k] > 0 and replica_sum.get(k, 0) > 0):
                raise AssertionError(f"freshness path: {k} launches {launches}")
        emit("freshness_launches", **launches, replicas_by_id=replicas,
             all_in_process=in_total, **card)
        timing["launches"] = launches
        timing["fused_resident"] = fused
        timing["seconds"] = time.monotonic() - t_phase
        return timing
    finally:
        if manager is not None:
            manager.close()  # SIGKILLs and reaps every replica process
        for p in procs:
            if p is not None:
                p.close()
        if netfleet is not None:
            netfleet.close()
        if fleet is not None:
            fleet.close()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_freshness_kernels(fresh: dict, seed: int, rate: float) -> dict:
    """The kernels of the freshness path at its shapes: ``gather_rows`` as
    the publisher runs it (one step's touched out-table rows from the
    trained ``[1,048,576, 2, 128]`` plane, the phase's own batches in
    rotation), beside ``index_select``; ``scatter_write_rows`` as one
    delta apply runs it (one batch's out-table rows into a ``[1,048,576,
    200]`` serving plane), beside ``index_copy_``. Bit-equal to the plain
    versions, timed, against the byte bound. Not counted: the path's
    launches were read before."""
    from swiftsnails_tpu_torch.ops import rowdma

    dev = torch.device("cuda")
    table = fresh["gather_table"]
    batches = fresh["batches"][-ROW_SETS:]
    sets = [torch.from_numpy(b["out_table"]["rows"].astype(np.int32)).to(dev) for b in batches]
    summary = {}
    case = _gather_case(table, sets, rate)
    n = int(sets[0].numel())  # the shape the bound counts
    emit("kernel", name="gather_rows", dtype="torch.float32", path="freshness", rows=n, **case)
    summary["gather_rows_freshness"] = {"shape": [n, *table.shape[1:]], **case}
    serving = rowdma.unpack_rows(table, DIM).contiguous()
    del fresh["gather_table"], table
    row_bytes = serving.stride(0) * serving.element_size()
    psets = []
    for b in batches:
        uniq = torch.from_numpy(b["out_table"]["rows"].astype(np.int32)).to(dev)
        vals = torch.from_numpy(np.array(b["out_table"]["values"])).to(dev)
        psets.append((uniq, vals, uniq.long(), int(uniq.numel())))
    n = int(psets[0][3])
    case = _push_case(
        lambda bf, u, v: (rowdma.scatter_write_rows(bf[0], u, v),),
        lambda bf, u, v: (rowdma.scatter_write_rows_plain(bf[0], u, v),),
        [serving], psets, lambda bf, st: bf[0].index_copy_(0, st[2], st[1]),
        n * (2 * row_bytes + 4), n, rate)
    emit("kernel", name="scatter_write_rows", dtype="torch.float32", path="freshness", **case)
    summary["scatter_write_rows_freshness"] = {"shape": list(serving.shape), **case}
    del serving, psets, sets
    torch.cuda.empty_cache()
    return summary


def _freshness_kernel_entries(summary: dict, fresh: dict) -> list:
    """The ``kernels`` line's ``path: "freshness"`` entries: each kernel at
    the freshness path's shape with its launches in the phase (in process,
    the replica processes' over their ``stats`` RPC added)."""
    out = []
    for key, replaces in (("gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
                          ("scatter_write_rows", "swiftsnails_tpu/ops/rowdma.py:289")):
        s = summary[f"{key}_freshness"]
        la = fresh["launches"]
        out.append({
            "name": key, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces,
            "launches": la["in_process"][key] + la["replicas"].get(key, 0),
            "launches_in_process": la["in_process"][key],
            "launches_replicas": la["replicas"].get(key, 0),
            "max_abs_err": s["max_abs_err"], "ms": s.get("ms", s.get("kernel_ms")),
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["library_ms"], "shape": s["shape"], "dtype": "float32",
            "path": "freshness"})
    return out


# ---------------------------------------------------------------- cluster ---


CLUSTER_WORKERS = 3
CLUSTER_BATCHES = 96  # chaos_cluster_bench(small=False)
CLUSTER_LOOP_STEPS = 96  # the plain TrainLoop timed beside the sim
ONE_ROW_TABLE = (VOCAB, -(-DIM // 128), 128)


def phase_one_row() -> dict:
    """One-row calls of the three row kernels of the cluster path on a
    ``[1,048,576, 2, 128]`` f32 table: bit-equal to plain, CUDA-event
    medians (a sleep kernel ahead hides the host's enqueue): the fixed
    device cost of one launch, which a byte bound leaves out."""
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.utils.metrics import time_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn(ONE_ROW_TABLE, generator=gen, device=dev)
    row = torch.tensor([12_345], dtype=torch.int32, device=dev)
    val = torch.randn((1, *ONE_ROW_TABLE[1:]), generator=gen, device=dev)
    out = {}
    for name, kernel, plain in (
            ("gather_rows", lambda t: rowdma.gather_rows(t, row),
             lambda t: rowdma.gather_rows_plain(t, row)),
            ("scatter_add_rows", lambda t: rowdma.scatter_add_rows(t, row, val),
             lambda t: rowdma.scatter_add_rows_plain(t, row, val)),
            ("scatter_write_rows", lambda t: rowdma.scatter_write_rows(t, row, val),
             lambda t: rowdma.scatter_write_rows_plain(t, row, val))):
        got, want = kernel(table.clone()), plain(table.clone())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: a one-row call differs from its plain version")
        del got, want
        out[name] = {"ms": time_ms(lambda i: kernel(table)),
                     "plain_ms": time_ms(lambda i: plain(table))}
        emit("kernel_one_row", name=name, dtype="torch.float32",
             table=list(ONE_ROW_TABLE), **out[name])
    del table
    torch.cuda.empty_cache()
    return out


def _cluster_sim(seed: int, corpora, env: dict, tmp: str, ledger) -> tuple:
    """(a): the three legs at full width, counted; the gates."""
    from swiftsnails_tpu_torch.cluster import chaos_lane
    from swiftsnails_tpu_torch.resilience.drill import LOSS_PARITY_BAR

    trainer, _, _ = _train_loop("train", seed, corpora)
    legs = {}
    t0 = time.monotonic()
    block, launches = _run_counted(lambda: chaos_lane.chaos_cluster_bench(
        small=False, workdir=os.path.join(tmp, "sim"), ledger=ledger,
        workers=CLUSTER_WORKERS, trainer=trainer, legs=legs))
    seconds = time.monotonic() - t0
    applied = {"control": CLUSTER_BATCHES, "protected": len(legs["protected"]["order"]),
               "unprotected": len(legs["unprotected"]["order"])}
    total = sum(applied.values())
    _check_launches("cluster_sim", launches,
                    {"gather_rows": 2 * total, "scatter_add_rows": 2 * total})
    checks = {
        "accounting_exact": block["accounting_exact"] and block["lost_count"] == 0
        and block["duplicated_count"] == 0,
        "worker_lost": block["workers_lost"] >= 1,
        "reassigned": block["reassignments"] >= 1,
        "finite": block["finite"],
        "loss_parity": block["loss_parity"] <= LOSS_PARITY_BAR,
        "unprotected_lost": block["unprotected_lost_count"] > 0,
    }
    prot = legs["protected"]
    sim_ms = prot["wall_s"] * 1e3 / applied["protected"]
    # the same trainer through a plain TrainLoop (no per-step loss read, one
    # sync at the end), timed in the same call
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop

    t1 = time.monotonic()
    TrainLoop(trainer, log_every=0).run(max_steps=CLUSTER_LOOP_STEPS)
    torch.cuda.synchronize()
    loop_ms = (time.monotonic() - t1) * 1e3 / CLUSTER_LOOP_STEPS
    dead = sorted(w for w, st in prot["workers"].items() if not st["alive"])
    emit("cluster_sim", checks=checks, block=block, applied=applied, launches=launches,
         ticks=prot["ticks"], virtual_s=prot["virtual_s"],
         stale_rejected=prot["stale_rejected"],
         stragglers_flagged=prot["status"].get("stragglers_flagged"),
         workers=prot["workers"], dead=dead,
         leg_wall_s={k: v["wall_s"] for k, v in legs.items()},
         sim_host_ms_per_batch=sim_ms, loop_host_ms_per_step=loop_ms,
         sim_over_loop=sim_ms / loop_ms, seconds=seconds,
         device=env["device"], nvidia_smi=env["nvidia_smi"])
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"cluster_sim: failed {bad}: {block}")
    del trainer
    torch.cuda.empty_cache()
    return block, {k: launches[k] for k in ("gather_rows", "scatter_add_rows")}, dead


class _HostPauses:
    """The fleet lane's process while it times the router. Every object the
    earlier phases left (~170k with torch and the port imported, more after
    them) is collected once and frozen out of the cyclic collector's reach
    (``gc.freeze``): a full collection over them stalls every thread for
    ~90 ms on a slow host, past the 54 ms the SLO leaves over the 6 ms
    service floor, and one stall in a probe of the 2-replica leg fails its
    rung. Records the collector's pauses by generation (``gc.callbacks``)
    and the threads alive at the start (ROADMAP.md, Queue 3 item 16), the
    tier's flush workers and the servants' micro-batchers counted."""

    BATCHERS = ("ssn-serve-pull", "ssn-serve-topk", "ssn-serve-score")

    def __init__(self):
        import gc

        self.threads = sorted(t.name for t in threading.enumerate())
        self.flush_workers = self.threads.count("tier-flush-worker")
        self.batchers = sum(self.threads.count(n) for n in self.BATCHERS)
        gc.collect()
        self.frozen = len(gc.get_objects())
        gc.freeze()
        self.pauses: list = []
        self._t0 = None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"], (time.perf_counter() - self._t0) * 1e3))
            self._t0 = None

    def stop(self) -> dict:
        import gc

        gc.callbacks.remove(self._on_gc)
        gc.unfreeze()
        gens = sorted({g for g, _ in self.pauses})
        return {"threads": self.threads, "tier_flush_workers": self.flush_workers,
                "servant_batchers": self.batchers, "gc_frozen_objects": self.frozen,
                "gc_collections": {g: sum(1 for x, _ in self.pauses if x == g) for g in gens},
                "gc_max_ms": {g: max(ms for x, ms in self.pauses if x == g) for g in gens},
                "gc_total_ms": sum(ms for _, ms in self.pauses)}


def phase_cluster(seed: int, corpora, env: dict) -> dict:
    """Phase 19: the cluster plane and the chaos lanes on the card."""
    from swiftsnails_tpu_torch import cli
    from swiftsnails_tpu_torch.cluster import chaos_lane
    from swiftsnails_tpu_torch.resilience.drill import run_drill_matrix
    from swiftsnails_tpu_torch.serving.chaos_lane import chaos_serve_bench
    from swiftsnails_tpu_torch.serving.fleet_lane import (
        SCALING_FLOOR, fleet_bench, fleet_chaos_drill)
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="ssn-cluster-")
    try:
        path = os.path.join(tmp, "LEDGER.jsonl")
        ledger = Ledger(path)
        cluster, launches, dead = _cluster_sim(seed, corpora, env, tmp, ledger)

        t0 = time.monotonic()
        drills, drill_launches = _run_counted(lambda: chaos_lane.run_cluster_drills(
            workdir=os.path.join(tmp, "drills"), device="cuda"))
        emit("cluster_drills", results=drills, launches=drill_launches,
             seconds=time.monotonic() - t0)
        bad = [k for k, v in drills.items() if not v["recovered"]]
        if bad:
            raise AssertionError(f"cluster_drills: unrecovered {bad}")

        t0 = time.monotonic()
        matrix, matrix_launches = _run_counted(lambda: run_drill_matrix(
            workdir=os.path.join(tmp, "matrix"), device="cuda"))
        emit("cluster_drill_matrix", results=matrix, launches=matrix_launches,
             seconds=time.monotonic() - t0)
        bad = [k for k, v in matrix.items() if not v.get("recovered")]
        if bad:
            raise AssertionError(f"cluster_drill_matrix: unrecovered {bad}: "
                                 f"{ {k: matrix[k] for k in bad} }")

        t0 = time.monotonic()
        serve, serve_launches = _run_counted(lambda: chaos_serve_bench(
            small=False, workdir=os.path.join(tmp, "serve"), ledger=ledger, device="cuda"))
        serve_checks = {
            "availability": serve["availability_pct"] >= serve["floor_pct"],
            "unprotected_hard_failure": bool(serve["unprotected_hard_failure"]),
            "reload_corrupt_rejected": bool(serve["reload_corrupt_rejected"]),
            "tier_bitflip_recovered": bool((serve.get("tier_bitflip") or {}).get("recovered")),
        }
        emit("cluster_chaos_serve", checks=serve_checks, block=serve,
             launches=serve_launches, seconds=time.monotonic() - t0)
        bad = [k for k, ok in serve_checks.items() if not ok]
        if bad:
            raise AssertionError(f"cluster_chaos_serve: failed {bad}")

        t0 = time.monotonic()
        pauses = _HostPauses()
        try:
            fleet, fleet_launches = _run_counted(lambda: fleet_bench(
                small=False, workdir=os.path.join(tmp, "fleet"), ledger=ledger, device="cuda"))
        finally:
            host = pauses.stop()
        fleet_s = time.monotonic() - t0
        t0 = time.monotonic()
        fdrill = fleet_chaos_drill(small=True, workdir=os.path.join(tmp, "fleet-drill"),
                                   ledger=ledger, device="cuda")
        fleet_checks = {
            "scaling": fleet["scaling_x"] >= SCALING_FLOOR,
            "affinity": fleet["affinity"]["affinity_hit_rate"]
            > fleet["affinity"]["random_hit_rate"],
            "hedge": fleet["hedge"]["p99_ms"] < fleet["hedge"]["nohedge_p99_ms"],
            **{f"{k}_availability": v["availability_pct"] >= v["floor_pct"]
               for k, v in fdrill.items()},
            **{f"{k}_recovered": bool(v["recovered"]) for k, v in fdrill.items()},
        }
        emit("cluster_fleet", checks=fleet_checks,
             block={k: v for k, v in fleet.items() if k not in ("single", "fleet")},
             single_max_qps=fleet["single"]["max_qps"],
             fleet_max_qps=fleet["fleet"]["max_qps"],
             points=len(fleet["single"]["points"]) + len(fleet["fleet"]["points"]),
             drill=fdrill, launches=fleet_launches, bench_seconds=fleet_s,
             drill_seconds=time.monotonic() - t0, bench_host=host)
        bad = [k for k, ok in fleet_checks.items() if not ok]
        if bad:
            raise AssertionError(f"cluster_fleet: failed {bad}")
        if host["tier_flush_workers"] or host["servant_batchers"]:
            raise AssertionError(
                f"cluster_fleet: earlier phases left {host['tier_flush_workers']} tier flush "
                f"workers and {host['servant_batchers']} servant micro-batchers alive")

        ledger.append("bench", {"payload": {
            "metric": "chip_smoke_cluster", "platform": "gpu", "device": env["device"],
            "chaos_cluster": cluster, "chaos_serve": serve, "fleet": fleet}})
        status_out = io.StringIO()
        with contextlib.redirect_stdout(status_out):
            status_rc = cli.main(["supervisor-status", path])
        status = status_out.getvalue()
        lost_lines = [ln for ln in status.splitlines()
                      if any(ln.strip().startswith(w + " ") for w in dead)]
        report_out = io.StringIO()
        with contextlib.redirect_stdout(report_out):
            report_rc = cli.main(["ledger-report", path, "--check-regression", "5"])
        report = report_out.getvalue()
        gates = {name: any(ln.startswith(f"{name} ok") for ln in report.splitlines())
                 for name in ("chaos-cluster", "chaos-serve", "fleet")}
        if not gates["fleet"]:
            gates["fleet"] = any(ln.startswith("fleet: single gpu record")
                                 for ln in report.splitlines())
        emit("cluster_ledger", supervisor_status=status.splitlines(), status_rc=status_rc,
             check_regression=report.splitlines(), check_regression_rc=report_rc,
             gates=gates)
        if status_rc != 0 or not dead or not lost_lines or not all(
                "lost" in ln for ln in lost_lines):
            raise AssertionError(f"supervisor-status does not name the lost worker {dead}")
        if "REGRESSION" in report or not all(gates.values()) or report_rc not in (0, 2) \
                or (report_rc == 2 and "no measured bench record" not in report):
            raise AssertionError(f"check-regression: {report}")
        _cluster_baseline_file(ledger, tmp, fleet)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one_row = phase_one_row()
    seconds = time.monotonic() - t_phase
    emit("cluster_total", seconds=seconds, device=env["device"],
         nvidia_smi=env["nvidia_smi"])
    return {"launches": launches, "one_row": one_row, "seconds": seconds}


def _cluster_baseline_file(ledger, tmp: str, fleet: dict) -> None:
    """The bench cache: one cacheable ``bench`` record of the fleet's
    measured qps appended to the phase's ledger, the last-good file derived
    from it (``derive_last_good``), then ``ledger-report --check-regression
    5 --baseline-file`` on that file (rc 0) and on a truncated copy (rc 2)."""
    from swiftsnails_tpu_torch import cli
    from swiftsnails_tpu_torch.telemetry.ledger import derive_last_good, load_bench_cache

    ledger.append("bench", {"cacheable": True, "payload": {
        "metric": "fleet_max_qps", "value": fleet["fleet"]["max_qps"], "unit": "qps",
        "config": {"replicas": fleet["replicas"], "slo_p99_ms": fleet["slo_p99_ms"]},
        "platform": "gpu", "fleet": fleet}})
    good = os.path.join(tmp, "BENCH_LAST_GOOD.json")
    payload, reason = derive_last_good(ledger, good)
    truncated = os.path.join(tmp, "BENCH_LAST_GOOD.truncated.json")
    with open(good, "rb") as f, open(truncated, "wb") as g:
        g.write(f.read()[:40])
    runs = {}
    for name, path in (("good", good), ("truncated", truncated)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["ledger-report", ledger.path, "--check-regression", "5",
                           "--baseline-file", path])
        runs[name] = {"rc": rc, "output": out.getvalue().splitlines()}
    emit("cluster_baseline_file", derive_reason=reason,
         derived={k: (payload or {}).get(k) for k in ("metric", "value", "unit", "measured_at")},
         loaded=load_bench_cache(good)[0] == payload, runs=runs)
    if (reason is not None or payload["value"] != fleet["fleet"]["max_qps"]
            or runs["good"]["rc"] != 0 or runs["truncated"]["rc"] != 2
            or not runs["truncated"]["output"][0].startswith("ledger_report: --baseline-file: ")):
        raise AssertionError(f"--baseline-file: derived {payload} ({reason}), runs {runs}")


def _cluster_kernel_entries(summary: dict, cluster: dict) -> list:
    """The ``kernels`` line's ``path: "cluster"`` entries: the full-width
    sim's two row kernels at the packed+pool out-table shape (phase 3's
    numbers, the same step's shape), with the sim's launches, and each one
    one-row call's ms."""
    out = []
    for key, replaces in (("gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
                          ("scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213")):
        s = summary[key]
        out.append({
            "name": key, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": cluster["launches"][key],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"],
            "one_row_ms": cluster["one_row"][key]["ms"],
            "shape": s["shape"], "dtype": "float32", "path": "cluster"})
    return out


# ------------------------------------------------------------------ seqlm ---

# The sequence model at the JAX trainer's defaults (models/seqlm.py: seq_len
# 256, 2 layers, 4 heads, d_model 128, batch 8), on a paired text corpus
# over 32,768 words (2 x 16,384 pair ids) read through `data`; the
# optimizers at the JAX tests' rates (tests/test_seqlm.py).
SEQLM_TOKENS = 1_000_000
SEQLM_IDS = 1 << 14
SEQLM_STEPS = 60
SEQLM_RATES = {"sgd": 0.1, "momentum": 0.05, "adam": 0.003, "adamw": 0.003}
# One step of each optimizer, card against CPU, from one carried state: the
# loss, and the parameters of sgd and momentum within these tolerances. An
# adam or adamw first step moves each parameter by lr g / (|g| + 1e-8),
# which for the many embedding rows that meet a batch only through the tied
# output's softmax tail (|g| ~ 1e-8) turns the last bits of a gradient
# summed in another order into ~1e-5 of a parameter: there the moments mu
# and nu (linear and quadratic in g) are held to the tolerances instead,
# and so are the parameters whose gradient is at least SEQLM_ADAM_G_FLOOR
# (100 eps, where |g| and not eps sets the step); the parameters' largest
# difference over all of them is printed.
SEQLM_ADAM_G_FLOOR = 1e-6
SEQLM_LOSS_RTOL = 1e-5
SEQLM_PARAM_RTOL, SEQLM_PARAM_ATOL = 1e-4, 1e-6
SEQLM_ATTENTION_TOL = 2e-4  # ring and Ulysses against dense
SEQLM_CLI_TOKENS = 64 * 8 * 257 + 257  # 64 batches of 8 windows of 257 tokens
SEQLM_CLI_PERIOD = 8


def _seqlm_config(data: str, seed: int, **over):
    from swiftsnails_tpu_torch.utils.config import Config

    return Config({"model": "seqlm", "data": data, "seed": str(seed), "min_count": "1",
                   "num_iters": "1", **{k: str(v) for k, v in over.items()}})


def _seqlm_cli_args(conf: str, root: str) -> list:
    return ["train", "-config", conf, "-param_backup_root", root]


def _write_seqlm_conf(path: str, data: str, seed: int) -> None:
    """A ``model: seqlm`` config: the JAX defaults, adam at the JAX tests'
    rate, a save every SEQLM_CLI_PERIOD steps, ``resume: auto``."""
    keys = {"model": "seqlm", "data": data, "seed": seed, "min_count": 1, "num_iters": 1,
            "optimizer": "adam", "learning_rate": SEQLM_RATES["adam"],
            "param_backup_period": SEQLM_CLI_PERIOD, "resume": "auto", "log_every": 1}
    with open(path, "w", encoding="utf-8") as f:
        f.write("# the sequence model at its defaults\n")
        f.writelines(f"{k}: {v}\n" for k, v in keys.items())


def _loss_by_step(text: str) -> dict:
    return {r["step"]: r["loss"] for r in _metric_records(text)}


def phase_seqlm(seed: int, env: dict) -> dict:
    """``seqlm`` on the card (module docstring, phase 20)."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer, param_leaves
    from swiftsnails_tpu_torch.parallel import sequence
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger
    from swiftsnails_tpu_torch.utils.tree import map_tensors

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="ssn-seqlm-")
    out = {}
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        n_tokens = _write_text_corpus(corpus, SEQLM_TOKENS, SEQLM_IDS, True, seed)

        # (a) one step on the card against the same step on the CPU, from
        # the same state (carried over from the card's), each optimizer
        card = SeqLMTrainer(_seqlm_config(corpus, seed))
        batch = next(iter(card.batches()))
        toks = torch.from_numpy(batch["tokens"])
        parity = {}
        for name, lr in SEQLM_RATES.items():
            kw = {"optimizer": name, "learning_rate": lr}
            tr = SeqLMTrainer(_seqlm_config(corpus, seed, **kw),
                              corpus_ids=card.corpus_ids, vocab_size=card.vocab_size)
            host = SeqLMTrainer(_seqlm_config(corpus, seed, **kw), device="cpu",
                                corpus_ids=card.corpus_ids, vocab_size=card.vocab_size)
            state = tr.init_state()
            cpu_state = map_tensors(state, lambda _, t: t.cpu().clone())
            state, m = tr.train_step(state, {"tokens": toks.cuda()})
            cpu_state, cm = host.train_step(cpu_state, {"tokens": toks})
            held = ({"params": state["params"]} if name in ("sgd", "momentum")
                    else {k: state["opt"][k] for k in ("mu", "nu")})
            want = ({"params": cpu_state["params"]} if name in ("sgd", "momentum")
                    else {k: cpu_state["opt"][k] for k in ("mu", "nu")})
            if name in ("adam", "adamw"):
                # from a zero mu, one step leaves mu = (1 - b1) g
                masks = [mu.abs() >= (1 - 0.9) * SEQLM_ADAM_G_FLOOR
                         for mu in param_leaves(cpu_state["opt"]["mu"])]
                key = "params (|g| >= floor)"
                held[key] = [a[m.to(a.device)]
                             for a, m in zip(param_leaves(state["params"]), masks)]
                want[key] = [b[m] for b, m in zip(param_leaves(cpu_state["params"]), masks)]
            errs, counts = {}, {}
            for key, got in held.items():
                pairs = (zip(got, want[key]) if isinstance(got, list)
                         else zip(param_leaves(got), param_leaves(want[key])))
                for a, b in pairs:
                    a = a.cpu()
                    counts[key] = counts.get(key, 0) + a.numel()
                    if not a.numel():
                        continue
                    errs[key] = max(errs.get(key, 0.0), float((a - b).abs().max()))
                    if not torch.allclose(a, b, rtol=SEQLM_PARAM_RTOL, atol=SEQLM_PARAM_ATOL):
                        raise AssertionError(f"seqlm {name}: card {key} differ from the "
                                             f"CPU's by {float((a - b).abs().max())}")
            errs["params"] = max(float((a.cpu() - b).abs().max()) for a, b in zip(
                param_leaves(state["params"]), param_leaves(cpu_state["params"])))
            loss, cpu_loss = float(m["loss"]), float(cm["loss"])
            if not math.isclose(loss, cpu_loss, rel_tol=SEQLM_LOSS_RTOL):
                raise AssertionError(f"seqlm {name}: loss {loss} on the card, "
                                     f"{cpu_loss} on the CPU")
            parity[name] = {"loss": loss, "cpu_loss": cpu_loss, "held": sorted(held),
                            "held_elements": counts, "max_abs_err": errs}
            del tr, host, state, cpu_state
        out["parity"] = {"vocab": card.vocab_size, "corpus_tokens": n_tokens, **parity}

        # (b) each optimizer 60 steps under TrainLoop: finite, falling
        runs = {}
        for name, lr in SEQLM_RATES.items():
            tr = SeqLMTrainer(_seqlm_config(corpus, seed, optimizer=name, learning_rate=lr),
                              corpus_ids=card.corpus_ids, vocab_size=card.vocab_size)
            records = []

            class Recorder(MetricsLogger):
                def log(self, record):
                    records.append(record)

            TrainLoop(tr, metrics=Recorder(), log_every=1).run(seed=seed, max_steps=SEQLM_STEPS)
            losses = [r["loss"] for r in records]
            if len(losses) != SEQLM_STEPS or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"seqlm {name}: losses {losses}")
            if not np.mean(losses[-5:]) < np.mean(losses[:5]):
                raise AssertionError(f"seqlm {name}: the loss did not fall: {losses}")
            steady = records[5:]
            runs[name] = {"lr": lr, "step_ms_median": statistics.median(
                              r["seconds"] * 1e3 for r in steady),
                          "tokens_per_sec": sum(r["items"] for r in steady)
                          / sum(r["seconds"] for r in steady),
                          "loss_first": losses[0], "loss_last": losses[-1],
                          "loss_first5": float(np.mean(losses[:5])),
                          "loss_last5": float(np.mean(losses[-5:]))}
        out["optimizers"] = runs

        # (c) ring and Ulysses under a one-rank NCCL group against dense
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            group = dist.new_group([0])
            sequence.reset_calls()
            toks = torch.from_numpy(batch["tokens"]).cuda()
            dense = SeqLMTrainer(_seqlm_config(corpus, seed, attention="dense"),
                                 corpus_ids=card.corpus_ids, vocab_size=card.vocab_size)
            start = dense.init_state()
            want = dense.forward(start["params"], toks[:, :-1]).detach()
            stepped, dm = dense.train_step(map_tensors(start, lambda _, t: t.clone()),
                                           {"tokens": toks})
            attn = {}
            for attention in ("ring", "ulysses"):
                par = SeqLMTrainer(_seqlm_config(corpus, seed, attention=attention),
                                   corpus_ids=card.corpus_ids, vocab_size=card.vocab_size,
                                   seq_group=group)
                got = par.forward(start["params"], toks[:, :-1]).detach()
                st, pm = par.train_step(map_tensors(start, lambda _, t: t.clone()),
                                        {"tokens": toks})
                errs = {"logits": float((got - want).abs().max()),
                        "params": max(float((a - b).abs().max()) for a, b in zip(
                            param_leaves(st["params"]), param_leaves(stepped["params"]))),
                        "loss": abs(float(pm["loss"]) - float(dm["loss"]))}
                if max(errs.values()) > SEQLM_ATTENTION_TOL:
                    raise AssertionError(f"seqlm {attention}: {errs} beyond "
                                         f"{SEQLM_ATTENTION_TOL} of dense")
                attn[attention] = errs
            torch.cuda.synchronize()
            attn["group"] = {"backend": dist.get_backend(group),
                             "size": dist.get_world_size(group),
                             "calls": dict(sequence.CALLS)}
            if attn["group"]["calls"]["all_to_all"] == 0:
                raise AssertionError(f"seqlm: Ulysses made no all-to-all: {attn['group']}")
        finally:
            dist.destroy_process_group()
        out["attention"] = attn

        # (d) the CLI: an uninterrupted control in process, a run stopped by
        # a real SIGTERM after its first periodic save, and the same command
        # again, which resumes: its losses equal the control's bit for bit
        from swiftsnails_tpu_torch import cli

        cli_corpus, conf = os.path.join(tmp, "cli.txt"), os.path.join(tmp, "seqlm.conf")
        _write_text_corpus(cli_corpus, SEQLM_CLI_TOKENS, SEQLM_IDS, True, seed + 1)
        _write_seqlm_conf(conf, cli_corpus, seed)
        ctl = io.StringIO()
        with contextlib.redirect_stdout(ctl), contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(_seqlm_cli_args(conf, os.path.join(tmp, "control")))
        control = _loss_by_step(ctl.getvalue())
        if rc != 0 or len(control) < 2 * SEQLM_CLI_PERIOD + 2:
            raise AssertionError(f"seqlm cli: control exited {rc} after {sorted(control)}")
        root = os.path.join(tmp, "run")
        args = _seqlm_cli_args(conf, root)
        log = os.path.join(tmp, "first.out")

        def sigterm_due() -> bool:
            # after the first periodic save, mid-period (as phase_cli)
            last = _last_logged_step(log) if os.path.exists(log) else None
            return (last is not None and last > SEQLM_CLI_PERIOD
                    and 0 < last % SEQLM_CLI_PERIOD < SEQLM_CLI_PERIOD - 1)

        rc, out1, err1, first_s = _subprocess_cli(args, tmp, "first", until=sigterm_due)
        drain = _DRAIN_RE.findall(err1)
        if rc != 0 or "preempted (SIGTERM)" not in err1 or len(drain) != 1:
            raise AssertionError(f"seqlm cli: SIGTERM run exited {rc}: {err1[-3000:]}")
        res = io.StringIO()
        res_err = io.StringIO()
        with contextlib.redirect_stdout(res), contextlib.redirect_stderr(res_err):
            rc = cli.main(args)
        restored = _RESTORE_RE.findall(res_err.getvalue())
        first, resumed = _loss_by_step(out1), _loss_by_step(res.getvalue())
        final = int(drain[0][1])
        if rc != 0 or not restored or int(restored[0][0]) != final:
            raise AssertionError(f"seqlm cli: resumed run exited {rc}, restored {restored}")
        merged = {**{s: v for s, v in first.items() if s <= final}, **resumed}
        differ = sorted(s for s in control if merged.get(s) != control[s])
        out["cli"] = {"steps": max(control), "period": SEQLM_CLI_PERIOD, "drained_at": final,
                      "resumed_steps": [min(resumed), max(resumed)] if resumed else [],
                      "differing_steps": differ, "first_s": first_s}
        if differ or min(resumed) != final + 1:
            raise AssertionError(f"seqlm cli: losses after the resume differ at {differ}")
        out.update(seconds=time.monotonic() - t_phase, device=env["device"],
                   nvidia_smi=env["nvidia_smi"],
                   shape={"seq_len": card.seq_len, "n_layers": card.n_layers,
                          "n_heads": card.n_heads, "d_model": card.d_model,
                          "batch_size": card.batch_size, "vocab": card.vocab_size})
        emit("seqlm", **out)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- launch ---

LAUNCH_HOSTS = ("localhost", "localhost")  # two ranks on this host
LAUNCH_TOKENS = 1_800  # about MESH_GLOO_STEPS batches of MESH_GLOO_BATCH pairs
LAUNCH_TIMEOUT_S = 300


def phase_launch(seed: int, env: dict) -> dict:
    """Phase 22: the port's multi-host launcher (``python -m
    swiftsnails_tpu_torch.tools.launch_pod``) on a hosts file of two
    ``localhost`` lines, both ranks on gloo at ``-device cpu``. One card
    cannot hold two NCCL ranks (NCCL refuses two ranks on one device), so
    this phase checks the launch, not the card: ``RANK`` and ``LOCAL_RANK``
    a line, the rendezvous at ``-master_addr localhost:PORT``, the exit
    codes. The config is leg 2's (``_mesh_gloo_trainer``'s keys: dim 200,
    window 5, negatives 5, pool 64 a 512, lr ``LR``, batch 2,048, numpy
    batches) over a text corpus of ``LAUNCH_TOKENS`` zipf words
    (``MESH_GLOO_VOCAB`` ids), about ``MESH_GLOO_STEPS`` steps. Gates: the
    launcher exits 0; each rank prints its ``joined cluster`` line; both log
    the same finite loss at each step; rank 0 alone writes ``-output``."""
    import socket

    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="ssn-launch-")
    proc = None
    try:
        corpus = os.path.join(tmp, "corpus.txt")
        _write_text_corpus(corpus, LAUNCH_TOKENS, MESH_GLOO_VOCAB, False, seed)
        conf = os.path.join(tmp, "launch.conf")
        with open(conf, "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in {
                "model": "word2vec", "data": corpus, "dim": DIM, "window": WINDOW,
                "negatives": NEGATIVES, "subsample": 0, "num_iters": 1, "min_count": 1,
                "pool_size": POOL_SIZE, "pool_block": POOL_BLOCK, "learning_rate": LR,
                "batch_size": MESH_GLOO_BATCH, "seed": seed, "use_native": 0,
                "log_every": 1}.items()))
        hosts = os.path.join(tmp, "hosts")
        with open(hosts, "w") as f:
            f.write("# the launch phase: two ranks on this host\n" + "\n".join(LAUNCH_HOSTS))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        out = os.path.join(tmp, "vectors.txt")
        proc = subprocess.Popen(
            [sys.executable, "-m", "swiftsnails_tpu_torch.tools.launch_pod", hosts, conf,
             "-device", "cpu", "-init_timeout", "120", "-output", out],
            env={**os.environ, "SNAILS_COORD_PORT": str(port), "OMP_NUM_THREADS": "1"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
        # the ranks share the launcher's stderr: find each line's text whole
        joined = re.findall(r"joined cluster: process \d+/\d+ via \S+?:\d+", stderr)
        by_step: dict = {}
        for rec in _metric_records(stdout):
            by_step.setdefault(rec["step"], []).append(rec["loss"])
        seconds = time.monotonic() - t0
        header = open(out).readline().split() if os.path.exists(out) else None
        emit("launch", ranks=len(LAUNCH_HOSTS), exit_code=proc.returncode, joined=joined,
             steps=len(by_step), losses={s: v[0] for s, v in sorted(by_step.items())},
             output_header=header, backend="gloo", device="cpu", seconds=seconds)
        if proc.returncode != 0:
            raise AssertionError(f"launch: the launcher exited {proc.returncode}: "
                                 f"{stderr[-2000:]}")
        if sorted(ln.split("joined cluster: ")[1].split(" via")[0] for ln in joined) \
                != [f"process {r}/{len(LAUNCH_HOSTS)}" for r in range(len(LAUNCH_HOSTS))] \
                or any(f"via localhost:{port}" not in ln for ln in joined):
            raise AssertionError(f"launch: joined lines {joined}")
        if not by_step or any(len(v) != len(LAUNCH_HOSTS) or len(set(v)) != 1
                              or not math.isfinite(v[0]) for v in by_step.values()):
            raise AssertionError(f"launch: the ranks' losses {by_step}")
        if stderr.count(f"exported parameters to {out}") != 1 or header is None \
                or header[1] != str(DIM):
            raise AssertionError(f"launch: the output {header}: {stderr[-2000:]}")
    finally:
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
            proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"seconds": seconds}


# ------------------------------------------------------------------- mesh ---

MESH_STEPS = 10  # leg 1: the (1, 1) NCCL mesh at full width
MESH_PHASES = ("train", "train_dense")  # packed+pool, packed: 0
MESH_GLOO = {"data": 2, "model": 2}  # leg 2: four spawned gloo ranks
MESH_GLOO_VOCAB = 1 << 16
MESH_GLOO_BATCH = 2_048
MESH_GLOO_STEPS = 5
MESH_GLOO_TOKENS = 200_000
MESH_GLOO_TIMEOUT_S = 300
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6  # tests/test_rowdma.py:188-192
# where the gloo ranks keep their shards: gloo's all_reduce and list
# all_gather take CUDA tensors on torch 2.11, so the four ranks share the
# one card and launch the row kernels there
MESH_GLOO_DEVICE = "cuda"
# The grouped collective plane: fused-grouped's shape (train_grouped) under
# the (1, 1) NCCL mesh. It is the merged update, which sums every update of
# a row where the hogwild kernels keep about one a substep, so it takes the
# merged paths' smaller rate: train_sweep.py's mesh_grouped rows on the card
# (PERF.md, Findings) chose it.
MESH_GROUPED = "train_grouped"
MESH_GROUPED_LR = 100.0
MESH_GROUPED_SHORT = 2  # steps of the dedup and bucketed runs, from one start
# dedup and bucketed against the plain plane (tests/test_grouped_mesh.py's bound)
MESH_GROUPED_RTOL, MESH_GROUPED_ATOL = 2e-4, 2e-6
# a unique list as long as a substep's out slots (8,192 windows of 10 and
# 32 pools of 64) holds every distinct row: nothing overflows
MESH_GROUPED_COVER = GROUPED_BATCH * CW + (GROUPED_BATCH // CENTERS_PER_BLOCK) * POOL_SIZE
MESH_GROUPED_SLACK = 2.0
# leg 2's grouped routes at its cut size, 2 substeps a step; dedup's cap
# covers a (1, 1) mesh's substep, so neither mesh overflows
MESH_GLOO_SPC = 2
MESH_GLOO_GROUPED = {
    "grouped": {},
    "dedup": {"dedup": 1, "mesh_u_cap": MESH_GLOO_BATCH * CW
              + (MESH_GLOO_BATCH // CENTERS_PER_BLOCK) * POOL_SIZE},
    "overlap1": {"overlap": 1},
}


# leg 2's hybrid routes on the grouped plane, MESH_GROUPED_SHORT steps from
# one start: the tail at the dedup route's covering cap (nothing drops)
MESH_GLOO_HYBRID = {
    "uniform": {},
    "hybrid": {"placement": "hybrid", "placement_head_rows": HOT_ROWS,
               "placement_tail_cap": MESH_GLOO_GROUPED["dedup"]["mesh_u_cap"]},
}
MESH_GLOO_HYBRID["hybrid_zero"] = {**MESH_GLOO_HYBRID["hybrid"], "optimizer_sharding": "zero"}
MESH_GLOO_CTR_SAVE = 2  # the step leg 2's hybrid + zero W&D saves at and resumes from


def _mesh_gloo_trainer(seed: int, device: str, mesh=None, **over):
    """Leg 2's word2vec: packed+pool at dim 200 (the full row width), the
    vocabulary, batch and steps cut (``MESH_GLOO_*``), numpy batches
    (``over``: config keys on top)."""
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(seed)
    ids = zipf_ids(MESH_GLOO_TOKENS, MESH_GLOO_VOCAB, rng)
    counts = np.maximum(np.bincount(ids, minlength=MESH_GLOO_VOCAB), 1)
    cfg = Config({"dim": str(DIM), "window": str(WINDOW), "negatives": str(NEGATIVES),
                  "subsample": "0", "num_iters": "1", "pool_size": str(POOL_SIZE),
                  "pool_block": str(POOL_BLOCK), "learning_rate": str(LR),
                  "batch_size": str(MESH_GLOO_BATCH), "seed": str(seed), "use_native": "0",
                  **{k: str(v) for k, v in over.items()}})
    vocab = Vocab([f"w{i}" for i in range(MESH_GLOO_VOCAB)], counts)
    return Word2VecTrainer(cfg, mesh=mesh, corpus_ids=ids, vocab=vocab, device=device)


def _mesh_gloo_grouped_trainer(seed: int, device: str, mesh, **over):
    """Leg 2's grouped plane: fused-grouped's keys at dim 200 and 256
    centers a block, ``MESH_GLOO_BATCH`` centers a substep, ``MESH_GLOO_SPC``
    substeps a step, over leg 2's corpus."""
    from swiftsnails_tpu_torch.data.vocab import Vocab
    from swiftsnails_tpu_torch.models.word2vec import Word2VecTrainer
    from swiftsnails_tpu_torch.utils.config import Config

    rng = np.random.default_rng(seed)
    ids = zipf_ids(MESH_GLOO_TOKENS, MESH_GLOO_VOCAB, rng)
    counts = np.maximum(np.bincount(ids, minlength=MESH_GLOO_VOCAB), 1)
    conf = {"dim": DIM, "window": WINDOW, "negatives": NEGATIVES, "subsample": 0,
            "num_iters": 1, "pool_size": POOL_SIZE, "fused": 1, "grouped": 1,
            "centers_per_block": CENTERS_PER_BLOCK, "learning_rate": MESH_GROUPED_LR,
            "batch_size": MESH_GLOO_BATCH, "steps_per_call": MESH_GLOO_SPC, "seed": seed,
            "use_native": 0, **over}
    vocab = Vocab([f"w{i}" for i in range(MESH_GLOO_VOCAB)], counts)
    return Word2VecTrainer(Config({k: str(v) for k, v in conf.items()}), mesh=mesh,
                           corpus_ids=ids, vocab=vocab, device=device)


def _grouped_launches(steps: int, spc: int, overlap: int = 0) -> dict:
    """The grouped plane's row-kernel launches in ``steps`` steps: one
    ``gather_rows`` a pull (two pulls a substep, and ``overlap`` more a
    step), one ``scatter_add_rows`` a push (two a substep)."""
    return {"gather_rows": 2 * steps * (spc + overlap), "scatter_add_rows": 2 * steps * spc}


def _loss_loop(trainer, records=None) -> tuple:
    """A ``TrainLoop`` logging every step, and the list its losses go to
    (its whole records go to ``records`` too, where given)."""
    from swiftsnails_tpu_torch.framework.trainer import TrainLoop
    from swiftsnails_tpu_torch.utils.metrics import MetricsLogger

    losses = []

    class Recorder(MetricsLogger):
        def log(self, record):
            # a guardrail trip drops a non-finite loss from its line
            losses.append(record.get("loss"))
            if records is not None:
                records.append(record)

    return TrainLoop(trainer, metrics=Recorder(), log_every=1), losses


def _mesh_gloo_rank(rank: int, size: int, init: str, out_dir: str, seed: int) -> None:
    """One rank of leg 2 (a spawned process): join the gloo group, make
    the (2, 2) mesh, train ``MESH_GLOO_STEPS`` steps, save its shards,
    losses, collective counts and launches."""
    import traceback

    import torch.distributed as dist

    from swiftsnails_tpu_torch.parallel import transfer
    from swiftsnails_tpu_torch.parallel.mesh import make_mesh

    out, sections = {}, {}
    t0 = time.monotonic()

    def lap(name):
        nonlocal t0
        sections[name] = time.monotonic() - t0
        t0 = time.monotonic()

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=size)
        mesh = make_mesh(MESH_GLOO, device=MESH_GLOO_DEVICE)
        lap("join")
        loop, losses = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh))
        transfer.reset_comm()
        state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=MESH_GLOO_STEPS))
        out = {"coords": mesh.coords, "tables": [t.table.cpu() for t in state],
               "losses": losses, "comm": dict(transfer.COMM), "launches": launches,
               "backend": dist.get_backend(mesh.groups["model"])}
        del state
        lap("packed")
        for route, over in MESH_GLOO_GROUPED.items():
            records = []
            loop, losses = _loss_loop(
                _mesh_gloo_grouped_trainer(seed, MESH_GLOO_DEVICE, mesh, **over), records)
            state, launches = _run_counted(
                lambda: loop.run(seed=seed, max_steps=MESH_GLOO_STEPS))
            out[route] = {"tables": [t.table.cpu() for t in state], "losses": losses,
                          "launches": launches,
                          "dropped": [r.get("dedup_dropped") for r in records]}
            del state
        lap("grouped")
        wd = _mesh_ctr_run(seed, _mesh_gloo_ctr_data(seed), mesh, MESH_GLOO_CTR_STEPS,
                           over=MESH_GLOO_CTR_OVER,
                           param_backup_root=os.path.join(out_dir, "ck-gloo-widedeep"),
                           param_backup_period=MESH_GLOO_CTR_STEPS)
        out["widedeep"] = {"state": {k: t.cpu() for k, t in _tensor_items(wd["state"])},
                           "losses": wd["losses"], "launches": wd["launches"]}
        del wd
        lap("widedeep")
        out["hybrid"] = _gloo_hybrid_runs(seed, mesh)
        lap("hybrid")
        out["ctr_layouts"] = _gloo_ctr_layouts(seed, mesh, out_dir)
        lap("ctr_layouts")
        wire_dev = _gloo_wire_device(mesh)
        wire_mesh = mesh if wire_dev == MESH_GLOO_DEVICE else make_mesh(MESH_GLOO, device=wire_dev)
        out["wire_device"] = wire_dev
        out["wire"] = _gloo_wire_runs(seed, wire_mesh, wire_dev)
        lap("wire")
        seq = make_mesh(MESH_SEQLM, device=MESH_SEQLM_DEVICE)
        out["seqlm"] = _mesh_seqlm_run(seed, MESH_SEQLM_DEVICE, seq)
        out["seq_coords"] = seq.coords
        lap("seqlm")
        out["tier"] = _gloo_tier_runs(seed, mesh, out_dir)
        lap("tier")
        out["guards"] = _gloo_guard_runs(seed, mesh, out_dir)
        lap("guards")
        out["serve"] = _gloo_serve(seed)
        lap("serve")
        out["sections_s"] = sections
        dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _gloo_hybrid_runs(seed: int, mesh) -> dict:
    """Leg 2's grouped plane on this rank under each of ``MESH_GLOO_HYBRID``
    ``MESH_GROUPED_SHORT`` steps: tables, losses, launches, dropped counts."""
    out = {}
    for name, over in MESH_GLOO_HYBRID.items():
        records = []
        loop, losses = _loss_loop(
            _mesh_gloo_grouped_trainer(seed, MESH_GLOO_DEVICE, mesh, **over), records)
        state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=MESH_GROUPED_SHORT))
        out[name] = {"tables": [t.table.cpu() for t in state], "losses": losses,
                     "launches": launches,
                     "dropped": [r.get("hybrid_dropped") for r in records],
                     "zero": loop.zero.summary() if loop.zero is not None else None}
        del state
    return out


def _gloo_ctr_layouts(seed: int, mesh, out_dir: str) -> dict:
    """Leg 2's W&D on this rank: ``optimizer_sharding: zero`` and ``dense_tp:
    1`` ``MESH_GLOO_CTR_STEPS`` steps each (the arrays, the planes this
    rank holds under zero); then ``placement: hybrid`` with zero: one start
    state saved in the uniform layout and through the split and zero's
    slices (the manifests' CRCs), and a run saved at ``MESH_GLOO_CTR_SAVE``
    and resumed beside the straight run."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.parallel.placement import PlacementManager
    from swiftsnails_tpu_torch.parallel.zero import ZeroManager

    data = _mesh_gloo_ctr_data(seed)
    out = {}
    for name in ("zero", "dense_tp"):
        run = _mesh_ctr_run(seed, data, mesh, MESH_GLOO_CTR_STEPS, over=MESH_GLOO_CTR_OVER,
                            **MESH_CTR_LAYOUTS[name])
        out[name] = {"state": {k: t.cpu() for k, t in _tensor_items(run["state"])},
                     "losses": run["losses"], "launches": run["launches"]}
        if name == "zero":
            tr = run["trainer"]
            zm = ZeroManager(tr, mesh)
            held = zm.adopt(tr.init_state())
            out[name]["held"] = {k: list(t.shape) for k, t in _tensor_items(held)
                                 if k.startswith("opt/")}
            out[name]["summary"] = zm.summary()
        del run
    keys = {"placement": "hybrid", "optimizer_sharding": "zero"}
    cfg = _widedeep_config(seed)
    for k, v in {**MESH_GLOO_CTR_OVER, **keys}.items():
        cfg.set(k, str(v))
    tr = get_model("widedeep")(cfg, mesh=mesh, data=data)
    state = tr.init_state()
    roots = {name: os.path.join(out_dir, f"ck-gloo-layout-{name}") for name in ("uniform",
                                                                                 "split")}
    ckpt.save_checkpoint(roots["uniform"], state, 0, mesh=mesh)
    pm, zm = PlacementManager(tr, mesh), ZeroManager(tr, mesh)
    split = zm.adopt(pm.adopt(state))
    ckpt.save_checkpoint(roots["split"], split, 0, mesh=mesh, placement=pm, zero=zm)
    out["crcs"] = {name: _crcs(ckpt.read_manifest(root, 0)) for name, root in roots.items()}
    del state, split
    root = os.path.join(out_dir, "ck-gloo-hybrid-zero")
    runs = {}
    for name, steps, extra in (
            ("straight", MESH_GLOO_CTR_STEPS, {}),
            ("saved", MESH_GLOO_CTR_SAVE, {"param_backup_root": root,
                                           "param_backup_period": MESH_GLOO_CTR_SAVE}),
            ("resumed", MESH_GLOO_CTR_STEPS, {"param_backup_root": root,
                                              "param_backup_period": 100,
                                              "resume": "auto"})):
        run = _mesh_ctr_run(seed, data, mesh, steps, over=MESH_GLOO_CTR_OVER, **keys, **extra)
        runs[name] = {"state": {k: t.cpu() for k, t in _tensor_items(run["state"])},
                      "losses": run["losses"], "cut": run["trainer"].placement_cut}
        del run
    out["resume"] = runs
    torch.cuda.empty_cache()
    return out


def _gloo_hybrid_check(by: dict) -> dict:
    """Leg 2's hybrid grouped plane against uniform (within
    ``MESH_GROUPED_RTOL`` / ``MESH_GROUPED_ATOL``, nothing dropped, each
    rank's launches the plain plane's) and with zero bit-equal to it."""
    def whole(route, i):
        return [torch.cat([by[(i, j)]["hybrid"][route]["tables"][k]
                           for j in range(MESH_GLOO["model"])]) for k in range(2)]

    errs = []
    for i in range(MESH_GLOO["data"]):
        got, want = whole("hybrid", i), whole("uniform", i)
        for a, b in zip(got, want):
            errs.append(float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=MESH_GROUPED_RTOL, atol=MESH_GROUPED_ATOL):
                raise AssertionError(f"mesh gloo hybrid: data replica {i} is {errs[-1]} "
                                     "from uniform")
        if not all(torch.equal(a, b) for a, b in zip(whole("hybrid_zero", i), got)):
            raise AssertionError(f"mesh gloo hybrid zero: data replica {i} differs from "
                                 "the replicated head push (bit-equal expected)")
    want_launches = _grouped_launches(MESH_GROUPED_SHORT, MESH_GLOO_SPC)
    for key, res in by.items():
        for route in MESH_GLOO_HYBRID:
            _check_launches(f"mesh gloo {route} rank {key}", res["hybrid"][route]["launches"],
                            want_launches)
        if any(res["hybrid"]["hybrid"]["dropped"]):
            raise AssertionError(f"mesh gloo hybrid: rows dropped {res['hybrid']['hybrid']}")
    mine = by[(0, 0)]["hybrid"]
    return {"steps": MESH_GROUPED_SHORT, "keys": MESH_GLOO_HYBRID["hybrid"],
            "max_abs_err": max(errs), "losses": mine["hybrid"]["losses"],
            "uniform_losses": mine["uniform"]["losses"],
            "zero_bit_equal": True, "zero": mine["hybrid_zero"]["zero"]}


def _gloo_ctr_layouts_check(by: dict) -> dict:
    """Leg 2's W&D: zero bit-equal to the replicated run (``widedeep``),
    each rank holding ``1 / data`` of each sharded plane; ``dense_tp: 1``
    against it (:func:`_ctr_close`); the hybrid +
    zero layouts' CRCs a uniform save's; the resume bit-equal to the
    straight run."""
    from swiftsnails_tpu_torch.parallel.zero import zero_plane_spec

    sharded = ("table/table", "table/slots/accum")

    def whole(get, i):
        first = get(by[(i, 0)])
        return {k: (torch.cat([get(by[(i, j)])[k] for j in range(MESH_GLOO["model"])])
                    if k in sharded else t) for k, t in first.items()}

    out = {}
    for i in range(MESH_GLOO["data"]):
        want = whole(lambda r: r["widedeep"]["state"], i)
        zero = whole(lambda r: r["ctr_layouts"]["zero"]["state"], i)
        for k, w in want.items():
            if not torch.equal(zero[k], w):
                raise AssertionError(f"mesh gloo widedeep zero: {k} of data replica {i} "
                                     "differs from the replicated run (bit-equal expected)")
        tp = whole(lambda r: r["ctr_layouts"]["dense_tp"]["state"], i)
        out[f"dense_tp_replica{i}"] = _ctr_close(f"mesh gloo widedeep dense_tp replica {i}",
                                                 tp, want, MESH_GLOO_CTR_STEPS)
        straight = whole(lambda r: r["ctr_layouts"]["resume"]["straight"]["state"], i)
        resumed = whole(lambda r: r["ctr_layouts"]["resume"]["resumed"]["state"], i)
        for k, t in straight.items():
            if not torch.equal(resumed[k], t):
                raise AssertionError(f"mesh gloo widedeep hybrid+zero resumed: {k} differs "
                                     "from the straight run")
    for key, res in by.items():
        lay = res["ctr_layouts"]
        if lay["crcs"]["split"] != lay["crcs"]["uniform"]:
            raise AssertionError(f"mesh gloo widedeep rank {key}: the hybrid + zero save's "
                                 "CRCs differ from the uniform save's")
        for k, shape in lay["zero"]["held"].items():
            whole = list(res["widedeep"]["state"][k].shape)
            if zero_plane_spec(whole, MESH_GLOO["data"]):
                whole[0] //= MESH_GLOO["data"]
            if shape != whole:
                raise AssertionError(f"mesh gloo widedeep zero rank {key}: {k} held {shape}")
        for name in ("zero", "dense_tp"):
            per_step = {k: n * MESH_GLOO_CTR_STEPS for k, n in MESH_CTR_LAUNCHES.items()}
            _check_launches(f"mesh gloo widedeep {name} rank {key}", lay[name]["launches"],
                            per_step)
    mine = by[(0, 0)]["ctr_layouts"]
    return {**out, "zero_bit_equal": True, "zero_summary": mine["zero"]["summary"],
            "zero_held": mine["zero"]["held"], "crcs_equal_uniform": True,
            "arrays": len(mine["crcs"]["uniform"]), "resume_bit_equal": True,
            "saved_at": MESH_GLOO_CTR_SAVE, "cut": mine["resume"]["straight"]["cut"],
            "losses": {k: list(v["losses"].values()) for k, v in mine["resume"].items()}}


def _mesh_gloo_spawn(seed: int, tmp: str) -> dict:
    """Start leg 2's four rank processes. They need nothing of leg 1, so
    they run while it does; :func:`_mesh_gloo_leg` joins them."""
    import multiprocessing as mp

    size = MESH_GLOO["data"] * MESH_GLOO["model"]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_gloo_rank,
                         args=(r, size, f"file://{tmp}/gloo-rendezvous", tmp, seed))
             for r in range(size)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    return {"procs": procs, "t0": t0}


def _mesh_gloo_stop(ranks: dict) -> None:
    for p in ranks["procs"]:
        if p.is_alive():
            p.kill()
            p.join()


def _mesh_gloo_leg(seed: int, tmp: str, solo, ranks: dict) -> dict:
    """Leg 2: four spawned processes (``ranks``, from
    :func:`_mesh_gloo_spawn`), a (2, 2) gloo mesh, packed+pool against the
    one-device port on ``MESH_GLOO_DEVICE`` and the grouped plane's routes
    against the same on ``solo``, the (1, 1) NCCL mesh."""
    size = MESH_GLOO["data"] * MESH_GLOO["model"]
    procs, t0 = ranks["procs"], ranks["t0"]
    t_join = time.monotonic()
    for p in procs:  # the phase kills a rank left alive
        p.join(max(1.0, MESH_GLOO_TIMEOUT_S - (time.monotonic() - t0)))
        if p.is_alive():
            raise AssertionError(f"mesh gloo: a rank outlived {MESH_GLOO_TIMEOUT_S} s")
    spawn_s = time.monotonic() - t0
    join_wait_s = time.monotonic() - t_join
    results = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(size)]
    for r, res in enumerate(results):
        if "error" in res:
            raise AssertionError(f"mesh gloo rank {r}:\n{res['error']}")
    loop, losses = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE))
    want = loop.run(seed=seed, max_steps=MESH_GLOO_STEPS)
    by = {(r["coords"]["data"], r["coords"]["model"]): r for r in results}
    errs = []
    for k, ts in enumerate(want):
        w = ts.table.cpu()
        for i in range(MESH_GLOO["data"]):
            got = torch.cat([by[(i, j)]["tables"][k] for j in range(MESH_GLOO["model"])])
            errs.append(float((got - w).abs().max()))
            if not torch.allclose(got, w, rtol=MESH_RTOL, atol=MESH_ATOL):
                raise AssertionError(f"mesh gloo: table {k} of data replica {i} is "
                                     f"{errs[-1]} from the one-device port's")
    got_losses = by[(0, 0)]["losses"]
    if not np.allclose(got_losses, losses, rtol=MESH_RTOL, atol=MESH_ATOL):
        raise AssertionError(f"mesh gloo: losses {got_losses}, one device {losses}")
    substeps = MESH_GLOO_STEPS
    want_launches = ({"gather_rows": 2 * substeps, "scatter_add_rows": 2 * substeps}
                     if MESH_GLOO_DEVICE == "cuda" else {})
    for r, res in enumerate(results):
        _check_launches(f"mesh gloo rank {r}", res["launches"], want_launches)
    del want
    grouped = {}
    for route, over in MESH_GLOO_GROUPED.items():
        records = []
        loop, solo_losses = _loss_loop(
            _mesh_gloo_grouped_trainer(seed, MESH_GLOO_DEVICE, solo, **over), records)
        ref = loop.run(seed=seed, max_steps=MESH_GLOO_STEPS)
        route_errs = []
        for k, ts in enumerate(ref):
            w = ts.table.cpu()
            for i in range(MESH_GLOO["data"]):
                got = torch.cat([by[(i, j)][route]["tables"][k]
                                 for j in range(MESH_GLOO["model"])])
                route_errs.append(float((got - w).abs().max()))
                if not torch.allclose(got, w, rtol=MESH_RTOL, atol=MESH_ATOL):
                    raise AssertionError(f"mesh gloo {route}: table {k} of data replica {i} "
                                         f"is {route_errs[-1]} from the (1, 1) mesh's")
        del ref
        mine = by[(0, 0)][route]
        if not np.allclose(mine["losses"], solo_losses, rtol=MESH_RTOL, atol=MESH_ATOL):
            raise AssertionError(f"mesh gloo {route}: losses {mine['losses']}, "
                                 f"(1, 1) mesh {solo_losses}")
        dropped = [r.get("dedup_dropped") for r in records]
        if any(dropped) or any(mine["dropped"]):
            raise AssertionError(f"mesh gloo {route}: rows dropped {mine['dropped']} "
                                 f"/ {dropped} under a covering cap")
        want_launches = _grouped_launches(MESH_GLOO_STEPS, MESH_GLOO_SPC,
                                          over.get("overlap", 0))
        for r, res in enumerate(results):
            _check_launches(f"mesh gloo {route} rank {r}", res[route]["launches"],
                            want_launches)
        grouped[route] = {"max_abs_err": max(route_errs), "losses": mine["losses"],
                          "solo_losses": solo_losses, "dropped": mine["dropped"],
                          "launches_by_rank": [{k: r[route]["launches"][k]
                                                for k in want_launches} for r in results]}
        torch.cuda.empty_cache()
    widedeep = _mesh_gloo_widedeep(seed, by, solo, tmp)
    hybrid = _gloo_hybrid_check(by)
    layouts = _gloo_ctr_layouts_check(by)
    wire = _gloo_wire_check(seed, by, solo)
    seqlm = _mesh_gloo_seqlm(seed, results)
    tier = _gloo_tier_check(results)
    guards = _gloo_guards_check(results)
    return {"device": MESH_GLOO_DEVICE, "backend": results[0]["backend"],
            "mesh": MESH_GLOO, "ranks": size, "steps": MESH_GLOO_STEPS,
            "widedeep": widedeep, "hybrid": hybrid, "ctr_layouts": layouts, "wire": wire,
            "seqlm": seqlm, "tier": tier, "guards": guards,
            "reduced": {"vocab": [MESH_GLOO_VOCAB, VOCAB],
                        "batch": [MESH_GLOO_BATCH, BATCH],
                        "grouped_centers": [MESH_GLOO_BATCH, GROUPED_BATCH],
                        "grouped_steps_per_call": [MESH_GLOO_SPC, FUSED_STEPS_PER_CALL],
                        "steps": [MESH_GLOO_STEPS, MESH_STEPS],
                        "corpus_tokens": [MESH_GLOO_TOKENS, N_TOKENS],
                        "widedeep_capacity": [MESH_GLOO_CTR_CAPACITY,
                                              _widedeep_config(seed).get_int("capacity")],
                        "widedeep_batch": [MESH_GLOO_BATCH,
                                           _widedeep_config(seed).get_int("batch_size")],
                        "widedeep_steps": [MESH_GLOO_CTR_STEPS, MESH_CTR_STEPS],
                        "seqlm_steps": [MESH_SEQLM_STEPS, SEQLM_STEPS],
                        "seqlm_corpus_tokens": [MESH_SEQLM_TOKENS, SEQLM_TOKENS]},
            "max_abs_err": max(errs), "rtol": MESH_RTOL, "atol": MESH_ATOL,
            "losses": got_losses, "one_device_losses": losses,
            "grouped": grouped, "grouped_lr": MESH_GROUPED_LR,
            "comm_by_rank": [r["comm"] for r in results],
            "launches_by_rank": [{k: r["launches"][k] for k in ("gather_rows",
                                                                "scatter_add_rows")}
                                 for r in results],
            "seconds": time.monotonic() - t_join, "spawn_s": spawn_s, "join_wait_s": join_wait_s,
            "rank_sections_s": results[0]["sections_s"]}


def _tensor_items(state):
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    return tensor_items(state)


def _mesh_gloo_widedeep(seed: int, by: dict, solo, tmp: str) -> dict:
    """Leg 2's W&D: the (2, 2) ranks' arrays (tables and slots from the
    model shards of each data replica, the rest whole) within
    ``MESH_RTOL`` / ``MESH_ATOL`` of the same trainer on ``solo``, the
    (1, 1) NCCL mesh, each rank's launches one of each row kernel a step;
    their checkpoint restored onto one device on the card, bit-equal to the
    gathered shards."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt
    from swiftsnails_tpu_torch.models.registry import get_model

    data = _mesh_gloo_ctr_data(seed)
    ref = _mesh_ctr_run(seed, data, solo, MESH_GLOO_CTR_STEPS, over=MESH_GLOO_CTR_OVER)
    want = {k: t.cpu() for k, t in _tensor_items(ref["state"])}
    sharded = ("table/table", "table/slots/accum")
    errs = []
    for i in range(MESH_GLOO["data"]):
        got = {k: (torch.cat([by[(i, j)]["widedeep"]["state"][k]
                              for j in range(MESH_GLOO["model"])]) if k in sharded else t)
               for k, t in by[(i, 0)]["widedeep"]["state"].items()}
        for k, w in want.items():
            errs.append(float((got[k] - w).abs().max()))
            if not torch.allclose(got[k], w, rtol=MESH_RTOL, atol=MESH_ATOL):
                raise AssertionError(f"mesh gloo widedeep: {k} of data replica {i} is "
                                     f"{errs[-1]} from the (1, 1) mesh's")
    losses = by[(0, 0)]["widedeep"]["losses"]
    if not np.allclose(list(losses.values()), list(ref["losses"].values()),
                       rtol=MESH_RTOL, atol=MESH_ATOL):
        raise AssertionError(f"mesh gloo widedeep: losses {losses}, (1, 1) {ref['losses']}")
    per_step = {k: n * MESH_GLOO_CTR_STEPS for k, n in MESH_CTR_LAUNCHES.items()}
    for key, res in by.items():
        _check_launches(f"mesh gloo widedeep rank {key}", res["widedeep"]["launches"], per_step)
    cfg = _widedeep_config(seed)
    for k, v in MESH_GLOO_CTR_OVER.items():
        cfg.set(k, str(v))
    template = get_model("widedeep")(cfg, data=data).init_state()
    restored = ckpt.restore_checkpoint(os.path.join(tmp, "ck-gloo-widedeep"), template,
                                       step=MESH_GLOO_CTR_STEPS)
    gathered = {k: (torch.cat([by[(0, j)]["widedeep"]["state"][k]
                               for j in range(MESH_GLOO["model"])]) if k in sharded else t)
                for k, t in by[(0, 0)]["widedeep"]["state"].items()}
    for k, t in _tensor_items(restored):
        if not torch.equal(t.cpu(), gathered[k]):
            raise AssertionError(f"mesh gloo widedeep: {k} restored onto one device is not "
                                 "the gathered shards")
    out = {"table": list(want["table/table"].shape), "steps": MESH_GLOO_CTR_STEPS,
           "max_abs_err": max(errs), "losses": list(losses.values()),
           "solo_losses": list(ref["losses"].values()),
           "launches_by_rank": [{k: by[key]["widedeep"]["launches"][k]
                                 for k in MESH_CTR_LAUNCHES} for key in sorted(by)],
           "restored_one_device_bit_equal": True}
    del ref, restored, template
    torch.cuda.empty_cache()
    return out


def _mesh_gloo_seqlm(seed: int, results: list) -> dict:
    """Leg 2's seqlm: every rank's parameters and losses after
    ``MESH_SEQLM_STEPS`` ring steps on the (data 2, seq 2) mesh within
    ``MESH_SEQLM_TOL`` of one device's dense run on the card."""
    want = _mesh_seqlm_run(seed, "cuda")
    errs = []
    for r in results:
        got = r["seqlm"]
        errs.append(max(float((a - b).abs().max())
                        for a, b in zip(got["params"], want["params"])))
        close = all(torch.allclose(a, b, rtol=MESH_SEQLM_TOL, atol=MESH_SEQLM_TOL)
                    for a, b in zip(got["params"], want["params"]))
        if not close or not np.allclose(got["losses"], want["losses"], rtol=MESH_SEQLM_TOL,
                                        atol=MESH_SEQLM_TOL):
            raise AssertionError(f"mesh gloo seqlm: rank {r['seq_coords']} is {errs[-1]} "
                                 f"from dense, losses {got['losses']} / {want['losses']}")
    return {"mesh": MESH_SEQLM, "device": MESH_SEQLM_DEVICE, "attention": "ring",
            "shape": want["shape"], "steps": MESH_SEQLM_STEPS, "max_abs_err": max(errs),
            "losses": results[0]["seqlm"]["losses"], "dense_losses": want["losses"],
            "tol": MESH_SEQLM_TOL}


@contextlib.contextmanager
def _nccl_mesh(tmp: str):
    """A (1, 1) mesh of a one-rank NCCL group, destroyed on exit."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl-rendezvous",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_mesh({"data": 1, "model": 1})
    finally:
        dist.destroy_process_group()


def _mesh_nccl_leg(seed: int, corpora, mesh, keep: dict) -> dict:
    """Leg 1: ``Word2VecTrainer(mesh=...)`` under ``TrainLoop`` on a (1, 1)
    mesh of a one-rank NCCL group, at full width, against the unmeshed
    run of the same steps: tables bit-equal, launches equal. ``keep``
    gets the meshed packed+pool run's tables (on the host) and losses,
    the tier leg's resident meshed run."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.parallel import transfer

    out = {}
    for phase in MESH_PHASES:
        runs = {}
        for name, m in (("one_device", None), ("mesh", mesh)):
            trainer, loop, records = _train_loop(phase, seed, corpora, mesh=m)
            transfer.reset_comm()
            state, launches = _run_counted(lambda: loop.run(seed=seed,
                                                            max_steps=MESH_STEPS))
            runs[name] = {"state": state, "launches": launches,
                          "comm": dict(transfer.COMM),
                          "step_ms_median": statistics.median(
                              r["seconds"] * 1e3 for r in records[1:]),
                          "losses": [r["loss"] for r in records]}
            if phase == "train" and name == "mesh":
                keep.update(tables=_table_on_cpu(state), losses=runs[name]["losses"],
                            step_ms_median=runs[name]["step_ms_median"])
            del trainer, loop
        diff = max(float((a.table - b.table).abs().max())
                   for a, b in zip(runs["mesh"]["state"], runs["one_device"]["state"]))
        equal = all(torch.equal(a.table, b.table)
                    for a, b in zip(runs["mesh"]["state"], runs["one_device"]["state"]))
        table = list(runs["mesh"]["state"].in_table.table.shape)
        finite = all(bool(torch.isfinite(t.table).all()) for t in runs["mesh"]["state"])
        for r in runs.values():
            del r["state"]
        torch.cuda.empty_cache()
        if not equal or not finite:
            raise AssertionError(f"mesh {phase}: the (1, 1) mesh's tables are {diff} "
                                 "from the unmeshed run's (bit-equal expected)")
        if runs["mesh"]["launches"] != runs["one_device"]["launches"]:
            raise AssertionError(f"mesh {phase}: launches {runs['mesh']['launches']}, "
                                 f"unmeshed {runs['one_device']['launches']}")
        if runs["mesh"]["comm"]["all_reduce_calls"] == 0:
            raise AssertionError(f"mesh {phase}: no collective made")
        out[phase] = {
            "table": table, "steps": MESH_STEPS, "max_abs_diff": diff,
            "bit_equal": equal, "backend": dist.get_backend(mesh.groups["model"]),
            "nccl": runs["mesh"]["comm"],
            "launches": {k: runs["mesh"]["launches"][k]
                         for k in ("gather_rows", "scatter_add_rows")},
            "one_device_launches": {k: runs["one_device"]["launches"][k]
                                    for k in ("gather_rows", "scatter_add_rows")},
            "step_ms_median": runs["mesh"]["step_ms_median"],
            "one_device_step_ms_median": runs["one_device"]["step_ms_median"],
            "losses": runs["mesh"]["losses"]}
    torch.cuda.synchronize()
    return out


def _mesh_grouped_run(seed: int, corpora, mesh, steps: int, keep: bool = False,
                      **extra) -> dict:
    """``MESH_GROUPED``'s config at ``MESH_GROUPED_LR`` (and ``extra``)
    under ``mesh``, the grouped collective plane (unmeshed: the grouped
    kernel), ``steps`` steps of ``TrainLoop``: losses (finite), the counted
    launches, the collectives' result bytes against ``step_cost``'s, the
    median step ms past the first, the dropped counts; the state where
    ``keep``."""
    from swiftsnails_tpu_torch.parallel import transfer

    trainer, loop, records = _train_loop(MESH_GROUPED, seed, corpora, mesh=mesh,
                                         learning_rate=MESH_GROUPED_LR, **extra)
    transfer.reset_comm()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=steps))
    n = trainer.batch_size * trainer.steps_per_call
    shape = {"centers": np.zeros(n, np.int32), "contexts": np.zeros((n, CW), np.int32)}
    step_bytes = trainer.step_cost(shape)["total_bytes"]
    losses = [r["loss"] for r in records]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh grouped {extra}: losses {losses}")
    if not all(bool(torch.isfinite(t.table).all()) for t in state):
        raise AssertionError(f"mesh grouped {extra}: a table is not finite")
    out = {"losses": losses, "launches": launches,
           "comm_bytes": transfer.comm_bytes(),
           "step_cost_bytes": None if step_bytes is None else steps * step_bytes,
           "step_ms_median": statistics.median(r["seconds"] * 1e3 for r in records[1:]),
           "dropped": [r.get("dedup_dropped", r.get("push_dropped", r.get("hybrid_dropped")))
                       for r in records],
           "decision": trainer.placement_decision}
    if mesh is not None and out["comm_bytes"] != out["step_cost_bytes"]:
        raise AssertionError(f"mesh grouped {extra}: {out['comm_bytes']} collective bytes "
                             f"counted, step_cost {out['step_cost_bytes']}")
    if keep:
        out["state"] = state
    del trainer, loop, state
    torch.cuda.empty_cache()
    return out


def _tables_close(what: str, got, want) -> float:
    """The largest difference of two states' tables; fails past
    ``MESH_GROUPED_RTOL`` / ``MESH_GROUPED_ATOL``."""
    diff = max(float((a.table - b.table).abs().max()) for a, b in zip(got, want))
    if not all(torch.allclose(a.table, b.table, rtol=MESH_GROUPED_RTOL, atol=MESH_GROUPED_ATOL)
               for a, b in zip(got, want)):
        raise AssertionError(f"mesh grouped {what}: tables {diff} from the plain plane's")
    return diff


def _falls(what: str, losses) -> None:
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"mesh grouped {what}: the loss did not fall: {losses}")


def _mesh_grouped_leg(seed: int, corpora, mesh) -> dict:
    """Leg 1's grouped plane on the (1, 1) NCCL mesh at fused-grouped's full
    width: the plain plane ``MESH_STEPS`` steps (falling, 2 launches of each
    row kernel a substep, the collective bytes = ``step_cost``'s); dedup at
    ``U_CAP``'s auto cap (its overflow reported), dedup at a covering cap and
    the bucketed push ``MESH_GROUPED_SHORT`` steps from the same start,
    each within ``MESH_GROUPED_RTOL`` / ``MESH_GROUPED_ATOL`` of the plain
    plane's; ``overlap`` 1 and 2 ``MESH_STEPS`` steps (falling); the median
    step ms of each beside the unmeshed fused-grouped's."""
    spc = FUSED_STEPS_PER_CALL
    out = {"lr": MESH_GROUPED_LR, "steps": MESH_STEPS, "steps_per_call": spc,
           "table": [VOCAB, -(-DIM // 128), 128], "centers": GROUPED_BATCH}
    plain = _mesh_grouped_run(seed, corpora, mesh, MESH_STEPS)
    _check_launches("mesh grouped", plain["launches"], _grouped_launches(MESH_STEPS, spc))
    _falls("plain", plain["losses"])
    out["plain"] = plain
    one = _mesh_grouped_run(seed, corpora, None, MESH_STEPS)
    _check_launches("unmeshed grouped", one["launches"],
                    {"fused_sgns_grouped_step": MESH_STEPS * spc})
    out["unmeshed_grouped_step_ms_median"] = one["step_ms_median"]
    short = _mesh_grouped_run(seed, corpora, mesh, MESH_GROUPED_SHORT, keep=True)
    auto = _mesh_grouped_run(seed, corpora, mesh, MESH_GROUPED_SHORT, dedup=1, u_cap=U_CAP)
    out["dedup_auto_cap"] = {"u_cap": U_CAP, "dropped": auto["dropped"],
                             "step_ms_median": auto["step_ms_median"]}
    for name, extra in (("dedup", {"dedup": 1, "u_cap": U_CAP,
                                   "mesh_u_cap": MESH_GROUPED_COVER}),
                        ("bucketed", {"push_mode": "bucketed",
                                      "bucket_slack": MESH_GROUPED_SLACK})):
        run = _mesh_grouped_run(seed, corpora, mesh, MESH_GROUPED_SHORT, keep=True, **extra)
        _check_launches(f"mesh grouped {name}", run["launches"],
                        _grouped_launches(MESH_GROUPED_SHORT, spc))
        run["max_abs_diff"] = _tables_close(name, run.pop("state"), short["state"])
        if not np.allclose(run["losses"], short["losses"], rtol=MESH_GROUPED_RTOL,
                           atol=MESH_GROUPED_ATOL):
            raise AssertionError(f"mesh grouped {name}: losses {run['losses']}, plain "
                                 f"{short['losses']}")
        out[name] = {**run, "keys": extra}
    del short["state"]
    for depth in (1, 2):
        run = _mesh_grouped_run(seed, corpora, mesh, MESH_STEPS, overlap=depth)
        _check_launches(f"mesh grouped overlap {depth}", run["launches"],
                        _grouped_launches(MESH_STEPS, spc, depth))
        _falls(f"overlap {depth}", run["losses"])
        out[f"overlap{depth}"] = run
    torch.cuda.empty_cache()
    return out


# Leg 1's hybrid placement: the grouped plane of _mesh_grouped_leg with its
# head the resident paths' HOT_ROWS, the tail at a covering cap (nothing
# drops), against the plain plane from the same start; then placement: auto
MESH_HYBRID = {"placement": "hybrid", "placement_head_rows": HOT_ROWS,
               "placement_tail_cap": MESH_GROUPED_COVER}
# W&D's layouts on the (1, 1) mesh (trivial on one rank: each equal to the
# uniform meshed run) and on leg 2's ranks
MESH_CTR_LAYOUTS = {"hybrid": {"placement": "hybrid"},
                    "zero": {"optimizer_sharding": "zero"}, "dense_tp": {"dense_tp": 1}}
MESH_CTR_LAYOUT_STEPS = 5
# a layout that changes the sums' order (hybrid's head merge, dense_tp's
# split products) against the uniform run: tests/test_hybrid_placement.py's bound
MESH_HYBRID_RTOL, MESH_HYBRID_ATOL = 1e-4, 1e-5


def _ctr_close(what: str, got: dict, want: dict, steps: int) -> dict:
    """Two W&D runs whose sums differ in order (a hybrid head's merge,
    ``dense_tp``'s split products), array by array: the dense tensors and
    the AdaGrad sums (the table's sublane 1 too) within
    ``MESH_HYBRID_RTOL`` / ``MESH_HYBRID_ATOL``; the table's values within
    ``2 lr`` a step, AdaGrad's bound (``|g| / sqrt(acc)`` is at most 1, so a
    value moves at most ``lr`` a step either way: a row first touched with a
    gradient of a few 1e-5, whose rounding differs by a few per cent between
    the two orders, takes a step of order ``lr`` in each). Returns the
    largest difference and the count of table values past ``MESH_ATOL``."""
    lr = _widedeep_config(0).get_float("learning_rate")
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: arrays {sorted(got)}, want {sorted(want)}")
    worst, differ = 0.0, 0
    for k, w in want.items():
        g = got[k]
        worst = max(worst, float((g - w).abs().max()))
        if k == "table/table":
            bound = 2 * lr * steps + MESH_ATOL
            if float((g[:, 0] - w[:, 0]).abs().max()) > bound:
                raise AssertionError(f"{what}: table values past AdaGrad's {bound}")
            differ += int(((g[:, 0] - w[:, 0]).abs() > MESH_ATOL).sum())
            g, w = g[:, 1:], w[:, 1:]
        if not torch.allclose(g, w, rtol=MESH_HYBRID_RTOL, atol=MESH_HYBRID_ATOL):
            raise AssertionError(f"{what}: {k} is {float((g - w).abs().max())} from the "
                                 "reference run")
    return {"max_abs_diff": worst, "table_values_differ": differ,
            "bit_equal": all(torch.equal(got[k], w) for k, w in want.items())}


def _mesh_hybrid_leg(seed: int, corpora, mesh) -> dict:
    """Leg 1's hybrid placement (phase 21 (f)): the grouped plane at
    fused-grouped's full width with ``MESH_HYBRID`` ``MESH_GROUPED_SHORT``
    steps from the plain plane's start, its tables within
    ``MESH_GROUPED_RTOL`` / ``MESH_GROUPED_ATOL`` of the plain plane's,
    nothing dropped, the row kernels launched as the plain plane's, the
    counted bytes ``step_cost``'s; ``placement: auto``'s decision (cut,
    coverage, predicted against counted bytes); the bytes a step of each."""
    t0 = time.monotonic()
    spc = FUSED_STEPS_PER_CALL
    plain = _mesh_grouped_run(seed, corpora, mesh, MESH_GROUPED_SHORT, keep=True)
    hyb = _mesh_grouped_run(seed, corpora, mesh, MESH_GROUPED_SHORT, keep=True, **MESH_HYBRID)
    _check_launches("mesh hybrid", hyb["launches"],
                    _grouped_launches(MESH_GROUPED_SHORT, spc))
    hyb["max_abs_diff"] = _tables_close("hybrid", hyb.pop("state"), plain.pop("state"))
    if not np.allclose(hyb["losses"], plain["losses"], rtol=MESH_GROUPED_RTOL,
                       atol=MESH_GROUPED_ATOL):
        raise AssertionError(f"mesh hybrid: losses {hyb['losses']}, plain {plain['losses']}")
    if any(hyb["dropped"]):
        raise AssertionError(f"mesh hybrid: {hyb['dropped']} rows dropped at a covering cap")
    auto = _mesh_grouped_run(seed, corpora, mesh, MESH_GROUPED_SHORT, placement="auto")
    decision = auto["decision"]
    per_step = {name: run["comm_bytes"] // MESH_GROUPED_SHORT
                for name, run in (("uniform", plain), ("hybrid", hyb), ("auto", auto))}
    torch.cuda.empty_cache()
    return {"steps": MESH_GROUPED_SHORT, "keys": MESH_HYBRID, "hybrid": hyb,
            "plain_losses": plain["losses"], "plain_step_ms_median": plain["step_ms_median"],
            "auto": {"decision": decision, "losses": auto["losses"],
                     "dropped": auto["dropped"], "step_ms_median": auto["step_ms_median"],
                     "predicted_exchange_bytes_a_substep": decision.get(
                         "predicted_exchange_bytes"),
                     "counted_bytes_a_substep": per_step["auto"] / spc},
            "bytes_a_step": per_step, "seconds": time.monotonic() - t0}


def _mesh_ctr_layouts(seed: int, mesh) -> dict:
    """Leg 1's W&D under each of ``MESH_CTR_LAYOUTS`` (trivial on one rank)
    ``MESH_CTR_LAYOUT_STEPS`` steps against the uniform meshed run of the
    same steps (:func:`_ctr_close`; bit equality reported), one ``gather_rows`` and one
    ``scatter_adagrad_fused_rows`` a step (the hybrid tail's), the counted
    bytes ``step_cost``'s."""
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    t0 = time.monotonic()
    data, _ = _ctr_data(seed)
    base = _mesh_ctr_run(seed, data, mesh, MESH_CTR_LAYOUT_STEPS)
    want = dict(tensor_items(base["state"]))
    out = {"steps": MESH_CTR_LAYOUT_STEPS}
    for name, keys in MESH_CTR_LAYOUTS.items():
        run = _mesh_ctr_run(seed, data, mesh, MESH_CTR_LAYOUT_STEPS, **keys)
        got = dict(tensor_items(run["state"]))
        close = _ctr_close(f"mesh widedeep {name}", got, want, MESH_CTR_LAYOUT_STEPS)
        _check_launches(f"mesh widedeep {name}", run["launches"],
                        {k: n * MESH_CTR_LAYOUT_STEPS for k, n in MESH_CTR_LAUNCHES.items()})
        tr = run["trainer"]
        step_bytes = tr.step_cost(next(iter(tr.batches())))["total_bytes"]
        if run["comm_bytes"] != MESH_CTR_LAYOUT_STEPS * step_bytes:
            raise AssertionError(f"mesh widedeep {name}: {run['comm_bytes']} bytes counted, "
                                 f"step_cost {MESH_CTR_LAYOUT_STEPS} x {step_bytes}")
        out[name] = {"keys": keys, **close,
                     "launches": {k: run["launches"][k] for k in MESH_CTR_LAUNCHES},
                     "bytes_a_step": step_bytes, "step_ms_median": run["step_ms_median"],
                     "placement": tr.placement_decision}
        del run, got
    out["uniform_bytes_a_step"] = base["comm_bytes"] // MESH_CTR_LAYOUT_STEPS
    out["uniform_step_ms_median"] = base["step_ms_median"]
    out["seconds"] = time.monotonic() - t0
    del base, want
    torch.cuda.empty_cache()
    return out


# Leg 1's CTR on the (1, 1) NCCL mesh: Wide & Deep at examples/widedeep.conf
# (26 fields, table dim 17, [262,144, 2, 128], batch 8,192, AdaGrad) on the
# _ctr_data batches, and FFM at 39 fields on the 2-D plane
MESH_CTR_STEPS = 10
MESH_CTR_SAVE = 5  # the step leg 1's W&D saves at and resumes from
MESH_FFM_STEPS = 5
MESH_CTR_LAUNCHES = {"gather_rows": 1, "scatter_adagrad_fused_rows": 1}  # a W&D step
# leg 2's Wide & Deep at a cut size on the four gloo ranks
MESH_GLOO_CTR_CAPACITY = 1 << 16
MESH_GLOO_CTR_STEPS = 5
# leg 2's seqlm: the seqlm phase's model (seq_len 256, 2 layers, 4 heads,
# d_model 128, batch 8) on a (data 2, seq 2) mesh of the same ranks, ring
# attention, on the CPU: gloo's send and recv, which ring's hops use, take
# no CUDA tensor; the one-device dense run it is held to is on the card
MESH_SEQLM = {"data": 2, "seq": 2}
MESH_SEQLM_STEPS = 3
MESH_SEQLM_TOKENS = 100_000
MESH_SEQLM_DEVICE = "cpu"
MESH_SEQLM_TOL = 2e-4  # tests/test_seqlm.py:92-93


def _mesh_ctr_run(seed: int, data, mesh, steps: int, over=None, **keys) -> dict:
    """A ``widedeep.conf`` trainer (``over``: config keys on top, ``keys``
    too, the loop's) under ``mesh`` or on one device, ``steps`` of
    ``TrainLoop`` on ``data``'s batches: the state, the losses by step, the
    launches, the collectives' result bytes and the median step ms past
    the first."""
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.parallel import transfer

    cfg = _widedeep_config(seed)
    for k, v in {**(over or {}), **keys}.items():
        cfg.set(k, str(v))
    trainer = get_model(cfg.get_str("model"))(cfg, mesh=mesh, data=data)
    records = []
    loop, _ = _loss_loop(trainer, records)
    transfer.reset_comm()
    state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=steps))
    # a guardrail trip's line carries no loss (the poisoned one is dropped)
    losses = {r["step"]: r["loss"] for r in records if "loss" in r}
    if not all(math.isfinite(x) for x in losses.values()):
        raise AssertionError(f"mesh ctr {over} {keys}: losses {losses}")
    return {"trainer": trainer, "state": state, "losses": losses, "launches": launches,
            "comm_bytes": transfer.comm_bytes(),
            "tier": loop.tier.summary() if loop.tier is not None else None,
            "tier_checksums": loop.tier.checksums if loop.tier is not None else None,
            "step_ms_median": statistics.median(r["seconds"] * 1e3 for r in records[1:])}


def _ctr_equal(what: str, a, b) -> None:
    """Two CTR states bit-equal, tensor by tensor (tables, slots, dense
    tensors, AdaGrad sums)."""
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    for (key, x), (_, y) in zip(tensor_items(a), tensor_items(b), strict=True):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {key} differs by {float((x - y).abs().max())} "
                                 "(bit-equal expected)")


def _mesh_ctr_nccl_leg(seed: int, mesh, tmp: str) -> dict:
    """Leg 1's CTR (module docstring, phase 21 (a)): W&D meshed and unmeshed
    ``MESH_CTR_STEPS`` steps, bit-equal, one ``gather_rows`` and one
    ``scatter_adagrad_fused_rows`` a step, the collectives' bytes equal to
    ``step_cost``'s; saved under the mesh at ``MESH_CTR_SAVE`` and resumed,
    bit-equal to the straight run, the manifest's CRCs an unmeshed save's;
    FFM at 39 fields ``MESH_FFM_STEPS`` steps on the 2-D plane, bit-equal."""
    from swiftsnails_tpu_torch.framework import checkpoint as ckpt

    t0 = time.monotonic()
    data, _ = _ctr_data(seed)
    one = _mesh_ctr_run(seed, data, None, MESH_CTR_STEPS)
    meshed = _mesh_ctr_run(seed, data, mesh, MESH_CTR_STEPS)
    _ctr_equal("mesh widedeep", meshed["state"], one["state"])
    if meshed["losses"] != one["losses"]:
        raise AssertionError(f"mesh widedeep: losses {meshed['losses']}, unmeshed "
                             f"{one['losses']}")
    want = {k: n * MESH_CTR_STEPS for k, n in MESH_CTR_LAUNCHES.items()}
    _check_launches("mesh widedeep", meshed["launches"], want)
    _check_launches("unmeshed widedeep", one["launches"], want)
    trainer = meshed["trainer"]
    batch = next(iter(trainer.batches()))
    step_bytes = trainer.step_cost(batch)["total_bytes"]
    if meshed["comm_bytes"] != MESH_CTR_STEPS * step_bytes:
        raise AssertionError(f"mesh widedeep: {meshed['comm_bytes']} collective bytes "
                             f"counted, step_cost {MESH_CTR_STEPS} x {step_bytes}")
    table = list(meshed["state"].table.table.shape)
    out = {"config": WIDEDEEP_CONF, "table": table, "batch": trainer.batch_size,
           "steps": MESH_CTR_STEPS, "bit_equal": True, "losses": list(meshed["losses"].values()),
           "launches": {k: meshed["launches"][k] for k in MESH_CTR_LAUNCHES},
           "comm_bytes": meshed["comm_bytes"], "step_cost_bytes": step_bytes,
           "step_ms_median": meshed["step_ms_median"],
           "one_device_step_ms_median": one["step_ms_median"]}
    del one
    roots = {name: os.path.join(tmp, f"ck-{name}") for name in ("mesh", "one")}
    keys = {"param_backup_root": roots["mesh"], "param_backup_period": MESH_CTR_SAVE}
    saved = _mesh_ctr_run(seed, data, mesh, MESH_CTR_SAVE, **keys)
    del saved
    resumed = _mesh_ctr_run(seed, data, mesh, MESH_CTR_STEPS, resume="auto", **keys)
    _ctr_equal("mesh widedeep resumed", resumed["state"], meshed["state"])
    tail = {s: meshed["losses"][s] for s in range(MESH_CTR_SAVE + 1, MESH_CTR_STEPS + 1)}
    if resumed["losses"] != tail:
        raise AssertionError(f"mesh widedeep resumed: losses {resumed['losses']}, "
                             f"straight {tail}")
    del resumed, meshed
    unmeshed = _mesh_ctr_run(seed, data, None, MESH_CTR_SAVE, param_backup_root=roots["one"],
                             param_backup_period=MESH_CTR_SAVE)
    del unmeshed
    crcs = {name: _crcs(ckpt.read_manifest(root, MESH_CTR_SAVE))
            for name, root in roots.items()}
    if crcs["mesh"] != crcs["one"]:
        raise AssertionError(f"mesh widedeep: the mesh's step-{MESH_CTR_SAVE} manifest "
                             f"CRCs {crcs['mesh']}, unmeshed {crcs['one']}")
    out["checkpoint"] = {"saved_at": MESH_CTR_SAVE, "resumed_to": MESH_CTR_STEPS,
                         "bit_equal": True, "crcs_equal_unmeshed": True,
                         "arrays": len(crcs["mesh"]),
                         "bytes": _dir_bytes(os.path.join(roots["mesh"],
                                                          f"step_{MESH_CTR_SAVE}"))}
    torch.cuda.empty_cache()
    ffm = CTR_TRAIN["train_ffm_wide"][0]
    (labels, feats), _ = _ctr_data(seed, ffm["num_fields"])
    runs = {name: _mesh_ctr_run(seed, (labels, feats), m, MESH_FFM_STEPS, over=ffm)
            for name, m in (("one_device", None), ("mesh", mesh))}
    if runs["mesh"]["trainer"].packed:
        raise AssertionError("mesh ffm: table dim 157 took the packed plane")
    _ctr_equal("mesh ffm", runs["mesh"]["state"], runs["one_device"]["state"])
    if runs["mesh"]["losses"] != runs["one_device"]["losses"]:
        raise AssertionError(f"mesh ffm: losses {runs['mesh']['losses']}, unmeshed "
                             f"{runs['one_device']['losses']}")
    out["ffm"] = {"over": ffm, "plane": "2-D", "steps": MESH_FFM_STEPS, "bit_equal": True,
                  "table": list(runs["mesh"]["state"].table.table.shape),
                  "losses": list(runs["mesh"]["losses"].values()),
                  "step_ms_median": runs["mesh"]["step_ms_median"],
                  "one_device_step_ms_median": runs["one_device"]["step_ms_median"]}
    del runs
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t0
    return out


def _mesh_gloo_ctr_data(seed: int):
    """Leg 2's W&D records: synth_ctr at widedeep.conf's 26 fields, one
    epoch of ``MESH_GLOO_CTR_STEPS`` batches of ``MESH_GLOO_BATCH``."""
    from swiftsnails_tpu_torch.data.ctr import synth_ctr

    labels, feats, _ = synth_ctr(MESH_GLOO_CTR_STEPS * MESH_GLOO_BATCH,
                                 _widedeep_config(seed).get_int("num_fields"),
                                 CTR_IDS_PER_FIELD, seed=seed)
    return labels, feats


MESH_GLOO_CTR_OVER = {"capacity": MESH_GLOO_CTR_CAPACITY, "batch_size": MESH_GLOO_BATCH}


def _mesh_seqlm_ids(seed: int) -> np.ndarray:
    """Leg 2's seqlm corpus: zipf ids over the seqlm phase's vocabulary."""
    return zipf_ids(MESH_SEQLM_TOKENS, SEQLM_IDS, np.random.default_rng(seed))


def _mesh_seqlm_run(seed: int, device: str, mesh=None) -> dict:
    """``MESH_SEQLM_STEPS`` SGD steps of the seqlm phase's model, under
    ``mesh`` with ring attention or on one device with dense attention
    (each rank its part of every global batch): parameters and losses."""
    from swiftsnails_tpu_torch.models.seqlm import SeqLMTrainer, param_leaves
    from swiftsnails_tpu_torch.utils.config import Config

    conf = {"seed": str(seed), "learning_rate": str(SEQLM_RATES["sgd"]),
            "attention": "ring" if mesh is not None else "dense"}
    tr = SeqLMTrainer(Config(conf), corpus_ids=_mesh_seqlm_ids(seed), vocab_size=SEQLM_IDS,
                      mesh=mesh, device=None if mesh is not None else device)
    state, losses = tr.init_state(), []
    for _, b in zip(range(MESH_SEQLM_STEPS), tr.batches()):
        batch = {"tokens": torch.from_numpy(tr.local_batch(b)["tokens"]).to(tr.device)}
        state, met = tr.train_step(state, batch)
        losses.append(float(met["loss"]))
    return {"params": [p.detach().cpu() for p in param_leaves(state["params"])],
            "losses": losses, "shape": {k: getattr(tr, k) for k in (
                "seq_len", "n_layers", "n_heads", "d_model", "batch_size")}}


# The wire leg (phase 21 (e)): comm_dtype on the (1, 1) NCCL mesh at full
# width, 5 steps of each path under each codec beside an f32 run
WIRE_STEPS = 5
WIRE_FORMATS = ("bfloat16", "int8", "int4")
# the JAX package's loss bars against the f32 wire on its grouped mesh plane
# (tests/test_comm_dtype.py:239-249, tests/test_int4_wire.py:304-313); it
# sets none for the CTR plane, whose gap the line reports
WIRE_LOSS_BARS = {"bfloat16": 0.01, "int8": 0.02, "int4": 0.01}
# the grouped exchange's scoped bytes at least this far below f32's
WIRE_BYTE_FLOORS = {"bfloat16": 1.9, "int8": 3.0, "int4": 6.0}
# leg 2's wire routes: 2 steps each under int8 and int4 on the four gloo ranks
WIRE_GLOO_STEPS = 2
WIRE_GLOO_FORMATS = ("int8", "int4")
WIRE_GLOO_GROUPED = {"dedup": MESH_GLOO_GROUPED["dedup"],
                     "bucketed": {"push_mode": "bucketed", "bucket_slack": MESH_GROUPED_SLACK}}
WIRE_STEP_SHARE = {"bfloat16": 2.0 ** -7, "int8": 1 / 127, "int4": 1 / 7}


def _kernel_profile(trainer, state, seed: int) -> dict:
    """One more step of ``trainer`` under ``torch.profiler``: the launches
    and device ms of its kernels, NCCL's apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from swiftsnails_tpu_torch.framework.trainer import step_generator

    dev = torch.device("cuda")
    it = iter(trainer.batches())
    batch = {k: torch.from_numpy(v).to(dev) if np.ndim(v) else v for k, v in next(it).items()}
    it.close()
    trainer.train_step(state, batch, step_generator(seed, 0, dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch, step_generator(seed, 1, dev))
        torch.cuda.synchronize()
    out = {"launches": 0, "ms": 0.0, "nccl_launches": 0, "nccl_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        key = "nccl_" if "nccl" in e.key.lower() else ""
        out[key + "launches"] += e.count
        out[key + "ms"] += e.self_device_time_total / 1e3
    return out


def _wire_run(path: str, seed: int, corpora, mesh, wire: str, profile: bool = False) -> dict:
    """``path`` (``packed``: the train phase's packed+pool; ``grouped``:
    ``MESH_GROUPED`` at ``MESH_GROUPED_LR``; ``widedeep``:
    ``examples/widedeep.conf``) under ``mesh`` and ``comm_dtype: wire``,
    ``WIRE_STEPS`` steps of ``TrainLoop``: losses (finite), launches, the
    wire bytes counted against ``step_cost``'s, bytes by scope, the median
    step ms past the first; with ``profile``, one more step's kernels."""
    from swiftsnails_tpu_torch.parallel import comm, transfer

    transfer.reset_comm()
    if path == "widedeep":
        data, _ = _ctr_data(seed)
        run = _mesh_ctr_run(seed, data, mesh, WIRE_STEPS, over={"comm_dtype": wire})
        trainer, state, launches = run["trainer"], run["state"], run["launches"]
        losses = list(run["losses"].values())
        step_ms = run["step_ms_median"]
        batch = next(iter(trainer.batches()))
    else:
        phase, extra = (("train", {}) if path == "packed"
                        else (MESH_GROUPED, {"learning_rate": MESH_GROUPED_LR}))
        trainer, loop, records = _train_loop(phase, seed, corpora, mesh=mesh,
                                             comm_dtype=wire, **extra)
        state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=WIRE_STEPS))
        losses = [r["loss"] for r in records]
        step_ms = statistics.median(r["seconds"] * 1e3 for r in records[1:])
        n = trainer.batch_size * trainer.steps_per_call
        batch = {"centers": np.zeros(n, np.int32),
                 "contexts": np.zeros((n, CW) if path == "grouped" else n, np.int32)}
    counted, scopes = transfer.comm_bytes(), dict(comm.SCOPES)
    step_bytes = trainer.step_cost(batch)["total_bytes"]
    if len(losses) != WIRE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"mesh wire {path} {wire}: losses {losses}")
    if counted != WIRE_STEPS * step_bytes:
        raise AssertionError(f"mesh wire {path} {wire}: {counted} bytes counted, step_cost "
                             f"{WIRE_STEPS} x {step_bytes}")
    out = {"losses": losses, "launches": launches, "step_bytes": step_bytes,
           "scoped_step_bytes": sum(scopes.values()) / WIRE_STEPS,
           "scopes": {k: v // WIRE_STEPS for k, v in scopes.items()}, "step_ms_median": step_ms}
    if profile:
        out["profile"] = _kernel_profile(trainer, state, seed)
    out["trainer"], out["state"] = trainer, state
    return out


def _codec_parity(trainer, state, mesh, seed: int) -> dict:
    """The codecs on the card against the CPU on a full-width pull's rows
    (the grouped plane's out rows of a step's first substep, 83,968 x 2 x
    128) and a push's gradients (captured from one grouped step under int8:
    the out rows' push, dithered at its place), deterministic and dithered;
    and each wire's meshed pull equal to the unmeshed pull through
    ``_wire_cast`` (the owner-exclusive sum's identity), on these rows and
    on W&D's small rows. Bit for bit, or the run fails."""
    from swiftsnails_tpu_torch.framework.trainer import step_generator
    from swiftsnails_tpu_torch.parallel import comm, store, transfer
    from swiftsnails_tpu_torch.serving.kernels import _wire_cast

    dev = torch.device("cuda")
    it = iter(trainer.batches())
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items() if np.ndim(v)}
    it.close()
    ctx = batch["contexts"][:GROUPED_BATCH].clamp_min(0).reshape(-1)
    pools = trainer._grouped_pools(torch.Generator(device=dev).manual_seed(seed),
                                   GROUPED_BATCH, None).reshape(-1)
    rows = torch.cat([ctx, pools]).to(torch.int32)
    pulled = store.pull_packed(state.out_table, rows)
    captured = []
    spy_of = transfer.all_gather_quantized

    def spy(m, x, axis, wire, **kw):
        captured.append((x.detach().clone(), kw.get("seed"), kw.get("place")))
        return spy_of(m, x, axis, wire, **kw)

    transfer.all_gather_quantized = spy
    try:
        trainer.comm_dtype = "int8"
        trainer.train_step(state, batch, step_generator(seed, 0, dev))
    finally:
        transfer.all_gather_quantized = spy_of
    grads, g_seed, place = captured[-1]
    checks = 0

    def same(a, b, what):
        nonlocal checks
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        if not torch.equal(a, b):
            raise AssertionError(f"mesh wire: {what} (not bit-equal)")
        checks += 1

    for name, x, kw in (("pull rows", pulled, {}),
                        ("push gradients", grads, {"stochastic": True,
                                                   "seed": comm.salted(g_seed, 0)}),
                        ("push gradients at their place", grads, {"stochastic": True,
                                                                  "place": place})):
        if kw.get("place") is None and "place" in kw:
            continue
        cpu_kw = {k: (tuple(t.cpu() for t in v) if k == "place" else
                      (v.cpu() if isinstance(v, torch.Tensor) else v)) for k, v in kw.items()}
        for q, args in ((comm.quantize_int8, {}), (comm.quantize_int4, {"block": 32}),
                        (comm.quantize_int4, {"block": 16})):
            got = q(x, **kw, **args)
            want = q(x.cpu(), **cpu_kw, **args)
            same(got[0], want[0], f"{q.__name__} {args} codes of the {name}, card vs CPU")
            same(got[1], want[1], f"{q.__name__} {args} scales of the {name}, card vs CPU")
            deq = (comm.dequantize_int8(*got) if q is comm.quantize_int8
                   else comm.dequantize_int4(*got, x.shape, **args))
            deq_cpu = (comm.dequantize_int8(*want) if q is comm.quantize_int8
                       else comm.dequantize_int4(*want, x.shape, **args))
            same(deq, deq_cpu, f"{q.__name__} {args} dequantized {name}, card vs CPU")
    identity = {}
    plain = store.pull_packed(state.out_table, rows)  # the tables after that step
    for wire in WIRE_FORMATS + ("int4/16",):
        meshed = transfer.pull_collective_packed(mesh, state.out_table, rows, comm_dtype=wire)
        same(meshed, _wire_cast(plain, wire), f"the meshed {wire} pull vs the wire cast")
        identity[wire] = True
    return {"rows": list(pulled.shape), "gradients": list(grads.shape),
            "bit_equal_checks": checks, "pull_is_wire_cast": identity}


def _wd_pull_identity(seed: int, mesh) -> dict:
    """W&D's small-row pull (table dim 17) under each wire on the mesh equal
    to the unmeshed pull through ``_wire_cast``."""
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.parallel import store, transfer
    from swiftsnails_tpu_torch.serving.kernels import _wire_cast

    data, _ = _ctr_data(seed)
    cfg = _widedeep_config(seed)
    trainer = get_model(cfg.get_str("model"))(cfg, mesh=mesh, data=data)
    state = trainer.init_state()
    feats = torch.from_numpy(data[1][:cfg.get_int("batch_size")]).cuda()
    rows = trainer._rows(feats.reshape(-1))
    plain = store.pull_packed_small(state.table, rows, trainer.table_dim)
    for wire in WIRE_FORMATS:
        got = transfer.pull_collective_packed_small(mesh, state.table, rows, trainer.table_dim,
                                                    comm_dtype=wire)
        if not torch.equal(got, _wire_cast(plain, wire)):
            raise AssertionError(f"mesh wire widedeep: the meshed {wire} pull is not the "
                                 "wire cast of the unmeshed one")
    return {"rows": list(plain.shape), "pull_is_wire_cast": list(WIRE_FORMATS)}


def _mesh_wire_leg(seed: int, corpora, mesh) -> dict:
    """Phase 21 (e), on the (1, 1) NCCL mesh at full width: packed+pool,
    W&D and the grouped plane, ``WIRE_STEPS`` steps under f32 and each
    codec. Gates: finite losses, word2vec's within ``WIRE_LOSS_BARS`` of
    f32's and falling, counted bytes equal to ``step_cost``'s, the grouped
    exchange's scoped bytes past ``WIRE_BYTE_FLOORS``, launches as f32's;
    the codecs on the card bit-equal to the CPU's and each meshed pull the
    unmeshed pull's wire cast. Reports each path's step bytes, step ms and
    the codec's launches and device ms a step (the profiled step's non-NCCL
    kernels beyond f32's)."""
    t0 = time.monotonic()
    out = {"steps": WIRE_STEPS, "formats": list(WIRE_FORMATS), "loss_bars": WIRE_LOSS_BARS,
           "byte_floors": WIRE_BYTE_FLOORS}
    for path in ("packed", "widedeep", "grouped"):
        runs = {}
        for wire in ("float32",) + WIRE_FORMATS:
            runs[wire] = _wire_run(path, seed, corpora, mesh, wire, profile=path != "widedeep")
            if path == "grouped" and wire == "float32":
                out["codec_parity"] = _codec_parity(runs[wire]["trainer"], runs[wire]["state"],
                                                    mesh, seed)
            del runs[wire]["trainer"], runs[wire]["state"]
            torch.cuda.empty_cache()
        f32 = runs["float32"]
        res = {"float32": {k: f32[k] for k in ("step_bytes", "scoped_step_bytes",
                                               "step_ms_median", "losses")}}
        for wire in WIRE_FORMATS:
            r = runs[wire]
            gap = (r["losses"][-1] - f32["losses"][-1]) / abs(f32["losses"][-1])
            if path != "widedeep":
                if abs(gap) >= WIRE_LOSS_BARS[wire]:
                    raise AssertionError(f"mesh wire {path} {wire}: last loss {gap:+.4%} from "
                                         f"f32's, bar {WIRE_LOSS_BARS[wire]:.0%}")
                if not r["losses"][-1] < r["losses"][0]:
                    raise AssertionError(f"mesh wire {path} {wire}: the loss did not fall: "
                                         f"{r['losses']}")
            if r["launches"] != f32["launches"]:
                raise AssertionError(f"mesh wire {path} {wire}: launches {r['launches']}, "
                                     f"f32 {f32['launches']}")
            ratio = f32["scoped_step_bytes"] / r["scoped_step_bytes"]
            if path == "grouped" and ratio < WIRE_BYTE_FLOORS[wire]:
                raise AssertionError(f"mesh wire grouped {wire}: scoped bytes {ratio:.3f}x "
                                     f"below f32's, floor {WIRE_BYTE_FLOORS[wire]}")
            entry = {"losses": r["losses"], "last_loss_gap_vs_f32": gap,
                     "step_bytes": r["step_bytes"], "scoped_step_bytes": r["scoped_step_bytes"],
                     "scoped_bytes_x_below_f32": ratio, "scopes": r["scopes"],
                     "step_ms_median": r["step_ms_median"]}
            if "profile" in r:
                entry["codec_launches_per_step"] = (r["profile"]["launches"]
                                                    - f32["profile"]["launches"])
                entry["codec_device_ms_per_step"] = r["profile"]["ms"] - f32["profile"]["ms"]
                entry["nccl_launches_per_step"] = r["profile"]["nccl_launches"]
                entry["nccl_ms_per_step"] = r["profile"]["nccl_ms"]
                res["float32"]["nccl_launches_per_step"] = f32["profile"]["nccl_launches"]
                res["float32"]["nccl_ms_per_step"] = f32["profile"]["nccl_ms"]
                res["float32"]["kernels_per_step"] = f32["profile"]["launches"]
            res[wire] = entry
        res["launches"] = {k: v for k, v in f32["launches"].items() if v}
        out[path] = res
    out["widedeep"]["pull_identity"] = _wd_pull_identity(seed, mesh)
    out["seconds"] = time.monotonic() - t0
    return out


def _gloo_wire_device(mesh) -> str:
    """Where leg 2's wire routes run: ``MESH_GLOO_DEVICE``, unless gloo
    refuses there a dtype the codecs move (int8 and uint8 sums, int32
    pairs, byte gathers and all-to-alls), then the CPU. Every rank probes
    alike."""
    import torch.distributed as dist

    if MESH_GLOO_DEVICE != "cuda":
        return MESH_GLOO_DEVICE
    try:
        for dtype in (torch.int8, torch.uint8, torch.int32):
            t = torch.zeros(4, dtype=dtype, device="cuda")
            dist.all_reduce(t, group=mesh.groups["model"])
            dist.all_gather([torch.empty_like(t) for _ in range(MESH_GLOO["data"])], t,
                            group=mesh.groups["data"])
            dist.all_to_all_single(torch.empty_like(t), t, group=mesh.groups["data"])
        torch.cuda.synchronize()
        return "cuda"
    except Exception:
        return "cpu"


def _gloo_wire_runs(seed: int, mesh, device: str) -> dict:
    """Leg 2's wire routes on this rank: the grouped plane's dedup and
    bucketed routes and W&D, ``WIRE_GLOO_STEPS`` steps under each of
    ``WIRE_GLOO_FORMATS``; tables (W&D: its arrays) and losses."""
    out = {}
    for wire in WIRE_GLOO_FORMATS:
        for route, over in WIRE_GLOO_GROUPED.items():
            loop, losses = _loss_loop(
                _mesh_gloo_grouped_trainer(seed, device, mesh, comm_dtype=wire, **over))
            state = loop.run(seed=seed, max_steps=WIRE_GLOO_STEPS)
            out[(route, wire)] = {"tables": [t.table.cpu() for t in state], "losses": losses}
            del state
        wd = _mesh_ctr_run(seed, _mesh_gloo_ctr_data(seed), mesh, WIRE_GLOO_STEPS,
                           over={**MESH_GLOO_CTR_OVER, "comm_dtype": wire})
        out[("widedeep", wire)] = {"tables": [wd["state"].table.table.cpu()],
                                   "losses": list(wd["losses"].values())}
        del wd
    return out


def _wd_start_table(seed: int, mesh, wire: str):
    """Leg 2's W&D table as it starts (the seeded init) on ``mesh``."""
    from swiftsnails_tpu_torch.models.registry import get_model

    cfg = _widedeep_config(seed)
    for k, v in {**MESH_GLOO_CTR_OVER, "comm_dtype": wire}.items():
        cfg.set(k, str(v))
    trainer = get_model(cfg.get_str("model"))(cfg, mesh=mesh, data=_mesh_gloo_ctr_data(seed))
    return trainer.init_state().table.table.cpu()


def _one_step_bound(route: str, wire: str, pushes: int, want, got, start):
    """Each element's bound for two runs whose dithered codes differ by one
    quantization step a push. SGD (word2vec): a code one step off moves an
    element by ``lr`` times its row's step, ``WIRE_STEP_SHARE`` of the row's
    largest gradient, which is at most the most an element of the row moved
    in either run (twice that, for pushes that cancel). AdaGrad (W&D's
    fused tiles: values in sublane 0, the accumulator in sublane 1): the
    accumulator adds ``g^2``, so one step off adds at most ``(2 + s) s
    amax^2`` (``s`` the share) a push, ``amax^2`` at most the most the
    tile's accumulator grew; a value moves at most ``lr`` a push either
    way (``|g| / sqrt(acc)`` is at most 1), so two runs differ by ``2 lr``
    a push at most."""
    share = WIRE_STEP_SHARE[wire]
    rows = want.shape[0]
    if route != "widedeep":
        moved = torch.maximum((want - start).abs().reshape(rows, -1).amax(dim=1),
                              (got - start).abs().reshape(rows, -1).amax(dim=1))
        return (2 * pushes * share * moved[:, None] + MESH_ATOL).expand(rows, want[0].numel())
    lr = _widedeep_config(0).get_float("learning_rate")
    grown = torch.maximum(want[:, 1] - start[:, 1], got[:, 1] - start[:, 1]).amax(dim=1)
    acc = (pushes * (2 + share) * share * grown[:, None] + MESH_ATOL).expand(rows, 128)
    val = torch.full((rows, 128), 2 * pushes * lr + MESH_ATOL)
    return torch.stack([val, acc], dim=1)


def _gloo_wire_check(seed: int, by: dict, solo) -> dict:
    """Leg 2's wire routes against the same on ``solo``, the (1, 1) NCCL
    mesh. The (2, 2) ranks split the pushes' rows into other chunks, so each
    element's dither differs: every element within one quantization step a
    push (:func:`_one_step_bound`), the count of differing elements
    reported."""
    out = {"device": by[(0, 0)]["wire_device"], "steps": WIRE_GLOO_STEPS}
    for wire in WIRE_GLOO_FORMATS:
        for route in tuple(WIRE_GLOO_GROUPED) + ("widedeep",):
            if route == "widedeep":
                ref = _mesh_ctr_run(seed, _mesh_gloo_ctr_data(seed), solo, WIRE_GLOO_STEPS,
                                    over={**MESH_GLOO_CTR_OVER, "comm_dtype": wire})
                want = [ref["state"].table.table.cpu()]
                starts = [_wd_start_table(seed, solo, wire)]
                pushes = WIRE_GLOO_STEPS
                del ref
            else:
                trainer = _mesh_gloo_grouped_trainer(seed, MESH_GLOO_DEVICE, solo,
                                                     comm_dtype=wire, **WIRE_GLOO_GROUPED[route])
                starts = [t.table.cpu() for t in trainer.init_state()]
                loop, _ = _loss_loop(trainer)
                want = [t.table.cpu() for t in loop.run(seed=seed, max_steps=WIRE_GLOO_STEPS)]
                pushes = WIRE_GLOO_STEPS * MESH_GLOO_SPC
                del trainer, loop
            worst, differ, size, slack = 0.0, 0, 0, 0.0
            for k, (w, s0) in enumerate(zip(want, starts)):
                for i in range(MESH_GLOO["data"]):
                    got = torch.cat([by[(i, j)]["wire"][(route, wire)]["tables"][k]
                                     for j in range(MESH_GLOO["model"])])
                    bound = _one_step_bound(route, wire, pushes, w, got, s0)
                    rows = w.shape[0]
                    d = (got - w).abs().reshape(rows, -1)
                    bound = bound.reshape(rows, -1)
                    excess = float((d - bound).max())
                    if excess > 0:
                        raise AssertionError(
                            f"mesh gloo wire {route} {wire}: table {k} of data replica {i} "
                            f"is past one quantization step a push of the (1, 1) mesh's "
                            f"(by {excess})")
                    worst = max(worst, float(d.max()))
                    slack = max(slack, float((d / bound).max()))
                    differ += int((d > MESH_ATOL).sum())
                    size += d.numel()
            losses = by[(0, 0)]["wire"][(route, wire)]["losses"]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"mesh gloo wire {route} {wire}: losses {losses}")
            out[f"{route}_{wire}"] = {"max_abs_err": worst, "worst_share_of_bound": slack,
                                      "elements_differ": differ, "elements": size,
                                      "losses": losses}
            torch.cuda.empty_cache()
    return out


# ------------------------------------------ the tier and serving under a mesh ---

# leg 1 (the (1, 1) NCCL mesh at full width): packed+pool behind the tiered
# phase's 64 MB and widedeep.conf behind 192 MB, MESH_STEPS / MESH_CTR_STEPS
# steps; a meshed servant and fleet from the serve phase's step-4 checkpoint
MESH_TIER_REPLICAS = 2
# leg 2 (the four gloo ranks): packed+pool and packed: 0 tiered MESH_GLOO_TIER_STEPS
# steps on the (2, 2) mesh, the budget MESH_GLOO_TIER_SLACK x a step's distinct
# units; a (1, 4) servant over a [MESH_GLOO_VOCAB, 200] table
MESH_GLOO_TIER_STEPS = 4
MESH_GLOO_TIER_SAVE = 2
MESH_GLOO_TIER_SLACK = 1.25
MESH_GLOO_SERVE = {"data": 1, "model": 4}
MESH_GLOO_SERVE_IDS = 2_000
MESH_GLOO_SERVE_TOPK = 4


def _requests(ids: np.ndarray) -> list:
    """``ids`` cut into requests of ``SERVE_REQUEST_IDS`` ids in turns."""
    out, lo = [], 0
    while lo < len(ids):
        n = SERVE_REQUEST_IDS[len(out) % len(SERVE_REQUEST_IDS)]
        out.append(ids[lo:lo + n])
        lo += n
    return out


def _table_on_cpu(state) -> list:
    """A word2vec state's two tables on the host (a meshed tier's run
    returns them on the card, an unmeshed one's on the host)."""
    return [t.table.cpu() for t in state]


def _mesh_tier_w2v(seed: int, corpora, mesh, resident: dict) -> dict:
    """Leg 1's packed+pool tier: behind ``TIER``'s 64 MB (no digests:
    ``tier_checksums: 0``), ``MESH_STEPS`` steps on one device and on the
    (1, 1) mesh, against each other and the leg's resident meshed run
    (``resident``: :func:`_mesh_nccl_leg`'s): the three bit-equal,
    evictions on both tiers, the same launches of the row kernels on both
    tiers (``gather_rows`` for the pulls and the evicted slots' reads,
    ``scatter_write_rows`` a fault's install, ``scatter_add_rows`` the
    pushes)."""
    runs, tables = {"resident": resident}, {"resident": resident["tables"]}
    for name, m in (("one_device", None), ("mesh", mesh)):
        run = _tier_w2v(seed, corpora, MESH_STEPS, mesh=m, **TIER, tier_checksums=0)
        tables[name] = _table_on_cpu(run["state"])
        runs[name] = run
        del run["state"]
        torch.cuda.empty_cache()
    # the losses of a meshed run are summed over the global batch and
    # divided (``total``), the unmeshed run's a mean: compared on the mesh
    for name in ("one_device", "resident"):
        diff = max(float((a - b).abs().max()) for a, b in zip(tables[name], tables["mesh"]))
        if not all(torch.equal(a, b) for a, b in zip(tables[name], tables["mesh"])):
            raise AssertionError(f"mesh tier: the meshed tier's tables are {diff} from the "
                                 f"{name} run's (bit-equal expected)")
    if runs["resident"]["losses"] != runs["mesh"]["losses"]:
        raise AssertionError(f"mesh tier: losses {runs['mesh']['losses']}, resident meshed "
                             f"{runs['resident']['losses']}")
    s = {k: runs[k]["loop"].tier.summary() for k in ("one_device", "mesh")}
    if not (s["mesh"]["evictions"] > 0 and s["mesh"]["flushed_rows"] > 0):
        raise AssertionError(f"mesh tier: no eviction under the mesh: {s['mesh']}")
    kernels = ("gather_rows", "scatter_add_rows", "scatter_write_rows")
    got = {k: runs["mesh"]["launches"][k] for k in kernels}
    want = {k: runs["one_device"]["launches"][k] for k in kernels}
    if got != want:
        raise AssertionError(f"mesh tier: launches {got}, the unmeshed tier's {want}")
    _tier_launches("mesh tier", runs["mesh"], 2 * MESH_STEPS,
                   {"scatter_add_rows": 2 * MESH_STEPS})
    p = runs["mesh"]["probe"]
    shapes = {"install_rows_median": statistics.median(p["installs"]),
              "snapshot_rows_median": statistics.median(p["evict_snapshots"]),
              "cache": [s["mesh"]["tables"]["in_table"]["budget_slots"], -(-DIM // 128), 128]}
    out = {"steps": MESH_STEPS, "budget_mb": TIER["tier_hbm_budget_mb"], "bit_equal": True,
           "tables": s["mesh"]["tables"], "evictions": s["mesh"]["evictions"],
           "flushed_rows": s["mesh"]["flushed_rows"], "faults": s["mesh"]["faults"],
           "launches": got, "shapes": shapes,
           "step_ms_median": {k: runs[k]["step_ms_median"] for k in runs},
           "losses": runs["mesh"]["losses"]}
    return out


def _mesh_tier_widedeep(seed: int, mesh) -> dict:
    """Leg 1's W&D tier: widedeep.conf behind ``TIER_WD_BUDGET_MB`` (raised
    while a step's tiles exceed it), ``MESH_CTR_STEPS`` steps on one device
    and on the (1, 1) mesh: bit-equal (every array, every loss), evictions
    on the mesh, the launches of the row kernels equal. The tier keeps its
    defaults, its digests on (``tier_checksums``): leg 1's run of the
    default meshed tier at full width."""
    from swiftsnails_tpu_torch.models.registry import get_model
    from swiftsnails_tpu_torch.utils.tree import tensor_items

    data, _ = _ctr_data(seed)
    cfg = _widedeep_config(seed)
    tiles = _wd_tiles(seed, get_model(cfg.get_str("model"))(cfg, data=data))[:MESH_CTR_STEPS]
    budget = TIER_WD_BUDGET_MB
    while max(tiles) > budget * (1 << 20) // 1024 and budget + TIER_WD_STEP_MB < 256:
        budget += TIER_WD_STEP_MB
    keys = {"table_tier": "host", "tier_hbm_budget_mb": budget}
    runs = {name: _mesh_ctr_run(seed, data, m, MESH_CTR_STEPS, **keys)
            for name, m in (("one_device", None), ("mesh", mesh))}
    for (key, a), (_, b) in zip(tensor_items(runs["mesh"]["state"]),
                                tensor_items(runs["one_device"]["state"]), strict=True):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"mesh tier widedeep: {key} differs from the unmeshed "
                                 "tier's (bit-equal expected)")
    if runs["mesh"]["losses"] != runs["one_device"]["losses"]:
        raise AssertionError("mesh tier widedeep: losses differ from the unmeshed tier's")
    summary = runs["mesh"]["tier"]
    if not summary["evictions"] > 0:
        raise AssertionError(f"mesh tier widedeep: no eviction: {summary}")
    kernels = ("gather_rows", "scatter_adagrad_fused_rows", "scatter_write_rows")
    got = {k: runs["mesh"]["launches"][k] for k in kernels}
    want = {k: runs["one_device"]["launches"][k] for k in kernels}
    if got != want:
        raise AssertionError(f"mesh tier widedeep: launches {got}, unmeshed {want}")
    if runs["mesh"]["tier_checksums"] is not True:
        raise AssertionError("mesh tier widedeep: the tier's digests are off (the default is on)")
    table = summary["tables"]["table"]
    return {"config": WIDEDEEP_CONF, "budget_mb": budget, "steps": MESH_CTR_STEPS,
            "bit_equal": True, "checksums": True, "evictions": summary["evictions"],
            "budget_tiles": table["budget_slots"], "master_tiles": table["master_units"],
            "launches": got, "wd_cache": [table["budget_slots"], 2, 128],
            "wd_pushed_tiles": tiles[0],
            "step_ms_median": {k: r["step_ms_median"] for k, r in runs.items()}}


def _mesh_serve_leg(seed: int, mesh, serve: dict, rate: float) -> dict:
    """Leg 1's serving: a meshed servant and a meshed fleet of
    ``MESH_TIER_REPLICAS`` from the serve phase's step-4 checkpoint, against
    the unmeshed servant: ``SERVE_PULL_IDS`` zipf ids in requests of
    ``SERVE_REQUEST_IDS``, bit-equal; ``SERVE_TOPK_QUERIES`` topk of
    ``SERVE_K``, the same ids; ``SERVE_DELTA_ROWS`` rows through
    ``apply_rows`` pulled back; the tiered servant behind 64 MB under the
    mesh, its pulls bit-equal. Then ``gather_rows`` at the meshed pull's
    owned gathers (the bucket shapes, on the meshed servant's shard)."""
    from swiftsnails_tpu_torch.serving import Fleet, Servant, mesh_serve
    from swiftsnails_tpu_torch.utils.config import Config

    t0 = time.monotonic()
    cfg, root = serve["cfg"], serve["root"]
    rng = np.random.default_rng(seed + 23)
    requests = _requests(zipf_ids(SERVE_PULL_IDS, CLI_CAPACITY, rng))
    queries = rng.integers(0, CLI_CAPACITY, SERVE_TOPK_QUERIES)
    dids = rng.choice(CLI_CAPACITY, SERVE_DELTA_ROWS, replace=False)
    vals = rng.standard_normal((SERVE_DELTA_ROWS, cfg.get_int("dim"))).astype(np.float32)
    out = {}
    with Servant.from_checkpoint(root, cfg, step=SERVE_TRAIN_STEPS) as ref:
        want = [ref.pull(r) for r in requests]
        want_topk = [ref.topk(ref.pull([int(q)])[0], k=SERVE_K) for q in queries]
        with mesh_serve.leading(mesh):
            sv = Servant.from_checkpoint(root, cfg, step=SERVE_TRAIN_STEPS, mesh=mesh)
            fleet = Fleet.from_checkpoint(root, cfg, step=SERVE_TRAIN_STEPS, mesh=mesh,
                                          replicas=MESH_TIER_REPLICAS)
            tcfg = Config({**cfg.as_dict(), "table_tier": "host",
                           "tier_hbm_budget_mb": str(TIER["tier_hbm_budget_mb"])})
            tier_sv = Servant.from_checkpoint(root, tcfg, step=SERVE_TRAIN_STEPS, mesh=mesh)
            try:
                for name, target in (("servant", sv), ("fleet", fleet), ("tiered", tier_sv)):
                    got, launches = _run_counted(lambda: [target.pull(r) for r in requests])
                    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"mesh serve {name}: a pull differs from the "
                                             "unmeshed servant's")
                    topk = []
                    for q, w in zip(queries, want_topk):
                        a = target.topk(target.pull([int(q)])[0], k=SERVE_K)
                        err = max(abs(x[1] - y[1]) for x, y in zip(a, w))
                        if [x[0] for x in a] != [y[0] for y in w] or err > TIER_TOPK_ATOL:
                            raise AssertionError(f"mesh serve {name}: topk {a} vs {w}")
                        topk.append(err)
                    out[name] = {"pull_launches": {k: launches[k] for k in
                                                   ("gather_rows", "scatter_write_rows")},
                                 "topk_max_abs_err": max(topk)}
                for name, target in (("servant", sv), ("fleet", fleet), ("tiered", tier_sv)):
                    target.apply_rows({"in_table": (dids, vals)})
                    for c in range(0, SERVE_DELTA_ROWS, SERVE_BUCKETS[-1]):
                        if not np.array_equal(target.pull(dids[c:c + SERVE_BUCKETS[-1]]),
                                              vals[c:c + SERVE_BUCKETS[-1]]):
                            raise AssertionError(f"mesh serve {name}: apply_rows not pulled "
                                                 "back")
                    out[name]["apply_rows"] = SERVE_DELTA_ROWS
                out["tiered"]["tiered"] = tier_sv.stats()["tiered"]
                if not out["tiered"]["tiered"]["faults"] > 0:
                    raise AssertionError(f"mesh serve tiered: {out['tiered']['tiered']}")
                shard = sv._tables["in_table"]
                for n in SERVE_BUCKETS:
                    sets = [torch.from_numpy(zipf_ids(n, CLI_CAPACITY, rng)).to(shard.device)
                            for _ in range(ROW_SETS)]
                    case = _gather_case(shard, sets, rate)
                    emit("kernel", name="gather_rows", dtype="torch.float32", path="mesh_serve",
                         rows=n, **case)
                    out[f"gather_rows_b{n}"] = {"shape": [n, shard.shape[1]], **case}
            finally:
                for target in (sv, fleet, tier_sv):
                    target.close()
    out.update(replicas=MESH_TIER_REPLICAS, ids=SERVE_PULL_IDS, requests=list(SERVE_REQUEST_IDS),
               topk=SERVE_TOPK_QUERIES, k=SERVE_K, bit_equal=True,
               seconds=time.monotonic() - t0)
    torch.cuda.empty_cache()
    return out


def _gloo_tier_budget_mb(trainer, seed: int, steps: int = MESH_GLOO_TIER_STEPS) -> float:
    """A budget of ``MESH_GLOO_TIER_SLACK`` x the most distinct units a table
    of ``trainer`` touches in one of its first ``steps`` steps (the tier's
    own plan of the global batches), both tables."""
    most = 0
    for step, batch in zip(range(steps), trainer.batches()):
        ids, _, _ = trainer.tier_plan(batch, seed, step)
        most = max(most, *(np.unique(v).size for v in ids.values()))
    unit = (-(-DIM // 128) * 128 if trainer.packed else DIM) * 4
    return 2 * math.ceil(MESH_GLOO_TIER_SLACK * most) * unit / float(1 << 20)


def _gloo_tier_runs(seed: int, mesh, out_dir: str) -> dict:
    """Leg 2's tier on this rank: packed+pool and ``packed: 0``
    ``MESH_GLOO_TIER_STEPS`` steps resident and tiered (async flush), the
    tables bit-equal (checked here), the tier's counters and slot maps (for
    the parent's check that every rank holds the same); then packed+pool
    tiered saved at ``MESH_GLOO_TIER_SAVE`` and resumed, bit-equal to the
    straight tiered run."""
    out = {}
    for plane, over in (("packed", {}), ("dense", {"packed": 0})):
        loop, losses = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh, **over))
        resident = _table_on_cpu(loop.run(seed=seed, max_steps=MESH_GLOO_TIER_STEPS))
        budget = _gloo_tier_budget_mb(loop.trainer, seed)
        keys = {**over, "table_tier": "host", "tier_hbm_budget_mb": budget,
                "tier_async_flush": 1}
        tloop, tlosses = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh, **keys))
        state, launches = _run_counted(lambda: tloop.run(seed=seed,
                                                         max_steps=MESH_GLOO_TIER_STEPS))
        tiered = _table_on_cpu(state)
        s = tloop.tier.summary()
        out[plane] = {"bit_equal": all(torch.equal(a, b) for a, b in zip(tiered, resident))
                      and tlosses == losses,
                      "budget_mb": budget, "evictions": s["evictions"],
                      "flushed_rows": s["flushed_rows"], "faults": s["faults"],
                      "launches": launches, "tables": s["tables"],
                      "slot_of": {k: torch.from_numpy(t.slot_of.copy())  # torch.load-able
                                  for k, t in tloop.tier.tables.items()}}
        if plane == "packed":
            out["save"] = {"straight": tiered, "losses": tlosses, "keys": keys}
        del state, loop, tloop
    keys = out["save"].pop("keys")
    root = os.path.join(out_dir, "ck-gloo-tier")
    ck = {"param_backup_root": root, "param_backup_period": MESH_GLOO_TIER_SAVE}
    loop, _ = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh, **keys, **ck))
    loop.run(seed=seed, max_steps=MESH_GLOO_TIER_SAVE)
    loop, losses = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh, **keys, **ck,
                                                 resume="auto"))
    resumed = _table_on_cpu(loop.run(seed=seed, max_steps=MESH_GLOO_TIER_STEPS))
    save = out.pop("save")
    out["resume"] = {"bit_equal": all(torch.equal(a, b) for a, b in
                                      zip(resumed, save["straight"]))
                     and losses == save["losses"][MESH_GLOO_TIER_SAVE:],
                     "saved_at": MESH_GLOO_TIER_SAVE, "resumed_to": MESH_GLOO_TIER_STEPS}
    return out


def _gloo_serve(seed: int) -> dict:
    """Leg 2's serving on a ``MESH_GLOO_SERVE`` mesh of the four ranks: a
    servant over a ``[MESH_GLOO_VOCAB, 200]`` table drawn from ``seed`` on
    every rank; rank 0 leads and holds its pulls of ``MESH_GLOO_SERVE_IDS``
    zipf ids (requests of ``SERVE_REQUEST_IDS``) and ``MESH_GLOO_SERVE_TOPK``
    topk against one rank's unmeshed servant, the others follow."""
    from swiftsnails_tpu_torch.parallel.mesh import make_mesh
    from swiftsnails_tpu_torch.serving import Servant, mesh_serve

    m = make_mesh(MESH_GLOO_SERVE, device=MESH_GLOO_DEVICE)
    rng = np.random.default_rng(seed + 29)
    tables = {"in_table": torch.from_numpy(
        rng.standard_normal((MESH_GLOO_VOCAB, DIM)).astype(np.float32))}
    sv = Servant(tables, mesh=m)
    if not mesh_serve.channel(m).leader:
        with sv:
            mesh_serve.follow(m)
        return {"followed": True}
    requests = _requests(zipf_ids(MESH_GLOO_SERVE_IDS, MESH_GLOO_VOCAB, rng))
    with mesh_serve.leading(m), sv, Servant(tables, device=MESH_GLOO_DEVICE) as ref:
        want = [ref.pull(r) for r in requests]
        got, launches = _run_counted(lambda: [sv.pull(r) for r in requests])
        topk = []
        for q in rng.integers(0, MESH_GLOO_VOCAB, MESH_GLOO_SERVE_TOPK):
            a = sv.topk(tables["in_table"][int(q)].numpy(), k=SERVE_K)
            b = ref.topk(tables["in_table"][int(q)].numpy(), k=SERVE_K)
            topk.append(([x[0] for x in a] == [y[0] for y in b],
                         max(abs(x[1] - y[1]) for x, y in zip(a, b))))
        return {"pulls_equal": all(np.array_equal(a, b) for a, b in zip(got, want)),
                "topk_ids_equal": all(t[0] for t in topk),
                "topk_max_abs_err": max(t[1] for t in topk),
                "launches": {k: launches[k] for k in ("gather_rows",)}, "mesh": MESH_GLOO_SERVE,
                "ids": MESH_GLOO_SERVE_IDS, "topk": MESH_GLOO_SERVE_TOPK}


def _gloo_tier_check(results: list) -> dict:
    """Leg 2's tier and serving, from the ranks' results: each plane's
    tiered tables bit-equal to the resident run on every rank, evictions,
    the slot maps equal on every rank; the resume bit-equal; the (1, 4)
    servant's pulls bit-equal to one rank's, its topk ids equal."""
    out = {}
    for plane in ("packed", "dense"):
        runs = [r["tier"][plane] for r in results]
        if not all(run["bit_equal"] for run in runs):
            raise AssertionError(f"mesh gloo tier {plane}: a rank's tiered tables differ "
                                 "from the resident run's (bit-equal expected)")
        if not runs[0]["evictions"] > 0:
            raise AssertionError(f"mesh gloo tier {plane}: no eviction ({runs[0]})")
        for r, run in enumerate(runs):
            same = all(torch.equal(run["slot_of"][k], runs[0]["slot_of"][k])
                       for k in runs[0]["slot_of"])
            if not same or run["evictions"] != runs[0]["evictions"]:
                raise AssertionError(f"mesh gloo tier {plane}: rank {r}'s slot map or "
                                     "counters differ from rank 0's")
        out[plane] = {"bit_equal": True, "slot_maps_equal": True,
                      **{k: runs[0][k] for k in ("budget_mb", "evictions", "flushed_rows",
                                                 "faults", "tables")},
                      "launches_by_rank": [{k: run["launches"][k] for k in
                                            ("gather_rows", "scatter_add_rows",
                                             "scatter_write_rows")} for run in runs]}
    if not all(r["tier"]["resume"]["bit_equal"] for r in results):
        raise AssertionError("mesh gloo tier: the resumed tiered run differs from the "
                             "straight one")
    out["resume"] = results[0]["tier"]["resume"]
    lead = [r["serve"] for r in results if "followed" not in r["serve"]]
    if len(lead) != 1 or not (lead[0]["pulls_equal"] and lead[0]["topk_ids_equal"]
                              and lead[0]["topk_max_abs_err"] <= TIER_TOPK_ATOL):
        raise AssertionError(f"mesh gloo serve: {lead}")
    out["serve"] = lead[0]
    return out


# The loop's guards under the mesh (phase 21 (h)): leg 1 on the (1, 1) NCCL
# mesh at full width, each case against the same run unmeshed (or, for the
# cluster, the resident meshed run of (a)); leg 2 on the four gloo ranks
GUARDS_NAN = "nan_grad@4"
GUARDS_VOTES = 100  # votes timed alone (host clock)
GUARDS_FRESH_EVERY = 5
GUARDS_CLUSTER = {"cluster_workers": 3, "chaos_spec": "preempt@6"}
GUARDS_WD_STEPS = 5
GUARDS_WD_NAN = "nan_grad@2"
# leg 2's heal drill: TIER_HEAL's at a period of 2 (a save and a sweep every
# 2 steps, the flip at step 2, the sweep at step index 3 heals from step 2)
MESH_GLOO_GUARDS = {"steps": 4, "nan": "nan_grad@2", "faulty": 2, "fresh_every": 2,
                    "heal": {"param_backup_period": 2, "tier_verify_period": 2,
                             "chaos_spec": "tier_bitflip@2"}, "heal_steps": 4}


def _tripped(records) -> list:
    """The step indices whose metrics line says the guardrail tripped."""
    return [i for i, r in enumerate(records) if r.get("guard_tripped")]


@contextlib.contextmanager
def _recorded_commits():
    """The indices the cluster's accountant commits, in order."""
    from swiftsnails_tpu_torch.cluster.accounting import BatchAccountant

    seen, commit = [], BatchAccountant.commit

    def spy(self, lease_id, index, *a, **k):
        seen.append(int(index))
        return commit(self, lease_id, index, *a, **k)

    BatchAccountant.commit = spy
    try:
        yield seen
    finally:
        BatchAccountant.commit = commit


@contextlib.contextmanager
def _recorded_heals():
    """Each tier heal's ``(step, tables)``."""
    from swiftsnails_tpu_torch.tiered.manager import TierManager

    seen, heal = [], TierManager.heal

    def spy(self, *a, **k):
        seen.append(heal(self, *a, **k))
        return seen[-1]

    TierManager.heal = spy
    try:
        yield seen
    finally:
        TierManager.heal = heal


def _guards_guardrail(seed: int, corpora, mesh, resident: dict) -> dict:
    """(h) the guardrail: packed+pool with ``guardrail: 1`` and
    ``GUARDS_NAN``, meshed and unmeshed ``MESH_STEPS`` steps: one trip at
    step 4 on both, the tables bit-equal, the row kernels launched as
    often; the step ms with the guardrail on against the resident meshed
    run's (off)."""
    runs = {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        trainer, loop, records = _train_loop("train", seed, corpora, mesh=m, guardrail=1,
                                             chaos_spec=GUARDS_NAN, chaos_seed=seed)
        state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=MESH_STEPS))
        runs[name] = {"tables": _table_on_cpu(state), "guard": loop.guardrail.summary(),
                      "tripped": _tripped(records),
                      "launches": {k: launches[k] for k in ("gather_rows", "scatter_add_rows")},
                      "step_ms_median": statistics.median(
                          r["seconds"] * 1e3 for r in records[1:])}
        del trainer, loop, state
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["one_device"]
    equal = all(torch.equal(x, y) for x, y in zip(a["tables"], b["tables"]))
    nan_at = int(GUARDS_NAN.split("@")[1])
    if not equal or a["tripped"] != [nan_at] or b["tripped"] != [nan_at]:
        raise AssertionError(f"mesh guards guardrail: bit-equal {equal}, trips "
                             f"{a['tripped']} / {b['tripped']}")
    if a["launches"] != b["launches"]:
        raise AssertionError(f"mesh guards guardrail: launches {a['launches']}, unmeshed "
                             f"{b['launches']}")
    # the vote alone (its numbers gathered over each axis, then summed)
    from swiftsnails_tpu_torch.parallel.mesh import vote_sum

    vote_sum(mesh, [1.0, 0.0, 0.0])
    t0 = time.perf_counter()
    for _ in range(GUARDS_VOTES):
        vote_sum(mesh, [1.0, 0.0, 0.0])
    vote_ms = (time.perf_counter() - t0) * 1e3 / GUARDS_VOTES
    return {"chaos": GUARDS_NAN, "steps": MESH_STEPS, "bit_equal": True,
            "tripped": a["tripped"], "trust": a["guard"]["trust"],
            "update_norm": a["guard"]["last_update_norm"], "launches": a["launches"],
            "step_ms_median_on": a["step_ms_median"],
            "step_ms_median_off": resident["step_ms_median"],
            "one_device_step_ms_median_on": b["step_ms_median"], "vote_ms": vote_ms}


def _sweep_result(run: dict, events: list, heals) -> dict:
    """What the sweep's gates read of a ``_tier_w2v`` heal drill."""
    return {"tables": _table_on_cpu(run["state"]), "heals": heals, "events": events,
            "launches": {k: run["launches"][k] for k in
                         ("gather_rows", "scatter_add_rows", "scatter_write_rows")},
            "evictions": run["loop"].tier.summary()["evictions"],
            "step_ms_median": run["step_ms_median"]}


def _guards_sweep(seed: int, corpora, mesh, tmp: str, heal_drill=None) -> dict:
    """(h) the tier's sweep: packed+pool behind ``TIER``'s 64 MB with
    ``TIER_HEAL`` (saves every 5 steps, the sweep every 5, a bit flipped
    at step 7), ``TIER_HEAL_STEPS`` steps under the mesh: one heal at step
    index 9 from the step-5 save, one ledger event, the tables bit-equal
    to the unmeshed drill's and the row kernels launched as often; the
    unmeshed drill is ``heal_drill`` (the tiered phase's, same config),
    else run here."""
    from swiftsnails_tpu_torch.telemetry.ledger import Ledger

    runs = {"one_device": heal_drill} if heal_drill is not None else {}
    for name, m in (("one_device", None), ("mesh", mesh)):
        if name in runs:
            continue
        root = os.path.join(tmp, f"guards-heal-{name}")
        ledger = os.path.join(tmp, f"guards-heal-{name}.jsonl")
        with _recorded_heals() as heals:
            run = _tier_w2v(seed, corpora, TIER_HEAL_STEPS, mesh=m, **TIER, **TIER_HEAL,
                            chaos_seed=seed, param_backup_root=root, ledger_path=ledger)
        events = [e for e in Ledger(ledger).records("cache_error") if e.get("source") == "tier"]
        runs[name] = _sweep_result(run, events, list(heals))
        del run
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    a, b = runs["mesh"], runs["one_device"]
    for name, r in runs.items():
        ev = r["events"]
        if (len(ev) != 1 or ev[0]["step"] != 9 or ev[0]["rebuilt_from_step"] != 5
                or (r["heals"] is not None and [h[0] for h in r["heals"]] != [5])):
            raise AssertionError(f"mesh guards sweep {name}: events {ev}, heals {r['heals']}")
    equal = all(torch.equal(x, y) for x, y in zip(a["tables"], b["tables"]))
    if not equal or a["launches"] != b["launches"] or a["events"][0]["tables"] != \
            b["events"][0]["tables"]:
        raise AssertionError(f"mesh guards sweep: bit-equal {equal}, launches {a['launches']} "
                             f"/ {b['launches']}, events {a['events']} / {b['events']}")
    return {"steps": TIER_HEAL_STEPS, "budget_mb": TIER["tier_hbm_budget_mb"],
            "chaos": TIER_HEAL["chaos_spec"], "bit_equal": True, "heals": a["heals"],
            "event": {k: a["events"][0][k] for k in ("step", "rebuilt_from_step", "tables")},
            "unmeshed_from": "the tiered phase" if heal_drill is not None else "this leg",
            "evictions": a["evictions"], "launches": a["launches"],
            "step_ms_median": {k: r["step_ms_median"] for k, r in runs.items()}}


def _guards_freshness(seed: int, corpora, mesh, tmp: str, rate: float) -> dict:
    """(h) freshness: packed+pool under the mesh publishing every
    ``GUARDS_FRESH_EVERY`` steps into a directory, ``MESH_STEPS`` steps,
    from a start state a 2-replica ``Fleet`` serves; the fleet follows the
    log (``DeltaSubscriber.poll``): its whole planes and its pulls of every
    published row (and as many others) equal the trained tables, bit for
    bit. Then ``gather_rows`` as the meshed publisher runs it (a publish's
    touched in-table rows from the trained shard, the owned gather) and
    ``scatter_write_rows`` as the fleet's apply runs it (a batch's rows into
    a ``[1,048,576, 200]`` serving plane), bit-equal to plain, timed beside
    ``index_select`` / ``index_copy_``, against the byte bound."""
    from swiftsnails_tpu_torch.freshness.log import list_seqs, read_batch, seg_path
    from swiftsnails_tpu_torch.freshness.subscriber import DeltaSubscriber
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.serving import Fleet, Servant
    from swiftsnails_tpu_torch.serving.engine import normalize_table

    names = ("in_table", "out_table")
    d = os.path.join(tmp, "guards-deltas")
    trainer, loop, records = _train_loop("train", seed, corpora, mesh=mesh,
                                         freshness_publish=GUARDS_FRESH_EVERY,
                                         freshness_dir=d, freshness_log_mb=FRESH_LOG_MB)
    start = trainer.init_state()
    trainer.init_state = lambda: start
    planes = {n: normalize_table(getattr(start, n).table, DIM, "packed").clone() for n in names}
    fleet = Fleet(lambda rid: Servant(planes, device="cuda"), replicas=2)
    try:
        state, launches = _run_counted(lambda: loop.run(seed=seed, max_steps=MESH_STEPS))
        pub = loop.freshness.stats()
        sub = DeltaSubscriber(fleet, d)
        applied, apply_launches = _run_counted(sub.poll)
        want = {n: normalize_table(getattr(state, n).table, DIM, "packed") for n in names}
        batches = [read_batch(seg_path(d, s))[1] for s in list_seqs(d)]
        rows = {n: np.unique(np.concatenate([b[n]["rows"] for b in batches])) for n in names}
        rng = np.random.default_rng(seed + 31)
        ids = {n: np.concatenate([r, np.setdiff1d(rng.choice(VOCAB, r.size, replace=False), r)])
               for n, r in rows.items()}
        planes_diff = _plane_mismatch(want, fleet.replicas()[0].servant._tables)
        pulls_diff = _pull_mismatch(fleet, want, ids)
        n_pub = pub["published_batches"]
        if (planes_diff or pulls_diff or loop.freshness.errors or applied != n_pub
                or n_pub != MESH_STEPS // GUARDS_FRESH_EVERY):
            raise AssertionError(f"mesh guards freshness: planes {planes_diff}, pulls "
                                 f"{pulls_diff}, published {pub}, applied {applied}")
        publisher_gathers = launches["gather_rows"] - 2 * MESH_STEPS
        if publisher_gathers != len(names) * n_pub:
            raise AssertionError(f"mesh guards freshness: {publisher_gathers} publisher "
                                 f"gathers, want {len(names) * n_pub}")
        # the kernels at the meshed publisher's and the apply's shapes
        shard = state.in_table.table
        dev = shard.device
        sets = [torch.from_numpy(b["in_table"]["rows"].astype(np.int32)).to(dev)
                for b in batches]
        gather = _gather_case(shard, sets, rate)
        emit("kernel", name="gather_rows", dtype="torch.float32", path="mesh_guards",
             rows=int(sets[0].numel()), **gather)
        gather["shape"] = [int(sets[0].numel()), *shard.shape[1:]]
        serving = want["in_table"].clone()
        row_bytes = serving.stride(0) * serving.element_size()
        psets = []
        for b in batches:
            uniq = torch.from_numpy(b["in_table"]["rows"].astype(np.int32)).to(dev)
            vals = torch.from_numpy(np.array(b["in_table"]["values"])).to(dev)
            psets.append((uniq, vals, uniq.long(), int(uniq.numel())))
        n = psets[0][3]
        write = _push_case(
            lambda bf, u, v: (rowdma.scatter_write_rows(bf[0], u, v),),
            lambda bf, u, v: (rowdma.scatter_write_rows_plain(bf[0], u, v),),
            [serving], psets, lambda bf, st: bf[0].index_copy_(0, st[2], st[1]),
            n * (2 * row_bytes + 4), n, rate)
        emit("kernel", name="scatter_write_rows", dtype="torch.float32", path="mesh_guards",
             **write)
        write["shape"] = list(serving.shape)
        out = {"every": GUARDS_FRESH_EVERY, "steps": MESH_STEPS, "published_batches": n_pub,
               "rows": {k: int(v.size) for k, v in rows.items()}, "replicas": 2,
               "planes_bit_equal": True, "pulls_bit_equal": True,
               "pulled_ids": {k: int(v.size) for k, v in ids.items()},
               "publish_ms": {k: pub[k] / n_pub for k in ("step_wait_ms", "gather_ms",
                                                         "d2h_ms", "write_ms")},
               "launches": {"gather_rows": launches["gather_rows"],
                            "publisher_gather_rows": publisher_gathers,
                            "scatter_write_rows": apply_launches["scatter_write_rows"]},
               "kernels": {"gather_rows": gather, "scatter_write_rows": write}}
        del serving, psets, sets, shard, want, state, start, planes
        return out
    finally:
        fleet.close()
        torch.cuda.empty_cache()


def _guards_cluster(seed: int, corpora, mesh, tmp: str, resident: dict) -> dict:
    """(h) cluster leases: packed+pool under the mesh with
    ``GUARDS_CLUSTER`` (``cluster_workers: 3``, ``preempt@6``) and a
    checkpoint root, drained at step 7 with a final save, then resumed
    (``resume: auto``) to ``MESH_STEPS``: every index committed once, in
    order, and the tables bit-equal to the resident meshed run of (a)."""
    root = os.path.join(tmp, "guards-cluster")
    with _recorded_commits() as commits:
        _, loop, _ = _train_loop("train", seed, corpora, mesh=mesh, param_backup_root=root,
                                 **GUARDS_CLUSTER)
        loop.run(seed=seed, max_steps=MESH_STEPS)
        preempted, first = loop.preempted, list(commits)
        del loop
        _, loop, records = _train_loop("train", seed, corpora, mesh=mesh,
                                       param_backup_root=root, resume="auto",
                                       cluster_workers=GUARDS_CLUSTER["cluster_workers"])
        state = loop.run(seed=seed, max_steps=MESH_STEPS)
        exact = loop.cluster.supervisor.accountant.verify(MESH_STEPS)
        cursor = loop.cluster.cursor()
    tables = _table_on_cpu(state)
    del state, loop
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    equal = all(torch.equal(a, b) for a, b in zip(tables, resident["tables"]))
    if not preempted or commits != list(range(MESH_STEPS)) or not equal:
        raise AssertionError(f"mesh guards cluster: preempted {preempted}, commits {commits}, "
                             f"bit-equal {equal}")
    return {"keys": GUARDS_CLUSTER, "steps": MESH_STEPS, "commits_before": first,
            "commits_after": commits[len(first):], "exactly_once": True,
            "watermarks": cursor.get("committed"), "bit_equal_uninterrupted": True,
            "resumed_losses": [r["loss"] for r in records]}


def _guards_widedeep(seed: int, mesh) -> dict:
    """(h) Wide & Deep: ``examples/widedeep.conf`` with ``guardrail: 1``
    and ``GUARDS_WD_NAN``, ``GUARDS_WD_STEPS`` steps meshed and unmeshed:
    every array bit-equal, one trip, the same launches of ``gather_rows``
    and ``scatter_adagrad_fused_rows``."""
    data, _ = _ctr_data(seed)
    runs = {name: _mesh_ctr_run(seed, data, m, GUARDS_WD_STEPS, guardrail=1,
                                chaos_spec=GUARDS_WD_NAN, chaos_seed=seed)
            for name, m in (("one_device", None), ("mesh", mesh))}
    _ctr_equal("mesh guards widedeep", runs["mesh"]["state"], runs["one_device"]["state"])
    kernels = ("gather_rows", "scatter_adagrad_fused_rows")
    got = {k: runs["mesh"]["launches"][k] for k in kernels}
    want = {k: runs["one_device"]["launches"][k] for k in kernels}
    if got != want:
        raise AssertionError(f"mesh guards widedeep: launches {got}, unmeshed {want}")
    out = {"chaos": GUARDS_WD_NAN, "steps": GUARDS_WD_STEPS, "bit_equal": True,
           "launches": got, "step_ms_median": {k: r["step_ms_median"] for k, r in runs.items()}}
    del runs
    torch.cuda.empty_cache()
    return out


def _mesh_guards_leg(seed: int, corpora, mesh, resident: dict, tmp: str, rate: float,
                     heal_drill=None) -> dict:
    """Leg 1's guards (phase 21 (h)): each case timed."""
    out = {}
    for name, fn in (("guardrail", lambda: _guards_guardrail(seed, corpora, mesh, resident)),
                     ("sweep", lambda: _guards_sweep(seed, corpora, mesh, tmp, heal_drill)),
                     ("freshness", lambda: _guards_freshness(seed, corpora, mesh, tmp, rate)),
                     ("cluster", lambda: _guards_cluster(seed, corpora, mesh, tmp, resident)),
                     ("widedeep", lambda: _guards_widedeep(seed, mesh))):
        t0 = time.monotonic()
        out[name] = fn()
        out[name]["seconds"] = time.monotonic() - t0
    return out


def _gloo_guard_runs(seed: int, mesh, out_dir: str) -> dict:
    """Leg 2's guards on this rank: packed+pool with the guardrail and
    ``nan_grad`` on the faulty rank alone; the tier's bitflip drill with
    the flip on the faulty rank's master alone; freshness into a directory
    of this rank's own; ``cluster_workers: 1``. The steps each tripped at,
    the heals, whether this rank wrote deltas, the leased indices."""
    import torch.distributed as dist

    from swiftsnails_tpu_torch.framework import trainer as tmod

    g = MESH_GLOO_GUARDS
    faulty = dist.get_rank() == g["faulty"]
    out = {}
    records = []
    loop, _ = _loss_loop(_mesh_gloo_trainer(
        seed, MESH_GLOO_DEVICE, mesh, guardrail=1, chaos_seed=seed,
        **({"chaos_spec": g["nan"]} if faulty else {})), records)
    loop.run(seed=seed, max_steps=g["steps"])
    out["nan"] = {"tripped": _tripped(records), "trips": loop.guardrail.trips_total}
    budget = _gloo_tier_budget_mb(loop.trainer, seed, g["heal_steps"])
    keys = {"table_tier": "host", "tier_hbm_budget_mb": budget,
            "param_backup_root": os.path.join(out_dir, "gloo-guards-heal"),
            **{k: v for k, v in g["heal"].items() if k != "chaos_spec"}}
    if faulty:
        keys["chaos_spec"] = g["heal"]["chaos_spec"]
    loop, _ = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh, chaos_seed=seed,
                                            **keys))
    with _recorded_heals() as heals:
        loop.run(seed=seed, max_steps=g["heal_steps"])
    out["heal"] = {"heals": [(s, list(t)) for s, t in heals], "verify": loop.tier.verify(),
                   "evictions": loop.tier.summary()["evictions"]}
    d = os.path.join(out_dir, f"gloo-guards-deltas-{dist.get_rank()}")
    loop, _ = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh,
                                            freshness_publish=g["fresh_every"],
                                            freshness_dir=d))
    loop.run(seed=seed, max_steps=g["steps"])
    out["fresh"] = {"files": len(os.listdir(d)) if os.path.isdir(d) else 0,
                    "errors": loop.freshness.errors}
    agreed, bcast = [], tmod.broadcast_ints

    def spy(m, values, n):
        got = bcast(m, values, n)
        agreed.append(got[0])
        return got

    tmod.broadcast_ints = spy
    try:
        loop, _ = _loss_loop(_mesh_gloo_trainer(seed, MESH_GLOO_DEVICE, mesh,
                                                cluster_workers=1))
        loop.run(seed=seed, max_steps=g["steps"])
    finally:
        tmod.broadcast_ints = bcast
    out["cluster"] = {"agreed": agreed[1:]}
    return out


def _gloo_guards_check(results: list) -> dict:
    """Leg 2's guards, from the ranks' results: every rank tripped at the
    faulty rank's NaN step, once; every rank healed the same table from
    the same save, its digests clean; only rank 0 wrote delta files; every
    rank took the same leased indices, in order."""
    g = MESH_GLOO_GUARDS
    runs = [r["guards"] for r in results]
    nan_at = int(g["nan"].split("@")[1])
    if any(r["nan"]["tripped"] != [nan_at] or r["nan"]["trips"] != 1 for r in runs):
        raise AssertionError(f"mesh gloo guards: trips {[r['nan'] for r in runs]}")
    heals = [r["heal"]["heals"] for r in runs]
    saved = g["heal"]["param_backup_period"]
    if any(h != heals[0] for h in heals) or [s for s, _ in heals[0]] != [saved] \
            or any(r["heal"]["verify"] for r in runs):
        raise AssertionError(f"mesh gloo guards: heals {heals}")
    files = [r["fresh"]["files"] for r in runs]
    if not files[0] or any(files[1:]) or any(r["fresh"]["errors"] for r in runs):
        raise AssertionError(f"mesh gloo guards: delta files by rank {files}")
    agreed = [r["cluster"]["agreed"] for r in runs]
    if any(a != agreed[0] for a in agreed) or agreed[0][:g["steps"]] != list(range(g["steps"])):
        raise AssertionError(f"mesh gloo guards: leased indices by rank {agreed}")
    return {"faulty_rank": g["faulty"], "nan": g["nan"], "tripped": runs[0]["nan"]["tripped"],
            "heals": heals[0], "evictions": runs[0]["heal"]["evictions"],
            "delta_files_by_rank": files, "leased": agreed[0], "steps": g["steps"],
            "heal_steps": g["heal_steps"]}


def _mesh_guards_kernel_entries(mesh: dict) -> list:
    """The ``kernels`` line's ``path: "mesh_guards"`` entries: the meshed
    publisher's owned ``gather_rows`` and the fleet's ``scatter_write_rows``
    at their shapes, with the guards freshness run's launches."""
    fresh = mesh["guards"]["freshness"]
    out = []
    for key, replaces in (("gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
                          ("scatter_write_rows", "swiftsnails_tpu/ops/rowdma.py:289")):
        s = fresh["kernels"][key]
        out.append({
            "name": key, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": fresh["launches"][key],
            "max_abs_err": s["max_abs_err"], "ms": s.get("ms", s.get("kernel_ms")),
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["library_ms"], "shape": s["shape"], "dtype": "float32",
            "path": "mesh_guards"})
    return out


def _mesh_tier_kernel_entries(summary: dict, mesh: dict) -> list:
    """The ``kernels`` line's ``path: "mesh_tier"`` entries (the tiered
    path's kernels at the meshed tier's shapes, with leg 1's launches) and
    ``"mesh_serve"`` ones (the owned gather of a meshed pull at the bucket
    shapes, with the meshed servant's launches)."""
    out = _tiered_kernel_entries(summary, mesh["tier"], path="mesh_tier")
    for n in SERVE_BUCKETS:
        s = mesh["serve"][f"gather_rows_b{n}"]
        out.append({
            "name": "gather_rows", "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": "swiftsnails_tpu/ops/rowdma.py:114",
            "launches": mesh["serve"]["servant"]["pull_launches"]["gather_rows"],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32", "path": "mesh_serve"})
    return out


def phase_mesh(seed: int, corpora, env: dict, serve: dict, heal_drill=None) -> dict:
    """Phase 21: word2vec, CTR, checkpoints, ``seqlm``, the tier and
    serving under a mesh, and the loop's guards there (module docstring).
    ``serve``: the serve phase's checkpoint (``root``, ``cfg``);
    ``heal_drill``: the tiered phase's unmeshed heal drill, or None to run
    it here."""
    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="ssn-mesh-")
    ranks = _mesh_gloo_spawn(seed, tmp)  # leg 2 runs beside leg 1
    try:
        with _nccl_mesh(tmp) as mesh:
            resident = {}
            nccl = _mesh_nccl_leg(seed, corpora, mesh, resident)
            t_tier = time.monotonic()
            tier_w2v = _mesh_tier_w2v(seed, corpora, mesh, resident)
            tier_s = time.monotonic() - t_tier
            t_guards = time.monotonic()
            guards = _mesh_guards_leg(seed, corpora, mesh, resident, tmp, env["mem_rate_Bps"],
                                      heal_drill)
            guards["seconds"] = time.monotonic() - t_guards
            del resident
            t_tier = time.monotonic()
            tier_wd = _mesh_tier_widedeep(seed, mesh)
            tier_s += time.monotonic() - t_tier
            serve_leg = _mesh_serve_leg(seed, mesh, serve, env["mem_rate_Bps"])
            t_grouped = time.monotonic()
            grouped = _mesh_grouped_leg(seed, corpora, mesh)
            grouped["seconds"] = time.monotonic() - t_grouped
            hybrid = _mesh_hybrid_leg(seed, corpora, mesh)
            ctr = _mesh_ctr_nccl_leg(seed, mesh, tmp)
            ctr_layouts = _mesh_ctr_layouts(seed, mesh)
            wire = _mesh_wire_leg(seed, corpora, mesh)
            gloo = _mesh_gloo_leg(seed, tmp, mesh, ranks)
    finally:
        _mesh_gloo_stop(ranks)
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.monotonic() - t_phase
    tier = {"w2v": {k: v for k, v in tier_w2v.items() if k != "shapes"},
            "widedeep": tier_wd, "seconds": tier_s}
    guards_line = {k: ({kk: vv for kk, vv in v.items() if kk != "kernels"}
                       if isinstance(v, dict) else v) for k, v in guards.items()}
    guards_line["gloo"] = gloo.pop("guards")
    emit("mesh", nccl=nccl, grouped=grouped, hybrid=hybrid, ctr=ctr, ctr_layouts=ctr_layouts,
         wire=wire, tier=tier, serve=serve_leg, guards=guards_line, gloo=gloo,
         seconds=seconds, device=env["device"], nvidia_smi=env["nvidia_smi"])
    return {"tier": {"launches": {**tier_w2v["launches"], "scatter_adagrad_fused_rows":
                                  tier_wd["launches"]["scatter_adagrad_fused_rows"]},
                     "shapes": {**tier_w2v["shapes"], "wd_cache": tier_wd["wd_cache"],
                                "wd_pushed_tiles": tier_wd["wd_pushed_tiles"]}},
            "serve": serve_leg,
            "guards": guards,
            "launches": nccl["train"]["launches"],
            "grouped_launches": grouped["plain"]["launches"],
            "ctr_launches": ctr["launches"],
            "gloo_ctr_launches": gloo["widedeep"]["launches_by_rank"],
            "hybrid_launches": {**hybrid["hybrid"]["launches"],
                                **{f"ctr_{k}": n for k, n
                                   in ctr_layouts["hybrid"]["launches"].items()}},
            "seconds": seconds}


def phase_mesh_grouped_kernels(seed: int, corpora, rate: float) -> dict:
    """``gather_rows`` and ``scatter_add_rows`` at the grouped plane's
    shapes, on the ids of a step of its batches (8 substeps) and pools drawn
    as it draws them, against a ``[1,048,576, 2, 128]`` f32 table: the
    in-table pull of 8,192 centers, the out-table pull of 83,968 rows
    (81,920 window slots, a pad reading row 0 as the shard-local pull does,
    then 2,048 pool rows), and each push of the merged unique rows (padded
    with the padding id). Bit-equal to plain, timed beside it and
    ``index_select`` / ``index_add_``, against the byte bound."""
    dev = torch.device("cuda")
    trainer, _, _ = _train_loop(MESH_GROUPED, seed, corpora)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = next(iter(trainer.batches()))
    centers = torch.from_numpy(batch["centers"]).to(dev).reshape(FUSED_STEPS_PER_CALL, -1)
    ctxs = torch.from_numpy(batch["contexts"]).to(dev).reshape(FUSED_STEPS_PER_CALL,
                                                               GROUPED_BATCH, CW)
    sets = {"gather_in": [], "gather_out": [], "scatter_in": [], "scatter_out": []}
    valid = {"scatter_in": [], "scatter_out": []}
    for c, x in zip(centers, ctxs):
        pools = trainer._grouped_pools(gen, GROUPED_BATCH, None).reshape(-1)
        sets["gather_in"].append(c.contiguous())
        sets["gather_out"].append(torch.cat([x.clamp_min(0).reshape(-1), pools]))
        for key, rows in (("scatter_in", c), ("scatter_out", torch.cat([x[x >= 0], pools]))):
            uniq = torch.unique(rows).to(torch.int32)
            valid[key].append(int(uniq.numel()))
            n = rows.numel() if key == "scatter_in" else x.numel() + pools.numel()
            pad = torch.full((n - uniq.numel(),), VOCAB, dtype=torch.int32, device=dev)
            sets[key].append(torch.cat([uniq, pad]))
    del trainer
    shape = (VOCAB, -(-DIM // 128), 128)
    table = torch.randn(shape, generator=gen, device=dev)
    out = {}
    for key in ("gather_in", "gather_out"):
        case = _gather_case(table, sets[key], rate)
        out[key] = {"shape": [sets[key][0].numel(), *shape[1:]], **case}
        emit("kernel", name="gather_rows", dtype="torch.float32", path="mesh_grouped",
             rows=sets[key][0].numel(), **case)
    for key in ("scatter_in", "scatter_out"):
        n = sets[key][0].numel()
        deltas = [torch.randn((n, *shape[1:]), generator=gen, device=dev).mul_(1e-3)
                  for _ in sets[key]]
        case = _scatter_case(table, sets[key], deltas, valid[key], rate)
        out[key] = {"shape": [n, *shape[1:]], **case}
        emit("kernel", name="scatter_add_rows", dtype="torch.float32", path="mesh_grouped",
             rows=n, **case)
        del deltas
    del table
    torch.cuda.empty_cache()
    return out


def phase_mesh_hybrid_kernels(seed: int, corpora, rate: float) -> dict:
    """The row kernels at the hybrid tail's shapes (``kernel`` lines, ``path:
    "mesh_hybrid"``), bit-equal to plain, timed beside it and
    ``index_select`` / ``index_add_``, against the byte bound: on leg 1's
    grouped plane (``MESH_HYBRID``: the head ``HOT_ROWS`` rows, the tail
    ``[VOCAB - HOT_ROWS, 2, 128]`` at a cap of ``MESH_GROUPED_COVER``
    rows) a step's tail pulls (``gather_rows`` of each table's unique tail
    list, its padding reading row 0 as the shard-local pull does) and
    pushes (``scatter_add_rows`` of the listed rows, padded with the padding
    id); on W&D with ``placement: hybrid`` (the head 1,024 rows, 256
    tiles) the tail's ``gather_rows`` of a step's tiles and its
    ``scatter_adagrad_fused_rows`` of them merged."""
    from swiftsnails_tpu_torch.data.ctr import ctr_batches
    from swiftsnails_tpu_torch.ops import rowdma
    from swiftsnails_tpu_torch.ops.hashing import hash_row
    from swiftsnails_tpu_torch.parallel.store import merge_small_rows, small_group

    dev = torch.device("cuda")
    cut, cap = HOT_ROWS, MESH_GROUPED_COVER
    tail_rows = VOCAB - cut
    trainer, _, _ = _train_loop(MESH_GROUPED, seed, corpora)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = next(iter(trainer.batches()))
    centers = torch.from_numpy(batch["centers"]).to(dev).reshape(FUSED_STEPS_PER_CALL, -1)
    ctxs = torch.from_numpy(batch["contexts"]).to(dev).reshape(FUSED_STEPS_PER_CALL,
                                                               GROUPED_BATCH, CW)
    sets = {"gather_in": [], "gather_out": [], "scatter_in": [], "scatter_out": []}
    valid = {"scatter_in": [], "scatter_out": []}
    for c, x in zip(centers, ctxs):
        pools = trainer._grouped_pools(gen, GROUPED_BATCH, None).reshape(-1)
        for side, rows in (("in", c), ("out", torch.cat([x[x >= 0], pools]))):
            uniq = torch.unique(rows[rows >= cut] - cut).to(torch.int32)
            pad = cap - uniq.numel()
            sets[f"gather_{side}"].append(torch.cat([uniq, uniq.new_zeros(pad)]))
            sets[f"scatter_{side}"].append(torch.cat([uniq, uniq.new_full((pad,), tail_rows)]))
            valid[f"scatter_{side}"].append(int(uniq.numel()))
    del trainer
    shape = (tail_rows, -(-DIM // 128), 128)
    table = torch.randn(shape, generator=gen, device=dev)
    out = {}
    for key in ("gather_in", "gather_out"):
        case = _gather_case(table, sets[key], rate)
        out[key] = {"shape": [cap, *shape[1:]], **case}
        emit("kernel", name="gather_rows", dtype="torch.float32", path="mesh_hybrid",
             rows=cap, tail_rows=int(valid[key.replace("gather", "scatter")][0]), **case)
    for key in ("scatter_in", "scatter_out"):
        deltas = [torch.randn((cap, *shape[1:]), generator=gen, device=dev).mul_(1e-3)
                  for _ in sets[key]]
        case = _scatter_case(table, sets[key], deltas, valid[key], rate)
        out[key] = {"shape": [cap, *shape[1:]], **case}
        emit("kernel", name="scatter_add_rows", dtype="torch.float32", path="mesh_hybrid",
             rows=cap, **case)
        del deltas
    del table
    torch.cuda.empty_cache()
    # W&D's hashed table: its default hybrid head (min(1024, capacity / 2)
    # rows, a whole number of tiles on one model shard)
    cfg = _widedeep_config(seed)
    dim, capacity = 1 + cfg.get_int("embed_dim"), cfg.get_int("capacity")
    lr, g = cfg.get_float("learning_rate"), small_group(1 + cfg.get_int("embed_dim"))
    head_tiles = min(1024, capacity // 2) // g
    tail_tiles = capacity // g - head_tiles
    (labels, feats), _ = _ctr_data(seed)
    batches = ctr_batches(labels, feats, cfg.get_int("batch_size"), np.random.default_rng(seed))
    tile_sets, merged_sets = [], []
    for _, b in zip(range(CTR_ROW_SETS), batches):
        rows = hash_row(torch.from_numpy(b["feats"]).to(dev).clamp_min(0), capacity).reshape(-1)
        tail = rows - head_tiles * g
        owned = tail >= 0
        tile_sets.append(torch.where(owned, tail // g, 0))  # the tail pull's tiles
        grads = torch.randn(rows.shape[0], dim, generator=gen, device=dev).mul_(0.01)
        t_rows = torch.where(owned, tail, tail_tiles * g)  # head rows: padding
        uniq, merged = merge_small_rows(t_rows, grads, dim, tail_tiles)
        n_valid = int((uniq < tail_tiles).sum())
        merged_sets.append((uniq, merged, uniq[:n_valid].long(), n_valid))
    live = (torch.arange(128, device=dev) % (128 // g)) < dim
    fused = torch.cat([torch.randn(tail_tiles, 1, 128, generator=gen, device=dev).mul_(0.01),
                       torch.rand(tail_tiles, 1, 128, generator=gen, device=dev).mul_(0.1)],
                      dim=1).mul_(live)
    pull = _gather_case(fused, tile_sets, rate)
    out["gather_widedeep"] = {"shape": [int(tile_sets[0].numel()), *fused.shape[1:]], **pull}
    emit("kernel", name="gather_rows", dtype="torch.float32", path="mesh_hybrid_ctr",
         rows=int(tile_sets[0].numel()), **pull)
    n_valid, n_ids = merged_sets[0][3], merged_sets[0][0].numel()
    # param and accumulator read and written, the gradient read: 5 sublanes
    # a unique tile; the ids read once
    nbytes = n_valid * 5 * 128 * 4 + n_ids * 4
    case = _push_case(
        lambda b, u, v: (rowdma.scatter_adagrad_fused_rows(b[0], u, v, lr),),
        lambda b, u, v: (rowdma.scatter_adagrad_fused_rows_plain(b[0], u, v, lr),),
        [fused], merged_sets, None, nbytes, n_valid, rate)
    out["scatter_adagrad_fused_rows"] = {"shape": list(fused.shape), **case}
    emit("kernel", name="scatter_adagrad_fused_rows", dtype="torch.float32",
         path="mesh_hybrid_ctr", **case)
    del fused
    torch.cuda.empty_cache()
    return out


def _mesh_hybrid_kernel_entries(cases: dict, mesh: dict) -> list:
    """The ``kernels`` line's ``path: "mesh_hybrid"`` entries: the hybrid
    tail's pulls and pushes on leg 1's grouped plane and W&D, with the
    launches of leg 1's hybrid runs."""
    launches = mesh["hybrid_launches"]
    out = []
    for key, name, replaces, counted in (
            ("gather_in", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114", "gather_rows"),
            ("gather_out", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114", "gather_rows"),
            ("scatter_in", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213",
             "scatter_add_rows"),
            ("scatter_out", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213",
             "scatter_add_rows"),
            ("gather_widedeep", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114",
             "ctr_gather_rows"),
            ("scatter_adagrad_fused_rows", "scatter_adagrad_fused_rows",
             "swiftsnails_tpu/ops/rowdma.py:552", "ctr_scatter_adagrad_fused_rows")):
        s = cases[key]
        out.append({
            "name": name, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": launches[counted],
            "max_abs_err": s["max_abs_err"], "ms": s.get("kernel_ms", s.get("ms")),
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["library_ms"], "shape": s["shape"], "dtype": "float32",
            "path": "mesh_hybrid_ctr" if counted.startswith("ctr_") else "mesh_hybrid"})
    return out


def _mesh_kernel_entries(summary: dict, mesh: dict) -> list:
    """The ``kernels`` line's ``path: "mesh"`` entries: the (1, 1) mesh's
    shard is the whole packed+pool table and its step the main path's, so
    phase 3's numbers at that shape, with the meshed run's launches."""
    out = []
    for key, replaces in (("gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
                          ("scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213")):
        s = summary[key]
        out.append({
            "name": key, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": mesh["launches"][key],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32", "path": "mesh"})
    return out


def _mesh_grouped_kernel_entries(cases: dict, mesh: dict) -> list:
    """The ``kernels`` line's ``path: "mesh_grouped"`` entries: the grouped
    plane's pulls and pushes, with the plain plane's launches in leg 1."""
    out = []
    for key, name, replaces in (
            ("gather_in", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("gather_out", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("scatter_in", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213"),
            ("scatter_out", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213")):
        s = cases[key]
        out.append({
            "name": name, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": mesh["grouped_launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32", "path": "mesh_grouped"})
    return out


def _mesh_ctr_kernel_entries(summary: dict, mesh: dict) -> list:
    """The ``kernels`` line's ``path: "mesh_ctr"`` entries: the (1, 1) mesh's
    W&D shard is the whole ``[262,144, 2, 128]`` table and its step the
    unmeshed one's, so the ``ctr_kernels`` numbers at that shape (212,992
    tile ids), with leg 1's launches and the gloo ranks'."""
    out = []
    for key, name, replaces in (
            ("gather_rows_widedeep", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("scatter_adagrad_fused_rows", "scatter_adagrad_fused_rows",
             "swiftsnails_tpu/ops/rowdma.py:552")):
        s = summary[key]
        out.append({
            "name": name, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": mesh["ctr_launches"][name],
            "max_abs_err": s["max_abs_err"], "ms": s.get("kernel_ms", s.get("ms")),
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["library_ms"], "shape": s["shape"], "dtype": "float32",
            "gloo_launches_by_rank": [r[name] for r in mesh["gloo_ctr_launches"]],
            "path": "mesh_ctr"})
    return out


def _only_mesh(seed: int, env: dict, corpora: dict, t_start: float) -> int:
    """``--only mesh``: the kernels' phase 3 and the W&D row kernels'
    phase (the mesh entries' numbers), a serve checkpoint of its own (the
    meshed servants'), the mesh phase and the kernels at the grouped
    plane's and the meshed tier's shapes."""
    rate = env["mem_rate_Bps"]
    with clocked("kernels"):
        summary = phase_kernels(seed, rate)
    with clocked("ctr_kernels"):
        summary.update(phase_ctr_kernels(seed, rate))
    tmp = tempfile.mkdtemp(prefix="ssn-serve-")
    try:
        root = os.path.join(tmp, "ckpt")
        with clocked("serve_checkpoint"):
            built = _build_serve_checkpoint(seed, corpora, root, "cuda")
        with clocked("mesh"):
            mesh = phase_mesh(seed, corpora, env, {"root": root, "cfg": built["cfg"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with clocked("mesh_kernels"):
        cases = phase_mesh_grouped_kernels(seed, corpora, rate)
        hybrid = phase_mesh_hybrid_kernels(seed, corpora, rate)
        summary.update(phase_tiered_kernels(mesh["tier"], seed, rate, path="mesh_tier"))
    emit("kernels", kernels=_mesh_kernel_entries(summary, mesh)
         + _mesh_grouped_kernel_entries(cases, mesh)
         + _mesh_ctr_kernel_entries(summary, mesh)
         + _mesh_hybrid_kernel_entries(hybrid, mesh)
         + _mesh_tier_kernel_entries(summary, mesh)
         + _mesh_guards_kernel_entries(mesh))
    emit_total(t_start)
    return 0


def _only_seqlm(seed: int, env: dict, corpora: dict, t_start: float) -> int:
    """``--only seqlm``: the sequence model's phase."""
    with clocked("seqlm"):
        phase_seqlm(seed, env)
    emit_total(t_start)
    return 0


def _only_cluster(seed: int, env: dict, corpora: dict, t_start: float) -> int:
    """``--only cluster``: the kernels' phase 3 (the cluster entries'
    numbers) and the cluster phase."""
    with clocked("kernels"):
        summary = phase_kernels(seed, env["mem_rate_Bps"])
    with clocked("cluster"):
        cluster = phase_cluster(seed, corpora, env)
    emit("kernels", kernels=_cluster_kernel_entries(summary, cluster))
    emit_total(t_start)
    return 0


def _only_freshness(seed: int, env: dict, corpora: dict, t_start: float) -> int:
    """``--only freshness``: the freshness phase over its own serve checkpoint."""
    tmp = tempfile.mkdtemp(prefix="ssn-serve-")
    try:
        root = os.path.join(tmp, "ckpt")
        with clocked("serve_checkpoint"):
            _build_serve_checkpoint(seed, corpora, root, "cuda")
        with clocked("freshness"):
            fresh = phase_freshness(seed, corpora, env, {"root": root})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with clocked("freshness_kernels"):
        summary = phase_freshness_kernels(fresh, seed, env["mem_rate_Bps"])
    emit("kernels", kernels=_freshness_kernel_entries(summary, fresh))
    emit_total(t_start)
    return 0


def _only_tiered(seed: int, env: dict, corpora: dict, t_start: float) -> int:
    """``--only tiered``: the tiered phase over its own serve checkpoint."""
    tmp = tempfile.mkdtemp(prefix="ssn-serve-")
    try:
        root = os.path.join(tmp, "ckpt")
        with clocked("serve_checkpoint"):
            built = _build_serve_checkpoint(seed, corpora, root, "cuda")
        with clocked("tiered"):
            tiered = phase_tiered(seed, corpora, env, {"root": root, "cfg": built["cfg"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with clocked("tiered_kernels"):
        summary = phase_tiered_kernels(tiered, seed, env["mem_rate_Bps"])
    emit("kernels", kernels=_tiered_kernel_entries(summary, tiered))
    emit_total(t_start)
    return 0


def _only_launch(seed: int, env: dict, corpora: dict, t_start: float) -> int:
    """``--only launch``: the launcher's phase."""
    with clocked("launch"):
        phase_launch(seed, env)
    emit_total(t_start)
    return 0


ONLY = {"tiered": _only_tiered, "freshness": _only_freshness, "cluster": _only_cluster,
        "seqlm": _only_seqlm, "mesh": _only_mesh, "launch": _only_launch}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=tuple(ONLY),
                    help="run only this phase (with the build and the inputs it "
                         "needs) and print no result line: a quicker check while "
                         "working on it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "a CUDA card", file=sys.stderr)
        return 2
    import swiftsnails_tpu_torch  # noqa: F401  fails outside the repository

    t_start = time.monotonic()
    with clocked("env"):
        env = phase_env()
    with clocked("build"):
        corpora = phase_build(args.seed)
    if args.only:
        return ONLY[args.only](args.seed, env, corpora, t_start)
    rate = env["mem_rate_Bps"]
    with clocked("kernels"):
        summary = phase_kernels(args.seed, rate)
    with clocked("fused_kernels"):
        summary.update(phase_fused_kernels(args.seed, env))
    for path in PATHS:
        with clocked(f"slice_parity_{path}"):
            phase_slice_parity(args.seed, path)
    with clocked("perpair_kernels"):
        summary.update(phase_perpair_kernels(args.seed, rate))
    launches, train_losses = {}, {}
    for phase, path in (("train", "packed"), ("train_fused", "fused"),
                        ("train_grouped", "grouped"), ("train_resident", "resident"),
                        ("train_dedup", "dedup"), ("train_dedup_res", "dedup_res"),
                        ("train_dense", "dense"), ("train_perpair", "perpair")):
        with clocked(phase):
            train, trainer, state = phase_train(phase, args.seed, corpora, env["device"],
                                                env["nvidia_smi"])
        train_losses[phase] = train.pop("losses")
        suffix = "_perpair" if phase == "train_perpair" else ""
        launches.update({k + suffix: n for k, n in train["launches"].items()
                         if TRAIN[phase][1].get(k)})
        with clocked(f"profile_{path}"):
            phase_profile(path, trainer, state, args.seed)
        del trainer, state
        torch.cuda.empty_cache()
    with clocked("ctr_kernels"):
        summary.update(phase_ctr_kernels(args.seed, rate))
    paths = {name: "train" for name in ("gather_rows", "scatter_add_rows")}
    paths.update({f"{name}_perpair": "train_perpair"
                  for name in ("gather_rows", "scatter_add_rows")})
    with clocked("ctr_parity"):
        phase_ctr_parity(args.seed)
    with clocked("store_routes"):
        for name, n in phase_store_routes(args.seed).items():
            launches[name], paths[name] = n, "ctr_parity store route"
    with clocked("train_widedeep"):
        train, trainer, state = phase_train_widedeep(args.seed, env)
    serve_tmp = tempfile.mkdtemp(prefix="ssn-serve-wd-")
    with clocked("save_widedeep"):
        widedeep = save_widedeep_for_serving(args.seed, trainer, state,
                                             os.path.join(serve_tmp, "ckpt"))
    launches["scatter_adagrad_fused_rows"] = train["launches"]["scatter_adagrad_fused_rows"]
    paths["scatter_adagrad_fused_rows"] = "train_widedeep"
    with clocked("profile_widedeep"):
        phase_profile("widedeep", trainer, state, args.seed)
    del trainer, state
    torch.cuda.empty_cache()
    launches["gather_rows_widedeep"] = train["launches"]["gather_rows"]
    paths["gather_rows_widedeep"] = "train_widedeep"
    for phase, path in (("train_widedeep_2d", "widedeep_2d"), ("train_ffm_wide", "ffm_wide")):
        with clocked(phase):
            _, trainer, state = phase_train_widedeep(args.seed, env, phase,
                                                     packed_auc=train["eval_auc"])
        with clocked(f"profile_{path}"):
            phase_profile(path, trainer, state, args.seed)
        del trainer, state
        torch.cuda.empty_cache()
    with clocked("native_producer"):
        phase_native_producer(args.seed, corpora, env)
    with clocked("stream"):
        phase_stream(args.seed, env)
    with clocked("quality"):
        phase_quality(env)
    with clocked("sem_probe"):
        probes = phase_sem_probe(rate)
    for name in CLI:
        with clocked(name):
            phase_cli(name, args.seed, env)
    with clocked("chaos"):
        phase_chaos(args.seed, env)
    with clocked("guardrail_cost"):
        phase_guardrail_cost(args.seed, env)
    with clocked("telemetry"):
        phase_telemetry(args.seed, corpora, env, train_losses)
    try:
        with clocked("serve"):
            served = phase_serve(args.seed, corpora, env, widedeep)
    finally:
        shutil.rmtree(serve_tmp, ignore_errors=True)
    serve_tmp = served["tmp"]
    try:
        with clocked("serve_kernels"):
            summary.update(phase_serve_kernels(served, args.seed, rate))
        emit("serve_total", seconds=served["seconds"], device=env["device"],
             nvidia_smi=env["nvidia_smi"])
        serve_launches = served["launches"]
        del served["table"]
        torch.cuda.empty_cache()
        with clocked("tiered"):
            tiered = phase_tiered(args.seed, corpora, env, served)
        with clocked("tiered_kernels"):
            summary.update(phase_tiered_kernels(tiered, args.seed, rate))
        emit("tiered_total", seconds=tiered["seconds"], device=env["device"],
             nvidia_smi=env["nvidia_smi"])
        with clocked("freshness"):
            fresh = phase_freshness(args.seed, corpora, env, served)
        serve_ckpt = {"root": served["root"], "cfg": served["cfg"]}
        del served
        with clocked("freshness_kernels"):
            summary.update(phase_freshness_kernels(fresh, args.seed, rate))
        emit("freshness_total", seconds=fresh["seconds"], device=env["device"],
             nvidia_smi=env["nvidia_smi"])
        with clocked("cluster"):
            cluster = phase_cluster(args.seed, corpora, env)
        with clocked("seqlm"):
            phase_seqlm(args.seed, env)
        # the mesh phase's servants load the serve phase's step-4 checkpoint;
        # its sweep is held to the tiered phase's unmeshed heal drill
        with clocked("mesh"):
            mesh = phase_mesh(args.seed, corpora, env, serve_ckpt,
                              heal_drill=tiered.pop("heal_drill"))
    finally:
        shutil.rmtree(serve_tmp, ignore_errors=True)
    with clocked("mesh_kernels"):
        summary.update(phase_tiered_kernels(mesh["tier"], args.seed, rate, path="mesh_tier"))
        mesh_grouped = phase_mesh_grouped_kernels(args.seed, corpora, rate)
        mesh_hybrid = phase_mesh_hybrid_kernels(args.seed, corpora, rate)
    with clocked("launch"):
        phase_launch(args.seed, env)
    kernels = []
    for key, name, replaces in (
            ("gather_rows", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("gather_rows_widedeep", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("gather_rows_perpair", "gather_rows", "swiftsnails_tpu/ops/rowdma.py:114"),
            ("scatter_add_rows", "scatter_add_rows", "swiftsnails_tpu/ops/rowdma.py:213"),
            ("scatter_add_rows_perpair", "scatter_add_rows",
             "swiftsnails_tpu/ops/rowdma.py:213")):
        s = summary[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32", "path": paths[key]})
    for key in (f"gather_rows_serve_b{n}" for n in SERVE_BUCKETS):
        s = summary[key]
        kernels.append({
            "name": "gather_rows", "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": "swiftsnails_tpu/ops/rowdma.py:114",
            "launches": serve_launches["gather_rows"],
            "max_abs_err": s["max_abs_err"], "ms": s["kernel_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "dtype": "float32", "path": "serve"})
    s = summary["scatter_write_rows_serve"]
    kernels.append({
        "name": "scatter_write_rows", "route": "cuda",
        "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
        "replaces": "swiftsnails_tpu/ops/rowdma.py:289",
        "launches": serve_launches["scatter_write_rows"],
        "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": "bytes", "library_ms": s["library_ms"],
        "shape": s["shape"], "ids": s["ids"], "unique_rows": s["unique_rows"],
        "dtype": "float32", "path": "serve"})
    for name, replaces in (
            ("scatter_write_rows", "swiftsnails_tpu/ops/rowdma.py:289"),
            ("scatter_adagrad_rows", "swiftsnails_tpu/ops/rowdma.py:418"),
            ("scatter_adagrad_fused_rows", "swiftsnails_tpu/ops/rowdma.py:552")):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": "bytes", "library_ms": s["library_ms"],
            "shape": s["shape"], "ids": s["ids"], "unique_rows": s["unique_rows"],
            "dtype": "float32", "path": paths[name]})
    grouped_shape = {"centers": GROUPED_BATCH, "centers_per_block": CENTERS_PER_BLOCK,
                     "window_slots": CW, "pool": POOL_SIZE}
    for name, replaces, source, shape in (
            ("fused_sgns_step", "swiftsnails_tpu/ops/fused_sgns.py:1832", "fused_sgns.cu",
             {"pairs": BATCH, "pairs_per_block": POOL_BLOCK, "pool": POOL_SIZE}),
            ("fused_sgns_grouped_step", "swiftsnails_tpu/ops/fused_sgns.py:347",
             "fused_sgns.cu", grouped_shape),
            ("fused_sgns_resident_step", "swiftsnails_tpu/ops/fused_sgns.py:1002",
             "fused_sgns_merged.cu", {**grouped_shape, **MERGED["fused_sgns_resident_step"]}),
            ("fused_sgns_dedup_step", "swiftsnails_tpu/ops/fused_sgns.py:1315",
             "fused_sgns_merged.cu", {**grouped_shape, **MERGED["fused_sgns_dedup_step"]}),
            ("fused_sgns_dedup_resident_step", "swiftsnails_tpu/ops/fused_sgns.py:1681",
             "fused_sgns_merged.cu",
             {**grouped_shape, **MERGED["fused_sgns_dedup_resident_step"]})):
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"swiftsnails_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": None,
            "kernel_only_ms": s["kernel_only_ms"], "yardstick_ms": s["yardstick_ms"],
            "card_launches_per_substep": s["card_launches_per_substep"],
            **{k: s[k] for k in ("host_ms", "cluster", "ctas", "max_active_clusters")
               if k in s},
            "shape": {**shape, "table": [VOCAB, -(-DIM // 128), 128]},
            "dtype": "float32"})
    kernels.extend(_tiered_kernel_entries(summary, tiered))
    kernels.extend(_freshness_kernel_entries(summary, fresh))
    kernels.extend(_cluster_kernel_entries(summary, cluster))
    kernels.extend(_mesh_kernel_entries(summary, mesh))
    kernels.extend(_mesh_grouped_kernel_entries(mesh_grouped, mesh))
    kernels.extend(_mesh_ctr_kernel_entries(summary, mesh))
    kernels.extend(_mesh_hybrid_kernel_entries(mesh_hybrid, mesh))
    kernels.extend(_mesh_tier_kernel_entries(summary, mesh))
    kernels.extend(_mesh_guards_kernel_entries(mesh))
    for name, replaces in (("unit_probe", "tools/sem_probe.py:80"),
                           ("chunk_probe", "tools/sem_probe.py:164"),
                           ("pipe_probe", "tools/sem_probe.py:233")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "swiftsnails_tpu_torch/csrc/sem_probe.cu",
                        "replaces": replaces, **probes[name],
                        "dtype": "float32", "path": "sem_probe"})
    emit("kernels", kernels=kernels)
    emit_total(t_start)
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
