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
and resumed).

    python3 chip_smoke.py [--seed N] [--only tiered|freshness|cluster|seqlm]

Run from the root of the repository on a machine with a CUDA card, ``nvcc``
(``$CUDA_HOME`` or ``/usr/local/cuda``) and PyTorch built for CUDA. The
kernels build at first use into ``swiftsnails_tpu_torch/build/``. Each phase
prints one JSON line; any failure exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the repository,
it exits non-zero and prints no result.

Phases:

1. ``env``: the card, its power limit, TF32 off for matmul and cuDNN.
2. ``build``: compile ``csrc/rowdma.cu``, ``csrc/fused_sgns.cu``,
   ``csrc/fused_sgns_merged.cu`` and ``csrc/sem_probe.cu``, one ``nvcc``
   each, started together; their ptxas register and spill lines.
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
    auto``) over a zipf text corpus from ``--seed`` (300,000 tokens over
    65,536 ids), with ``-capacity 1048576`` (two 1 GiB tables),
    ``-num_iters 1``, ``-min_count 1``, ``-param_backup_period 8``,
    ``-param_backup_root``/``-output`` in a temporary directory, ``-log_every
    1`` and ``-seed``, each listed in the phase's line. First an
    uninterrupted control through ``cli.main`` in this process, every launch
    counter set to 0 just before and read just after (``gather_rows`` and
    ``scatter_add_rows`` 2 a substep, every other kernel 0). Then
    ``python -m swiftsnails_tpu_torch train`` in a subprocess, sent a real
    SIGTERM after its second periodic manifest, mid-period: it must exit 0,
    say it was preempted and leave a final step past the last periodic one.
    Then the same command again: it must say it restored that step and run
    to the end of the data. Every step both runs committed must carry the
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
    knows; ``ledger-report``, ``--failures`` and ``trace-summary`` on the
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
    ``fleet_chaos_drill`` (availability >= 99% through each drill). (f)
    ``cluster_ledger``: the blocks in one bench record of the phase's
    ledger; ``supervisor-status`` over it names the lost worker, and
    ``ledger-report --check-regression`` reports the chaos-cluster,
    chaos-serve and fleet gates ok, no gate failing (it exits 2, the
    headline's code when a ledger holds no measured bench value). Then
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
21. ``kernels``: one line for every ported kernel, with its launches in the
    run of its path (``path``) and its f32 numbers from phases 3, 7, 10, 16,
    17 and 18 (``gather_rows`` and ``scatter_add_rows`` also at
    ``train_perpair``'s shape and launches, and with the ``cluster`` path's
    launches; ``gather_rows`` and ``scatter_write_rows`` also at the serving
    shapes with the ``serve`` path's launches, and at the freshness shapes
    with the ``freshness`` path's, the replicas' included; all four row
    kernels of the tiered runs with ``path: "tiered"``); then ``total``,
    the script's seconds.
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_build() -> None:
    from swiftsnails_tpu_torch.ops import _build

    t0 = time.monotonic()
    results = _build.build_all(["rowdma", "fused_sgns", "fused_sgns_merged", "sem_probe"])
    for name, result in results.items():
        ptxas = [ln.strip() for ln in result["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", seconds=result["seconds"], source=f"{name}.cu",
             cached=result["cached"], ptxas=ptxas)
    emit("build", seconds=time.monotonic() - t0, source="all")


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


def _kernel_only(fn, id_sets, tables, kw, name: str, calls: int = 5) -> tuple:
    """Device time of the CUDA kernel alone (no prep) a call, by
    torch.profiler, and its launches on the card a call (events named
    ``name``). The profiler must see every launch the wrapper's counter
    made, each of which returned success: a window with records lost fails
    the run, since its time would be short too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    if seen < made:
        raise AssertionError(f"the profiler saw {seen} {name} launches of the {made} that "
                             f"{fn.__name__} made: records lost")
    us = sum(e.self_device_time_total for e in events)
    return us / 1e3 / calls, seen / calls


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


def _train_loop(phase: str, seed: int, corpora, **extra):
    """A train phase's trainer and loop (``extra`` config keys on top), and
    the list its records go to."""
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
    trainer = Word2VecTrainer(cfg, corpus_ids=ids, vocab=vocab)
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
# Free space a CLI phase needs under the temporary directory: one root at a
# time (the control's is deleted before the interrupted run), up to 5 step
# directories of 2 GiB (3 kept, the protected one, the one being written).
CLI_DISK_BYTES = 12 << 30
# phase -> its config, corpus (tokens, zipf id range, paired), backup period,
# overrides beyond the common ones, and launches a substep of each kernel.
# The id ranges keep the vocabularies at ~31k and ~65k words, so that the
# text export of `output` takes seconds; the tables stay at CLI_CAPACITY.
CLI = {
    "cli_resume": {"conf": W2V_CONF, "tokens": 300_000, "ids": 1 << 16, "paired": False,
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
    uninterrupted control in this process, then a run in a subprocess
    stopped by a real SIGTERM after its second periodic manifest, then the
    same command again, which resumes. The resumed run's periodic
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

        # the control, in process: its launches and every manifest it commits
        ctl_root, ctl_out = os.path.join(tmp, "control"), os.path.join(tmp, "control.txt")
        watch = _ManifestWatch(ctl_root)
        out, err, launches, ctl_s = _in_process_cli(_cli_args(spec, corpus, ctl_root, ctl_out, seed))
        control = watch.stop()
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

        # the run a real SIGTERM stops after its second periodic manifest
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

        rc, out1, err1, first_s = _subprocess_cli(args, tmp, "first", until=sigterm_due)
        if rc != 0 or "preempted (SIGTERM)" not in err1:
            raise AssertionError(f"{name}: SIGTERM run exited {rc}: {err1[-3000:]}")
        drain = _DRAIN_RE.findall(err1)
        if len(drain) != 1:
            raise AssertionError(f"{name}: drain lines {drain}: {err1[-3000:]}")
        final = int(drain[0][1])
        before = sorted(s for s in ckpt.intact_steps(root) if s % period == 0)
        if ckpt.intact_steps(root)[0] != final or final <= before[-1] or final <= 2 * period:
            raise AssertionError(f"{name}: drained at {final}, intact {ckpt.intact_steps(root)}")

        # the same command again: it resumes from the drain's save
        rc, out2, err2, resumed_s = _subprocess_cli(args, tmp, "resumed")
        run = watch.stop()
        restored = _RESTORE_RE.findall(err2)
        if rc != 0 or not restored or int(restored[0][0]) != final or "preempted" in err2:
            raise AssertionError(f"{name}: resumed run exited {rc}, restored {restored}: "
                                 f"{err2[-3000:]}")
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
                           "save": _save_stats(err2), "restore_s": float(restored[0][1])},
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


def phase_telemetry(seed: int, corpora, env: dict) -> dict:
    """The loop's telemetry at full width on packed+pool and fused-resident:
    30 steps with ``telemetry: 1``, ``trace_path``, ``ledger_path``,
    ``profile_dir`` (``profile_steps: 10,20``), ``profile_cadence: 4``,
    ``drift_detect: 1``, ``param_backup_period: 10`` and the loss read every
    step, against the same run with telemetry off; then ``resume: auto`` on
    the ledger, the reports, the drift drill and the continuous profiler's
    cost."""
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
            off, _ = _losses(phase, seed, corpora)
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


def _tier_w2v(seed: int, corpora, steps: int = STEPS, **extra) -> dict:
    """The ``train`` phase's packed+pool config (``extra`` on top) for
    ``steps`` steps, counted and probed."""
    trainer, loop, records = _train_loop("train", seed, corpora, **extra)
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
        return {"launches": launches, "shapes": shapes,
                "seconds": time.monotonic() - t_phase}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_tiered_kernels(tiered: dict, seed: int, rate: float) -> dict:
    """The kernels of the tiered path at its shapes: ``scatter_write_rows``
    installing the run's median faulted rows a step into the ``[32,768, 2,
    128]`` cache (distinct slots), beside ``index_copy_``;
    ``gather_rows`` snapshotting the median dirty victims an eviction,
    beside ``index_select``; ``scatter_add_rows`` pushing a step's merged
    out-table rows into the cache; ``scatter_adagrad_fused_rows`` pushing a
    Wide & Deep step's tiles into its cache. Bit-equal to the plain
    versions, timed, against the byte bound. Not counted: the tiered runs'
    launches were read before."""
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
    emit("kernel", name="scatter_write_rows", dtype="torch.float32", path="tiered", **case)
    summary["scatter_write_rows_tiered"] = {"shape": list(cache.shape), **case}
    n = int(sh["snapshot_rows_median"])
    gsets = [torch.from_numpy(rng.choice(slots, n, replace=False).astype(np.int32)).to(dev)
             for _ in range(ROW_SETS)]
    case = _gather_case(cache, gsets, rate)
    emit("kernel", name="gather_rows", dtype="torch.float32", path="tiered", rows=n, **case)
    summary["gather_rows_tiered"] = {"shape": [n, *sh["cache"][1:]], **case}
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
    emit("kernel", name="scatter_add_rows", dtype="torch.float32", path="tiered", rows=n, **case)
    summary["scatter_add_rows_tiered"] = {"shape": [n, *sh["cache"][1:]], **case}
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
    emit("kernel", name="scatter_adagrad_fused_rows", dtype="torch.float32", path="tiered", **case)
    summary["scatter_adagrad_fused_rows_tiered"] = {"shape": list(fused.shape), **case}
    del fused, sets
    torch.cuda.empty_cache()
    return summary


def _tiered_kernel_entries(summary: dict, tiered: dict) -> list:
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
        s = summary[f"{key}_tiered"]
        out.append({
            "name": name, "route": "cuda", "source": "swiftsnails_tpu_torch/csrc/rowdma.cu",
            "replaces": replaces, "launches": tiered["launches"][key],
            "max_abs_err": s["max_abs_err"], "ms": s.get("ms", s.get("kernel_ms")),
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": "bytes",
            "library_ms": s["library_ms"], "shape": s["shape"], "dtype": "float32",
            "path": "tiered"})
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
        fleet, fleet_launches = _run_counted(lambda: fleet_bench(
            small=False, workdir=os.path.join(tmp, "fleet"), ledger=ledger, device="cuda"))
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
             drill_seconds=time.monotonic() - t0)
        bad = [k for k, ok in fleet_checks.items() if not ok]
        if bad:
            raise AssertionError(f"cluster_fleet: failed {bad}")

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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one_row = phase_one_row()
    seconds = time.monotonic() - t_phase
    emit("cluster_total", seconds=seconds, device=env["device"],
         nvidia_smi=env["nvidia_smi"])
    return {"launches": launches, "one_row": one_row, "seconds": seconds}


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


def _only_seqlm(seed: int, env: dict, t_start: float) -> int:
    """``--only seqlm``: the sequence model's phase."""
    phase_seqlm(seed, env)
    emit("total", seconds=time.monotonic() - t_start)
    return 0


def _only_cluster(seed: int, env: dict, t_start: float) -> int:
    """``--only cluster``: the kernels' phase 3 (the cluster entries'
    numbers) and the cluster phase."""
    summary = phase_kernels(seed, env["mem_rate_Bps"])
    cluster = phase_cluster(seed, {False: _corpus(seed)}, env)
    emit("kernels", kernels=_cluster_kernel_entries(summary, cluster))
    emit("total", seconds=time.monotonic() - t_start)
    return 0


def _only_freshness(seed: int, env: dict, t_start: float) -> int:
    """``--only freshness``: the freshness phase over its own serve checkpoint."""
    corpora = {False: _corpus(seed), True: _corpus(seed, paired=True)}
    tmp = tempfile.mkdtemp(prefix="ssn-serve-")
    try:
        root = os.path.join(tmp, "ckpt")
        _build_serve_checkpoint(seed, corpora, root, "cuda")
        fresh = phase_freshness(seed, corpora, env, {"root": root})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = phase_freshness_kernels(fresh, seed, env["mem_rate_Bps"])
    emit("kernels", kernels=_freshness_kernel_entries(summary, fresh))
    emit("total", seconds=time.monotonic() - t_start)
    return 0


def _only_tiered(seed: int, env: dict, t_start: float) -> int:
    """``--only tiered``: the tiered phase over its own serve checkpoint."""
    corpora = {False: _corpus(seed), True: _corpus(seed, paired=True)}
    tmp = tempfile.mkdtemp(prefix="ssn-serve-")
    try:
        root = os.path.join(tmp, "ckpt")
        built = _build_serve_checkpoint(seed, corpora, root, "cuda")
        tiered = phase_tiered(seed, corpora, env, {"root": root, "cfg": built["cfg"]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = phase_tiered_kernels(tiered, seed, env["mem_rate_Bps"])
    emit("kernels", kernels=_tiered_kernel_entries(summary, tiered))
    emit("total", seconds=time.monotonic() - t_start)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("tiered", "freshness", "cluster", "seqlm"),
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
    env = phase_env()
    phase_build()
    if args.only == "tiered":
        return _only_tiered(args.seed, env, t_start)
    if args.only == "freshness":
        return _only_freshness(args.seed, env, t_start)
    if args.only == "cluster":
        return _only_cluster(args.seed, env, t_start)
    if args.only == "seqlm":
        return _only_seqlm(args.seed, env, t_start)
    summary = phase_kernels(args.seed, env["mem_rate_Bps"])
    summary.update(phase_fused_kernels(args.seed, env))
    for path in PATHS:
        phase_slice_parity(args.seed, path)
    corpora = {False: _corpus(args.seed), True: _corpus(args.seed, paired=True)}
    summary.update(phase_perpair_kernels(args.seed, env["mem_rate_Bps"]))
    launches = {}
    for phase, path in (("train", "packed"), ("train_fused", "fused"),
                        ("train_grouped", "grouped"), ("train_resident", "resident"),
                        ("train_dedup", "dedup"), ("train_dedup_res", "dedup_res"),
                        ("train_dense", "dense"), ("train_perpair", "perpair")):
        train, trainer, state = phase_train(phase, args.seed, corpora, env["device"],
                                            env["nvidia_smi"])
        suffix = "_perpair" if phase == "train_perpair" else ""
        launches.update({k + suffix: n for k, n in train["launches"].items()
                         if TRAIN[phase][1].get(k)})
        phase_profile(path, trainer, state, args.seed)
        del trainer, state
        torch.cuda.empty_cache()
    summary.update(phase_ctr_kernels(args.seed, env["mem_rate_Bps"]))
    paths = {name: "train" for name in ("gather_rows", "scatter_add_rows")}
    paths.update({f"{name}_perpair": "train_perpair"
                  for name in ("gather_rows", "scatter_add_rows")})
    phase_ctr_parity(args.seed)
    for name, n in phase_store_routes(args.seed).items():
        launches[name], paths[name] = n, "ctr_parity store route"
    train, trainer, state = phase_train_widedeep(args.seed, env)
    serve_tmp = tempfile.mkdtemp(prefix="ssn-serve-wd-")
    widedeep = save_widedeep_for_serving(args.seed, trainer, state,
                                         os.path.join(serve_tmp, "ckpt"))
    launches["scatter_adagrad_fused_rows"] = train["launches"]["scatter_adagrad_fused_rows"]
    paths["scatter_adagrad_fused_rows"] = "train_widedeep"
    phase_profile("widedeep", trainer, state, args.seed)
    del trainer, state
    torch.cuda.empty_cache()
    launches["gather_rows_widedeep"] = train["launches"]["gather_rows"]
    paths["gather_rows_widedeep"] = "train_widedeep"
    for phase, path in (("train_widedeep_2d", "widedeep_2d"), ("train_ffm_wide", "ffm_wide")):
        _, trainer, state = phase_train_widedeep(args.seed, env, phase,
                                                 packed_auc=train["eval_auc"])
        phase_profile(path, trainer, state, args.seed)
        del trainer, state
        torch.cuda.empty_cache()
    phase_native_producer(args.seed, corpora, env)
    phase_stream(args.seed, env)
    phase_quality(env)
    probes = phase_sem_probe(env["mem_rate_Bps"])
    for name in CLI:
        phase_cli(name, args.seed, env)
    phase_chaos(args.seed, env)
    phase_guardrail_cost(args.seed, env)
    phase_telemetry(args.seed, corpora, env)
    try:
        served = phase_serve(args.seed, corpora, env, widedeep)
    finally:
        shutil.rmtree(serve_tmp, ignore_errors=True)
    try:
        summary.update(phase_serve_kernels(served, args.seed, env["mem_rate_Bps"]))
        emit("serve_total", seconds=served["seconds"], device=env["device"],
             nvidia_smi=env["nvidia_smi"])
        serve_launches = served["launches"]
        del served["table"]
        torch.cuda.empty_cache()
        tiered = phase_tiered(args.seed, corpora, env, served)
        summary.update(phase_tiered_kernels(tiered, args.seed, env["mem_rate_Bps"]))
        emit("tiered_total", seconds=tiered["seconds"], device=env["device"],
             nvidia_smi=env["nvidia_smi"])
        fresh = phase_freshness(args.seed, corpora, env, served)
    finally:
        shutil.rmtree(served["tmp"], ignore_errors=True)
    del served
    summary.update(phase_freshness_kernels(fresh, args.seed, env["mem_rate_Bps"]))
    emit("freshness_total", seconds=fresh["seconds"], device=env["device"],
         nvidia_smi=env["nvidia_smi"])
    cluster = phase_cluster(args.seed, corpora, env)
    phase_seqlm(args.seed, env)
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
    for name, replaces in (("unit_probe", "tools/sem_probe.py:80"),
                           ("chunk_probe", "tools/sem_probe.py:164"),
                           ("pipe_probe", "tools/sem_probe.py:233")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "swiftsnails_tpu_torch/csrc/sem_probe.cu",
                        "replaces": replaces, **probes[name],
                        "dtype": "float32", "path": "sem_probe"})
    emit("kernels", kernels=kernels)
    emit("total", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
