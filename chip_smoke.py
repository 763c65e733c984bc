#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elasticdl_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout on a machine with one card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ``"ok"`` line):

1. build -- every hand-written kernel, one nvcc per source, all started
   together, from the checkout's sources (K4, ops/csrc/flash_fwd.cu;
   K5 and K6, ops/csrc/flash_bwd.cu; K1-K3, ops/csrc/embedding_tier.cu),
   with ptxas's report per entry; beside them a copy of K1-K3's source
   under build/ with programmatic dependent launch off (the serial
   chain of phase 4);
2. kernels -- K4 against its plain PyTorch version on the card at the
   serving and training shape and at eleven more (fp32, non-causal,
   head_dim 128, ragged S = 1000; head_dim 256 at bench.py's
   transformer and s16k_flash shapes, ragged in fp32 and bf16; head_dim
   96, zero-padded to the kernel's 128; head_dim 128 at bench.py's MoE
   shape, batch 16 x 8 heads, S 1024), and at five unequal query and
   key lengths (``UNEQUAL_CASES``), each under the tolerance printed
   with it; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (timed only: the port never calls
   it) with CUDA events, L2 flushed before every launch;
3. backward kernels -- K5 (dq) and K6 (dk, dv) against
   ``flash_attention_bwd_reference`` at the same seventeen shapes (K6's
   dk and dv rows of keys no query sees exactly zero), row by row
   (each row's error relative to that row's size), raw launches on the
   same inputs bit-equal to the wrapper's, each kernel timed alone
   beside its own plain version, the wrapper (delta and both kernels)
   and the backward of ``scaled_dot_product_attention`` (the yardstick
   for K5 + K6 together);
4. tier kernels -- K1 (gather-merge), K2 (insert rows: a staging
   chunk into the weights, the slot buffers and the step counts in one
   launch) and K3 (scatter-apply), ops/csrc/embedding_tier.cu, against
   their plain versions at deepfm's deployment shapes for both tables
   (d 8 and 1): K1 and K2 bit for bit (K2 on every buffer), K3 for
   each of sgd, momentum, nesterov, adagrad and adam within the
   tolerance printed with it on every row but the scratch row, which
   the kernel leaves alone; each timed with CUDA events (L2 flushed)
   beside its plain version, its bound and a library yardstick (K1
   index_select + torch.where, K2 index_copy_ + index_fill_ x 3, K3
   none), K3 also on all hits beside the real mix; K1 also by the
   profiler; then the staging chunk's chain (K1 victims -> K2 insert ->
   K1 combined, the last two programmatic dependent launches) with
   every insert reusing a victim's slot, 200 runs at each width, each
   bit-equal to the plain versions applied in order; and the chain's
   device span with programmatic dependent launch against the serial
   copy's, in turns, by CUDA events and by the profiler;
5. serve -- zoo-width TransformerLM weights (vocab 32000, 12 layers, 12
   heads, d 768) made with numpy from a seed and written as an export
   bundle; the port's ServeRole on a free port (``--device cuda
   --compute_dtype bfloat16 --max_batch 8``); 8 concurrent one-row
   requests of 1024 tokens over real gRPC through ServeClient. Checks:
   every answer equals ``ServingModel.predict`` on the same row bit for
   bit; the answers agree with the same model forced to plain attention
   within a stated bf16 tolerance; the K4 launch count over the served
   burst is 12 (one per layer) for every batch formed. Then a drain;
6. train -- the zoo TransformerLM at full width and depth trained by
   ``LocalExecutor`` (bf16 compute, fp32 masters, AdamW, minibatch 8,
   S = 1024) over RecordIO token records made with numpy from a seed.
   Checks: every loss is finite; every step launches 12 K4, 12 K5 and
   12 K6; from identical weights the first step's loss, its gradient
   as a whole and the gradient of every attention projection leaf
   agree with the same model on plain attention within the printed
   bf16 tolerances; the loss falls over steps on one repeated batch;
   the exported state serves through ``ServingModel`` with the
   trainer's ``eval_step`` outputs. Then the device time of a step,
   tokens/s, the model-FLOP share of the card's bf16 peak and a
   ``torch.profiler`` breakdown of one step;
7. sparse train -- DeepFM through the port's ``SparseTrainer`` with
   the device tier at bench.py's deployment configuration (39 fields,
   batch 512, id capacity 8192, Zipf(1.2) ids, the in-process store
   ``LocalPSClient`` builds -- the native C++ store, ps/embedding_store.py
   -- and the tier, both adam lr 0.001, tier capacity 65536). Checks:
   the store is a ``NativeEmbeddingStore`` (its class and library
   printed); a tier that never promotes is bit-exact with the tier off;
   the card agrees with the CPU over the first steps on the same store
   class (loss, touched store rows, tier rows); 110 steps with finite
   losses, K1-K3 launches per step as the path requires and a warm hit
   rate above 0; the loss falls on a repeated batch; a 4096-row tier
   evicts and, after ``close()``, holds every resident row bit-equal to
   the store's. Then steps/s, examples/s, the host stage split of each
   store (medians over 10 fresh steps, the native trainer and a numpy
   one that replayed the same steps, in turns) and a profiled step
   (device busy, idle share, K1-K3 share);
8. stream -- bench.py's deepfm ladder (bench.py:83-180) through the
   port against fresh pairs of the port's own PS processes, started as
   ``python -m elasticdl_tpu_torch.ps.server`` with bench.py's flags
   (two shards, adam lr 0.001, sync with grads_to_wait 1, the native
   store; all pairs started together, each checked to serve the native
   store in sync mode, all stopped by SIGTERM and waited on at the
   end): sequential ``train_step`` (no cache, no tier),
   ``train_stream(push_interval=2)`` with ``cache_staleness`` 8, and
   the same with the tier, 110 steps each over gRPC (``PSClient``).
   Checks: every loss finite; no push rejected; the tier rung's K1-K3
   launches per step follow phase 7's formula (counted from 0 at the
   rung's start); after ``close()`` every resident tier row equals its
   row pulled back over gRPC; on disjoint-id batches
   ``train_stream(push_interval=1)`` on the card agrees with
   ``train_step`` on the card, each over its own PS pair, within the
   sparse phase's tolerances. For each rung: steps/s and examples/s
   over steps 11-110, Timing's medians (``sparse_pull`` is the part of
   the lookahead prepare left on the critical path) beside each call's
   own time on its thread (prepare, the PS pull in it, the push RPC);
   the ladder's order (printed, not gated); one profiled pipelined tier
   step (device busy, idle share, and the gaps between the K1/K2
   launches of a staging chunk's chain);
9. job -- DeepFM as an elastic job through the port's own control
   plane: RecordIO files made with numpy from seeds (196,608 training
   records in 4 shards, 24 tasks of 8192 records = 16 steps of 512;
   16,384 validation records; phase 7's 39 fields and Zipf(1.2) ids,
   the label a planted linear signal); the port's ``Master`` in this
   process (liveness timeout 10 s, evaluation every 160 worker
   versions); two ``python -m elasticdl_tpu_torch.ps.server`` with
   phase 8's flags, async (two tier workers push concurrently) and
   ``--master_addr``; worker 1 as ``python -m
   elasticdl_tpu_torch.worker.main --device cuda``; worker 0 a
   ``Worker`` in this process; both sequential with the tier on
   (``EDL_DEVICE_TIER=1``, phase 7's knobs). Once worker 1 has
   reported a task and holds another it gets SIGKILL. Checks: the
   master's run returns 0 and the job did not fail; a task was
   recovered from worker 1; the done training records add up to the
   dataset; worker 0's K1-K3 launches follow phase 7's per-step
   formula in every step; the final evaluation's AUC is at least 0.70;
   both PS exit 0 on their own within 30 s of the master's stop. It
   prints the job's wall time, examples/s, the time from the kill to
   the requeue and worker 0's steps/s;
10. PS restart -- phase 9's job over two of its four training files
   (98,304 records, 12 tasks, 192 steps) with worker 0 alone, in this
   process, its K1-K3 launches counted; two PS processes with phase
   9's flags plus one ``--checkpoint_dir`` (the reference's pod manager
   gives every PS of a job the same one) and ``--checkpoint_steps 16``.
   Inside worker 0's push, once the newest complete checkpoint chain
   holds a full base and 2 deltas and PS 1 is 10 versions past it, PS 1
   gets SIGKILL and is relaunched with the same id, port and flags (no
   ``--checkpoint_dir_for_init``). Checks: the relaunch logs the
   restored version (at least 1 and at least the chain's); worker 0's
   PS client saw shard 1's stamp change and resynced once; the tier's
   restart flush wrote rows back through one K1 per table and the
   relaunched PS serves them bit for bit; phase 7's formula, with a K1
   per host read of resident rows, in every step; master rc 0 with
   every training record done once; final AUC at least 0.70; worker
   0's version for shard 1 equals PS 1's store version at its exit;
   both PS exit 0 on their own, each with its last checkpoint file
   whole at its last cadence version. It prints, with the card's name
   and power limit, the saves by kind (seconds, rows), the restore's
   seconds and rows, the kill to serving and to the first accepted
   push, the versions lost, the rows flushed, worker 0's steps/s before
   and after the kill and the job's wall time;
11. the job's artifact -- phase 9's job over one of its training files
   (49,152 records, 6 tasks, 96 steps) with worker 0 alone in this
   process (``--checkpoint_dir``, ``--checkpoint_steps 32``,
   ``--keep_checkpoint_max 2``), its K1-K3 launches counted at every
   step and at every flush barrier; two PS with phase 10's flags (one
   ``--checkpoint_dir``); the master with ``--output``, evaluating once
   at the final version. The PS stop on SIGTERM after the job (a final
   full checkpoint each) and are relaunched with
   ``--checkpoint_dir_for_init`` on held ports; an evaluation-only job
   and a prediction-only job (``models/deepfm_predictions.py`` writes
   the outputs to a file) run together, each a fresh ``worker.main``
   process restoring ``--checkpoint_dir_for_init`` the dense
   checkpoints; ``serve.main`` serves the export over the restored PS
   (``max_batch`` 64) a burst of validation rows, PS 1 is SIGKILLed
   and relaunched from the same checkpoint and the burst is sent
   again. Checks: master rc 0 with every record done; one
   TRAIN_END_CALLBACK task, created after the last training task and
   done once; the export's step is worker 0's final version; the dense
   directory holds the two newest multiples of 32, the final version
   the latest; phase 7's formula at every step and flush barrier, one
   K1 per tier table dirty at the train-end barrier, and no training
   task after the train-end task; both PS save their final
   checkpoint at one version and the relaunches restore it; the
   evaluation-only AUC is at least 0.70 and within 1e-6 of the AUC of
   the prediction job's outputs; every record predicted once; the
   served answers bit-equal to ``ServingModel.predict`` and within 1e-5
   of the prediction job's; the cache dropped once for each stamped
   relaunch the server's PS client saw; the second burst bit-equal to
   the first. It prints, with the card's name and power limit, the
   job's wall, the export's and each dense save's seconds and bytes,
   the restore's seconds, the scoring jobs' walls, served p50/p99 and
   requests/s, and K1's launches at the barriers;
12. the control plane's failures -- phase 9's job over two of its four
   training files (98,304 records, 12 tasks of 16 steps) with the
   master a process (``python -m elasticdl_tpu_torch.master.main``,
   ``EDL_STATE_DIR`` set, ``--output``, its port held across the kill,
   evaluation every 64 versions); two async PS with ``--master_addr``;
   worker 1 a ``worker.main`` process and worker 0 in this process, both
   with the tier on. After worker 1's first report it gets SIGTERM and
   worker 0 starts: worker 1 finishes its current task, joins its push,
   flushes its tier (K1) and deregisters. Then, once the journal holds 4 done ops with training
   mid-epoch, the master gets SIGKILL and is relaunched 1 s later with
   the same flags; it replays its journal and finishes the job. Checks:
   the relaunched master exits 0; every task the journal created done
   exactly once across both lifetimes; two boots; one
   TRAIN_END_CALLBACK task, done; worker 0 granted an epoch in each
   lifetime, the second above the first; worker 1 exits 0 within its
   45 s drain deadline, its ack logged with pushes_joined, tier_flushed
   and nothing handed back; no requeue with a retry; the drain's K1s
   by the path's formula; worker 0's launches by phase 7's formula in
   every step; every completed evaluation's AUC at least 0.70, one at
   least; the export at worker 0's final version. It prints, with the
   card's name and power limit, the job's wall, SIGTERM to the ack and
   to the exit, the drain flush's seconds, rows and K1s, kill to
   serving and to worker 0's first task from the relaunched master,
   the replay's seconds and ops, the journal's bytes and ops at the
   kill, the tasks trained twice and worker 0's steps/s before and
   after the kill;
13. telemetry -- phase 12's job (two files, 12 tasks, evaluation every
   64 versions) with every role observed: the master a ``master.main``
   process, two async PS and worker 1 processes, worker 0 in this
   process (K1-K3 counted), each with ``EDL_METRICS=1``, a metrics
   port held by ``reserve_port``, ``EDL_EVENTS_DIR`` and
   ``EDL_TRACE_DIR`` with ``EDL_TRACE_SAMPLE=1``. Worker 1 holding a
   task gets SIGSTOP for 12 s, then SIGCONT (dead air at 8 s, the
   master's liveness timeout 20 s, the PS's master poll every 2.5 s:
   each gap at least 3 s spare; worker 0's task fetches pause
   meanwhile, so the store cannot run 100 versions past worker 1's
   stale push); once the master exits, the PS drain on SIGTERM. Checks: ``/alerts`` shows ``dead_air`` for worker 1
   during the stop and no other alert ever; the master's journal
   raises and clears it, ``edl_master_alerts_total{alert="dead_air"}``
   is 1; no task requeued; ``/statusz`` lists both workers with the
   CUDA allocator's bytes (the card's memory as the limit) and the
   tier's tallies, and both PS with push and pull rates; each worker's
   ``/metrics`` after its last step counts the tier's hits and misses
   its ``stats()`` logged at exit; the PS' gRPC server push counters
   equal the workers' client counters; one step's trace id reaches the
   master and a PS; the journal of every role that runs a port main
   (master, both PS, worker 1) has ``role_start`` and ``role_stop``;
   every training task done once, the AUC floor, phase 7's formula.
   Then the serve phase's TransformerLM ``ServeRole`` with a metrics
   port: ``/readyz`` 503 before the load and 200 after; one warm-up
   batch of 8 requests, then 64 concurrent requests (8 batches); the
   served-request counter equal to the requests sent, K4 once a layer
   a batch, the batcher's and servicer's spans, whose split of each
   measured request's time (queue wait, batch assembly, forward,
   reply; medians over the 64) is printed beside worker 0's steps/s against phase 9's, the bytes of
   each role's trace and journal and the phase's seconds;
14. the serving fleet -- ``python -m elasticdl_tpu_torch.serve.router_main``
   a process of its own (``--min_replicas 2 --max_replicas 3``, a
   versioned export root, the fleet clocks of ``FLEET_ENV``), its
   ``SubprocessReplicaScaler`` spawning port ``serve.main`` replicas of
   the zoo TransformerLM at full width (``--device cuda``, bf16,
   ``--max_batch 8``); 256-token requests from 8 closed-loop callers in
   a process of their own, affinity keys 1-64 and every 8th request
   unkeyed. Spin-up: two replicas register and load v1; one answer
   through the router within SERVE_MEAN_TOL / SERVE_MAX_TOL of an
   in-process ``ServingModel`` of v1 (K4 once a layer); a burst over
   keys 1-64 lands on each replica as the ring says; one replica's keys
   as four bursts, through the router, direct to it, direct, through
   the router. Under the loop:
   a replica SIGKILLed (no request fails, ``replica_lost``, the floor's
   replacement registers and serves, only the victim's keys move on
   the ring); a v2 export (same weights, step + 7) promoted by the
   canary and loaded everywhere; a poisoned v3 (every logit + 0.5)
   rolled back and never retried; the router's SIGTERM drain exits 0.
   Every scale and canary decision is journaled with reasons, and in
   every replica process (``K4_HOOK``) K4 launched once a layer for
   every forward. It prints the loop's and the bursts' p50/p99, kill to
   the replacement's registration and first served request, export to
   promotion and to rollback, each replica's cold start and the card's
   free memory after the replacement registered;
15. the vision zoo and the rest of the dense step -- bench.py's
   ResNet-50 configuration (bench.py:441-461: ``resnet50(num_classes=
   1000, stem="space_to_depth")``, Momentum lr 0.1 / 0.9 nesterov, bf16
   compute, batch 256, 224x224 random images from numpy seed 0) through
   the port's ``make_train_step``: warm-up steps, then windows of
   steps each fenced by its loss; images/s of the best window, step
   ms, peak memory, the FLOP share of the bf16 peak (989 TFLOP/s; the
   FLOPs counted from the model's Conv and Dense shapes, 3x the
   forward) and a profiled step (device busy, idle share, top ops).
   Then one fp32 step at batch 8 on the card (TF32 off) and on the CPU
   from the same weights: loss, training-mode logits and the updated
   running statistics within the printed tolerances. Then ResNet-50 as
   a job: 512 planted-class 224x224 RecordIO images, the port's
   ``Master`` in this process with ``saved_model_path``, one ``python
   -m elasticdl_tpu_torch.worker.main`` (bf16, batch 64, 4 tasks);
   checks: master and worker rc 0, every task done once, the export
   at the final step with ``model_state/batch_stats`` and trained
   statistics; ``serve.main`` on the export answers a warm-up request,
   then 8 concurrent one-image requests, each within SERVE_MEAN_TOL /
   SERVE_MAX_TOL of an in-process ``ServingModel``. Then the zoo TransformerLM (S 1024, batch 8, bf16,
   AdamW) through ``TorchTrainer`` under no remat, "dots", "flash" and
   "full": K4 launches 12, 12, 12 and 24 a step and K5/K6 12 (held),
   step ms, peak memory, and gradients equal to no remat's within the
   reference test's tolerances; one "flash" and one no-remat step at S
   16384, batch 1 ("flash" must peak lower); two steps with dropout 0.1
   under "flash" equal to the same steps without remat. Last, mnist,
   cifar10 and mobilenet each one ``LocalExecutor`` epoch on seeded
   planted-class records, the loss falling. Every record carries the
   card's name and power limit;
16. heads of 256 and the CTR zoo -- bench.py's ``transformer``
   (bench.py:265-280: d 2048, 10 layers, 8 heads of 256, vocab 32000,
   S 1024, batch 12, no remat, AdamW lr 3e-4 wd 0.01, bf16, the default
   attention) through the port's ``make_train_step``, weights made with
   numpy from a seed and token ids from numpy seed 0: the first step
   against the same model on plain attention (phase 6's loss, cosine
   and attention-leaf rules), then warm-up steps and windows of steps,
   10 K4, 10 K5 and 10 K6 launches in every step, finite losses; step
   ms, tokens/s, peak memory, the FLOP share of the bf16 peak and a
   profiled step (device busy, idle share, top ops). Then bench.py's
   ``s16k_flash`` (the same model at S 16384, batch 1, remat "flash")
   through ``TorchTrainer``: 10 of each kernel a step, step ms, tokens/s,
   the FLOP share and peak memory. Then Wide&Deep, DCN and xDeepFM at
   the zoo's defaults (vocab 1,000,000, dim 8) through
   ``LocalExecutor`` over RecordIO records of 39 Zipf(1.2) ids with
   phase 9's planted signal (16384 training, 4096 validation, batch
   512, 2 epochs): finite, falling losses, the validation AUC at least
   CTR_AUC_FLOOR, and one fp32 step at batch 64 on the card and on the
   CPU from the same weights agreeing in the loss, in every gradient
   leaf as the optimizer receives it, and in the updated tables and
   dense weights (CTR_AGREE_*), each table moved; steps/s, peak memory
   and the AUC;
17. the feature-column family -- tests/test_model_handler.py's model
   (DenseFeatures, Dense 16 + ReLU, Dense 1) with ``cat_big`` at
   1,000,000 buckets x dim 8 (32 MB of fp32) under the "mean" combiner,
   1-5 Zipf(1.2) ids a row through ``from_row_lists``, beside
   ``cat_small`` (10 x 4, a device parameter) and a numeric ``x``:
   ``promote_large_embeddings`` at its default 2 MiB threshold must
   promote ``cat_big`` alone. First the promoted column's output on the
   card against a float64 numpy mean of the same PS rows over the real
   slots; then three steps on the card and on the CPU from the same
   weights and store seed, the tier on (adam eps 1e-3): the loss, every
   dense gradient leaf as the optimizer receives it and the row
   gradients of the pulled buffer within a relative L2 of 1e-5; then
   200 steps at batch 512 through ``SparseTrainer`` over the in-process
   store with the tier on through ``EDL_DEVICE_TIER=1`` (adam lr 0.05):
   finite losses, the last-10 mean below 0.7x the first-10 mean, K1-K3
   by phase 7's formula at every step and each launched in every step
   after the 20th, no PS row and no tier slot or candidate for an id
   that only padded slots hold (0, and the masked rows' id), and after
   the tier's flush ``export_promoted_train_state`` and
   ``load_exported_tables`` give every row bit-equal to the live PS.
   Then census_wide_deep, census_dnn, census_sqlflow_wide_deep and
   heart through ``LocalExecutor`` over RecordIO from the port's
   generators at the reference tests' sizes, each above its AUC floor
   (``FEATURE_ZOO``; census_wide_deep also one card-against-CPU step,
   every gradient leaf within 1e-5). Then iris as a job: ``python -m
   elasticdl_tpu_torch.master.main`` (``EDL_STATE_DIR``, ``--output``)
   and one ``worker.main --device cuda`` over two CSV files of 120 rows,
   16 rows a task, 10 epochs: master and worker rc 0, every task the
   journal created done once, one train-end task, the export at the
   final step and its accuracy on the validation rows above 0.85, and
   the export served by an in-process ``ServingEngine`` over gRPC
   bit-equal to ``eval_step`` on the same 32 rows. Then iris again as
   an in-process job over a table: the port's ``Master`` with an
   ``odps://`` origin and one ``Worker`` on the card over a
   ``TableDataReader`` of an ``InMemoryTableClient`` holding the same
   rows; every row trained once an epoch by the dispatcher's books,
   accuracy at or above 0.85; then a prediction-only job over the
   validation table whose rows land through a
   ``TablePredictionOutputsProcessor`` in an ``InMemoryWritableTable``
   and, read back through ``TableDataReader``, equal the trained
   state's ``eval_step`` over the same rows bit for bit. Each part
   prints a record (steps/s, AUC or accuracy, the worst gradient error,
   K1-K3 launches per step) beside the card's name and power limit, and
   the phase its seconds;
18. continual streaming (``continual_phase``; phase 8's ``stream_phase``
   is another path) -- DeepFM as a stream job at phase 9's size: the
   port's master in this process with ``EDL_STREAM=synthetic`` (24
   windows of 8192 records of a Zipf(1.3) clickstream over a hot set of
   200,000 ids sliding 20 a window, 39 fields, at most 32,768
   records minted ahead, a checkpoint boundary every 49,152 records of
   watermark and an export every 98,304), its state journal, events
   journal, ``--output`` and ``--tensorboard_log_dir``, evaluating over
   the two windows after the stream; two PS processes with the
   embedding lifecycle (admission after 4 sightings, at most 24,000
   rows a table, under the tier's 32,768 a shard, a sweep a second, LFU
   decay 0.9, ids touched in the last second safe from LFU), PS 1 with an
   ``unavailable`` burst of 3 on ``push_gradients`` (``EDL_FAULT_SPEC``);
   worker 0 in this process, the tier on. Eight checks, each printed:
   every window minted and done once, in the replayed journal too, the
   final watermark the minted records; each boundary a watermark event
   on the worker and on each PS, a sparse checkpoint per shard and a
   worker barrier whose tier flush launched K1; the feeder's two exports
   at the cadence and the train-end export after them, the last export
   scoring the holdout; every sweep of the stream within the row bound
   and every later one over it only by in-flight rows, LFU evictions,
   dropped pre-admission gradients and tombstones; K1-K3 by phase 7's
   formula at every step and every tier-resident row bit-equal on its
   shard right after a re-assert at the stream's end; the holdout's
   logloss under its base
   rate's; the burst fired exactly 3 times with every push's version
   booked on both sides; the TensorBoard event file read back, CRC
   checked, with every evaluation's scalars. A summary prints steps/s,
   K1-K3 a step, peak resident rows, evictions, admissions, the
   watermark's lag, each checkpoint's seconds, the phase's seconds and
   the card's name and power limit;
19. MoE on one card -- bench.py's MoE (bench.py:316-334: d 1024, 8
   layers, 8 heads of 128, vocab 32000, MLP ratio 4, 8 experts, top-2,
   capacity factor 1.25 (320 slots an expert), S 1024, batch 16, AdamW
   lr 3e-4 wd 0.01, bf16, the one-hot dispatch) and the dense
   TransformerLM at the matched active MLP ratio 7, both through the
   port's ``make_train_step`` and the default attention: each arm's
   first step against the same model on plain attention (phase 6's
   loss, cosine and attention-leaf rules, ``hold_agreement``),
   then 2 warm-up steps and 10 timed ones, 8 K4, 8 K5 and 8 K6 in every
   step; step ms, tokens/s, the FLOP share of the bf16 peak by
   scripts/bench_moe.py's formulas, peak memory, a profiled step and
   ``moe_step_overhead_vs_dense``. Then ``"compact"`` against
   ``"onehot"``: three fp32 AdamW steps each from the same weights,
   losses within 1e-4 relative, and the compact arm's bf16 step time;
   the aux loss finite and each MoE block's first-choice share per
   expert and dropped share. Then the mesh (``moe_mesh_arm``): three
   bf16 steps of ``TorchTrainer`` and three of
   ``parallel.spmd_trainer.SpmdTrainer`` over a one-rank NCCL process
   group (started and destroyed here), its model on the host, from the
   one-hot arm's starting weights: losses, parameters and AdamW's slots
   bit-equal, K4-K6 8 a step, the dense plan all local and 0 collective
   bytes, each step's ms beside the other's. Last, the zoo's MoE
   ``custom_model`` (12
   layers, 12 heads, d 768, 8 experts) 3 steps through
   ``LocalExecutor`` over RecordIO token records (K4-K6 12 a step), its
   export answered once by an in-process ``ServingEngine``: bare
   logits, K4 12 times in that forward, within the serve tolerances of
   ``eval_step``.

The last lines are the kernels JSON line, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --mutations`` plants each fault of
``K4_MUTATIONS``, ``BWD_MUTATIONS``, ``TIER_MUTATIONS`` and
``FC_MUTATIONS`` in its own copy of the port under build/ and requires
the kernel phase (phase 17's promoted model for ``FC_MUTATIONS``) to
fail there, then times K4's schedules (``K4_SCHEDULES``) and K3's handling
of misses (``K3_VARIANTS``) in turns. ``--sparse-ab PARENT`` runs phase
7's main run for the checkout at PARENT and this one in turns;
``--job-ab PARENT [OTHER ...]`` runs phase 9's job the same way.
``--against-parent PARENT`` builds K4-K6 from the checkout at PARENT,
from this one and from copies of this one under each candidate of
``K6_D256_VARIANTS``, requires this checkout's raw launches to give the
parent's bits at every ``AGAINST_PARENT_CASES`` entry (the variants'
bits are logged), and times K6 of each build in turns at bench.py's
transformer and s16k_flash shapes. ``--lm-ab PARENT`` runs phase 16's
transformer and s16k_flash steps for both checkouts in turns.
Imports nothing of JAX or of the JAX package.
"""

import datetime
import gc
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ZOO = "elasticdl_tpu_torch.models.transformer"
SEED = 0
# the zoo TransformerLM (elasticdl_tpu/models/transformer.py custom_model)
ZOO_WIDTHS = dict(vocab_size=32000, num_layers=12, num_heads=12, embed_dim=768)

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its
# operations over the peak rate for its type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # fp32 off the tensor cores

# kernel cases: (name, batch*heads, seq, head_dim, dtype, causal)
CASES = (
    # the served and the trained shape: 8 rows x 12 heads, S 1024, d 64
    ("serve_bf16_causal", 96, 1024, 64, "bfloat16", True),
    ("f32_causal", 96, 1024, 64, "float32", True),
    ("bf16_full", 96, 1024, 64, "bfloat16", False),
    ("bf16_d128_causal", 48, 1024, 128, "bfloat16", True),
    ("bf16_ragged_s1000_causal", 96, 1000, 64, "bfloat16", True),
    ("f32_d128_ragged_s1000_full", 16, 1000, 128, "float32", False),
    # heads of 256: bench.py's transformer (batch 12 x 8 heads, S 1024),
    # its s16k_flash (batch 1 x 8 heads, S 16384: 256 query tiles, the
    # causal tile range and the K/V ring over as many turns as the main
    # path runs; the plain versions' fp32 score matrices are 8.6 GB
    # each) and the ragged edges of the D 256 tiles (64 keys in K4 and
    # K6, 32 in K5; K6's query mask past S needs a ragged bf16 case)
    ("bench_bf16_d256_causal", 96, 1024, 256, "bfloat16", True),
    ("s16k_bf16_d256_causal", 8, 16384, 256, "bfloat16", True),
    ("f32_d256_ragged_s1000_full", 16, 1000, 256, "float32", False),
    ("bf16_d256_ragged_s1000_causal", 16, 1000, 256, "bfloat16", True),
    # a head_dim between the kernels' widths: zero-padded to 128
    ("bf16_d96_padded_causal", 96, 1024, 96, "bfloat16", True),
    # bench.py's MoE and its matched dense arm (phase 19): batch 16 x 8
    # heads of 128, S 1024
    ("moe_bf16_d128_causal", 128, 1024, 128, "bfloat16", True),
)
# unequal query and key lengths: (name, batch*heads, seq_q, seq_k,
# head_dim, dtype, causal). Fewer queries than keys leaves key tiles past
# seq_q under the causal mask that no query sees (K6 stores their dk and
# dv as zeros: d 256's 64-key work tiles 4-15 at seq_q 200), more
# queries than keys gives rows past seq_k that see every key (their lse
# from K4), and a head_dim between the kernels' widths runs padded
UNEQUAL_CASES = (
    ("uneq_bf16_d64_q384_k1000_causal", 16, 384, 1000, 64, "bfloat16", True),
    ("uneq_bf16_d128_q1000_k384_causal", 16, 1000, 384, 128, "bfloat16",
     True),
    ("uneq_bf16_d256_q200_k1000_causal", 16, 200, 1000, 256, "bfloat16",
     True),
    ("uneq_f32_d128_q520_k1000_full", 16, 520, 1000, 128, "float32", False),
    ("uneq_bf16_d96_q1000_k384_full", 16, 1000, 384, 96, "bfloat16", False),
)


def case_lengths(case):
    """``(name, bh, seq_q, seq_k, dim, dtype, causal)`` of a CASES entry
    (seq_k = seq_q) or an UNEQUAL_CASES entry."""
    if len(case) == 6:
        name, bh, seq, dim, dtype, causal = case
        return name, bh, seq, seq, dim, dtype, causal
    return tuple(case)


# o tolerance per dtype: bf16 rounds p and o at other points than the
# plain version (one bf16 ulp of O(1) values is 2^-8 = 0.004); fp32
# differs only in summation order. lse is fp32 on both paths.
O_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_TOL = 1e-3
# dq, dk, dv are held row by row: every row r (one query for dq, one
# key for dk and dv) must have ||got_r - ref_r|| <= rtol * (||ref_r|| +
# floor), floor = GRAD_FLOOR * sqrt(head_dim). The rule is relative to
# each row's own size, because under the causal mask a gradient row's
# size falls off along the sequence (|dv_j| ~ 1/sqrt(j)), and a check
# scaled by the tensor's largest entry would pass a wrong late tile. The
# floor keeps rows whose exact gradient is ~0 (dq's first row under the
# causal mask) from dividing by ~0; it is a fifth of a late row's norm
# at the main shape. bf16: the two sides round the same p and ds to
# bf16 and differ in summation order and in the last ulp of some
# products, so a row is off by about one bf16 ulp (2^-8 of the value)
# per entry at most; fp32: summation order only, but dq sums terms
# ds_ij k_j whose ds_ij sum to zero over j, so a row can lose a few
# digits to cancellation. The kernels are deterministic; a right K5/K6
# reads at most 0.0045 (bf16) and 1.1e-4 (fp32) at the main shape on
# an H100, a late tile of dv 10% off reads 0.088. fp32 is also held
# entry by entry to an absolute 1e-4.
GRAD_ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-3}
GRAD_FLOOR = 1e-2
GRAD_F32_ATOL = 1e-4

# serve-phase tolerance of the kernel model against the same model with
# plain attention, both in bf16: every activation is rounded to bf16 (8
# significant bits) at other points in the two attentions, and the
# differences compound over 12 layers. A wrong kernel moves the mean by
# O(1); rounding moves it by well under 0.02.
SERVE_MEAN_TOL = 0.02
SERVE_MAX_TOL = 0.5

# train phase: the zoo's minibatch and sequence, steps over distinct
# batches, then steps on one repeated batch
TRAIN_BATCH = 8
TRAIN_SEQ = 1024
TRAIN_STEPS = 10
REPEAT_STEPS = 5
# first-step agreement of the kernel model with the same weights on
# plain attention, both bf16 compute with fp32 masters. The loss is a
# mean of bf16 per-sample losses, whose ulp at 8-16 is 0.0625: two ulps.
# The gradients (134M entries, flattened) point the same way to a
# cosine of at least 0.999; a wrong kernel gives a cosine far below.
TRAIN_LOSS_TOL = 0.125
TRAIN_GRAD_COS = 0.999
# and leaf by leaf over the attention projections (query, key, value,
# out_proj of every layer), whose gradients are the ones K5 and K6 feed:
# the worst relative L2 error of one leaf. The flattened cosine above is
# led by lm_head and the embedding, which K5 and K6 never touch. A right
# kernel reads about 0.015 (bf16 rounding at other points in the two
# attentions, over 12 layers); K5 or K6 skipping the diagonal tile of
# late blocks reads 0.071, with the cosine still above 0.9999.
TRAIN_ATTN_LEAF_TOL = 0.03


def log(msg):
    print(msg, flush=True)


def stage_clock():
    """``(seconds, mark)``: ``mark(name)`` books under ``name`` the
    seconds since the previous mark, or since the clock was made."""
    seconds, last = {}, [time.monotonic()]

    def mark(name):
        now = time.monotonic()
        seconds[name] = now - last[0]
        last[0] = now

    return seconds, mark


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters=20, warmup=3):
    """Mean device time of fn() in ms over iters launches, each after
    an L2 flush (a caller's inputs are not L2-resident at this size)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def worst_row_error(got, ref, dim):
    """(max over rows of ||got_r - ref_r|| / (||ref_r|| + floor), the
    median row norm of ref): the row rule of GRAD_ROW_RTOL."""
    err = (got.float() - ref.float()).norm(dim=-1)
    size = ref.float().norm(dim=-1)
    return ((err / (size + GRAD_FLOOR * dim ** 0.5)).max().item(),
            size.median().item())


# per kernel: (matrix products over the kept (q, k) pairs, (seq, dim)
# tensors read or written once, fp32 (bh, seq_q) statistics read or
# written once). K4: q k^T and p v; reads q, k, v, writes o and lse.
# K5: q k^T, do v^T and ds k; reads q, k, v, do, lse, delta, writes dq.
# K6: q k^T, do v^T, p^T do and ds^T q; reads q, k, v, do, lse, delta,
# writes dk and dv. KEY_TENSORS: how many of those tensors have seq_k
# rows (k, v, and K6's dk, dv); the rest have seq_q. Of these, k and v
# are read; under the causal mask no query sees a key at or past seq_q,
# so only min(seq_q, seq_k) of their rows are read (K6 still writes
# every row of dk and dv).
KERNEL_WORK = {"fwd": (2, 4, 1), "dq": (3, 5, 2), "dkv": (4, 6, 2)}
KEY_TENSORS = {"fwd": 2, "dq": 2, "dkv": 4}


def roofline(nbytes, flops, dtype="float32"):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the memory
    rate and ``flops`` over the peak rate for ``dtype``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(seq_q, seq_k):
    """The (q, k) pairs the causal mask keeps: sum over query rows i <
    seq_q of min(i + 1, seq_k)."""
    seen = min(seq_q, seq_k)
    return seen * (seen + 1) // 2 + (seq_q - seen) * seq_k


def bound(bh, seq, dim, dtype, causal, kernel="fwd", seq_k=None):
    """(bound_ms, bound_by) of one launch of ``kernel``: its bytes (each
    input read once, each output written once) and its operations (2 *
    dim per kept (q, k) pair and product; causal keeps
    ``causal_pairs``) on the roofline. ``seq`` is seq_q; seq_k defaults
    to it."""
    seq_k = seq if seq_k is None else seq_k
    products, tensors, stats = KERNEL_WORK[kernel]
    key_tensors = KEY_TENSORS[kernel]
    elem = 2 if dtype == "bfloat16" else 4
    pairs = causal_pairs(seq, seq_k) if causal else seq * seq_k
    flops = 2.0 * products * bh * dim * pairs
    keys_read = min(seq, seq_k) if causal else seq_k
    rows = ((tensors - key_tensors) * seq + 2 * keys_read
            + (key_tensors - 2) * seq_k)
    nbytes = rows * bh * dim * elem + stats * 4.0 * bh * seq
    return roofline(nbytes, flops, dtype)


def raw_launch(torch, fn, *args):
    """A no-argument launcher of the C function ``fn`` of a built kernel
    library on the current stream: no wrapper checks, no launch count."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*args, stream):
            raise SystemExit("raw %s launch failed" % fn.__name__)

    return launch


def kernel_phase(torch, flash, cases=CASES + UNEQUAL_CASES, baselines=True):
    """K4 against its plain version at every case, and a raw launch of
    the built library's ``edl_flash_fwd`` on the same inputs bit-equal
    to the wrapper's. K4 is timed by that raw call (no wrapper, not
    counted) with the wrapper's time beside it; ``baselines`` adds the
    plain version's and scaled_dot_product_attention's times."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for case in cases:
        name, bh, seq, seq_k, dim, dtype_name, causal = case_lengths(case)
        dtype = getattr(torch, dtype_name)
        q, k, v = (
            torch.randn(bh, rows, dim, device="cuda", generator=gen).to(dtype)
            for rows in (seq, seq_k, seq_k)
        )
        scale = 1.0 / dim ** 0.5
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        # the kernel's own width: a head_dim between 64, 128 and 256
        # runs zero-padded, and its raw launch takes the padded inputs
        width = flash.kernel_head_dim(dim)
        raw_in = [flash.pad_head_dim(t, width) for t in (q, k, v)]
        o_raw, lse_raw = torch.empty_like(raw_in[0]), torch.empty_like(lse)
        raw = raw_launch(torch, lib.edl_flash_fwd,
                         *(t.data_ptr() for t in raw_in), o_raw.data_ptr(),
                         lse_raw.data_ptr(), bh, seq, seq_k, width,
                         int(dtype == torch.bfloat16), int(causal), scale)
        raw()
        torch.cuda.synchronize()
        bit_equal = (torch.equal(o, o_raw[..., :dim])
                     and torch.equal(lse, lse_raw))
        ro, rlse = flash.flash_attention_fwd_reference(q, k, v, causal, scale)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        tol = O_TOL[dtype_name]
        ok = (
            o.shape == q.shape and o.dtype == dtype
            and lse.shape == (bh, 1, seq) and lse.dtype == torch.float32
            and bool(torch.isfinite(o.float()).all())
            and bool(((o.float() - ro.float()).abs()
                      <= tol + tol * ro.float().abs()).all())
            and err_lse <= LSE_TOL and bit_equal
        )
        record = {
            "case": name, "shape": [bh, seq, dim], "seq_k": seq_k,
            "dtype": dtype_name, "causal": causal, "kernel_width": width,
            "max_abs_err": err_o, "max_abs_err_lse": err_lse, "tol_o": tol,
            "tol_lse": LSE_TOL, "launches_bit_equal": bit_equal,
        }
        if not ok:
            log(json.dumps(dict(record, ok=False)))
            raise SystemExit("kernel phase failed at case %s" % name)
        record["ms"] = time_ms(torch, raw, flush)
        record["wrapper_ms"] = time_ms(torch, lambda: flash.flash_attention_fwd(
            q, k, v, causal=causal), flush)
        # host time of one raw call (ctypes, the bf16 path's three tensor
        # map encodings, the launch), enqueued back to back
        t0 = time.perf_counter()
        for _ in range(100):
            raw()
        record["host_us_per_raw_call"] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        if baselines:
            record["plain_ms"] = time_ms(
                torch, lambda: flash.flash_attention_fwd_reference(
                    q, k, v, causal, scale), flush)
            q4, k4, v4 = (t.view(1, bh, -1, dim) for t in (q, k, v))
            record["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, scale=scale), flush)
            del q4, k4, v4
        record["bound_ms"], record["bound_by"] = bound(
            bh, seq, dim, dtype_name, causal, seq_k=seq_k)
        record["ok"] = ok
        log(json.dumps(record))
        results[name] = record
        del q, k, v, o, lse, o_raw, lse_raw, ro, rlse, raw_in
    return results


def bwd_kernel_phase(torch, flash, timing=True, cases=CASES + UNEQUAL_CASES):
    """K5 and K6 against the plain backward at every case, and raw
    launches of the built library's C functions on the same inputs
    bit-equal to the wrapper's; with ``timing``, each kernel timed
    alone by those raw launches (not counted) beside the wrapper
    ``flash_attention_bwd`` (checks, delta, K5 and K6: the only wrapper
    either kernel has), its own plain version, and the backward of
    scaled_dot_product_attention, which computes dq, dk and dv together
    (no PyTorch call computes K5's or K6's part alone). Where the causal
    mask leaves keys that no query sees (seq_q < seq_k), their dk and dv
    rows must be exactly zero."""
    import torch.nn.functional as F

    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for case in cases:
        name, bh, seq, seq_k, dim, dtype_name, causal = case_lengths(case)
        dtype = getattr(torch, dtype_name)
        q, k, v, do = (
            torch.randn(bh, rows, dim, device="cuda", generator=gen).to(dtype)
            for rows in (seq, seq_k, seq_k, seq)
        )
        scale = 1.0 / dim ** 0.5
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal)
        torch.cuda.synchronize()
        refs = flash.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                   causal, scale)
        errs, row_errs, row_norms, oks = {}, {}, {}, []
        rtol = GRAD_ROW_RTOL[dtype_name]
        for grad_name, got, ref, like in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                             refs, (q, k, v)):
            err = (got.float() - ref.float()).abs().max().item()
            row_err, row_norm = worst_row_error(got, ref, dim)
            errs[grad_name], row_errs[grad_name] = err, row_err
            row_norms[grad_name] = row_norm
            oks.append(got.shape == like.shape and got.dtype == dtype
                       and bool(torch.isfinite(got.float()).all())
                       and row_err <= rtol
                       and (dtype_name == "bfloat16" or err <= GRAD_F32_ATOL))
        del refs
        # keys no query sees under the causal mask: exactly zero
        unseen = seq_k - seq if causal and seq < seq_k else 0
        if unseen:
            oks.append(not bool(dk[:, seq:].any() | dv[:, seq:].any()))
        # raw launches at the kernel's width (padded inputs, as K4's;
        # delta summed over the padded rows, as the wrapper sums it)
        width = flash.kernel_head_dim(dim)
        raw_in = [flash.pad_head_dim(t, width) for t in (q, k, v, do)]
        o_in = flash.pad_head_dim(o, width)
        delta = (o_in.float() * raw_in[3].float()).sum(-1).unsqueeze(1)
        del o_in
        common = (bh, seq, seq_k, width, int(dtype == torch.bfloat16),
                  int(causal), scale)
        inputs = (*(t.data_ptr() for t in raw_in), lse.data_ptr(),
                  delta.data_ptr())
        raw_out = [torch.empty_like(t) for t in raw_in[:3]]
        raw_dq = raw_launch(torch, lib.edl_flash_bwd_dq, *inputs,
                            raw_out[0].data_ptr(), *common)
        raw_dkv = raw_launch(torch, lib.edl_flash_bwd_dkv, *inputs,
                             raw_out[1].data_ptr(), raw_out[2].data_ptr(),
                             *common)
        raw_dq()
        raw_dkv()
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a[..., :dim], b)
                        for a, b in zip(raw_out, (dq, dk, dv)))
        oks.append(bit_equal)
        record = {
            "case": name, "shape": [bh, seq, dim], "seq_k": seq_k,
            "dtype": dtype_name, "causal": causal, "kernel_width": width,
            "unseen_key_rows_zero": unseen * bh if unseen else None,
            "max_abs_err": errs, "worst_row_rel_err": row_errs,
            "tol_row_rel": rtol, "row_floor": GRAD_FLOOR * dim ** 0.5,
            "median_row_norm": row_norms,
            "tol_abs": GRAD_F32_ATOL if dtype_name == "float32" else None,
            "launches_bit_equal": bit_equal,
            "dq_bound": bound(bh, seq, dim, dtype_name, causal, "dq",
                              seq_k),
            "dkv_bound": bound(bh, seq, dim, dtype_name, causal, "dkv",
                               seq_k),
            "ok": all(oks),
        }
        if not record["ok"]:
            log(json.dumps(record))
            raise SystemExit("backward kernel phase failed at case %s" % name)
        if not timing:
            log(json.dumps(record))
            results[name] = record
            del q, k, v, do, o, lse, dq, dk, dv, delta, raw_out, raw_in
            continue
        record["dq_ms"] = time_ms(torch, raw_dq, flush)
        record["dkv_ms"] = time_ms(torch, raw_dkv, flush)
        record["wrapper_ms_dq_dk_dv"] = time_ms(
            torch, lambda: flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal=causal), flush)
        args = (q, k, v, o, lse, do, causal, scale)
        record["dq_plain_ms"] = time_ms(
            torch, lambda: flash.flash_attention_bwd_dq_reference(*args),
            flush, iters=5)
        record["dkv_plain_ms"] = time_ms(
            torch, lambda: flash.flash_attention_bwd_dkv_reference(*args),
            flush, iters=5)
        q4, k4, v4 = (t.view(1, bh, -1, dim).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
        do4 = do.view(1, bh, seq, dim)
        record["library_ms_dq_dk_dv"] = time_ms(
            torch, lambda: torch.autograd.grad(
                sdpa, (q4, k4, v4), do4, retain_graph=True), flush)
        log(json.dumps(record))
        results[name] = record
        del q, k, v, do, o, lse, dq, dk, dv, delta, raw_out, q4, k4, v4
        del sdpa, do4, args, raw_in
    return results


# device-tier kernels K1-K3 at deepfm's deployment shapes (bench.py:65-78,
# 106-129): tier capacity 65536 + 1 scratch row; the combined buffer is
# the id capacity min(512 * 39, 8192) = 8192 rows, of which a Zipf(1.2)
# batch fills about 5100 unique ids; a staging chunk is launched at its
# real length, which the main run's resident rows over its insert chunks
# put at about 540 (118k rows in 218 chunks): 512 promotions and 512
# victims here
TIER_ROWS = 65536 + 1
TIER_CAPACITY_IDS = 8192
TIER_UNIQUE = 5100
TIER_HIT_SHARE = 0.6
TIER_STAGED = 512
TIER_DIMS = (("deepfm_emb", 8), ("deepfm_linear", 1))
TIER_OPTS = ("sgd", "momentum", "nesterov", "adagrad", "adam")
# K3 against its plain version on every row but the scratch row: the
# kernel rounds each operation once in the plain version's order (no FMA
# contraction), so only adam's powf(beta, t) may differ from torch's pow
# by an fp32 ulp; a few ulps on the row: relative 2e-6, absolute 1e-7
K3_RTOL, K3_ATOL = 2e-6, 1e-7
# fp32 operations per element of K3, per optimizer (adam adds two powf
# a row): far under the bytes, so the bound is the memory's
K3_FLOPS = {"sgd": 2, "momentum": 4, "nesterov": 6, "adagrad": 6, "adam": 16}


def tier_inputs(torch, np, rng, dim, opt_type, device="cuda"):
    """A random tier state of TIER_ROWS rows and the slot arrays of one
    step: the combined buffer's slots (unique hits, misses -1, padding
    -1), a staging chunk's insert and evict slots (unique) and the
    inserted rows."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    scratch = TIER_ROWS - 1
    state = tier.init_table_state(TIER_ROWS, dim, opt_type, device=device)
    state["rows"].copy_(torch.from_numpy(
        rng.standard_normal((TIER_ROWS, dim), dtype=np.float32) * 0.01))
    for key in state:
        if key.startswith("slot"):
            state[key].copy_(torch.from_numpy(
                rng.random((TIER_ROWS, dim), dtype=np.float32) * 1e-4))
    state["steps"].copy_(torch.from_numpy(
        rng.integers(0, 100, TIER_ROWS).astype(np.int32)))
    perm = rng.permutation(scratch).astype(np.int32)
    slots = np.full(TIER_CAPACITY_IDS, -1, np.int32)
    hits = int(TIER_UNIQUE * TIER_HIT_SHARE)
    slots[:TIER_UNIQUE][rng.permutation(TIER_UNIQUE)[:hits]] = perm[:hits]
    arrays = {
        "slots": slots, "ins": perm[hits:hits + TIER_STAGED],
        "evict": perm[hits + TIER_STAGED:hits + 2 * TIER_STAGED],
        "miss": rng.standard_normal((TIER_CAPACITY_IDS, dim),
                                    dtype=np.float32),
        "ins_rows": rng.standard_normal((TIER_STAGED, dim),
                                        dtype=np.float32),
        "grads": rng.standard_normal((TIER_CAPACITY_IDS, dim),
                                     dtype=np.float32) * 1e-3,
    }
    return state, {k: torch.from_numpy(v).to(device)
                   for k, v in arrays.items()}


# deepfm's tier optimizer: lr, momentum, beta1, beta2, eps
K3_HYPER = (0.001, 0.9, 0.9, 0.999, 1e-8)


def k3_raw(torch, np, lib, state, slots, grads, opt_type):
    """A raw launcher of K3 (``raw_launch``) on ``state`` with the
    wrapper's arguments at K3_HYPER (1 - beta rounded once to fp32)."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    lr, momentum, beta1, beta2, eps = K3_HYPER
    slot_ptrs = [state[key].data_ptr() for key in sorted(state)
                 if key.startswith("slot")]
    slot_ptrs += [None] * (2 - len(slot_ptrs))
    return raw_launch(
        torch, lib.edl_tier_scatter_apply, grads.data_ptr(),
        slots.data_ptr(), state["rows"].data_ptr(), *slot_ptrs,
        state["steps"].data_ptr(), int(slots.shape[0]),
        state["rows"].shape[1], state["rows"].shape[0],
        tier._OPT_CODES[opt_type], lr, momentum, beta1,
        float(np.float32(1.0 - beta1)), beta2,
        float(np.float32(1.0 - beta2)), eps)


def k3_bound(n, hits, dim, opt_type):
    """(bound_ms, bound_by) of one K3 launch: the slots read, and for
    each hit its gradient read, its weights and slot buffers read and
    written and its step count read and written (a miss needs nothing)."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier

    buffers = 1 + tier.TIER_OPT_SLOTS[opt_type]
    return roofline(4 * n + hits * (4 * dim + 2 * 4 * dim * buffers + 8),
                    K3_FLOPS[opt_type] * hits * dim)


def kernel_device_ms(torch, fn, prefix, flush, iters=20):
    """Mean device time in ms of the kernels whose profiler name starts
    with ``prefix``, over ``iters`` calls of fn() (each after an L2
    flush), read from torch.profiler: the kernel's own run, without the
    launch and event overhead that time_ms counts (a few microseconds,
    as much as a small kernel's run). None when the profiler sees no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.key.startswith(prefix):
            total_us += getattr(evt, "device_time_total", None) or \
                evt.cuda_time_total
            count += evt.count
    return total_us / 1e3 / count if count and total_us > 0 else None


def k3_hit_mix_ms(torch, np, lib, flush, state, t):
    """K3 (adam) by raw launch on the real mix of ``t["slots"]`` (hits
    and -1) and on as many slots all hits: what the misses cost, by
    CUDA events (``_ms``) and by the profiler (``_device_ms``)."""
    n = int(t["slots"].shape[0])
    all_hits = torch.from_numpy(np.random.default_rng(SEED + 4).permutation(
        TIER_ROWS - 1)[:n].astype(np.int32)).to(t["slots"].device)
    out = {}
    for key, slots in (("real_mix", t["slots"]), ("all_hits", all_hits)):
        work = {k: v.clone() for k, v in state.items()}
        raw = k3_raw(torch, np, lib, work, slots, t["grads"], "adam")
        out[key + "_ms"] = time_ms(torch, raw, flush)
        out[key + "_device_ms"] = kernel_device_ms(
            torch, raw, TIER_PROFILE_PREFIX["k3"], flush)
        out[key + "_hits"] = int((slots >= 0).sum())
    return out


def k3_hit_mix_timing(torch, np):
    """``k3_hit_mix_ms`` at deepfm_emb's shape, printed as one line (the
    --mutations run times it on each of K3_VARIANTS)."""
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("embedding_tier")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    state, t = tier_inputs(torch, np, np.random.default_rng(SEED + 3), 8,
                           "adam")
    log(json.dumps({"k3_hit_mix": k3_hit_mix_ms(torch, np, lib, flush,
                                                state, t)}))


def tier_kernel_phase(torch, np, tier, timing=True):
    """K1, K2 and K3 against their plain versions on the card at
    deepfm's shapes, for both tables (d 8 and 1) and, for K3, every
    optimizer: K1 and K2 bit for bit (K2 on every buffer of an adam
    state: weights, m, v, step counts), K3 within K3_RTOL/K3_ATOL on
    every row but scratch. With ``timing``, each kernel is timed alone
    (CUDA events, L2 flushed before each launch) by a raw call of the
    built library (no wrapper, not counted), with the wrapper's time
    beside it, its plain version, its bound from this run's inputs and
    a library yardstick: K1 ``index_select`` + ``torch.where`` (two
    calls), K2 ``index_copy_`` + three ``index_fill_`` (four calls), K3
    none; K3 (adam, d 8) also on as many slots all hits; K1 also by the
    profiler (``device_ms``). Then ``chain_check`` at both widths.
    Returns {kernel: {table: record}} and {"chain": {table: record}}."""
    from elasticdl_tpu_torch.ops import _build

    lib = _build.load("embedding_tier")
    flush = (torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
             if timing else None)

    def timed(record, **fns):
        if timing:
            record.update({key: time_ms(torch, fn, flush)
                           for key, fn in fns.items()})

    rng = np.random.default_rng(SEED + 3)
    results = {"gather": {}, "insert_rows": {}, "scatter_apply": {}}
    scratch = TIER_ROWS - 1
    for table, dim in TIER_DIMS:
        state, t = tier_inputs(torch, np, rng, dim, "adam")
        rows = state["rows"]
        slots, miss = t["slots"], t["miss"]
        hits = int((slots >= 0).sum())
        # K1: the combined buffer and the eviction read
        got = tier.gather_merge(rows, slots, miss)
        got_ev = tier.gather_merge(rows, t["evict"])
        torch.cuda.synchronize()
        want = tier.gather_merge_reference(rows, slots, miss)
        want_ev = tier.gather_merge_reference(rows, t["evict"])
        exact = torch.equal(got, want) and torch.equal(got_ev, want_ev)
        err = max((got - want).abs().max().item(),
                  (got_ev - want_ev).abs().max().item())
        long_slots = slots.long()
        hit_mask = (slots >= 0)[:, None]
        safe = torch.where(slots >= 0, long_slots, 0)
        n = slots.shape[0]
        out = torch.empty_like(got)
        raw = raw_launch(torch, lib.edl_tier_gather, rows.data_ptr(),
                         slots.data_ptr(), miss.data_ptr(), out.data_ptr(),
                         n, dim, TIER_ROWS, 0)
        raw()
        torch.cuda.synchronize()
        exact = exact and torch.equal(out, got)
        record = {
            "table": table, "shape": [n, dim], "table_rows": TIER_ROWS,
            "hits": hits, "bit_exact": exact, "max_abs_err": err,
            "library_calls": "index_select + torch.where (two calls)",
        }
        timed(record, ms=raw,
              wrapper_ms=lambda: tier.gather_merge(rows, slots, miss),
              plain_ms=lambda: tier.gather_merge_reference(rows, slots,
                                                           miss),
              library_ms=lambda: torch.where(
                  hit_mask, rows.index_select(0, safe), miss))
        if timing:
            record["device_ms"] = kernel_device_ms(
                torch, raw, TIER_PROFILE_PREFIX["k1"], flush)
        # slots, the rows read (a hit from the table, a miss from the
        # miss buffer) and the rows written
        record["bound_ms"], record["bound_by"] = roofline(
            4 * n + 2 * 4 * n * dim, 0)
        log(json.dumps({"tier_kernel": "K1 gather_merge", **record}))
        results["gather"][table] = record
        if not exact:
            raise SystemExit("K1 disagrees with its plain version (%s)"
                             % table)

        # K2: a staging chunk inserted into the whole adam state (rows,
        # m, v, steps) by the wrapper and by a raw launch, and the
        # one-buffer set_rows (rows, then zeros); every buffer compared
        # whole (the chunk holds no scratch slot)
        ins, ins_rows = t["ins"], t["ins_rows"]
        n = int(ins.shape[0])
        got = {k: v.clone() for k, v in state.items()}
        want = {k: v.clone() for k, v in state.items()}
        work = {k: v.clone() for k, v in state.items()}
        tier.insert_rows(got, ins, ins_rows)
        tier.insert_rows_reference(want, ins, ins_rows)
        raw = raw_launch(torch, lib.edl_tier_insert_rows,
                         work["rows"].data_ptr(), work["slot0"].data_ptr(),
                         work["slot1"].data_ptr(), work["steps"].data_ptr(),
                         ins.data_ptr(), ins_rows.data_ptr(), n, dim,
                         TIER_ROWS, 0)
        raw()
        torch.cuda.synchronize()
        exact = all(torch.equal(got[k], want[k]) and torch.equal(work[k],
                                                                 want[k])
                    for k in want)
        err = max(float((got[k] - want[k]).abs().max()) for k in want)
        for values in (ins_rows, None):
            one, plain = rows.clone(), rows.clone()
            tier.set_rows(one, ins, values)
            tier.set_rows_reference(plain, ins, values)
            torch.cuda.synchronize()
            exact = exact and torch.equal(one, plain)
            err = max(err, (one - plain).abs().max().item())
        ins_long = ins.long()

        def library():
            work["rows"].index_copy_(0, ins_long, ins_rows)
            work["slot0"].index_fill_(0, ins_long, 0.0)
            work["slot1"].index_fill_(0, ins_long, 0.0)
            work["steps"].index_fill_(0, ins_long, 0)

        record = {
            "table": table, "shape": [n, dim],
            "buffers": sorted(state), "bit_exact": exact,
            "max_abs_err": err,
            "library_calls": "index_copy_ + index_fill_ x 3 (four calls)",
        }
        timed(record, ms=raw,
              wrapper_ms=lambda: tier.insert_rows(work, ins, ins_rows),
              plain_ms=lambda: tier.insert_rows_reference(work, ins,
                                                          ins_rows),
              library_ms=library)
        # slots and rows read; the weights, both slot buffers and the
        # step counts written
        record["bound_ms"], record["bound_by"] = roofline(
            4 * n + 4 * n * dim + 3 * 4 * n * dim + 4 * n, 0)
        log(json.dumps({"tier_kernel": "K2 insert_rows", **record}))
        results["insert_rows"][table] = record
        if not exact:
            raise SystemExit("K2 disagrees with its plain version (%s)"
                             % table)
        del got, want, work

        # K3: every optimizer on the combined buffer's gradients
        per_opt = {}
        for opt_type in TIER_OPTS:
            base, t = tier_inputs(torch, np, rng, dim, opt_type)
            slots, grads = t["slots"], t["grads"]
            got = {k: v.clone() for k, v in base.items()}
            want = {k: v.clone() for k, v in base.items()}
            args = (opt_type,) + K3_HYPER
            tier.scatter_apply(got, slots, grads, *args)
            tier.scatter_apply_reference(want, slots, grads, *args)
            torch.cuda.synchronize()
            err, ok = 0.0, torch.equal(got["steps"][:scratch],
                                        want["steps"][:scratch])
            for key in got:
                if key == "steps":
                    continue
                a, b = got[key][:scratch], want[key][:scratch]
                err = max(err, (a - b).abs().max().item())
                ok = ok and bool(((a - b).abs()
                                  <= K3_ATOL + K3_RTOL * b.abs()).all())
            work = {k: v.clone() for k, v in base.items()}
            n = slots.shape[0]
            hits = int((slots >= 0).sum())
            record = {
                "table": table, "opt": opt_type, "shape": [n, dim],
                "hits": hits, "max_abs_err": err, "rtol": K3_RTOL,
                "atol": K3_ATOL, "ok": ok, "library_ms": None,
            }
            timed(record, ms=k3_raw(torch, np, lib, work, slots, grads,
                                    opt_type),
                  wrapper_ms=lambda: tier.scatter_apply(work, slots, grads,
                                                        *args),
                  plain_ms=lambda: tier.scatter_apply_reference(
                      work, slots, grads, *args))
            if timing and (table, opt_type) == ("deepfm_emb", "adam"):
                record.update(k3_hit_mix_ms(torch, np, lib, flush, base, t))
            record["bound_ms"], record["bound_by"] = k3_bound(
                n, hits, dim, opt_type)
            log(json.dumps({"tier_kernel": "K3 scatter_apply", **record}))
            per_opt[opt_type] = record
            if not ok:
                raise SystemExit("K3 (%s, %s) disagrees with its plain "
                                 "version" % (opt_type, table))
            del base, got, want, work
        results["scatter_apply"][table] = per_opt
        del state
    results["chain"] = {table: chain_check(torch, np, tier, dim)
                        for table, dim in TIER_DIMS}
    return results


# the staging chunk's chain on the card, K1 (victims' rows) -> K2 (the
# insert) -> K1 (the combined buffer), the second and third launched as
# programmatic dependents of the one before. Each run is queued behind a
# sleeping kernel (torch.cuda._sleep, about 0.5 ms at the card's clock),
# so that its launches meet on the card as they would behind a busy
# stream, not one by one behind the host.
CHAIN_REPS = 200
CHAIN_SLEEP_CYCLES = 1_000_000
CHAIN_TIMING_REPS = 100
# the serial chain: the same source with the launch attribute off, built
# in a copy under build/ and timed against the checkout's, in turns
K1_CHAIN_VARIANTS = {
    "pdl": (),
    "serial": (("  attr[0].val.programmaticStreamSerializationAllowed = "
                "pdl ? 1 : 0;\n",
                "  attr[0].val.programmaticStreamSerializationAllowed = 0;"
                "\n"),),
}


def chain_inputs(torch, np, rng, dim, device="cuda"):
    """tier_inputs' adam state and arrays for one staging chunk whose
    inserts reuse every victim's slot (in another order) and whose
    promoted rows are hits of the combined buffer: the case where the
    chain's order decides every value."""
    state, t = tier_inputs(torch, np, rng, dim, "adam", device)
    evict = t["evict"].cpu().numpy()
    slots = t["slots"].cpu().numpy()
    ins = evict[rng.permutation(evict.size)]
    slots[TIER_UNIQUE:TIER_UNIQUE + ins.size] = ins
    t["ins"] = torch.from_numpy(ins).to(device)
    t["slots"] = torch.from_numpy(slots).to(device)
    return state, t


def chain_check(torch, np, tier, dim, reps=CHAIN_REPS, device="cuda"):
    """``fused_insert_gather`` on chain_inputs, ``reps`` times from the
    same state, each run queued behind a sleep: the victims' rows, the
    combined buffer and every buffer of the state must equal the plain
    versions applied in order (gather_merge_reference,
    insert_rows_reference, gather_merge_reference), bit for bit, in
    every run. Logs how many runs disagreed, then raises if any did."""
    rng = np.random.default_rng(SEED + 5)
    state, t = chain_inputs(torch, np, rng, dim, device)
    want = {k: v.clone() for k, v in state.items()}
    want_ev = tier.gather_merge_reference(want["rows"], t["evict"])
    tier.insert_rows_reference(want, t["ins"], t["ins_rows"])
    want_comb = tier.gather_merge_reference(want["rows"], t["slots"],
                                            t["miss"])
    work = {k: v.clone() for k, v in state.items()}
    bad = []
    for rep in range(reps):
        torch.cuda._sleep(CHAIN_SLEEP_CYCLES)
        for key in work:
            work[key].copy_(state[key])
        _, comb, ev = tier.fused_insert_gather(
            work, t["ins"], t["ins_rows"], t["evict"], t["slots"], t["miss"])
        wrong = [name for name, got, ref in (
            ("evicted", ev, want_ev), ("combined", comb, want_comb),
            *((k, work[k], want[k]) for k in want))
            if not torch.equal(got, ref)]
        if wrong:
            bad.append([rep, wrong])
    record = {"tier_chain": "K1 -> K2 -> K1, inserts into the victims' "
              "slots", "dim": dim, "reps": reps, "mismatches": len(bad),
              "first_mismatches": bad[:5], "staged": TIER_STAGED,
              "combined": int(t["slots"].shape[0])}
    log(json.dumps(record))
    if bad:
        raise SystemExit("the chain disagrees with the plain versions in "
                         "%d of %d runs (d %d)" % (len(bad), reps, dim))
    return record


def chain_launcher(torch, lib, state, t):
    """One chunk chain by raw calls of ``lib``'s C functions (no
    wrapper, not counted): K1 on the victims (plain launch), K2 and K1
    on the combined buffer as programmatic dependents (pdl 1; a library
    built with the attribute off ignores it)."""
    rows = state["rows"]
    n_ev, dim = int(t["evict"].shape[0]), rows.shape[1]
    out_ev = torch.empty((n_ev, dim), device=rows.device)
    out = torch.empty((int(t["slots"].shape[0]), dim), device=rows.device)
    calls = (
        (lib.edl_tier_gather, rows.data_ptr(), t["evict"].data_ptr(), None,
         out_ev.data_ptr(), n_ev, dim, rows.shape[0], 0),
        (lib.edl_tier_insert_rows, rows.data_ptr(), state["slot0"].data_ptr(),
         state["slot1"].data_ptr(), state["steps"].data_ptr(),
         t["ins"].data_ptr(), t["ins_rows"].data_ptr(),
         int(t["ins"].shape[0]), dim, rows.shape[0], 1),
        (lib.edl_tier_gather, rows.data_ptr(), t["slots"].data_ptr(),
         t["miss"].data_ptr(), out.data_ptr(), int(t["slots"].shape[0]),
         dim, rows.shape[0], 1),
    )
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        for fn, *args in calls:
            if fn(*args, stream):
                raise SystemExit("raw chain launch failed (%s)"
                                 % fn.__name__)

    run.buffers = (out_ev, out)  # kept alive with the launcher
    return run


def chain_span(torch, run, reps=CHAIN_TIMING_REPS):
    """Device times of ``reps`` chains, each queued behind a sleep ->
    {"span_ms": median by CUDA events from the chain's first launch to
    its last kernel's end, "profiler": per-kernel durations and the
    span from the first K1's start to the last K1's end, read from a
    torch.profiler trace (None unless it holds every chain's three
    kernels in order), "profiler_kernels": how many it holds}."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(CHAIN_SLEEP_CYCLES)
        start.record()
        run()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    span_ms = sorted(s.elapsed_time(e) for s, e in spans)[reps // 2]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.cuda._sleep(CHAIN_SLEEP_CYCLES)
            run()
        torch.cuda.synchronize()
    path = os.path.join(HERE, "build", "chain_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = (TIER_PROFILE_PREFIX["k1"], TIER_PROFILE_PREFIX["k2"])
    kernels = sorted((e for e in events if e.get("ph") == "X"
                      and str(e.get("name", "")).startswith(names)),
                     key=lambda e: float(e["ts"]))
    out = {"span_ms": span_ms, "profiler": None,
           "profiler_kernels": len(kernels)}
    chains = [kernels[i:i + 3] for i in range(0, len(kernels), 3)]
    if len(kernels) != 3 * reps or any(
            not c[1]["name"].startswith(names[1]) for c in chains):
        return out

    def median(values):
        return sorted(values)[len(values) // 2]

    def end(e):
        return float(e["ts"]) + float(e["dur"])

    out["profiler"] = {
        "span_ms": median([(end(c[2]) - float(c[0]["ts"])) / 1e3
                           for c in chains]),
        "k1_evict_ms": median([float(c[0]["dur"]) / 1e3 for c in chains]),
        "k2_ms": median([float(c[1]["dur"]) / 1e3 for c in chains]),
        "k1_combined_ms": median([float(c[2]["dur"]) / 1e3 for c in chains]),
        # a start before the previous kernel's end is the overlap PDL buys
        "k2_start_after_k1_end_ms": median(
            [(float(c[1]["ts"]) - end(c[0])) / 1e3 for c in chains]),
        "k1_start_after_k2_end_ms": median(
            [(float(c[2]["ts"]) - end(c[1])) / 1e3 for c in chains]),
    }
    return out


def chain_timing(torch, np, tier, serial_lib):
    """The chunk chain at deepfm's shapes (512-row chunk, 8192 slots,
    adam; d 8 and d 1) with programmatic dependent launch (the
    checkout's library) against the serial chain (``serial_lib``, built
    from K1_CHAIN_VARIANTS["serial"]), in turns (pdl, serial, serial,
    pdl), by ``chain_span``; with the wrapper ``fused_insert_gather``
    timed by events beside it (host-bound: Python between launches)."""
    from elasticdl_tpu_torch.ops import _build

    libs = {"pdl": _build.load("embedding_tier"), "serial": serial_lib}
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    results = {}
    for table, dim in TIER_DIMS:
        state, t = chain_inputs(torch, np, np.random.default_rng(SEED + 6),
                                dim)
        record = {"table": table, "dim": dim, "staged": TIER_STAGED,
                  "combined": int(t["slots"].shape[0]),
                  "pdl": [], "serial": []}
        for key in ("pdl", "serial", "serial", "pdl"):
            record[key].append(chain_span(
                torch, chain_launcher(torch, libs[key], state, t)))
        record["wrapper_ms"] = time_ms(
            torch, lambda: tier.fused_insert_gather(
                state, t["ins"], t["ins_rows"], t["evict"], t["slots"],
                t["miss"]), flush)
        log(json.dumps({"tier_chain_timing": record}))
        results[table] = record
    return results


# sparse train phase: DeepFM through SparseTrainer at the deployment
# configuration of bench.py:65-78,106-129 (39 fields, batch 512, id
# capacity min(512 * 39, 8192), ids Zipf(1.2) % 1e6 from numpy seed 0,
# adam lr 0.001 on the PS and the tier)
SPARSE_BATCH = 512
SPARSE_FIELDS = 39
SPARSE_VOCAB = 1_000_000
SPARSE_STEPS = 110
SPARSE_TIER = dict(capacity=65536, promote_hits=2, ttl=4096,
                   stage_budget=2048, opt_type="adam",
                   opt_args={"lr": 0.001}, writeback_steps=256)
SPARSE_SMALL_CAPACITY = 4096
SPARSE_SMALL_STEPS = 8
# card against CPU over the first steps, same batches, same seed: fp32
# throughout (TF32 off), so the two differ in summation order only
# (cuBLAS against the CPU's BLAS, the index backward's scatter-add).
# Adam near its eps divides such noise by eps (the dense slice's
# finding), so this run sets eps 1e-3 on the dense params, the PS and
# the tier: an update then moves by at most the gradient's own noise.
# The loss to 1e-5 relative; the touched store rows and the tier's
# rows to 1e-5 relative, 1e-6 absolute (their init scale is 1e-3; a
# wrong optimizer step moves a row by about lr = 1e-3).
SPARSE_AGREE_STEPS = 3
SPARSE_AGREE_EPS = 1e-3
SPARSE_LOSS_RTOL = 1e-5
SPARSE_ROW_RTOL, SPARSE_ROW_ATOL = 1e-5, 1e-6
SPARSE_NEVER_STEPS = 3
SPARSE_REPEAT_STEPS = 5
# the host stage split: medians over this many fresh steps, per store
SPARSE_SPLIT_STEPS = 10


def ctr_batches(np, n, batch=SPARSE_BATCH, fields=SPARSE_FIELDS,
                vocab=SPARSE_VOCAB, seed=SEED):
    """bench.py's Zipfian CTR batches: ids Zipf(1.2) % vocab, random
    labels, all rows real."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.2, size=(batch, fields)) % vocab).astype(np.int64)
        out.append({
            "features": {"ids": ids},
            "labels": rng.randint(0, 2, batch).astype(np.float32),
            "_mask": np.ones(batch, np.float32),
        })
    return out


def sparse_trainer(device, batch, fields, tier=None, eps=None,
                   numpy_store=False):
    """DeepFM's SparseTrainer over an in-process store (adam lr 0.001,
    as bench.py's PS), seed 0: the store ``LocalPSClient`` picks (the
    native one, through ``create_store``) or, with ``numpy_store``, a
    ``NumpyEmbeddingStore``; ``tier`` a dict of DeviceTierConfig knobs
    or None; ``eps`` overrides adam's epsilon on the dense params, the
    PS and the tier."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.ps.embedding_store import NumpyEmbeddingStore
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.sparse import SparseTrainer

    eps_args = {} if eps is None else {"epsilon": eps}
    config = False
    if tier is not None:
        knobs = dict(tier)
        knobs["opt_args"] = {**knobs["opt_args"], **eps_args}
        config = DeviceTierConfig(**knobs)
    if numpy_store:
        store = NumpyEmbeddingStore(seed=SEED)
        store.set_optimizer("adam", lr=0.001, **eps_args)
        client = LocalPSClient(store=store)
    else:
        client = LocalPSClient(seed=SEED, opt_type="adam", lr=0.001,
                               **eps_args)
    return SparseTrainer(
        model=deepfm.custom_model(),
        loss_fn=deepfm.loss,
        optimizer=create_optimizer("Adam", learning_rate=0.001, **eps_args),
        specs=deepfm.sparse_embedding_specs(
            num_features=fields, batch_size=batch,
            capacity=min(batch * fields, deepfm.MAX_ID_CAPACITY)),
        ps_client=client,
        seed=SEED,
        device_tier=config,
        device=device,
    )


def store_record(trainer):
    """Which store ``trainer`` trains on: its class and its library."""
    store = trainer.preparer._ps.store
    return {"store": type(store).__name__,
            "library": getattr(store, "library_path", None)}


def tier_counts(tier):
    return (tier.GATHER_LAUNCHES, tier.SET_ROWS_LAUNCHES,
            tier.SCATTER_APPLY_LAUNCHES)


def reset_tier_launches(tier):
    tier.GATHER_LAUNCHES = tier.SET_ROWS_LAUNCHES = 0
    tier.SCATTER_APPLY_LAUNCHES = 0


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def sparse_phase(torch, np, tier, device="cuda", batch=SPARSE_BATCH,
                 fields=SPARSE_FIELDS, vocab=SPARSE_VOCAB, steps=SPARSE_STEPS,
                 tier_knobs=None, small_capacity=SPARSE_SMALL_CAPACITY):
    """DeepFM through the port's SparseTrainer with the device tier, and
    its checks (each printed; any failure raises SystemExit): the
    never-promote tier bit-exact with the tier off; the card against
    the CPU over the first steps; the main run's finite losses, K1-K3
    launches per step against the path's formula and a warm hit rate
    above 0; a small tier's evictions and flush parity; the loss
    falling on one repeated batch. Returns what the kernels line and
    the timing need."""
    knobs = dict(SPARSE_TIER if tier_knobs is None else tier_knobs)
    device = torch.device(device)
    # the main run's batches, the repeated batch, and fresh ones for the
    # profiled step (up to three, see sparse_timing) and the host split
    batches = ctr_batches(np, steps + 4 + SPARSE_SPLIT_STEPS, batch, fields,
                          vocab)
    tables = ("deepfm_emb", "deepfm_linear")

    # 1. an engaged tier that never promotes is the tier-off path
    never = dict(knobs, promote_hits=10 ** 9)
    losses = {}
    for name, tier_cfg in (("off", None), ("never", never)):
        trainer = sparse_trainer(device, batch, fields, tier=tier_cfg)
        state, run = None, []
        for b in batches[:SPARSE_NEVER_STEPS]:
            state, loss = trainer.train_step(state, b)
            run.append(float(loss))
        losses[name] = run
        trainer.close()
        del trainer, state
    record = {"sparse": "never_promote_vs_tier_off", "losses_off":
              losses["off"], "losses_never": losses["never"],
              "bit_exact": losses["off"] == losses["never"]}
    log(json.dumps(record))
    if not record["bit_exact"]:
        raise SystemExit("a never-promoting tier changed the losses")

    # 2. the card against the CPU on the same batches (plain versions)
    runs = []
    for dev in (device, torch.device("cpu")):
        trainer = sparse_trainer(dev, batch, fields, tier=knobs,
                                 eps=SPARSE_AGREE_EPS)
        state, run = None, []
        for b in batches[:SPARSE_AGREE_STEPS]:
            state, loss = trainer.train_step(state, b)
            run.append(float(loss))
        touched = np.unique(np.concatenate(
            [b["features"]["ids"].ravel()
             for b in batches[:SPARSE_AGREE_STEPS]]))
        store = trainer.preparer._ps.store
        runs.append({
            "losses": run, "store": store_record(trainer),
            "rows": {t: store.lookup(t, touched) for t in tables},
            "tier": {t: trainer.device_tier.table_rows(t) for t in tables},
            "stats": trainer.device_tier.stats(),
        })
        trainer.close()
        del trainer, state
    card, cpu = runs
    if card["store"] != cpu["store"]:
        raise SystemExit("card and CPU trained on other stores: %s, %s"
                         % (card["store"], cpu["store"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    row_err, rows_ok = 0.0, card["stats"] == cpu["stats"]
    for t in tables:
        pairs = [(card["rows"][t], cpu["rows"][t]),
                 (card["tier"][t][1], cpu["tier"][t][1])]
        rows_ok = rows_ok and np.array_equal(card["tier"][t][0],
                                             cpu["tier"][t][0])
        for got, want in pairs:
            if got.shape != want.shape:
                rows_ok = False
                continue
            diff = np.abs(got.astype(np.float64) - want)
            row_err = max(row_err, float(diff.max()) if diff.size else 0.0)
            rows_ok = rows_ok and bool((diff <= SPARSE_ROW_ATOL
                                        + SPARSE_ROW_RTOL
                                        * np.abs(want)).all())
    record = {"sparse": "card_vs_cpu", "steps": SPARSE_AGREE_STEPS,
              "losses": card["losses"], "cpu_losses": cpu["losses"],
              "loss_rel_err": loss_err, "tol_loss_rel": SPARSE_LOSS_RTOL,
              "row_max_abs_err": row_err, "tol_row_rel": SPARSE_ROW_RTOL,
              "tol_row_abs": SPARSE_ROW_ATOL, "rows_ok": rows_ok,
              "adam_eps": SPARSE_AGREE_EPS, **card["store"],
              "resident": {t: int(card["tier"][t][0].size) for t in tables}}
    log(json.dumps(record))
    if not (loss_err <= SPARSE_LOSS_RTOL and rows_ok):
        raise SystemExit("the card disagrees with the CPU on the sparse "
                         "path")
    del runs, card, cpu

    # 3. the main run: the deployment configuration over distinct batches,
    # on the store a user gets (the native one; create_store's fallback
    # to numpy fails the run here)
    trainer = sparse_trainer(device, batch, fields, tier=knobs)
    used = store_record(trainer)
    log(json.dumps({"sparse": "main_run_store", **used}))
    if used["store"] != "NativeEmbeddingStore":
        raise SystemExit("the sparse path trains on %s, not the native "
                         "store" % used["store"])
    dtier = trainer.device_tier
    state, main_losses, step_s, bad_steps = None, [], [], []
    half_stats = None
    reset_tier_launches(tier)  # the sparse path's count starts here
    for i, b in enumerate(batches[:steps]):
        before = tier_counts(tier)
        stats0 = dtier.stats()
        t0 = time.monotonic()
        state, loss = trainer.train_step(state, b)
        main_losses.append(float(loss))
        step_s.append(time.monotonic() - t0)
        stats1 = dtier.stats()
        d_k1, d_k2, d_k3 = (a - c for a, c in zip(tier_counts(tier), before))
        gather_only = (stats1["gather_only_combines"]
                       - stats0["gather_only_combines"])
        # per staging chunk: K1 for the combined buffer, K1 for the
        # victims if it has any, K2 once (the whole table state) if it
        # has promotions
        chunks, inserts, evicts = (
            stats1[k] - stats0[k]
            for k in ("staged_chunks", "insert_chunks", "evict_chunks"))
        want = (gather_only + chunks + evicts, inserts, len(tables))
        if (d_k1, d_k2, d_k3) != want:
            bad_steps.append([i, [d_k1, d_k2, d_k3], list(want)])
        if i + 1 == steps // 2:
            half_stats = dtier.stats()
    sync(torch, device)
    launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                        tier_counts(tier)))
    end_stats = dtier.stats()
    warm_lookups = (end_stats["hits"] + end_stats["misses"]
                    - half_stats["hits"] - half_stats["misses"])
    warm_hit_rate = (end_stats["hits"] - half_stats["hits"]) / max(
        warm_lookups, 1)
    warm = step_s[10:] or step_s
    main_record = {
        "sparse": "main_run", "steps": len(main_losses), "batch": batch,
        "fields": fields, "tier": knobs, "launches": launches,
        "launches_per_step": {k: v / len(main_losses)
                              for k, v in launches.items()},
        "launch_formula_mismatches": bad_steps[:5],
        "losses_first_last": [main_losses[0], main_losses[-1]],
        "all_finite": bool(np.isfinite(main_losses).all()),
        "warm_hit_rate": warm_hit_rate, "tier_stats": end_stats,
        "steps_per_s": len(warm) / sum(warm),
        "examples_per_s": batch * len(warm) / sum(warm),
        "step_ms_host_median": float(np.median(warm)) * 1e3, **used,
    }
    log(json.dumps(main_record))
    if not main_record["all_finite"] or len(main_losses) != steps:
        raise SystemExit("sparse losses: %s" % main_losses)
    if bad_steps or min(launches.values()) <= 0:
        raise SystemExit("K1-K3 launches do not follow the path: %s"
                         % bad_steps[:5])
    if not warm_hit_rate > 0:
        raise SystemExit("the tier served no hit once warm")

    # 4. the loss falls on one repeated batch
    repeated = []
    for _ in range(SPARSE_REPEAT_STEPS):
        state, loss = trainer.train_step(state, batches[steps])
        repeated.append(float(loss))
    log(json.dumps({"sparse": "repeated_batch", "losses": repeated}))
    if not repeated[-1] < repeated[0]:
        raise SystemExit("the sparse loss did not fall on a repeated batch")

    # 5. a small tier: evictions, then flush parity after close()
    small = sparse_trainer(device, batch, fields,
                           tier=dict(knobs, capacity=small_capacity))
    small_state = None
    for b in batches[:SPARSE_SMALL_STEPS]:
        small_state, _ = small.train_step(small_state, b)
    small.close()
    store = small.preparer._ps.store
    parity, resident = True, {}
    for t in tables:
        ids, rows = small.device_tier.table_rows(t)
        resident[t] = int(ids.size)
        parity = parity and ids.size > 0 and np.array_equal(
            rows, store.lookup(t, ids))
    small_stats = small.device_tier.stats()
    record = {"sparse": "small_tier_flush_parity",
              "capacity": small_capacity, "steps": SPARSE_SMALL_STEPS,
              "evictions": small_stats["evictions"], "resident": resident,
              "bit_exact": parity, "tier_stats": small_stats}
    log(json.dumps(record))
    if not (small_stats["evictions"] > 0 and parity):
        raise SystemExit("small tier: no evictions or flush parity broken")
    del small, small_state
    return {"trainer": trainer, "state": state,
            "replay_batches": batches[:steps] + [batches[steps]]
            * SPARSE_REPEAT_STEPS,
            "profile_batches": batches[steps + 1:steps + 4],
            "split_batches": batches[steps + 4:], "launches": launches,
            "steps": len(main_losses), "main": main_record,
            "knobs": knobs, "batch": batch, "fields": fields}


# the profiler's demangled names of K1-K3 (ops/csrc/embedding_tier.cu),
# matched from the start: torch's own gathers (e.g.
# at::native::vectorized_gather_kernel) contain "gather_kernel" too
TIER_PROFILE_PREFIX = {
    "k1": "void (anonymous namespace)::gather_kernel<",
    "k2": "void (anonymous namespace)::insert_rows_kernel<",
    "k3": "void (anonymous namespace)::scatter_apply_kernel<",
}


# spin kernels that open a profiled session (profiler_warmup)
PROFILER_WARMUP_KERNELS = 16
PROFILER_WARMUP_CYCLES = 10_000
# torch.cuda._sleep's kernel (at::cuda::...::spin_kernel), by substring
PROFILER_WARMUP_NAME = "spin_kernel"


def profiler_warmup(torch):
    """Open a torch.profiler session with PROFILER_WARMUP_KERNELS spin
    kernels and a sync, before what it measures. In some processes the
    profiler drops the first few device records of every session: on
    the H100 a phase-7 step lost its first two copies and its first K1
    in every session of such a process, and a session opened with
    device work and a sync lost that work's records and held every
    tier kernel (chain_span's sessions open with a sleep and never lost
    one). The spin kernels are what is lost then; none is a tier
    kernel, and nothing the step runs is named like them."""
    for _ in range(PROFILER_WARMUP_KERNELS):
        torch.cuda._sleep(PROFILER_WARMUP_CYCLES)
    torch.cuda.synchronize()


def profile_step(torch, tier, trainer, state, batch):
    """One train step under torch.profiler -> (state, record, counted,
    profiled): its wall time beside the device-busy time, the idle
    share, the K1-K3 share of busy time, and each of K1-K3's launches by
    its counter and by the profiler (None when the profiler sees no
    device time). The profiler traces the card alone (with CPU activity
    on as well, more records were lost), and the session opens with
    ``profiler_warmup``; ``warmup_kernels_kept`` says how many of its
    spin kernels the profiler held (fewer than launched: this process
    drops a session's first records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_warmup(torch)
        before = tier_counts(tier)
        t0 = time.monotonic()
        state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    counted = dict(zip(("k1", "k2", "k3"),
                       (a - b for a, b in zip(tier_counts(tier), before))))
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total_us = getattr(evt, "device_time_total", None)
        if total_us is None:
            total_us = evt.cuda_time_total
        kernels[evt.key] = (total_us / 1e3, evt.count)
    warmup = {key: kernels.pop(key) for key in list(kernels)
              if PROFILER_WARMUP_NAME in key}
    busy_ms = sum(ms for ms, _ in kernels.values())
    k_ms, k_launches = {}, {}
    for k, prefix in TIER_PROFILE_PREFIX.items():
        rows = [v for key, v in kernels.items() if key.startswith(prefix)]
        k_ms[k] = sum(ms for ms, _ in rows)
        k_launches[k] = sum(n for _, n in rows)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    record = {"profile": "sparse_train_step", "wall_ms": wall_ms,
              "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
              "counted_launches": counted,
              "warmup_kernels_kept": [sum(n for _, n in warmup.values()),
                                      PROFILER_WARMUP_KERNELS]}
    if busy_ms <= 0:
        return state, record, counted, None
    record.update({
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "k1_k3_ms": sum(k_ms.values()), **{k + "_ms": v
                                            for k, v in k_ms.items()},
        "profiled_launches": k_launches,
        "k1_k3_share_of_busy": sum(k_ms.values()) / busy_ms,
        "top": [[key[:90], ms, n] for key, (ms, n) in top],
    })
    return state, record, counted, k_launches


def sparse_timing(torch, tier, sparse):
    """One step on a fresh batch (as the main run's: misses pulled and
    pushed, promotions staged) profiled (``profile_step``), each of
    K1-K3's profiled launches held against its launch counter over the
    step. A profiled launch more than counted fails at once. Fewer can
    be the profiler's loss: then another fresh step is profiled, up to
    len(sparse["profile_batches"]), and one must match. Returns the
    state after the steps."""
    state = sparse["state"]
    for attempt, batch in enumerate(sparse["profile_batches"]):
        state, record, counted, profiled = profile_step(
            torch, tier, sparse["trainer"], state, batch)
        log(json.dumps(dict(record, attempt=attempt)))
        if profiled is None or profiled == counted:
            return state
        if any(profiled[k] > counted[k] for k in counted):
            break
    raise SystemExit("the profiled K1-K3 launches %s are not the counted "
                     "ones %s" % (profiled, counted))


SPLIT_TOP = ("prepare", "combine", "step", "apply_extract", "push")


def _split_stages(trainer):
    """(stage, owner, attribute) of the trainer's own calls that
    ``sparse_host_split`` times: ``prepare`` (unique ids, tier lookup
    and admission, and the PS ``pull`` of the misses, shown on its own
    too), ``combine`` (the miss rows to the card, K1/K2), ``step``
    (forward, backward, dense update), ``apply_extract`` (``_fold``:
    the wait for the row gradients' host copy, K3, the push gradients
    copied out) and ``push`` (the PS optimizer step)."""
    return (("prepare", trainer.preparer, "prepare"),
            ("pull", trainer.preparer._embedding, "pull_tables"),
            ("combine", trainer, "_tier_combine"),
            ("step", trainer, "_train_step"),
            ("apply_extract", trainer, "_fold"),
            ("push", trainer.preparer, "push_gradients"))


def sparse_host_split(torch, runs, batches):
    """One step of each trainer of ``runs`` ({label: [trainer, state]})
    on each of ``batches`` (fresh ones), in turns (the order flips from
    batch to batch), timed stage by stage through the trainer's own
    calls (``_split_stages``; each wrapped with a timer that waits for
    the card at its end). Updates the states in ``runs``; logs and
    returns {label: record} with each stage's median over the steps
    and the steps' wall times."""
    import numpy as np

    steps = {label: [] for label in runs}  # label -> [{stage: ms}, ...]
    current = {}

    def timed(label, name, fn):
        def run(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            sync(torch, runs[label][0].device)
            stage = current[label]
            stage[name] = stage.get(name, 0.0) + (time.monotonic() - t0) * 1e3
            return out
        return run

    saved = []
    for label, (trainer, _) in runs.items():
        for name, owner, attr in _split_stages(trainer):
            saved.append((owner, attr, owner.__dict__.get(attr)))
            setattr(owner, attr, timed(label, name, getattr(owner, attr)))
    walls = {label: [] for label in runs}
    try:
        order = list(runs)
        for i, batch in enumerate(batches):
            for label in order if i % 2 == 0 else order[::-1]:
                trainer, state = runs[label]
                current[label] = {}
                sync(torch, trainer.device)
                t0 = time.monotonic()
                runs[label][1], _ = trainer.train_step(state, batch)
                sync(torch, trainer.device)
                walls[label].append((time.monotonic() - t0) * 1e3)
                steps[label].append(current[label])
    finally:
        for owner, attr, own in saved:
            if own is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)

    def median(values):
        return float(np.median(values))

    records = {}
    for label, per_step in steps.items():
        names = sorted({k for step in per_step for k in step})
        records[label] = {
            "profile": "sparse_host_split", "store": label,
            "steps": len(per_step),
            "wall_ms_median": median(walls[label]),
            "wall_ms": walls[label],
            "stage_ms_median": {k: median([step.get(k, 0.0)
                                           for step in per_step])
                                for k in names},
            "other_ms_median": median([
                wall - sum(step.get(k, 0.0) for k in SPLIT_TOP)
                for wall, step in zip(walls[label], per_step)]),
        }
        log(json.dumps(records[label]))
    return records


def store_splits(torch, sparse):
    """The host stage split for each store on this card, in one run:
    the main run's trainer (the native store) and a trainer on the numpy
    store that first replays the main run's steps and the repeated
    batch (the same id stream, so the same tier state), timed in turns
    over the same SPARSE_SPLIT_STEPS fresh batches (``sparse_host_split``).
    Updates ``sparse["state"]``; returns the records by store."""
    main = sparse["trainer"]
    numpy_trainer = sparse_trainer(main.device, sparse["batch"],
                                   sparse["fields"], tier=sparse["knobs"],
                                   numpy_store=True)
    state = None
    for batch in sparse["replay_batches"]:
        state, _ = numpy_trainer.train_step(state, batch)
    runs = {store_record(main)["store"]: [main, sparse["state"]],
            store_record(numpy_trainer)["store"]: [numpy_trainer, state]}
    records = sparse_host_split(torch, runs, sparse["split_batches"])
    sparse["state"] = runs[store_record(main)["store"]][1]
    numpy_trainer.close()
    return records


# phase 8, stream: bench.py's deepfm ladder (bench.py:83-180) through the
# port, against two PS processes of the port started with bench.py's
# flags (sync, grads_to_wait 1, the native store, adam lr 0.001)
STREAM_PS_FLAGS = ("--num_ps_pods", "2", "--opt_type", "adam",
                   "--opt_args", "lr=0.001")
STREAM_PUSH_INTERVAL = 2
STREAM_CACHE_STALENESS = 8
# rates over steps 11-110, as bench.py's warmup 10 + 100 steps
STREAM_WARMUP = 10
STREAM_PS_WAIT_S = 180
# train_stream(push_interval=1) against train_step on disjoint-id
# batches: both on the card, both over a gRPC PS pair, adam eps 1e-3 on
# the dense params and the PS (SPARSE_AGREE_EPS): they differ only in
# the card's summation order, so the losses agree to SPARSE_LOSS_RTOL
# and the touched PS rows to SPARSE_ROW_RTOL / SPARSE_ROW_ATOL
STREAM_AGREE_STEPS = 5
STREAM_AGREE_VOCAB = 4096  # ids of batch k lie in [k * V, (k + 1) * V)
# extra batches after the tier rung's timed steps: the profiled window
STREAM_PROFILE_STEPS = 2
STREAM_LADDER = ("sequential", "pipelined", "pipelined_tier")


def start_ps_pairs(n_pairs, logdir, started, extra=(), env=None):
    """``n_pairs`` pairs of ``python -m elasticdl_tpu_torch.ps.server``
    (ps_id 0 and 1 of 2) on free ports, all started together, each
    logging to its own file, in ``env`` (this process's environment by
    default). Each pair (procs, addrs, logs) goes into
    ``started`` as it starts, so the caller's finally stops
    (``stop_ps``) every process even if a later start fails; returns
    this call's pairs."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port

    os.makedirs(logdir, exist_ok=True)
    env = dict(os.environ if env is None else env, PYTHONPATH=HERE)
    pairs = []
    for pair in range(n_pairs):
        procs, addrs, logs = [], [], []
        pairs.append((procs, addrs, logs))
        started.append((procs, addrs, logs))
        for ps_id in range(2):
            port = find_free_port()
            log_path = os.path.join(logdir, "ps-%d-%d.log" % (pair, ps_id))
            procs.append(start_ps(ps_id, port, log_path, extra, env))
            addrs.append("localhost:%d" % port)
            logs.append(log_path)
    return pairs


def start_ps(ps_id, port, log_path, extra, env):
    """One ``python -m elasticdl_tpu_torch.ps.server`` (shard ``ps_id``
    of 2, STREAM_PS_FLAGS and ``extra``) logging to ``log_path``."""
    with open(log_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.ps.server",
             "--ps_id", str(ps_id), "--port", str(port), *STREAM_PS_FLAGS,
             *extra],
            cwd=HERE, env=env, stdout=out, stderr=subprocess.STDOUT)


def wait_ps_ready(pairs):
    """Wait until every PS logs that it serves (the line names its store
    and its mode); a PS that exits or does not come up in
    STREAM_PS_WAIT_S fails the phase. Returns each PS's serving line."""
    deadline = time.monotonic() + STREAM_PS_WAIT_S
    lines = []
    for procs, addrs, logs in pairs:
        for proc, addr, path in zip(procs, addrs, logs):
            want = "serving on :%s " % addr.rsplit(":", 1)[1]
            while True:
                with open(path) as f:
                    found = [ln for ln in f if want in ln]
                if found:
                    lines.append(found[0].strip())
                    break
                if proc.poll() is not None or time.monotonic() > deadline:
                    with open(path) as f:
                        tail = f.read()[-2000:]
                    raise SystemExit("PS %s did not come up (exit %s):\n%s"
                                     % (addr, proc.poll(), tail))
                time.sleep(0.1)
    return lines


def stop_ps(pairs):
    """SIGTERM every PS (the drain), wait; kill what does not exit."""
    procs = [p for ps, _, _ in pairs for p in ps]
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=20))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
    return codes


def stream_trainer(device, addrs, batch, fields, tier=None,
                   cache_staleness=0, eps=None):
    """bench.py's deepfm SparseTrainer over a PSClient of ``addrs``:
    deepfm.optimizer() (adam lr 0.001) on the dense params, the id
    capacity min(batch * fields, MAX_ID_CAPACITY), seed 0; ``tier`` a
    dict of DeviceTierConfig knobs or None; ``eps`` adam's epsilon on
    the dense params and the tier."""
    from elasticdl_tpu_torch.models import deepfm
    from elasticdl_tpu_torch.train.device_tier import DeviceTierConfig
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.sparse import SparseTrainer
    from elasticdl_tpu_torch.worker.ps_client import PSClient

    config = False
    if tier is not None:
        config = DeviceTierConfig(**tier)
    optimizer = (deepfm.optimizer() if eps is None else
                 create_optimizer("Adam", learning_rate=0.001, epsilon=eps))
    return SparseTrainer(
        model=deepfm.custom_model(),
        loss_fn=deepfm.loss,
        optimizer=optimizer,
        specs=deepfm.sparse_embedding_specs(
            num_features=fields, batch_size=batch,
            capacity=min(batch * fields, deepfm.MAX_ID_CAPACITY)),
        ps_client=PSClient(addrs),
        seed=SEED,
        cache_staleness=cache_staleness,
        device_tier=config,
        device=device,
    )


def disjoint_batches(np, n, batch, fields, vocab=STREAM_AGREE_VOCAB,
                     seed=SEED):
    """Batch k draws ids from [k * vocab, (k + 1) * vocab): consecutive
    batches share no row, so one push of staleness changes no value."""
    rng = np.random.RandomState(seed)
    return [{
        "features": {"ids": (k * vocab + rng.randint(
            0, vocab, size=(batch, fields))).astype(np.int64)},
        "labels": rng.randint(0, 2, batch).astype(np.float32),
        "_mask": np.ones(batch, np.float32),
    } for k in range(n)]


def stream_agreement(torch, np, device, pairs, batch, fields):
    """train_stream(push_interval=1) on the card against train_step on
    the card, each over its own fresh gRPC PS pair, on disjoint-id
    batches: the losses within SPARSE_LOSS_RTOL, the touched PS rows
    (pulled back over gRPC) within SPARSE_ROW_RTOL / SPARSE_ROW_ATOL."""
    batches = disjoint_batches(np, STREAM_AGREE_STEPS, batch, fields)
    touched = np.unique(np.concatenate(
        [b["features"]["ids"].ravel() for b in batches]))
    runs = {}
    for mode, (_, addrs, _) in zip(("train_step", "train_stream"), pairs):
        trainer = stream_trainer(device, addrs, batch, fields,
                                 eps=SPARSE_AGREE_EPS)
        state, losses = None, []
        if mode == "train_step":
            for b in batches:
                state, loss = trainer.train_step(state, b)
                losses.append(loss)
        else:
            for state, loss, _ in trainer.train_stream(None, batches,
                                                       push_interval=1):
                losses.append(loss)
        trainer.close()
        client = trainer.preparer._ps
        runs[mode] = {
            "losses": [float(x) for x in losses],
            "rows": client.pull_embedding_batch(
                {"deepfm_emb": touched, "deepfm_linear": touched}),
            "rejections": trainer.push_rejections,
        }
        client.close()
        del trainer, state
    step, stream = runs["train_step"], runs["train_stream"]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(stream["losses"], step["losses"]))
    row_err, rows_ok = 0.0, True
    for table, want in step["rows"].items():
        got = stream["rows"][table]
        diff = np.abs(got.astype(np.float64) - want)
        row_err = max(row_err, float(diff.max()))
        rows_ok = rows_ok and bool(
            (diff <= SPARSE_ROW_ATOL + SPARSE_ROW_RTOL * np.abs(want)).all())
    record = {"stream": "train_stream_vs_train_step", "device": str(device),
              "steps": STREAM_AGREE_STEPS, "push_interval": 1,
              "losses_train_step": step["losses"],
              "losses_train_stream": stream["losses"],
              "loss_rel_err": loss_err, "tol_loss_rel": SPARSE_LOSS_RTOL,
              "rows": int(touched.size), "row_max_abs_err": row_err,
              "tol_row_rel": SPARSE_ROW_RTOL, "tol_row_abs": SPARSE_ROW_ATOL,
              "adam_eps": SPARSE_AGREE_EPS,
              "rejections": [step["rejections"], stream["rejections"]]}
    log(json.dumps(record))
    if not (loss_err <= SPARSE_LOSS_RTOL and rows_ok
            and record["rejections"] == [0, 0]):
        raise SystemExit("train_stream disagrees with train_step over the "
                         "gRPC PS")
    return record


def stream_window_profile(torch, trace_path, run_window):
    """Profile ``run_window()`` (one pipelined tier step, from a yield
    to the next step's end) with CUDA activity only: wall time, device
    busy time and the idle share, and the gaps between consecutive tier
    kernels of one chunk's chain (K1 victims -> K2 -> K1 combined; a
    negative gap is a launch that started before its predecessor
    ended). The session opens with ``profiler_warmup``, which the
    times leave out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_warmup(torch)
        t0 = time.monotonic()
        run_window()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    busy_ms = 0.0
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA
                and PROFILER_WARMUP_NAME not in evt.key):
            total_us = getattr(evt, "device_time_total", None)
            busy_ms += (evt.cuda_time_total if total_us is None
                        else total_us) / 1e3
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    names = {TIER_PROFILE_PREFIX["k1"]: "K1", TIER_PROFILE_PREFIX["k2"]: "K2"}
    kernels = sorted(
        ((float(e["ts"]), float(e["dur"]), label) for e in events
         if e.get("ph") == "X" for prefix, label in names.items()
         if str(e.get("name", "")).startswith(prefix)),
        key=lambda k: k[0])
    gaps = {"K1->K2": [], "K2->K1": []}
    for (ts0, dur0, a), (ts1, _, b) in zip(kernels, kernels[1:]):
        key = "%s->%s" % (a, b)
        if key in gaps:
            gaps[key].append((ts1 - (ts0 + dur0)) / 1e3)
    record = {"profile": "pipelined_tier_step", "wall_ms": wall_ms,
              "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
              "tier_kernels": [label for _, _, label in kernels],
              "chain_gaps_ms": gaps,
              "chain_launches_overlap": (any(g < 0 for v in gaps.values()
                                             for g in v)
                                         if any(gaps.values()) else
                                         "no chain in the window")}
    if busy_ms > 0:
        record["idle_share"] = max(0.0, 1.0 - busy_ms / wall_ms)
    return record


def stream_rung(torch, np, tier, name, trainer, batches, profile_path=None,
                instrument=True):
    """One rung of the ladder: ``sequential`` (train_step) or a
    pipelined one (train_stream, push_interval 2). Steps/s and
    examples/s over steps 11-110 (a sync at the 10th step's loss and at
    the 110th's) and every loss. With ``instrument`` also Timing's
    medians over the same steps (Timing syncs the card at every step),
    each wrapped call's own time, on the tier rung the K1-K3 launches
    per step against sparse_phase's formula (counted from 0 at the
    rung's start) and, over the extra batches after step 110, one
    profiled pipelined step; without it the trainer runs as bench.py
    runs it (EDL_TIMING unset, nothing wrapped), for the rates."""
    from elasticdl_tpu_torch.common.timing_utils import Timing

    trainer.timing = Timing(enabled=instrument)
    steps = len(batches) - (STREAM_PROFILE_STEPS if profile_path else 0)
    dtier = trainer.device_tier
    losses, bad_steps, record = [], [], {}
    # each call's own wall time on whatever thread runs it: the
    # preparer's prepare (the lookahead thread under train_stream), the
    # pull inside it (the HotRowCache's split and put, one per table,
    # inside that) and the PS push RPC (the push thread)
    calls_ms = {"prepare": [], "pull": [], "push_rpc": [], "cache_split": [],
                "cache_put": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            calls_ms[name].append((time.monotonic() - t0) * 1e3)
            return out
        return run

    preparer = trainer.preparer
    if instrument:
        preparer.prepare = timed("prepare", preparer.prepare)
        preparer._embedding.pull_tables = timed(
            "pull", preparer._embedding.pull_tables)
        preparer._ps.push_gradients = timed("push_rpc",
                                            preparer._ps.push_gradients)
        if preparer.cache is not None:
            preparer.cache.split = timed("cache_split", preparer.cache.split)
            preparer.cache.put = timed("cache_put", preparer.cache.put)
    reset_tier_launches(tier)
    before, stats0 = tier_counts(tier), dtier.stats() if dtier else None
    marks = {}

    def on_step(i, loss):
        nonlocal before, stats0
        losses.append(loss)
        if i + 1 == STREAM_WARMUP:
            float(loss)
            if instrument:
                trainer.timing.report("%s warmup" % name)  # logs and resets
            for values in calls_ms.values():
                values.clear()
            marks["t0"] = time.monotonic()
        if i + 1 == steps:
            float(loss)
            marks["t1"] = time.monotonic()
            marks["timing"] = trainer.timing.summary()
            marks["calls"] = {k: (float(np.median(v)), len(v))
                              for k, v in calls_ms.items() if v}
        if dtier is None or i >= steps or not instrument:
            return
        # per window (the previous yield to this one): K3 twice for the
        # previous step's fold, then K1/K2 as this step's combine
        # requires
        counts, stats1 = tier_counts(tier), dtier.stats()
        d_k1, d_k2, d_k3 = (a - c for a, c in zip(counts, before))
        gather_only, chunks, inserts, evicts = (
            stats1[k] - stats0[k]
            for k in ("gather_only_combines", "staged_chunks",
                      "insert_chunks", "evict_chunks"))
        want = (gather_only + chunks + evicts, inserts, 2 if i else 0)
        if (d_k1, d_k2, d_k3) != want:
            bad_steps.append([i, [d_k1, d_k2, d_k3], list(want)])
        before, stats0 = counts, stats1

    if name == "sequential":
        state = None
        for i, b in enumerate(batches):
            state, loss = trainer.train_step(state, b)
            on_step(i, loss)
    else:
        stream = trainer.train_stream(None, batches,
                                      push_interval=STREAM_PUSH_INTERVAL)
        for i, (state, loss, _) in enumerate(stream):
            on_step(i, loss)
            if profile_path and i == steps:
                # the window from this yield to the end of the next step
                record["profile"] = stream_window_profile(
                    torch, profile_path,
                    lambda: float(next(stream)[1]))
                losses.append(None)  # consumed inside the window
                break
        for state, loss, _ in stream:  # nothing left: runs the teardown
            losses.append(loss)
    launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                        tier_counts(tier)))
    sync(torch, trainer.device)
    elapsed = marks["t1"] - marks["t0"]
    timed = steps - STREAM_WARMUP
    host_losses = [float(x) for x in losses if x is not None]
    record.update({
        "stream": "rung", "rung": name, "instrumented": instrument,
        "steps": steps, "timed_steps": timed,
        "batch": len(batches[0]["labels"]),
        "steps_per_s": timed / elapsed,
        "examples_per_s": timed * len(batches[0]["labels"]) / elapsed,
        "losses_first_last": [host_losses[0], host_losses[-1]],
        "all_finite": bool(np.isfinite(host_losses).all()),
        "push_rejections": trainer.push_rejections,
        "cache_hit_rate": (trainer.preparer.cache.hit_rate()
                           if trainer.preparer.cache else None),
    })
    if instrument:
        record.update({
            "timing_medians_ms": {k: v["median_ms"]
                                  for k, v in marks["timing"].items()},
            "timing_counts": {k: v["count"]
                              for k, v in marks["timing"].items()},
            # medians of each call's own wall time over the timed steps
            "call_ms_median": {k: v[0] for k, v in marks["calls"].items()},
            "call_counts": {k: v[1] for k, v in marks["calls"].items()},
        })
    if dtier is not None and instrument:
        record.update({"launches": launches,
                       # every batch driven, the profiled ones too
                       "launches_per_step": {k: v / len(batches)
                                             for k, v in launches.items()},
                       "launch_formula_mismatches": bad_steps[:5],
                       "tier_stats": dtier.stats()})
    return record


def stream_phase(torch, np, tier, device="cuda", batch=SPARSE_BATCH,
                 fields=SPARSE_FIELDS, vocab=SPARSE_VOCAB, steps=SPARSE_STEPS,
                 tier_knobs=None):
    """Phase 8: bench.py's deepfm ladder on this card through the port,
    against fresh pairs of the port's PS processes (bench.py's flags):
    sequential train_step (no cache, no tier), train_stream with
    push_interval 2 and cache_staleness 8, and the same with the tier.
    Each rung runs twice, each time on its own fresh PS pair: a plain
    pass as bench.py runs it (the rates) and an instrumented pass
    (Timing, the wrapped calls, the launch formula, the profiled step).
    Checks (each printed; a failure raises SystemExit): every PS serves
    from the native store in sync mode; every loss finite; no push
    rejected; the tier rung's K1-K3 launches per step follow the
    formula; after close() every resident tier row equals its row
    pulled back over gRPC; train_stream(push_interval=1) agrees with
    train_step on disjoint ids. Returns the rung records (the plain
    pass's, with the instrumented one under ``instrumented``) and the
    instrumented tier rung's launches."""
    knobs = dict(SPARSE_TIER if tier_knobs is None else tier_knobs)
    device = torch.device(device)
    batches = ctr_batches(np, steps + STREAM_PROFILE_STEPS, batch, fields,
                          vocab)
    logdir = os.path.join(HERE, "build", "chip_smoke_ps")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.monotonic()
    started = []
    try:
        # two passes of three rungs, then train_step and train_stream for
        # the agreement
        pairs = start_ps_pairs(2 * len(STREAM_LADDER), logdir, started)
        agree_pairs = start_ps_pairs(
            2, os.path.join(logdir, "agree"), started,
            extra=("--opt_args", "lr=0.001;epsilon=%g" % SPARSE_AGREE_EPS))
        lines = wait_ps_ready(pairs + agree_pairs)
        log(json.dumps({"stream": "ps_ready", "processes": len(lines),
                        "seconds": time.monotonic() - t0,
                        "flags": list(STREAM_PS_FLAGS), "lines": lines[:2]}))
        if not all("(NativeEmbeddingStore store, sync, grads_to_wait 1)"
                   in ln for ln in lines):
            raise SystemExit("a PS does not serve the native store in sync "
                             "mode: %s" % lines)
        agreement = stream_agreement(torch, np, device, agree_pairs, batch,
                                     fields)
        records = {}
        passes = [(name, instrument) for name in STREAM_LADDER
                  for instrument in (False, True)]
        for (name, instrument), (_, addrs, _) in zip(passes, pairs):
            trainer = stream_trainer(
                device, addrs, batch, fields,
                tier=knobs if name == "pipelined_tier" else None,
                cache_staleness=(0 if name == "sequential"
                                 else STREAM_CACHE_STALENESS))
            profile_path = (os.path.join(HERE, "build", "stream_trace.json")
                            if name == "pipelined_tier" and instrument
                            and device.type == "cuda" else None)
            record = stream_rung(
                torch, np, tier, name, trainer,
                batches if profile_path else batches[:steps], profile_path,
                instrument=instrument)
            trainer.close()  # the tier's final writeback, before the PS go
            client = trainer.preparer._ps
            if trainer.device_tier is not None:
                parity, resident = True, {}
                for table in ("deepfm_emb", "deepfm_linear"):
                    ids, rows = trainer.device_tier.table_rows(table)
                    resident[table] = int(ids.size)
                    pulled = client.pull_embedding_batch({table: ids})
                    parity = parity and ids.size > 0 and np.array_equal(
                        rows, pulled[table])
                record["flush_parity"] = {"bit_exact": parity,
                                          "resident": resident}
            client.close()
            log(json.dumps(record))
            if instrument:
                records[name]["instrumented"] = record
            else:
                records[name] = record
            del trainer
            if not record["all_finite"]:
                raise SystemExit("%s: a loss is not finite" % name)
            if record["push_rejections"]:
                raise SystemExit("%s: a push was rejected" % name)
            if name == "pipelined_tier":
                if instrument and (record["launch_formula_mismatches"]
                                   or min(record["launches"].values()) <= 0):
                    raise SystemExit("stream K1-K3 launches do not follow "
                                     "the path: %s"
                                     % record["launch_formula_mismatches"])
                if not record["flush_parity"]["bit_exact"]:
                    raise SystemExit("a resident tier row differs from its "
                                     "row on the PS after close()")
    finally:
        codes = stop_ps(started)
    order = sorted(STREAM_LADDER, key=lambda n: -records[n]["steps_per_s"])
    log(json.dumps({"stream": "ladder",
                    "steps_per_s": {n: records[n]["steps_per_s"]
                                    for n in STREAM_LADDER},
                    "steps_per_s_instrumented": {
                        n: records[n]["instrumented"]["steps_per_s"]
                        for n in STREAM_LADDER},
                    "order_fastest_first": order,
                    "bench_order": list(STREAM_LADDER[::-1]),
                    "ps_exit_codes": codes}))
    if any(codes):
        raise SystemExit("a PS did not exit 0 on SIGTERM: %s" % codes)
    tier_rung = records["pipelined_tier"]["instrumented"]
    return {"records": records, "agreement": agreement,
            "launches": tier_rung["launches"], "steps": tier_rung["steps"]}


# phase 9, job: the elastic DeepFM job through the port's own master,
# worker and master-aware PS, at bench.py's deepfm configuration (39
# fields, batch 512, ids Zipf(1.2) % 1e6, adam lr 0.001 on the dense
# params, the PS and the tier, the tier on): 24 tasks of 8192 records
# (16 steps of 512), one epoch, and one worker killed mid-job
JOB_FILES = 4
JOB_RECORDS = 196_608          # 24 tasks of JOB_PER_TASK
JOB_VALID = 16_384
JOB_PER_TASK = 8192
JOB_TASK_TIMEOUT_S = 10.0      # the master's liveness timeout
JOB_REPORT_VERSION_STEPS = 16
# the step-based evaluation trigger: worker 0 reports its version every
# 16 steps and takes about 360 of the 384 steps, so passes run at its
# versions 160 and 320; the last is the job's final evaluation
JOB_EVAL_STEPS = 160
JOB_AUC_FLOOR = 0.70
# the planted signal's weights, fixed and independent of every file's
# seed (tests/test_utils.py create_ctr_recordio plants the same kind)
JOB_SIGNAL_SEED = 12345
JOB_PS_GONE_WAIT_S = 30
JOB_WAIT_S = 300
# both workers' tier and id capacity: phase 7's knobs, by environment
# as a user sets them for worker processes
JOB_WORKER_ENV = {
    "EDL_DEVICE_TIER": "1",
    "EDL_DEVICE_TIER_ROWS": str(SPARSE_TIER["capacity"]),
    "EDL_DEVICE_TIER_PROMOTE": str(SPARSE_TIER["promote_hits"]),
    "EDL_DEVICE_TIER_TTL": str(SPARSE_TIER["ttl"]),
    "EDL_DEVICE_TIER_STAGE": str(SPARSE_TIER["stage_budget"]),
    "EDL_DEVICE_TIER_OPT": SPARSE_TIER["opt_type"],
    "EDL_DEVICE_TIER_OPT_ARGS": "lr=%g" % SPARSE_TIER["opt_args"]["lr"],
    "EDL_DEVICE_TIER_WRITEBACK": str(SPARSE_TIER["writeback_steps"]),
    "EDL_SPARSE_ID_CAPACITY": "8192",
}


def job_data(np, workdir, records=JOB_RECORDS, valid=JOB_VALID,
             files=JOB_FILES, fields=SPARSE_FIELDS, vocab=SPARSE_VOCAB):
    """Training files (``files`` shards) and one validation file of
    DeepFM Examples: ids Zipf(1.2) % vocab over ``fields`` fields, the
    label a planted linear signal, label = 1 if sum(w[ids]) / sqrt(F)
    + 0.1 * noise > 0 with w ~ 2 N(0, 1) drawn from JOB_SIGNAL_SEED.
    Each file draws from its own numpy seed. Returns the two
    directories."""
    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.data.example import encode_example

    t0 = time.monotonic()
    weights = np.random.RandomState(JOB_SIGNAL_SEED).randn(vocab) * 2
    dirs = (os.path.join(workdir, "train"), os.path.join(workdir, "valid"))
    plan = [(dirs[0], k, records // files) for k in range(files)]
    plan.append((dirs[1], files, valid))
    for directory, k, n in plan:
        os.makedirs(directory, exist_ok=True)
        rng = np.random.RandomState(SEED + 1 + k)
        ids = (rng.zipf(1.2, size=(n, fields)) % vocab).astype(np.int64)
        score = weights[ids].sum(axis=1) / np.sqrt(fields)
        labels = (score + 0.1 * rng.randn(n) > 0).astype(np.int64)
        recordio.write_records(
            os.path.join(directory, "part-%d.rec" % k),
            [encode_example({"ids": row, "label": label})
             for row, label in zip(ids, labels)])
    log(json.dumps({"job": "data", "records": records, "valid": valid,
                    "seconds": time.monotonic() - t0}))
    return dirs


def count_worker_steps(tier, trainer, tables=2):
    """Instrument an in-process worker's ``trainer`` (device tier on):
    each train step's host time, loss, prepare time (its PS pull
    inside), whether it evicted, and its end on the host clock; each
    step's K1-K3 launches held against phase 7's formula, with one more
    K1 for each host read of resident rows (``_read_rows``: the periodic
    writeback every 256 tier steps, the PS-restart flush); the push
    RPC's own time and the loop's gap between steps. Returns the dict
    the wrappers fill: ``steps`` [(s, loss, prepare ms, evicted, end)],
    ``bad_steps`` [[step, launches, formula]], ``gaps``, ``calls_ms``,
    ``reads`` (a one-element count) and ``launches`` (each step's [K1,
    K2, K3]). ``tables``: the host-PS tables, one K3 each a step."""
    dtier = trainer.device_tier
    rec = {"steps": [], "bad_steps": [], "gaps": [], "launches": [],
           "calls_ms": {"prepare": [], "push_rpc": []}, "reads": [0]}
    calls_ms, reads = rec["calls_ms"], rec["reads"]

    def timed(name, fn):
        def run(*args, **kwargs):
            c0 = time.monotonic()
            out = fn(*args, **kwargs)
            calls_ms[name].append((time.monotonic() - c0) * 1e3)
            return out
        return run

    def counted_read(fn):
        def run(*args):
            reads[0] += 1
            return fn(*args)
        return run

    trainer.preparer.prepare = timed("prepare", trainer.preparer.prepare)
    trainer.preparer._ps.push_gradients = timed(
        "push_rpc", trainer.preparer._ps.push_gradients)
    dtier._read_rows = counted_read(dtier._read_rows)
    train_step, last_end = trainer.train_step, [None]

    def counted_step(state, b):
        before, stats0 = tier_counts(tier), dtier.stats()
        reads0, prepares0 = reads[0], len(calls_ms["prepare"])
        s0 = time.monotonic()
        if last_end[0] is not None:
            # the worker loop between steps: the next batch, the record
            # report, the version report
            rec["gaps"].append(s0 - last_end[0])
        state, loss = train_step(state, b)
        last_end[0] = time.monotonic()
        stats1 = dtier.stats()
        rec["steps"].append((last_end[0] - s0, float(loss),
                             sum(calls_ms["prepare"][prepares0:]),
                             stats1["evict_chunks"] > stats0["evict_chunks"],
                             last_end[0]))
        d_k1, d_k2, d_k3 = (a - c for a, c in zip(tier_counts(tier), before))
        gather_only, chunks, inserts, evicts = (
            stats1[k] - stats0[k]
            for k in ("gather_only_combines", "staged_chunks",
                      "insert_chunks", "evict_chunks"))
        want = (gather_only + chunks + evicts + reads[0] - reads0, inserts,
                tables)
        rec["launches"].append([d_k1, d_k2, d_k3])
        if (d_k1, d_k2, d_k3) != want:
            rec["bad_steps"].append([len(rec["steps"]) - 1,
                                     [d_k1, d_k2, d_k3], list(want)])
        return state, loss

    trainer.train_step = counted_step
    return rec


JOB_DATA_CHILD = "import numpy, chip_smoke; chip_smoke.job_data(numpy, %r)"


def job_phase(torch, np, tier, workdir, device="cuda", records=JOB_RECORDS,
              valid=JOB_VALID, per_task=JOB_PER_TASK, batch=SPARSE_BATCH,
              fields=SPARSE_FIELDS, eval_steps=JOB_EVAL_STEPS,
              report_version_steps=JOB_REPORT_VERSION_STEPS,
              task_timeout_s=JOB_TASK_TIMEOUT_S, worker_env=None,
              data_written=False):
    """Phase 9: DeepFM as an elastic job over the files ``job_data``
    writes under ``workdir`` (already there with ``data_written``: the
    script writes them in a child process during the build). The
    port's master in this
    process (``Master``, ``prepare``, ``run`` on a thread); two PS
    processes (``python -m elasticdl_tpu_torch.ps.server``, phase 8's
    flags, async, ``--master_addr``); worker 1 as ``python -m
    elasticdl_tpu_torch.worker.main``; worker 0 a ``Worker`` in this
    process, whose K1-K3 launches are counted. Both workers run the
    sequential loop with the tier on. Once worker 1 has reported a task
    and holds another it is SIGKILLed. Checks (each printed; a failure
    raises SystemExit): the master's run returns 0 and the job did not
    fail; at least one task was recovered from worker 1; the done
    training records add up to the dataset; worker 0's K1-K3 launches
    follow phase 7's per-step formula in every step; the final
    evaluation's AUC is at least JOB_AUC_FLOOR; both PS exit 0 on their
    own within JOB_PS_GONE_WAIT_S of the master's stop."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    device = torch.device(device)
    worker_env = dict(JOB_WORKER_ENV if worker_env is None else worker_env)
    if data_written:
        train_dir, valid_dir = (os.path.join(workdir, "train"),
                                os.path.join(workdir, "valid"))
    else:
        train_dir, valid_dir = job_data(np, workdir, records, valid,
                                        fields=fields)
    master = Master(zoo, training_data=train_dir, validation_data=valid_dir,
                    records_per_task=per_task, num_epochs=1,
                    port=find_free_port(), eval_steps=eval_steps,
                    task_timeout_secs=task_timeout_s, seed=SEED)
    dispatcher = master.task_dispatcher
    addr = "localhost:%d" % master._port
    # the dispatcher's view, recorded as the servicer drives it: the
    # training ranges done (with their worker), worker 1's recovery
    done, recovered, first = [], [], {}
    report, recover, get = (dispatcher.report, dispatcher.recover_tasks,
                            dispatcher.get)

    def on_report(task_id, success, worker_id=None, count_failure=True):
        doing = dispatcher.doing_tasks().get(task_id)
        ok, task = report(task_id, success, worker_id=worker_id,
                          count_failure=count_failure)
        if (success and task is not None and doing is not None
                and doing[0] == worker_id and task.type == pb.TRAINING):
            done.append((worker_id, task.shard_name, task.start, task.end,
                         time.monotonic()))
        return ok, task

    def on_recover(worker_id):
        held = [t for t, (w, _) in dispatcher.doing_tasks().items()
                if w == worker_id]
        if held:
            recovered.append((worker_id, held, time.monotonic()))
        recover(worker_id)

    def on_get(worker_id, task_type=None):
        task = get(worker_id, task_type)
        if task is not None:
            first.setdefault("dispatch", time.monotonic())
        return task

    dispatcher.report, dispatcher.recover_tasks = on_report, on_recover
    dispatcher.get = on_get
    logdir = os.path.join(HERE, "build", "chip_smoke_job")
    shutil.rmtree(logdir, ignore_errors=True)
    os.makedirs(logdir)
    env = dict(os.environ, PYTHONPATH=HERE, EDL_PS_MASTER_GONE_SECS="2")
    saved_env = {k: os.environ.get(k) for k in worker_env}
    started, result, ps_codes = [], {}, []
    runner = worker1 = None
    try:
        job_t0 = time.monotonic()
        master.prepare()
        master_thread = threading.Thread(
            target=lambda: result.setdefault("rc", master.run(poll_secs=0.5)),
            daemon=True)
        master_thread.start()
        # PS and worker 1 start together; worker 1's PS client retries
        # until its shards serve
        (procs, ps_addrs, ps_logs), = start_ps_pairs(
            1, logdir, started, extra=("--use_async", "1", "--master_addr",
                                       addr), env=env)
        w1_log = os.path.join(logdir, "worker-1.log")
        with open(w1_log, "w") as out:
            worker1 = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.worker.main",
                 "--model_zoo", zoo, "--training_data", train_dir,
                 "--minibatch_size", str(batch), "--master_addr", addr,
                 "--worker_id", "1", "--ps_addrs", ",".join(ps_addrs),
                 "--report_version_steps", str(report_version_steps),
                 "--device", device.type],
                cwd=HERE, env=dict(env, **worker_env), stdout=out,
                stderr=subprocess.STDOUT)
        lines = wait_ps_ready([(procs, ps_addrs, ps_logs)])
        log(json.dumps({"job": "ps_ready", "lines": lines,
                        "seconds": time.monotonic() - job_t0}))
        if not all("(NativeEmbeddingStore store, async)" in ln
                   for ln in lines):
            raise SystemExit("a job PS does not serve the native store "
                             "async: %s" % lines)

        def holds(worker_id):
            return any(w == worker_id
                       for w, _ in dispatcher.doing_tasks().values())

        deadline = time.monotonic() + JOB_WAIT_S
        while not holds(1):
            if worker1.poll() is not None or time.monotonic() > deadline:
                with open(w1_log) as f:
                    raise SystemExit("worker 1 took no task (exit %s):\n%s"
                                     % (worker1.poll(), f.read()[-3000:]))
            time.sleep(0.05)
        w1_first_task_s = time.monotonic() - job_t0
        # worker 0, in this process: its tier's launches are counted
        os.environ.update(worker_env)
        client = MasterClient(addr, worker_id=0)
        client.reset_worker()
        worker0 = Worker(client, zoo, RecordIODataReader(data_dir=train_dir),
                         minibatch_size=batch,
                         report_version_steps=report_version_steps,
                         wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                         device=device)
        trainer = worker0.trainer
        dtier = trainer.device_tier
        if dtier is None:
            raise SystemExit("worker 0 runs without the device tier")
        counts = count_worker_steps(tier, trainer)
        steps, bad_steps, gaps = (counts["steps"], counts["bad_steps"],
                                  counts["gaps"])
        calls_ms, reads = counts["calls_ms"], counts["reads"]
        reset_tier_launches(tier)  # the job's count starts here
        runner = threading.Thread(target=worker0.run, daemon=True)
        runner.start()
        kill_t = None
        while kill_t is None:
            if any(w == 1 for w, *_ in done) and holds(1):
                worker1.kill()
                kill_t = time.monotonic()
            elif (worker1.poll() is not None
                  or time.monotonic() > deadline or not runner.is_alive()):
                with open(w1_log) as f:
                    raise SystemExit(
                        "worker 1 never held a task after reporting one "
                        "(exit %s):\n%s" % (worker1.poll(),
                                            f.read()[-3000:]))
            time.sleep(0.02)
        held_at_kill = [t for t, (w, _) in dispatcher.doing_tasks().items()
                        if w == 1]
        worker1_rc = worker1.wait(timeout=30)
        master_thread.join(timeout=JOB_WAIT_S)
        if master_thread.is_alive():
            raise SystemExit("the job did not finish in %d s" % JOB_WAIT_S)
        stopped_t = time.monotonic()
        job_s = stopped_t - job_t0
        runner.join(timeout=60)
        launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                            tier_counts(tier)))
        for proc in procs:
            try:
                ps_codes.append(proc.wait(
                    timeout=max(0.0, stopped_t + JOB_PS_GONE_WAIT_S
                                - time.monotonic())))
            except subprocess.TimeoutExpired:
                ps_codes.append(None)
        ps_exit_s = time.monotonic() - stopped_t
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        if worker1 is not None and worker1.poll() is None:
            worker1.kill()
            worker1.wait()
        for procs_, _, _ in started:
            for proc in procs_:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        master.stop()
    summaries = master.evaluation_service.completed_summaries
    done_records = sum(end - start for _, _, start, end, _ in done)
    by_worker = {w: sum(1 for d in done if d[0] == w) for w in (0, 1)}
    recovered_w1 = [r for r in recovered if r[0] == 1]
    kill_to_requeue = (recovered_w1[0][2] - kill_t if recovered_w1
                       else None)
    train_window = (max(d[4] for d in done) - first["dispatch"]
                    if done else None)
    warm = [s[0] for s in steps[10:]] or [s[0] for s in steps]
    losses = [s[1] for s in steps]
    # the step and its prepare, split by whether the step's staging
    # chunks evicted (a full tier writes the victims back to the PS, and
    # a later prepare whose misses include them waits for that)
    split = {}
    for evicting in (False, True):
        chosen = [s for s in steps[10:] if s[3] == evicting]
        split["evicting" if evicting else "not_evicting"] = {
            "steps": len(chosen),
            "step_ms_median": (float(np.median([c[0] for c in chosen]))
                               * 1e3 if chosen else None),
            "prepare_ms_median": (float(np.median([c[2] for c in chosen]))
                                  if chosen else None)}
    final = summaries[-1] if summaries else (None, {})
    record = {
        "job": "result", "master_rc": result.get("rc"),
        "job_failed": dispatcher.job_failed(),
        "job_wall_s": job_s,
        "examples_per_s_job": records / job_s,
        "examples_per_s_training_window": (records / train_window
                                           if train_window else None),
        "training_window_s": train_window,
        "worker1_first_task_s": w1_first_task_s,
        "kill_to_requeue_s": kill_to_requeue,
        "task_timeout_s": task_timeout_s,
        "worker1_rc": worker1_rc, "worker1_held_at_kill": held_at_kill,
        "recovered_from_worker1": [r[1] for r in recovered_w1],
        "tasks_done_by_worker": by_worker,
        "done_training_records": done_records, "dataset_records": records,
        "worker0_steps": len(steps), "worker0_version": worker0.model_version,
        "worker0_steps_per_s": len(warm) / sum(warm) if warm else None,
        "worker0_examples_per_s": (batch * len(warm) / sum(warm)
                                   if warm else None),
        "worker0_step_ms_host_median": (float(np.median(warm)) * 1e3
                                        if warm else None),
        "worker0_losses_first_last": ([losses[0], losses[-1]] if losses
                                      else None),
        # medians: the prepare (PS pull inside) and the push RPC of a
        # train step, and the loop's gap between two steps
        "worker0_call_ms_median": {k: float(np.median(v))
                                   for k, v in calls_ms.items() if v},
        "worker0_gap_ms_median": (float(np.median(gaps)) * 1e3 if gaps
                                  else None),
        "worker0_split_by_eviction": split,
        "worker0_row_reads": reads[0],
        "all_finite": bool(np.isfinite(losses).all()) if losses else False,
        "launches": launches,
        "launches_per_step": {k: v / max(len(steps), 1)
                              for k, v in launches.items()},
        "launch_formula_mismatches": bad_steps[:5],
        "tier_stats": dtier.stats(),
        "evaluations": [[v, s] for v, s in summaries],
        "final_auc": final[1].get("auc"), "auc_floor": JOB_AUC_FLOOR,
        "ps_exit_codes": ps_codes, "ps_exit_after_master_s": ps_exit_s,
    }
    log(json.dumps(record))
    failures = []
    if result.get("rc") != 0 or dispatcher.job_failed():
        failures.append("master rc %s, job failed %s" % (
            result.get("rc"), dispatcher.job_failed()))
    if worker1_rc != -9:
        failures.append("worker 1 exited %s, not by SIGKILL" % worker1_rc)
    if not recovered_w1:
        failures.append("no task was recovered from worker 1")
    if done_records != records:
        failures.append("done training records %d != %d"
                        % (done_records, records))
    if not record["all_finite"] or runner.is_alive():
        failures.append("worker 0: losses finite %s, still running %s"
                        % (record["all_finite"], runner.is_alive()))
    if bad_steps or min(launches.values()) <= 0:
        failures.append("worker 0's K1-K3 launches do not follow the "
                        "path: %s" % bad_steps[:5])
    if final[1].get("auc") is None or not final[1]["auc"] >= JOB_AUC_FLOOR:
        failures.append("final AUC %s < %s" % (final[1].get("auc"),
                                                JOB_AUC_FLOOR))
    if ps_codes != [0, 0] or ps_exit_s > JOB_PS_GONE_WAIT_S:
        failures.append("PS exit codes %s after %.1f s" % (ps_codes,
                                                           ps_exit_s))
    if failures:
        raise SystemExit("job phase: " + "; ".join(failures))
    record.pop("tier_stats")
    return record


# phase 10: phase 9's job over two of its four training files (12 tasks,
# 192 steps of 512 for worker 0 alone), both PS checkpointing into one
# directory every RESTART_CKPT_STEPS versions (the reference's pod
# manager hands every PS of a job the same --checkpoint_dir); PS 1 is
# SIGKILLed once the newest complete chain holds a full base and
# RESTART_MIN_DELTAS deltas and PS 1 is RESTART_MIN_LOST versions past it
RESTART_FILES = 2
RESTART_CKPT_STEPS = 16
RESTART_MIN_DELTAS = 2
RESTART_MIN_LOST = 10
RESTART_WARMUP = 10
_SAVE_RE = re.compile(r"checkpoint (\S+) at version (\d+): (full|delta), "
                      r"(\d+) rows, (\d+) tombstones, chain (\d+), "
                      r"([0-9.]+) s")
_RESTORE_RE = re.compile(r"PS (\d+) auto-restored checkpoint version (\d+) "
                         r"\((\d+) rows, ([0-9.]+) s\)")
_EXIT_RE = re.compile(r"exiting at store version (\d+)")
_SAVED_PATH_RE = re.compile(r"Saved sparse checkpoint (\S+) \(")


def newest_chain(saver_cls, ckpt_dir):
    """(base version, complete deltas, effective version) of the newest
    complete checkpoint chain in ``ckpt_dir``, or None."""
    effective = saver_cls.latest_version(ckpt_dir)
    if effective is None:
        return None
    saver = saver_cls(ckpt_dir)
    for base in sorted((int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                        if d.startswith("version-")), reverse=True):
        vdir = saver._version_dir(base)
        if saver._complete(vdir):
            return base, len(saver._delta_chain(vdir)), effective
    return None


class RestartFlushes:
    """Wraps a device tier's flush after a PS relaunch
    (``dtier._process_restart``, on the dispatch thread): records the
    rows it writes back (``rows``: {table: {id: row}}, last write wins)
    and the host reads of resident rows it makes (``reads``, counted on
    ``read_count``, the one-element count ``count_worker_steps``
    keeps), waits for the writebacks to land and pulls the same ids
    back through ``probe`` (a PSClient): ``served`` {table: rows in
    ``rows``' order}."""

    def __init__(self, np, dtier, probe, read_count=None):
        self.rows, self.served, self.reads = {}, {}, 0
        self._np, self._dtier, self._probe = np, dtier, probe
        self._read_count = read_count or [0]
        self._restart = dtier._process_restart
        dtier._process_restart = self

    def __call__(self):
        np, dtier = self._np, self._dtier
        with dtier._lock:
            pending = any(t.pending_flush is not None
                          for t in dtier._tables.values())
        if not pending:
            return self._restart()
        reads0, submit = self._read_count[0], dtier._submit_writeback

        def recorded(name, ids, values):
            self.rows.setdefault(name, {}).update(
                zip(np.asarray(ids).tolist(), np.array(values)))
            return submit(name, ids, values)

        dtier._submit_writeback = recorded
        try:
            self._restart()
        finally:
            del dtier._submit_writeback
        self.reads += self._read_count[0] - reads0
        dtier.drain_writebacks()
        for name, rows in self.rows.items():
            self.served[name] = self._probe.pull_embedding_vectors(
                name, np.fromiter(rows, np.int64, len(rows)))

    def mismatched(self):
        """Tables whose served rows differ from those written back."""
        np = self._np
        return [name for name, rows in self.rows.items()
                if not np.array_equal(self.served.get(name),
                                      np.stack(list(rows.values())))]


def ps_log(path):
    """What a PS process logged about its checkpoints: its saves
    [(version, kind, rows, tombstones, chain, seconds)], its restore
    (version, rows, seconds) or None, the version it exited at (None
    before it exits) and the last shard file it saved."""
    with open(path) as f:
        text = f.read()
    saves = [(int(m[2]), m[3], int(m[4]), int(m[5]), int(m[6]), float(m[7]))
             for m in _SAVE_RE.finditer(text)]
    restore = _RESTORE_RE.search(text)
    exit_at = _EXIT_RE.search(text)
    paths = _SAVED_PATH_RE.findall(text)
    return {"saves": saves,
            "restore": (int(restore[2]), int(restore[3]), float(restore[4]))
            if restore else None,
            "exit_version": int(exit_at[1]) if exit_at else None,
            "last_file": paths[-1] if paths else None}


def verified_save(np, path):
    """The store version a checkpoint shard file records (a delta's own,
    a base's directory name) after reading every array in it (the zip's
    CRC checks), or None when it does not read whole."""
    try:
        with np.load(path) as data:
            for key in data.files:
                data[key]  # a read: the zip checks its CRC
            if "__delta_version__" in data.files:
                return int(data["__delta_version__"])
    except Exception:  # a torn or missing file: the check fails
        return None
    return int(os.path.basename(os.path.dirname(path)).split("-")[1])


def ps_restart_phase(torch, np, tier, workdir, device="cuda",
                     files=RESTART_FILES, per_task=JOB_PER_TASK,
                     batch=SPARSE_BATCH, eval_steps=JOB_EVAL_STEPS,
                     report_version_steps=JOB_REPORT_VERSION_STEPS,
                     task_timeout_s=JOB_TASK_TIMEOUT_S,
                     ckpt_steps=RESTART_CKPT_STEPS,
                     min_deltas=RESTART_MIN_DELTAS,
                     min_lost=RESTART_MIN_LOST, warmup=RESTART_WARMUP,
                     worker_env=None, card=None):
    """Phase 10: a SIGKILLed parameter server restores its checkpoint
    and the job goes on. Phase 9's job (its master in this process, its
    data under ``workdir``, the first ``files`` training files) with
    worker 0 alone, in this process, its K1-K3 launches counted; two PS
    processes with phase 9's flags plus one ``--checkpoint_dir`` and
    ``--checkpoint_steps ckpt_steps``. Inside worker 0's push, once the
    newest complete checkpoint chain holds a full base and
    ``min_deltas`` deltas and PS 1 is ``min_lost`` versions past it, PS
    1 gets SIGKILL; it is relaunched with the same id, port and flags
    (no ``--checkpoint_dir_for_init``). Checks (each printed; a failure
    raises SystemExit): the relaunched PS logs the restored version, at
    least 1 and at least the newest checkpoint at the kill; worker 0's
    PS client saw shard 1's stamp change to it and the resync hook fired
    once; the tier's restart flush wrote back rows through one K1 per
    table and the relaunched PS serves them bit for bit; phase 7's
    formula (with a K1 per ``_read_rows``) holds in every step; the
    master returns 0 with every training record done once; the final
    AUC is at least JOB_AUC_FLOOR; worker 0's version for shard 1
    equals PS 1's store version at its exit; both PS exit 0 on their own
    after the master stops, each with its last checkpoint file whole at
    its last cadence version. ``card`` is the nvidia-smi line printed
    with the numbers (the CPU rehearsal passes its own)."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.ps_client import PSClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    device = torch.device(device)
    card = card or nvidia_smi_line()
    worker_env = dict(JOB_WORKER_ENV if worker_env is None else worker_env)
    train_dir = os.path.join(workdir, "restart_train")
    shutil.rmtree(train_dir, ignore_errors=True)
    os.makedirs(train_dir)
    for path in sorted(os.listdir(os.path.join(workdir, "train")))[:files]:
        os.symlink(os.path.join(workdir, "train", path),
                   os.path.join(train_dir, path))
    records = sum(n for _, n in RecordIODataReader(
        data_dir=train_dir).create_shards().values())
    master = Master(zoo, training_data=train_dir,
                    validation_data=os.path.join(workdir, "valid"),
                    records_per_task=per_task, num_epochs=1,
                    port=find_free_port(), eval_steps=eval_steps,
                    task_timeout_secs=task_timeout_s, seed=SEED)
    dispatcher = master.task_dispatcher
    addr = "localhost:%d" % master._port
    done = []
    report = dispatcher.report

    def on_report(task_id, success, worker_id=None, count_failure=True):
        ok, task = report(task_id, success, worker_id=worker_id,
                          count_failure=count_failure)
        if success and task is not None and task.type == pb.TRAINING:
            done.append((task.shard_name, task.start, task.end))
        return ok, task

    dispatcher.report = on_report
    logdir = os.path.join(HERE, "build", "chip_smoke_restart")
    shutil.rmtree(logdir, ignore_errors=True)
    ckpt_dir = os.path.join(logdir, "ckpt")
    os.makedirs(ckpt_dir)
    env = dict(os.environ, PYTHONPATH=HERE, EDL_PS_MASTER_GONE_SECS="2")
    extra = ("--use_async", "1", "--master_addr", addr, "--checkpoint_dir",
             ckpt_dir, "--checkpoint_steps", str(ckpt_steps))
    saved_env = {k: os.environ.get(k) for k in worker_env}
    started, result, ps_codes, relaunched = [], {}, [], []
    kill, killed = {}, threading.Event()
    resyncs, runner = [], None
    try:
        job_t0 = time.monotonic()
        master.prepare()
        master_thread = threading.Thread(
            target=lambda: result.setdefault("rc", master.run(poll_secs=0.5)),
            daemon=True)
        master_thread.start()
        (procs, ps_addrs, ps_logs), = start_ps_pairs(1, logdir, started,
                                                      extra=extra, env=env)
        lines = wait_ps_ready([(procs, ps_addrs, ps_logs)])
        if not all("(NativeEmbeddingStore store, async)" in ln
                   for ln in lines):
            raise SystemExit("a PS does not serve the native store async: "
                             "%s" % lines)
        os.environ.update(worker_env)
        client = MasterClient(addr, worker_id=0)
        client.reset_worker()
        worker0 = Worker(client, zoo, RecordIODataReader(data_dir=train_dir),
                         minibatch_size=batch,
                         report_version_steps=report_version_steps,
                         wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                         device=device)
        trainer = worker0.trainer
        dtier = trainer.device_tier
        if dtier is None:
            raise SystemExit("worker 0 runs without the device tier")
        ps_client = trainer.preparer._ps
        probe = PSClient(ps_addrs)
        counts = count_worker_steps(tier, trainer)
        hook = ps_client.resync_hook

        def counted_hook(shard):
            resyncs.append((shard, time.monotonic()))
            hook(shard)

        ps_client.resync_hook = counted_hook
        push = ps_client.push_gradients

        def should_kill():
            version = ps_client._shard_versions.get(1, 0)
            if version < ckpt_steps * (min_deltas + 1) + min_lost:
                return False
            chain = newest_chain(SparseCheckpointSaver, ckpt_dir)
            if (chain is None or chain[1] < min_deltas
                    or version < chain[2] + min_lost):
                return False
            kill.update(version=version, chain=chain)
            return True

        def push_and_kill(*args, **kwargs):
            # depth-1 pushes: none is in flight here, so the version
            # worker 0 last saw from shard 1 is PS 1's own
            if not killed.is_set() and should_kill():
                procs[1].kill()
                procs[1].wait()
                kill["t"] = time.monotonic()
                killed.set()
            out = push(*args, **kwargs)
            if killed.is_set() and "first_push_t" not in kill:
                kill["first_push_t"] = time.monotonic()
                kill["first_push"] = [bool(out[0]), int(out[1])]
            return out

        ps_client.push_gradients = push_and_kill
        flushes = RestartFlushes(np, dtier, probe, counts["reads"])
        reset_tier_launches(tier)  # the phase's count starts here
        runner = threading.Thread(target=worker0.run, daemon=True)
        runner.start()
        deadline = time.monotonic() + JOB_WAIT_S
        while not killed.wait(0.05):
            if not runner.is_alive() or time.monotonic() > deadline:
                raise SystemExit(
                    "PS 1 was never killed: worker 0 %s, newest chain %s, "
                    "shard 1 at version %s" % (
                        "alive" if runner.is_alive() else "done",
                        newest_chain(SparseCheckpointSaver, ckpt_dir),
                        ps_client._shard_versions.get(1)))
        relaunch_log = os.path.join(logdir, "ps-0-1-relaunch.log")
        relaunched.append(start_ps(1, int(ps_addrs[1].rsplit(":", 1)[1]),
                                   relaunch_log, extra, env))
        wait_ps_ready([(relaunched, ps_addrs[1:], [relaunch_log])])
        serving_s = time.monotonic() - kill["t"]
        master_thread.join(timeout=JOB_WAIT_S)
        if master_thread.is_alive():
            raise SystemExit("the job did not finish in %d s" % JOB_WAIT_S)
        stopped_t = time.monotonic()
        job_s = stopped_t - job_t0
        runner.join(timeout=60)
        launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                            tier_counts(tier)))
        for proc in (procs[0], relaunched[0]):
            try:
                ps_codes.append(proc.wait(
                    timeout=max(0.0, stopped_t + JOB_PS_GONE_WAIT_S
                                - time.monotonic())))
            except subprocess.TimeoutExpired:
                ps_codes.append(None)
        ps_exit_s = time.monotonic() - stopped_t
        shard1_version = ps_client._shard_versions.get(1)
        shard1_stamp = ps_client._shard_restored.get(1)
        probe.close()
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for proc in relaunched + [p for ps, _, _ in started for p in ps]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        master.stop()
    logs = [ps_log(ps_logs[0]), ps_log(ps_logs[1]), ps_log(relaunch_log)]
    restore = logs[2]["restore"]
    restored = restore[0] if restore else None
    steps = counts["steps"]
    losses = [s[1] for s in steps]
    before = [s[0] for s in steps[warmup:] if s[4] < kill["t"]]
    after = [s[0] for s in steps if s[4] - s[0] > kill["first_push_t"]]
    summaries = master.evaluation_service.completed_summaries
    final = summaries[-1] if summaries else (None, {})
    saves = logs[0]["saves"] + logs[1]["saves"] + logs[2]["saves"]
    by_kind = {}
    for _, kind, rows, _, _, secs in saves:
        entry = by_kind.setdefault(kind, {"saves": 0, "seconds": [],
                                          "rows": []})
        entry["saves"] += 1
        entry["seconds"].append(secs)
        entry["rows"].append(rows)
    flush = {"rows": sum(len(r) for r in flushes.rows.values()),
             "reads": flushes.reads,
             "tables": {k: len(r) for k, r in flushes.rows.items()},
             "mismatched": flushes.mismatched()}
    drained = []
    for ps_id, entry in ((0, logs[0]), (1, logs[2])):
        cadence = (entry["exit_version"] // ckpt_steps * ckpt_steps
                   if entry["exit_version"] is not None else None)
        last = (verified_save(np, entry["last_file"])
                if entry["last_file"] else None)
        drained.append({"ps": ps_id, "exit_version": entry["exit_version"],
                        "last_cadence_version": cadence,
                        "last_file": entry["last_file"],
                        "last_file_version": last,
                        "ok": last is not None and last == cadence})
    record = {
        "restart": "result", "card": card, "master_rc": result.get("rc"),
        "job_failed": dispatcher.job_failed(), "job_wall_s": job_s,
        "dataset_records": records, "files": files,
        "done_training_records": sum(e - s for _, s, e in done),
        "done_ranges_repeated": len(done) - len(set(done)),
        "checkpoint_steps": ckpt_steps,
        "saves_by_kind": {k: {"saves": v["saves"],
                              "seconds_median": float(np.median(v["seconds"])),
                              "seconds_max": max(v["seconds"]),
                              "rows_median": float(np.median(v["rows"])),
                              "rows_max": max(v["rows"])}
                          for k, v in by_kind.items()},
        "saves": {"ps0": logs[0]["saves"], "ps1_before_kill": logs[1]["saves"],
                  "ps1_relaunched": logs[2]["saves"]},
        "chain_at_kill": kill.get("chain"),
        "version_at_kill": kill.get("version"),
        "restored_version": restored,
        "versions_lost": (kill["version"] - restored
                          if restored is not None else None),
        "restore_rows": restore[1] if restore else None,
        "restore_s": restore[2] if restore else None,
        "kill_to_serving_s": serving_s,
        "kill_to_first_push_s": kill["first_push_t"] - kill["t"],
        "first_push_after_kill": kill.get("first_push"),
        "resyncs": [[s, t - kill["t"]] for s, t in resyncs],
        "shard1_stamp": shard1_stamp,
        "tier_flush": flush, "tier_epoch": dtier.epoch,
        "worker0_steps": len(steps),
        "worker0_steps_per_s_before_kill": (len(before) / sum(before)
                                            if before else None),
        "worker0_steps_per_s_after_restore": (len(after) / sum(after)
                                              if after else None),
        "worker0_step_ms_median_before_after": [
            float(np.median(before)) * 1e3 if before else None,
            float(np.median(after)) * 1e3 if after else None],
        "all_finite": bool(np.isfinite(losses).all()) if losses else False,
        "launches": launches,
        "launches_per_step": {k: v / max(len(steps), 1)
                              for k, v in launches.items()},
        "launch_formula_mismatches": counts["bad_steps"][:5],
        "row_reads": counts["reads"][0],
        "evaluations": [[v, s] for v, s in summaries],
        "final_auc": final[1].get("auc"), "auc_floor": JOB_AUC_FLOOR,
        "shard1_version_worker0": shard1_version,
        "ps_exit_codes": ps_codes, "ps_exit_after_master_s": ps_exit_s,
        "checkpoints_drained": drained,
    }
    log(json.dumps(record))
    failures = []
    if restored is None or restored < 1 or restored < kill["chain"][2]:
        failures.append("PS 1 restored %s (newest chain at the kill %s)"
                        % (restored, kill["chain"]))
    if shard1_stamp != (restored + 1 if restored is not None else None):
        failures.append("worker 0 holds shard 1's stamp %s, not %s + 1"
                        % (shard1_stamp, restored))
    if [s for s, _ in resyncs] != [1]:
        failures.append("resync hook fired for shards %s, not once for 1"
                        % [s for s, _ in resyncs])
    tables = len(dtier._tables)
    if (flush["rows"] <= 0 or flush["reads"] != tables
            or len(flush["tables"]) != tables or flush["mismatched"]):
        failures.append("restart flush: %s (want rows > 0, %d K1 reads, "
                        "every table's rows served back bit for bit)"
                        % (flush, tables))
    if counts["bad_steps"] or min(launches.values()) <= 0:
        failures.append("worker 0's K1-K3 launches do not follow the "
                        "path: %s" % counts["bad_steps"][:5])
    if (result.get("rc") != 0 or dispatcher.job_failed()
            or record["done_training_records"] != records
            or record["done_ranges_repeated"]):
        failures.append("master rc %s, job failed %s, %d of %d records "
                        "done, %d ranges repeated" % (
                            result.get("rc"), dispatcher.job_failed(),
                            record["done_training_records"], records,
                            record["done_ranges_repeated"]))
    if not record["all_finite"] or runner.is_alive():
        failures.append("worker 0: losses finite %s, still running %s"
                        % (record["all_finite"], runner.is_alive()))
    if final[1].get("auc") is None or not final[1]["auc"] >= JOB_AUC_FLOOR:
        failures.append("final AUC %s < %s" % (final[1].get("auc"),
                                                JOB_AUC_FLOOR))
    if shard1_version is None or shard1_version != logs[2]["exit_version"]:
        failures.append("worker 0's version for shard 1 %s != PS 1's %s"
                        % (shard1_version, logs[2]["exit_version"]))
    if ps_codes != [0, 0] or ps_exit_s > JOB_PS_GONE_WAIT_S:
        failures.append("PS exit codes %s after %.1f s" % (ps_codes,
                                                           ps_exit_s))
    if not all(d["ok"] for d in drained):
        failures.append("a checkpoint thread did not drain: %s" % drained)
    if failures:
        raise SystemExit("restart phase: " + "; ".join(failures))
    return record


# phase 11: the job's artifact. Phase 9's job over one of its training
# files (6 tasks, 96 steps of 512), worker 0 alone in this process with
# dense checkpoints every ARTIFACT_CKPT_STEPS versions (the newest
# ARTIFACT_KEEP kept), both PS checkpointing into one directory, the
# master with an export path; then an evaluation-only and a
# prediction-only job on the restored model, and the server over the
# export and the restored PS
ARTIFACT_FILES = 1
ARTIFACT_CKPT_STEPS = 32
ARTIFACT_KEEP = 2
ARTIFACT_SERVE_BATCH = 64
ARTIFACT_BURST = 512
ARTIFACT_CLIENTS = 16
ARTIFACT_PRED_TOL = 1e-5       # served against the prediction job's
ARTIFACT_AUC_TOL = 1e-6        # eval job's AUC against the predictions'
ARTIFACT_PRED_ZOO = "elasticdl_tpu_torch.models.deepfm_predictions"
_FINAL_SAVE_RE = re.compile(r"final sparse checkpoint saved at version "
                            r"(\d+)")
_RESUMED_RE = re.compile(r"Resumed from checkpoint at version (\d+) "
                         r"\(([0-9.]+) s\)")


def flush_counts(tier, worker, counts):
    """Count the device tier's launches at each of ``worker``'s flush
    barriers, labelled by the boundary that ran it (``checkpoint``:
    ``_save_checkpoint``; ``train_end``: ``_process_train_end_task``),
    each held against the formula of the path (K1 once per table with
    dirty rows read back, through ``_read_rows``, plus the staged
    chunks' launches as in a step; K2 once per inserting chunk; no K3).
    ``counts`` is ``count_worker_steps``' record (its ``reads`` counts
    the row reads). ``dirty_tables`` is what was dirty at the barrier:
    the tables holding live dirty rows when the flush's writeback pass
    began (each costs one row read). Returns [{label, launches, want,
    reads, dirty_tables, s}] as the barriers run."""
    import numpy as np

    dtier = worker.trainer.device_tier
    flushes, label, dirty_at = [], [None], []
    flush = worker._flush_device_tier
    flush_dirty = dtier._flush_dirty

    def noted_flush_dirty(wait):
        with dtier._lock:
            dirty_at.append(sum(
                bool((t.slot_id[np.nonzero(t.slot_dirty)[0]] >= 0).any())
                for t in dtier._tables.values()))
        return flush_dirty(wait)

    dtier._flush_dirty = noted_flush_dirty

    def counted_flush():
        before, stats0 = tier_counts(tier), dtier.stats()
        reads0, t0 = counts["reads"][0], time.monotonic()
        passes0 = len(dirty_at)
        flush()
        stats1 = dtier.stats()
        d = [a - c for a, c in zip(tier_counts(tier), before)]
        reads = counts["reads"][0] - reads0
        gather_only, chunks, inserts, evicts = (
            stats1[k] - stats0[k]
            for k in ("gather_only_combines", "staged_chunks",
                      "insert_chunks", "evict_chunks"))
        flushes.append({"label": label[0], "launches": d,
                        "want": [gather_only + chunks + evicts + reads,
                                 inserts, 0],
                        "reads": reads,
                        "dirty_tables": sum(dirty_at[passes0:]),
                        "s": time.monotonic() - t0})

    def labelled(name, fn):
        def run(*args, **kwargs):
            label[0] = name
            try:
                return fn(*args, **kwargs)
            finally:
                label[0] = None
        return run

    worker._flush_device_tier = counted_flush
    worker._save_checkpoint = labelled("checkpoint", worker._save_checkpoint)
    worker._process_train_end_task = labelled(
        "train_end", worker._process_train_end_task)
    return flushes


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def start_worker_process(log_path, args, env):
    with open(log_path, "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "elasticdl_tpu_torch.worker.main", *args],
            cwd=HERE, env=env, stdout=out, stderr=subprocess.STDOUT)


def read_labels(np, valid_dir):
    """The validation file's labels, in record order."""
    from elasticdl_tpu_torch.data.example import decode_example
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb

    reader = RecordIODataReader(data_dir=valid_dir)
    labels, ids = {}, {}
    for name, (start, count) in reader.create_shards().items():
        rows = [decode_example(r) for r in reader.read_records(
            pb.Task(shard_name=name, start=start, end=start + count))]
        labels[name] = np.array([int(r["label"]) for r in rows])
        ids[name] = np.stack([np.asarray(r["ids"], np.int64) for r in rows])
    return labels, ids


def serve_burst(np, addr, rows, clients):
    """``rows`` [n, fields] as n one-row requests from ``clients``
    threads, each with its own channel; returns (answers [n], latencies
    s [n], wall s)."""
    from elasticdl_tpu_torch.serve.client import ServeClient

    n = len(rows)
    answers, latencies, errors = [None] * n, [None] * n, []

    def run(k):
        try:
            with ServeClient(addr) as client:
                for i in range(k, n, clients):
                    t0 = time.monotonic()
                    outputs, _, _ = client.predict(
                        {"ids": rows[i:i + 1]}, deadline_secs=120)
                    latencies[i] = time.monotonic() - t0
                    answers[i] = outputs["output"].numpy()
        except Exception as e:  # recorded and re-raised below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(a is None for a in answers):
        raise SystemExit("served requests failed: %s" % errors[:3])
    return np.concatenate(answers), np.array(latencies), wall


def wait_for_line(proc, path, text, what, timeout=STREAM_PS_WAIT_S):
    deadline = time.monotonic() + timeout
    while True:
        with open(path) as f:
            content = f.read()
        if text in content:
            return content
        if proc.poll() is not None or time.monotonic() > deadline:
            raise SystemExit("%s did not come up (exit %s):\n%s"
                             % (what, proc.poll(), content[-3000:]))
        time.sleep(0.1)


def artifact_phase(torch, np, tier, workdir, device="cuda",
                   files=ARTIFACT_FILES, per_task=JOB_PER_TASK,
                   batch=SPARSE_BATCH,
                   report_version_steps=JOB_REPORT_VERSION_STEPS,
                   task_timeout_s=JOB_TASK_TIMEOUT_S,
                   ckpt_steps=ARTIFACT_CKPT_STEPS, keep_max=ARTIFACT_KEEP,
                   serve_batch=ARTIFACT_SERVE_BATCH, burst=ARTIFACT_BURST,
                   clients=ARTIFACT_CLIENTS, worker_env=None, card=None,
                   train_end_first=False, out_dir=None):
    """Phase 11: the job's artifact, from the end of a DeepFM job to its
    use (the module docstring's steps). Checks (each printed; a failure
    raises SystemExit): the job's master returns 0 with every training
    record done, one TRAIN_END_CALLBACK task created after the last
    training task and completed once, the export's manifest step equal
    to worker 0's final version, the dense directory holding exactly the
    ``keep_max`` newest multiples of ``ckpt_steps`` with the final
    version the latest; worker 0's K1-K3 launches follow phase 7's
    formula in every step and at every flush barrier, and the train-end
    barrier read back one K1 per tier table that was dirty at it (the
    job's evaluation, when it ran first, left both tables dirty; when
    the train-end task was handed out first, nothing was); no training
    task was handed out after the train-end task; both PS save a final full
    checkpoint at one version on SIGTERM and exit 0; the relaunched PS
    restore it; the evaluation-only job's AUC is at least JOB_AUC_FLOOR
    and within ARTIFACT_AUC_TOL of the AUC of the prediction-only job's
    outputs; every validation record is predicted once; the served
    answers are bit-equal to ``ServingModel.predict`` on the same rows
    and within ARTIFACT_PRED_TOL of the prediction job's; PS 1,
    SIGKILLed and relaunched from the same checkpoint, restores the same
    version, the engine drops its cache once for each relaunch its PS
    client saw stamped, and the same burst again is answered bit for
    bit as the first. ``card`` is the nvidia-smi line printed with the
    numbers (the CPU rehearsal passes its own).

    ``train_end_first`` forces the other order of the job's end: worker
    0's version report that triggers the evaluation waits until a
    ``get_task`` (the stream's prefetch) has been answered with the
    train-end task, so the train-end barrier runs before the evaluation
    leaves tier rows dirty. ``out_dir`` (default
    ``build/chip_smoke_artifact``) takes the logs, checkpoints, export
    and predictions."""
    from elasticdl_tpu_torch.common.grpc_utils import (
        find_free_port,
        reserve_port,
    )
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.models.deepfm_predictions import (
        PREDICTION_DIR_ENV,
        read_predictions,
    )
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.ps.checkpoint import SparseCheckpointSaver
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.train import metrics
    from elasticdl_tpu_torch.train.callbacks import SavedModelExporter
    from elasticdl_tpu_torch.train.checkpoint import DenseCheckpointManager
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.ps_client import PSClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    device = torch.device(device)
    card = card or nvidia_smi_line()
    worker_env = dict(JOB_WORKER_ENV if worker_env is None else worker_env)
    train_dir = os.path.join(workdir, "artifact_train")
    valid_dir = os.path.join(workdir, "valid")
    shutil.rmtree(train_dir, ignore_errors=True)
    os.makedirs(train_dir)
    for path in sorted(os.listdir(os.path.join(workdir, "train")))[:files]:
        os.symlink(os.path.join(workdir, "train", path),
                   os.path.join(train_dir, path))
    records = sum(n for _, n in RecordIODataReader(
        data_dir=train_dir).create_shards().values())
    steps_total = -(-records // batch)
    out = out_dir or os.path.join(HERE, "build", "chip_smoke_artifact")
    shutil.rmtree(out, ignore_errors=True)
    dense_dir, export_dir = (os.path.join(out, "dense"),
                             os.path.join(out, "export"))
    ps_ckpt, pred_dir = (os.path.join(out, "ps_ckpt"),
                         os.path.join(out, "predictions"))
    os.makedirs(ps_ckpt)
    # the job's evaluation runs once, at the final version: it pulls (and
    # so creates on the PS) every validation id, and its lookups leave
    # tier rows dirty for the train-end barrier
    master = Master(zoo, training_data=train_dir, validation_data=valid_dir,
                    records_per_task=per_task, num_epochs=1,
                    port=find_free_port(), eval_steps=steps_total,
                    task_timeout_secs=task_timeout_s, seed=SEED,
                    saved_model_path=export_dir)
    dispatcher = master.task_dispatcher
    addr = "localhost:%d" % master._port
    reports, handed = [], []
    report, get = dispatcher.report, dispatcher.get

    def on_report(task_id, success, worker_id=None, count_failure=True):
        ok, task = report(task_id, success, worker_id=worker_id,
                          count_failure=count_failure)
        if success and task is not None:
            reports.append((task.type, task.task_id, task.shard_name,
                            task.start, task.end, time.monotonic()))
        return ok, task

    def on_get(worker_id, task_type=None):
        task = get(worker_id, task_type)
        if task is not None:
            handed.append((task.type, task.task_id, time.monotonic()))
        return task

    dispatcher.report, dispatcher.get = on_report, on_get
    env = dict(os.environ, PYTHONPATH=HERE, EDL_PS_MASTER_GONE_SECS="60")
    saved_env = {k: os.environ.get(k) for k in worker_env}
    job_extra = ("--use_async", "1", "--master_addr", addr,
                 "--checkpoint_dir", ps_ckpt, "--checkpoint_steps",
                 str(ckpt_steps))
    started, result, procs, reservations = [], {}, [], []
    runner = None
    record = {"artifact": "result", "card": card}
    try:
        # -- 1. the job ---------------------------------------------------
        job_t0 = time.monotonic()
        master.prepare()
        master_thread = threading.Thread(
            target=lambda: result.setdefault("rc", master.run(poll_secs=0.5)),
            daemon=True)
        master_thread.start()
        (job_ps, ps_addrs, ps_logs), = start_ps_pairs(
            1, os.path.join(out, "job"), started, extra=job_extra, env=env)
        wait_ps_ready([(job_ps, ps_addrs, ps_logs)])
        os.environ.update(worker_env)
        client = MasterClient(addr, worker_id=0)
        client.reset_worker()
        worker0 = Worker(client, zoo, RecordIODataReader(data_dir=train_dir),
                         minibatch_size=batch,
                         report_version_steps=report_version_steps,
                         wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                         device=device, checkpoint_dir=dense_dir,
                         checkpoint_steps=ckpt_steps,
                         keep_checkpoint_max=keep_max)
        trainer = worker0.trainer
        dtier = trainer.device_tier
        if dtier is None:
            raise SystemExit("worker 0 runs without the device tier")
        counts = count_worker_steps(tier, trainer)
        flushes = flush_counts(tier, worker0, counts)
        saves = []
        mgr_save = worker0._checkpoint_mgr.save

        def timed_save(version, state):
            t0 = time.monotonic()
            mgr_save(version, state)
            saves.append({"version": int(version),
                          "s": time.monotonic() - t0,
                          "bytes": dir_bytes(os.path.join(
                              dense_dir, str(int(version))))})

        worker0._checkpoint_mgr.save = timed_save
        exporter, = [cb for cb in worker0._callbacks
                     if isinstance(cb, SavedModelExporter)]
        export_rec = {}
        on_train_end = exporter.on_train_end

        def timed_export(state, extended_config=None):
            t0 = time.monotonic()
            on_train_end(state, extended_config)
            export_rec["s"] = time.monotonic() - t0

        exporter.on_train_end = timed_export
        forced = {}
        if train_end_first:
            report_version = worker0._mc.report_version

            def delayed_report(version):
                # the report that triggers the evaluation waits for the
                # prefetch's get_task to be answered with the train end
                if version >= steps_total and "waited_s" not in forced:
                    t0 = time.monotonic()
                    while (time.monotonic() - t0 < JOB_WAIT_S and not any(
                            h[0] == pb.TRAIN_END_CALLBACK for h in handed)):
                        time.sleep(0.01)
                    forced["waited_s"] = time.monotonic() - t0
                return report_version(version)

            worker0._mc.report_version = delayed_report
            add_eval = master.evaluation_service.add_evaluation_task_if_needed

            def held_eval(version):
                # the PS report every store version too (the trigger
                # fires at version steps_total - 1 from a PS), so no
                # round starts before the train-end hand-out, whoever
                # reports (unmet, the report only defers it)
                if not any(h[0] == pb.TRAIN_END_CALLBACK for h in handed):
                    return False
                return add_eval(version)

            master.evaluation_service.add_evaluation_task_if_needed = (
                held_eval)
        reset_tier_launches(tier)  # the phase's count starts here
        runner = threading.Thread(target=worker0.run, daemon=True)
        runner.start()
        master_thread.join(timeout=JOB_WAIT_S)
        if master_thread.is_alive():
            raise SystemExit("the job did not finish in %d s" % JOB_WAIT_S)
        job_s = time.monotonic() - job_t0
        runner.join(timeout=60)
        launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                            tier_counts(tier)))
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        # the PS drain: a final full checkpoint at the store version
        stop_t0 = time.monotonic()
        job_ps_codes = stop_ps([(job_ps, ps_addrs, ps_logs)])
        ps_stop_s = time.monotonic() - stop_t0
        finals, final_saves = [], []
        for path in ps_logs:
            with open(path) as f:
                match = _FINAL_SAVE_RE.search(f.read())
            finals.append(int(match[1]) if match else None)
            final_saves += [s for s in ps_log(path)["saves"]
                            if s[1] == "full" and match
                            and s[0] == int(match[1])][-1:]
        ps_latest = SparseCheckpointSaver.latest_version(ps_ckpt)
        with open(os.path.join(export_dir, "manifest.json")) as f:
            manifest = json.load(f)
        dense_versions = sorted(int(d) for d in os.listdir(dense_dir)
                                if d.isdigit())
        dense_latest = DenseCheckpointManager(
            dense_dir, create=False).latest_version()
        version = worker0.model_version
        done_training = [r for r in reports if r[0] == pb.TRAINING]
        train_end = [r for r in reports if r[0] == pb.TRAIN_END_CALLBACK]
        train_end_handed = [h for h in handed
                            if h[0] == pb.TRAIN_END_CALLBACK]
        steps = counts["steps"]
        losses = [s[1] for s in steps]
        warm = [s[0] for s in steps[10:]] or [s[0] for s in steps]
        end_flush = [f for f in flushes if f["label"] == "train_end"]
        ckpt_flush = [f for f in flushes if f["label"] == "checkpoint"]
        eval_handed = [h for h in handed if h[0] == pb.EVALUATION]
        order = ("train_end_first" if train_end_handed and (
            not eval_handed or train_end_handed[0][2] < eval_handed[0][2])
            else "evaluation_first")
        training_after_end = [
            h[1] for h in handed if h[0] == pb.TRAINING
            and train_end_handed and h[2] > train_end_handed[0][2]]
        record.update({
            "job_wall_s": job_s, "master_rc": result.get("rc"),
            "job_failed": dispatcher.job_failed(),
            "dataset_records": records,
            "done_training_records": sum(r[4] - r[3]
                                         for r in done_training),
            "worker0_version": version, "worker0_steps": len(steps),
            "worker0_steps_per_s": len(warm) / sum(warm) if warm else None,
            "all_finite": bool(np.isfinite(losses).all()) if losses
            else False,
            "train_end_tasks_done": [r[1] for r in train_end],
            "train_end_tasks_handed": [h[1] for h in train_end_handed],
            "train_end_after_last_training": bool(
                train_end_handed and done_training
                and train_end_handed[0][2] > done_training[-1][5]),
            "export_step": manifest["step"],
            "export_s": export_rec.get("s"),
            "export_bytes": dir_bytes(export_dir),
            "dense_saves": saves, "dense_versions": dense_versions,
            "dense_latest": dense_latest,
            "launches": launches,
            "launches_per_step": {k: v / max(len(steps), 1)
                                  for k, v in launches.items()},
            "launch_formula_mismatches": counts["bad_steps"][:5],
            "launches_train_end_flush": [f["launches"] for f in end_flush],
            "train_end_flushes": end_flush,
            "train_end_order": order,
            "train_end_forced_wait_s": forced.get("waited_s"),
            "training_handed_after_train_end": training_after_end,
            "launches_checkpoint_flush": [f["launches"]
                                          for f in ckpt_flush],
            "flush_s": {"train_end": [f["s"] for f in end_flush],
                        "checkpoint": [f["s"] for f in ckpt_flush]},
            "flush_formula_mismatches": [
                f for f in flushes if f["launches"] != f["want"]],
            "job_evaluations": [[v, s] for v, s in
                                master.evaluation_service.completed_summaries],
            "ps_exit_codes": job_ps_codes, "ps_stop_s": ps_stop_s,
            "ps_final_versions": finals, "ps_final_saves": final_saves,
            "ps_latest_version": ps_latest,
        })
        failures = []
        if (result.get("rc") != 0 or dispatcher.job_failed()
                or record["done_training_records"] != records):
            failures.append("master rc %s, job failed %s, %d of %d "
                            "records done" % (
                                result.get("rc"), dispatcher.job_failed(),
                                record["done_training_records"], records))
        if not record["all_finite"] or runner.is_alive():
            failures.append("worker 0: losses finite %s, still running %s"
                            % (record["all_finite"], runner.is_alive()))
        if (len(train_end) != 1 or len(train_end_handed) != 1
                or not record["train_end_after_last_training"]
                or training_after_end):
            failures.append("train-end tasks done %s, handed %s, after the "
                            "last training task %s, training tasks handed "
                            "after it %s" % (
                                record["train_end_tasks_done"],
                                record["train_end_tasks_handed"],
                                record["train_end_after_last_training"],
                                training_after_end))
        if train_end_first and order != "train_end_first":
            failures.append("the forced order did not hold: %s (waited "
                            "%s s)" % (order, forced.get("waited_s")))
        if manifest["step"] != version:
            failures.append("export step %s != worker 0's version %d"
                            % (manifest["step"], version))
        want_versions = [version - ckpt_steps * k
                         for k in range(keep_max - 1, -1, -1)]
        if (version % ckpt_steps or dense_versions != want_versions
                or dense_latest != version):
            failures.append("dense checkpoints %s, latest %s (want %s)"
                            % (dense_versions, dense_latest,
                               want_versions))
        if counts["bad_steps"] or min(launches.values()) <= 0:
            failures.append("worker 0's K1-K3 launches do not follow the "
                            "path: %s" % counts["bad_steps"][:5])
        # the evaluation before the train end leaves every tier table
        # dirty; a train end handed out first finds none dirty
        want_dirty = len(dtier._tables) if order == "evaluation_first" else 0
        if (record["flush_formula_mismatches"]
                or len(ckpt_flush) != version // ckpt_steps
                or len(end_flush) != 1
                or end_flush[0]["reads"] != end_flush[0]["dirty_tables"]
                or end_flush[0]["dirty_tables"] != want_dirty):
            failures.append("flush barriers: %s (want one K1 per tier "
                            "table dirty at the train end, %d tables dirty "
                            "in the order %s)" % (flushes, want_dirty,
                                                  order))
        if (job_ps_codes != [0, 0] or None in finals
                or len(set(finals)) != 1 or ps_latest != finals[0]):
            failures.append("job PS exits %s, final saves at %s, latest "
                            "complete checkpoint %s" % (
                                job_ps_codes, finals, ps_latest))
        if failures:
            log(json.dumps(record))
            raise SystemExit("artifact phase (job): " + "; ".join(failures))

        # -- 3-5. the restored PS; evaluation, prediction, serving --------
        reservations = [reserve_port() for _ in range(2)]
        ports = [port for _, port in reservations]
        addrs = ["localhost:%d" % port for port in ports]
        restore_extra = ("--use_async", "1", "--checkpoint_dir_for_init",
                         ps_ckpt)
        logs = [os.path.join(out, "ps-%d.log" % i) for i in range(2)]
        restored_ps = [start_ps(i, ports[i], logs[i], restore_extra, env)
                       for i in range(2)]
        procs.extend(restored_ps)
        serve_port = find_free_port()
        serve_log = os.path.join(out, "serve.log")
        with open(serve_log, "w") as sink:
            serve_proc = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.serve.main",
                 "--model_zoo", zoo, "--export_dir", export_dir,
                 "--ps_addrs", ",".join(addrs), "--port", str(serve_port),
                 "--max_batch", str(serve_batch), "--device", device.type,
                 "--deadline_ms", "600000", "--watch_secs", "3600"],
                cwd=HERE, env=env, stdout=sink, stderr=subprocess.STDOUT)
        procs.append(serve_proc)
        wait_ps_ready([(restored_ps, addrs, logs)])
        restored_versions = [ps_log(p)["restore"] for p in logs]
        # the evaluation-only and the prediction-only job run together:
        # both only read the PS
        jobs_t0 = time.monotonic()
        eval_master = Master(zoo, validation_data=valid_dir,
                             records_per_task=per_task,
                             port=find_free_port(),
                             task_timeout_secs=task_timeout_s).prepare()
        pred_master = Master(ARTIFACT_PRED_ZOO, prediction_data=valid_dir,
                             records_per_task=per_task,
                             port=find_free_port(),
                             task_timeout_secs=task_timeout_s).prepare()
        pred_done = []
        pred_report = pred_master.task_dispatcher.report

        def on_pred_report(task_id, success, worker_id=None,
                           count_failure=True):
            ok, task = pred_report(task_id, success, worker_id=worker_id,
                                   count_failure=count_failure)
            if success and task is not None and task.type == pb.PREDICTION:
                pred_done.append((task.shard_name, task.start, task.end))
            return ok, task

        pred_master.task_dispatcher.report = on_pred_report
        job_results, walls = {}, {}

        def run_master(name, m):
            job_results[name] = m.run(poll_secs=0.2)
            walls[name] = time.monotonic() - jobs_t0

        master_threads = [
            threading.Thread(target=run_master, args=(name, m), daemon=True)
            for name, m in (("evaluation", eval_master),
                            ("prediction", pred_master))]
        for t in master_threads:
            t.start()
        # the scoring workers run without the tier (they only read), at
        # the job's id capacity
        scoring_env = dict(env, **{PREDICTION_DIR_ENV: pred_dir})
        if "EDL_SPARSE_ID_CAPACITY" in worker_env:
            scoring_env["EDL_SPARSE_ID_CAPACITY"] = worker_env[
                "EDL_SPARSE_ID_CAPACITY"]
        common = ["--minibatch_size", str(batch), "--worker_id", "0",
                  "--ps_addrs", ",".join(addrs), "--device", device.type,
                  "--checkpoint_dir_for_init", dense_dir]
        eval_log = os.path.join(out, "worker-evaluation.log")
        pred_log = os.path.join(out, "worker-prediction.log")
        scorers = [
            start_worker_process(eval_log, [
                "--model_zoo", zoo, "--validation_data", valid_dir,
                "--mode", "evaluation", "--master_addr",
                "localhost:%d" % eval_master._port, *common], scoring_env),
            start_worker_process(pred_log, [
                "--model_zoo", ARTIFACT_PRED_ZOO, "--prediction_data",
                valid_dir, "--mode", "prediction", "--master_addr",
                "localhost:%d" % pred_master._port, *common], scoring_env)]
        procs.extend(scorers)
        for t in master_threads:
            t.join(timeout=JOB_WAIT_S)
        scorer_codes = [p.wait(timeout=60) for p in scorers]
        resumed = []
        for path in (eval_log, pred_log):
            with open(path) as f:
                match = _RESUMED_RE.search(f.read())
            resumed.append([int(match[1]), float(match[2])] if match
                           else None)
        summaries = eval_master.evaluation_service.completed_summaries
        eval_auc = summaries[-1][1].get("auc") if summaries else None
        labels_by_shard, ids_by_shard = read_labels(np, valid_dir)
        (shard, labels), = labels_by_shard.items()
        rows_ids = ids_by_shard[shard]
        predictions = read_predictions(pred_dir)
        preds = predictions.get(0, np.empty(0, np.float32))
        by_record = np.full(labels.size, np.nan, np.float32)
        covered = np.zeros(labels.size, np.int64)
        offset = 0
        for _, start, end in pred_done:
            if offset + end - start <= preds.size:
                by_record[start:end] = preds[offset:offset + end - start]
            covered[start:end] += 1
            offset += end - start
        auc = metrics.AUC(from_logits=True)
        auc.update_state(labels, by_record)
        pred_auc = auc.result() if np.isfinite(by_record).all() else None
        record.update({
            "ps_restored": restored_versions,
            "scoring_jobs_rc": job_results, "scoring_jobs_wall_s": walls,
            "scoring_workers_rc": scorer_codes,
            "scoring_resumed_version_s": resumed,
            "eval_only_auc": eval_auc, "prediction_auc": pred_auc,
            "auc_floor": JOB_AUC_FLOOR,
            "predicted_records": int(preds.size),
            "validation_records": int(labels.size),
            "predicted_once": bool((covered == 1).all()
                                   and preds.size == labels.size),
        })
        failures = []
        if any(r is None or r[0] != finals[0] for r in restored_versions):
            failures.append("restored PS at %s, not %s"
                            % (restored_versions, finals[0]))
        if (job_results != {"evaluation": 0, "prediction": 0}
                or scorer_codes != [0, 0]
                or any(r is None or r[0] != version for r in resumed)):
            failures.append("scoring jobs %s, workers %s, resumed %s"
                            % (job_results, scorer_codes, resumed))
        if (eval_auc is None or not eval_auc >= JOB_AUC_FLOOR
                or pred_auc is None
                or abs(eval_auc - pred_auc) > ARTIFACT_AUC_TOL):
            failures.append("eval-only AUC %s, from the predictions %s "
                            "(floor %s, tolerance %s)" % (
                                eval_auc, pred_auc, JOB_AUC_FLOOR,
                                ARTIFACT_AUC_TOL))
        if not record["predicted_once"]:
            failures.append("predicted %d of %d records, each once: %s"
                            % (preds.size, labels.size,
                               record["predicted_once"]))
        if failures:
            log(json.dumps(record))
            raise SystemExit("artifact phase (scoring): "
                             + "; ".join(failures))

        # -- 5. serving -----------------------------------------------------
        wait_for_line(serve_proc, serve_log, "serve 0 on :%d" % serve_port,
                      "the server")
        serve_addr = "localhost:%d" % serve_port
        rows = rows_ids[:burst]
        first, latencies, burst_s = serve_burst(np, serve_addr, rows,
                                                clients)
        reference = ServingModel(get_model_spec(zoo), export_dir,
                                 max_batch=serve_batch,
                                 ps_client=PSClient(addrs), device=device)
        direct = np.concatenate([
            reference.predict({"ids": rows[i:i + serve_batch]},
                              len(rows[i:i + serve_batch]))["output"].numpy()
            for i in range(0, len(rows), serve_batch)])
        reference._preparer._ps.close()
        kill_t0 = time.monotonic()
        restored_ps[1].kill()
        restored_ps[1].wait()
        relaunch_log = os.path.join(out, "ps-1-relaunch.log")
        relaunched = start_ps(1, ports[1], relaunch_log, restore_extra, env)
        procs.append(relaunched)
        wait_ps_ready([([relaunched], addrs[1:], [relaunch_log])])
        relaunch_s = time.monotonic() - kill_t0
        second, latencies2, burst2_s = serve_burst(np, serve_addr, rows,
                                                   clients)
        serve_proc.terminate()
        serve_rc = serve_proc.wait(timeout=60)
        with open(serve_log) as f:
            serve_text = f.read()
        drops = serve_text.count("serving embedding cache dropped")
        stamped = len(re.findall(r"PS shard \d+ relaunched", serve_text))
        # each burst's own: the first meets a server that has answered
        # nothing yet, the second one warm
        record.update({
            "serve_requests": 2 * len(rows), "serve_max_batch": serve_batch,
            "serve_clients": clients,
            "serve_p50_ms": [float(np.percentile(lat, 50)) * 1e3
                             for lat in (latencies, latencies2)],
            "serve_p99_ms": [float(np.percentile(lat, 99)) * 1e3
                             for lat in (latencies, latencies2)],
            "serve_requests_per_s": [len(rows) / burst_s,
                                     len(rows) / burst2_s],
            "served_equal_direct": bool(np.array_equal(first, direct)),
            "served_vs_prediction_max_abs": float(
                np.abs(first - by_record[:len(rows)]).max()),
            "prediction_tol": ARTIFACT_PRED_TOL,
            "ps1_relaunch_restored": ps_log(relaunch_log)["restore"],
            "ps1_kill_to_serving_s": relaunch_s,
            "serve_stamped_relaunches": stamped,
            "serve_cache_drops": drops,
            "second_burst_equal": bool(np.array_equal(first, second)),
            "serve_rc": serve_rc,
        })
        failures = []
        if not record["served_equal_direct"]:
            failures.append("served answers differ from "
                            "ServingModel.predict")
        if not record["served_vs_prediction_max_abs"] <= ARTIFACT_PRED_TOL:
            failures.append("served answers differ from the prediction "
                            "job's by %s" % (
                                record["served_vs_prediction_max_abs"]))
        restore = record["ps1_relaunch_restored"]
        if restore is None or restore[0] != restored_versions[1][0]:
            failures.append("PS 1's relaunch restored %s, not %s" % (
                restore, restored_versions[1]))
        if drops != stamped:
            failures.append("the engine dropped its cache %d times for %d "
                            "stamped relaunches" % (drops, stamped))
        if not record["second_burst_equal"] or serve_rc != 0:
            failures.append("the burst after the relaunch equal %s, serve "
                            "exit %s" % (record["second_burst_equal"],
                                         serve_rc))
        log(json.dumps(record))
        if failures:
            raise SystemExit("artifact phase (serving): "
                             + "; ".join(failures))
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for proc in procs + [p for ps, _, _ in started for p in ps]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for sock, _ in reservations:
            sock.close()
        master.stop()
        if runner is not None:
            runner.join(timeout=10)
    return record


# phase 12: phase 9's job over two of its four training files (12 tasks
# of 16 steps), the master a process journaling its state
# (EDL_STATE_DIR): worker 1, a process, is SIGTERMed after its first
# report and drains; then the master is SIGKILLed mid-epoch and
# relaunched with the same flags, and replays its journal
CONTROL_FILES = 2
# the step trigger at worker 0's versions 64, 128, ...; the relaunched
# master's evaluation service starts afresh, so it fires at worker 0's
# first version report at or past 63 after the relaunch
CONTROL_EVAL_STEPS = 64
CONTROL_MIN_DONE = 4            # done ops in the journal before the kill
CONTROL_RELAUNCH_GAP_S = 1.0
CONTROL_PS_GONE_S = 30          # the PS ride out the master's outage
CONTROL_DRAIN_DEADLINE_S = 45.0  # the worker's EDL_DRAIN_DEADLINE_SECS
_DRAIN_ACK_RE = re.compile(
    r"worker (\d+) drained cleanly \((\S+); pushes_joined=(\w+) "
    r"tier_flushed=(\w+) handed_back=(\d+)\)")
_DRAIN_FLUSH_RE = re.compile(
    r"drain tier flush: (\d+) rows written back, (\d+) K1 launches, "
    r"(\d+) row reads, (\d+) staged chunks, (\d+) evict chunks, (\d+) "
    r"gather-only combines, ([0-9.]+) s")
_REPLAY_RE = re.compile(r"\((\d+) journal ops replayed in ([0-9.]+) s\)")
_EVAL_RE = re.compile(r"Evaluation finished at model version (-?\d+): .*"
                      r"'auc': (?:np\.float\d+\()?([-0-9.eE+]+)")


def journal_ops(path):
    """The state journal's ops (a torn last line skipped)."""
    ops = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                try:
                    ops.append(json.loads(line))
                except ValueError:
                    pass
    return ops


def control_phase(torch, np, tier, workdir, device="cuda",
                  files=CONTROL_FILES, per_task=JOB_PER_TASK,
                  batch=SPARSE_BATCH, eval_steps=CONTROL_EVAL_STEPS,
                  report_version_steps=JOB_REPORT_VERSION_STEPS,
                  task_timeout_s=JOB_TASK_TIMEOUT_S,
                  min_done=CONTROL_MIN_DONE, worker_env=None, card=None):
    """Phase 12: the control plane's failures in a DeepFM job (the
    module docstring's steps). The master is ``python -m
    elasticdl_tpu_torch.master.main`` with ``EDL_STATE_DIR`` and
    ``--output`` on a held port; two async PS processes with
    ``--master_addr``; worker 1 a process and worker 0 in this process,
    both with the tier on. Checks (each printed; a failure raises
    SystemExit): the relaunched master exits 0; every task the journal
    created is done exactly once across both lifetimes; two
    ``master_restarted`` ops and one TRAIN_END_CALLBACK task, done;
    worker 0 granted an epoch in each lifetime, the second above the
    first; worker 1 exits 0 within its drain deadline, and the first
    master logged its ack with pushes_joined, tier_flushed and nothing
    handed back; no requeue op carries a retry; the drain's flush read
    K1 by the path's formula (none on the CPU, where no kernel runs);
    worker 0's K1-K3 launches follow phase 7's formula in every step;
    every completed evaluation's AUC is at least JOB_AUC_FLOOR and at
    least one completed; the export's step is worker 0's final version.
    ``card`` is the nvidia-smi line printed with the numbers (the CPU
    rehearsal passes its own)."""
    from elasticdl_tpu_torch.common.grpc_utils import reserve_port
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master.state_store import (
        JOURNAL_NAME,
        STATE_DIR_ENV,
    )
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    device = torch.device(device)
    card = card or nvidia_smi_line()
    worker_env = dict(JOB_WORKER_ENV if worker_env is None else worker_env)
    train_dir = os.path.join(workdir, "control_train")
    valid_dir = os.path.join(workdir, "valid")
    shutil.rmtree(train_dir, ignore_errors=True)
    os.makedirs(train_dir)
    for path in sorted(os.listdir(os.path.join(workdir, "train")))[:files]:
        os.symlink(os.path.join(workdir, "train", path),
                   os.path.join(train_dir, path))
    out = os.path.join(HERE, "build", "chip_smoke_control")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    state_dir, export_dir = (os.path.join(out, "state"),
                             os.path.join(out, "export"))
    journal = os.path.join(state_dir, JOURNAL_NAME)
    # held across the kill, so the relaunch finds its port free
    reservation, port = reserve_port()
    addr = "localhost:%d" % port
    env = dict(os.environ, PYTHONPATH=HERE,
               EDL_PS_MASTER_GONE_SECS=str(CONTROL_PS_GONE_S))
    master_args = [
        sys.executable, "-m", "elasticdl_tpu_torch.master.main",
        "--model_zoo", zoo, "--training_data", train_dir,
        "--validation_data", valid_dir, "--records_per_task", str(per_task),
        "--port", str(port), "--evaluation_steps", str(eval_steps),
        "--task_timeout_secs", str(task_timeout_s), "--output", export_dir]
    logs = {name: os.path.join(out, name + ".log")
            for name in ("master-1", "master-2", "worker-1")}
    procs, started, runner = [], [], None
    record = {"control": "result", "card": card}

    def start_master(name):
        """The master, with the same flags and state directory in both
        lifetimes; returns once it serves."""
        with open(logs[name], "w") as sink:
            proc = subprocess.Popen(
                master_args, cwd=HERE, stdout=sink, stderr=subprocess.STDOUT,
                env=dict(env, **{STATE_DIR_ENV: state_dir}))
        procs.append(proc)
        wait_for_line(proc, logs[name], "Master serving on :%d" % port,
                      "the master (%s)" % name)
        return proc

    def read(name):
        with open(logs[name]) as f:
            return f.read()

    def journal_view():
        """task id -> the worker of its last dispatch; the done ops."""
        ops = journal_ops(journal)
        dispatched = {op["task"]: op["worker"] for op in ops
                      if op["op"] == "dispatch"}
        return dispatched, [op for op in ops if op["op"] == "done"]

    saved_env = {k: os.environ.get(k) for k in worker_env}
    try:
        # -- the job: master, PS and worker 1, then worker 0 --------------
        job_t0 = time.monotonic()
        master = start_master("master-1")
        (ps, ps_addrs, ps_logs), = start_ps_pairs(
            1, os.path.join(out, "ps"), started,
            extra=("--use_async", "1", "--master_addr", addr), env=env)
        worker1 = start_worker_process(logs["worker-1"], [
            "--model_zoo", zoo, "--training_data", train_dir,
            "--minibatch_size", str(batch), "--master_addr", addr,
            "--worker_id", "1", "--ps_addrs", ",".join(ps_addrs),
            "--report_version_steps", str(report_version_steps),
            "--device", device.type], dict(env, **worker_env))
        procs.append(worker1)
        wait_ps_ready([(ps, ps_addrs, ps_logs)])
        deadline = time.monotonic() + JOB_WAIT_S
        while 1 not in journal_view()[0].values():
            if worker1.poll() is not None or time.monotonic() > deadline:
                raise SystemExit("worker 1 took no task (exit %s):\n%s"
                                 % (worker1.poll(), read("worker-1")[-3000:]))
            time.sleep(0.05)
        os.environ.update(worker_env)
        client = MasterClient(addr, worker_id=0)
        client.reset_worker()
        handed = []  # (time, task id, master epoch) of worker 0's tasks
        get_task = client.get_task

        def recorded_get_task(task_type=None):
            task = get_task(task_type)
            if task.task_id:
                handed.append((time.monotonic(), task.task_id,
                               task.master_epoch))
            return task

        client.get_task = recorded_get_task
        worker0 = Worker(client, zoo, RecordIODataReader(data_dir=train_dir),
                         minibatch_size=batch,
                         report_version_steps=report_version_steps,
                         wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                         device=device)
        if worker0.trainer.device_tier is None:
            raise SystemExit("worker 0 runs without the device tier")
        counts = count_worker_steps(tier, worker0.trainer)
        runner = threading.Thread(target=worker0.run, daemon=True)

        # -- 1. worker 1, SIGTERMed after its first report, drains --------
        # (worker 0 starts with the SIGTERM: started earlier, it could
        # finish the epoch before the drain is acked)
        while True:
            dispatched, done = journal_view()
            if any(dispatched.get(op["task"]) == 1 for op in done):
                break
            if worker1.poll() is not None or time.monotonic() > deadline:
                raise SystemExit("worker 1 reported no task (exit %s):\n%s"
                                 % (worker1.poll(), read("worker-1")[-3000:]))
            time.sleep(0.02)
        worker1.terminate()  # SIGTERM
        sigterm_t = time.monotonic()
        reset_tier_launches(tier)  # the phase's count starts here
        runner.start()
        ack_t = exit_t = None
        while ack_t is None or exit_t is None:
            now = time.monotonic()
            if ack_t is None and "worker 1 drained cleanly" in read(
                    "master-1"):
                ack_t = now
            if exit_t is None and worker1.poll() is not None:
                exit_t = now
            if now - sigterm_t > CONTROL_DRAIN_DEADLINE_S + 10:
                raise SystemExit("worker 1's drain: acked %s, exit %s:\n%s"
                                 % (ack_t is not None, worker1.poll(),
                                    read("worker-1")[-3000:]))
            time.sleep(0.02)

        # -- 2. the master, SIGKILLed mid-epoch ------------------------------
        while True:
            ops = journal_ops(journal)
            training = [t[0] for op in ops if op["op"] == "tasks_created"
                        for t in op["tasks"] if t[1] == pb.TRAINING]
            done = [op for op in ops if op["op"] == "done"]
            if sum(op["type"] == pb.TRAINING for op in done) >= len(
                    training):
                raise SystemExit("the epoch ended before the kill (%d "
                                 "training tasks)" % len(training))
            if len(done) >= min_done:
                break
            if time.monotonic() > deadline:
                raise SystemExit("the job stalled before the kill")
            time.sleep(0.02)
        master.kill()
        kill_t = time.monotonic()
        master.wait()
        at_kill = journal_ops(journal)
        record.update({
            "journal_bytes_at_kill": os.path.getsize(journal),
            "journal_ops_at_kill": len(at_kill),
            "done_at_kill": sum(op["op"] == "done" for op in at_kill)})

        # -- 3. relaunched with the same flags, it replays -------------------
        time.sleep(CONTROL_RELAUNCH_GAP_S)
        master = start_master("master-2")
        serving_t = time.monotonic()
        try:
            master_rc = master.wait(timeout=JOB_WAIT_S)
        except subprocess.TimeoutExpired:
            raise SystemExit("the relaunched master did not finish:\n%s"
                             % read("master-2")[-3000:])
        job_s = time.monotonic() - job_t0
        runner.join(timeout=60)
        launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                            tier_counts(tier)))
        ps_codes = stop_ps([(ps, ps_addrs, ps_logs)])
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for proc in procs + [p for pair, _, _ in started for p in pair]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reservation.close()
        if runner is not None:
            runner.join(timeout=10)

    # -- what the journal, the logs and worker 0 say ---------------------------
    ops = journal_ops(journal)
    created = {t[0]: t[1] for op in ops if op["op"] == "tasks_created"
               for t in op["tasks"]}
    done_ids = [op["task"] for op in ops if op["op"] == "done"]
    training = sorted(t for t, kind in created.items() if kind == pb.TRAINING)
    train_end = [t for t, kind in created.items()
                 if kind == pb.TRAIN_END_CALLBACK]
    dispatches, base, grants = {}, None, []
    for op in ops:
        if op["op"] == "dispatch":
            dispatches.setdefault(op["task"], []).append(op["worker"])
        elif op["op"] == "epoch_base":
            base = op["base"]
        elif op["op"] == "grant" and op["worker"] == 0:
            grants.append(base + op["count"])  # the epoch granted
    boots = [op["master_epoch"] for op in ops
             if op["op"] == "master_restarted"]
    acks = _DRAIN_ACK_RE.findall(read("master-1"))
    flush = _DRAIN_FLUSH_RE.search(read("worker-1"))
    replay = _REPLAY_RE.search(read("master-2"))
    evaluations = [[int(v), float(auc)] for name in ("master-1", "master-2")
                   for v, auc in _EVAL_RE.findall(read(name))]
    manifest = os.path.join(export_dir, "manifest.json")
    export_step = None
    if os.path.isfile(manifest):
        with open(manifest) as f:
            export_step = json.load(f)["step"]
    drain = None
    if flush:
        rows, k1, reads, chunks, evicts, gather_only = (
            int(g) for g in flush.groups()[:6])
        drain = {"rows": rows, "k1_launches": k1, "row_reads": reads,
                 "staged_chunks": chunks, "evict_chunks": evicts,
                 "gather_only_combines": gather_only,
                 "k1_formula": gather_only + chunks + evicts + reads,
                 "s": float(flush[7])}
    # worker 0's first task from the relaunched master, and its steps
    # (end time on the host clock) on either side of the outage
    relaunched = [h[0] for h in handed if boots and h[2] == boots[-1]]
    after_t = relaunched[0] if relaunched else None
    steps = counts["steps"]
    losses = [s[1] for s in steps]
    before = [s[0] for s in steps[10:] if s[4] < kill_t]
    after = [s[0] for s in steps
             if after_t is not None and s[4] - s[0] > after_t]
    record.update({
        "job_wall_s": job_s, "master_rc": master_rc,
        "worker1_rc": worker1.returncode,
        "sigterm_to_ack_s": ack_t - sigterm_t,
        "sigterm_to_exit_s": exit_t - sigterm_t,
        "drain_acks": acks, "drain_flush": drain,
        "kill_to_serving_s": serving_t - kill_t,
        "kill_to_worker0_task_s": (after_t - kill_t if after_t is not None
                                   else None),
        "replay_ops": int(replay[1]) if replay else None,
        "replay_s": float(replay[2]) if replay else None,
        "tasks_created": len(created), "training_tasks": len(training),
        "done_ops": len(done_ids),
        "done_exactly_once": sorted(done_ids) == sorted(created),
        "tasks_trained_twice": sum(len(dispatches.get(t, [])) > 1
                                   for t in training),
        "training_tasks_by_last_worker": {
            w: sum(dispatches.get(t, [None])[-1] == w for t in training)
            for w in (0, 1)},
        "master_boots": boots, "worker0_epochs": grants,
        "train_end_tasks": train_end,
        "train_end_done": [t for t in done_ids if t in train_end],
        "requeue_retries": [op["retries"] for op in ops
                            if op["op"] == "requeue"],
        "evaluations": evaluations, "auc_floor": JOB_AUC_FLOOR,
        "export_step": export_step, "worker0_version": worker0.model_version,
        "worker0_steps": len(steps),
        "worker0_steps_per_s_before_kill": (len(before) / sum(before)
                                            if before else None),
        "worker0_steps_per_s_after_kill": (len(after) / sum(after)
                                           if after else None),
        "all_finite": bool(np.isfinite(losses).all()) if losses else False,
        "launches": launches,
        "launches_per_step": {k: v / max(len(steps), 1)
                              for k, v in launches.items()},
        "launch_formula_mismatches": counts["bad_steps"][:5],
        "ps_exit_codes": ps_codes,
    })
    log(json.dumps(record))
    failures = []
    if master_rc != 0:
        failures.append("the relaunched master exited %s" % master_rc)
    if not record["done_exactly_once"] or not training:
        failures.append("%d tasks created, %d done ops, each once: %s"
                        % (len(created), len(done_ids),
                           record["done_exactly_once"]))
    if boots != [1, 2] or len(train_end) != 1 or (
            record["train_end_done"] != train_end):
        failures.append("boots %s, train-end tasks %s, done %s"
                        % (boots, train_end, record["train_end_done"]))
    if len(grants) != 2 or not grants[1] > grants[0]:
        failures.append("worker 0's granted epochs %s" % grants)
    if worker1.returncode != 0 or (
            record["sigterm_to_exit_s"] > CONTROL_DRAIN_DEADLINE_S):
        failures.append("worker 1 exited %s, %.1f s after SIGTERM" % (
            worker1.returncode, record["sigterm_to_exit_s"]))
    if acks != [("1", "sigterm", "True", "True", "0")]:
        failures.append("the master's drain acks %s" % acks)
    if any(record["requeue_retries"]):
        failures.append("counted retries %s" % record["requeue_retries"])
    want_k1 = None
    if drain is not None:
        want_k1 = drain["k1_formula"] if device.type == "cuda" else 0
    if drain is None or drain["rows"] <= 0 or drain["row_reads"] < 1 or (
            drain["k1_launches"] != want_k1):
        failures.append("the drain's tier flush %s (K1 wanted %s)"
                        % (drain, want_k1))
    if counts["bad_steps"] or min(launches.values()) <= 0 or (
            not record["all_finite"]):
        failures.append("worker 0's K1-K3 launches do not follow the "
                        "path, or a loss is not finite: %s"
                        % counts["bad_steps"][:5])
    if not evaluations or any(auc < JOB_AUC_FLOOR for _, auc in evaluations):
        failures.append("evaluations %s (floor %s)"
                        % (evaluations, JOB_AUC_FLOOR))
    if export_step != worker0.model_version:
        failures.append("export step %s, worker 0's version %d"
                        % (export_step, worker0.model_version))
    if failures:
        raise SystemExit("control phase: " + "; ".join(failures))
    return record


# phase 13: the job's telemetry. Phase 12's job (two of phase 9's
# training files, 12 tasks of 16 steps) with every role a telemetry
# source: the master (a process; its fleet monitor behind /statusz and
# /alerts), two async PS and worker 1 (processes; worker 1's stays up
# after its main returns until scraped, ``linger_worker``) and worker 0
# (in this process, its K1-K3 counted), each with a metrics port, the events
# journal and a trace of every step. Worker 1 is SIGSTOPped for
# TELEMETRY_STOP_S: the master's dead-air detector must raise on it, and
# clear once it is SIGCONTed, with no alert on any other role and no
# task requeued. The times keep TELEMETRY_MARGIN_S spare on each side
# (``dead_air_margins``); worker 0's task fetches pause while worker 1
# is stopped, so the store cannot run EDL_VERSION_LAG_MAX versions past
# worker 1's stale push (which would raise version_lag on a PS).
TELEMETRY_FILES = 2
TELEMETRY_EVAL_STEPS = 64
TELEMETRY_DEAD_AIR_S = 8.0       # EDL_DEAD_AIR_SECS (the default is 15)
TELEMETRY_STOP_S = 12.0          # worker 1's SIGSTOP
TELEMETRY_TASK_TIMEOUT_S = 20.0  # the master's liveness timeout
TELEMETRY_PS_GONE_S = 5.0        # EDL_PS_MASTER_GONE_SECS: a poll each 2.5 s
TELEMETRY_MARGIN_S = 3.0
TELEMETRY_SCRAPE_S = 0.1         # the script's scrape of /alerts
TELEMETRY_SERVE_REQUESTS = 64     # after one warm-up batch, not recorded
TELEMETRY_SERVE_BATCH = 8
_TIER_EXIT_RE = re.compile(r"Worker (\d+) tier stats at exit: (\{.*\})")


def dead_air_margins(dead_air_s, stop_s, task_timeout_s, ps_gone_s,
                     heartbeat_s):
    """The spare seconds of the phase's times: a healthy role's longest
    silence (the worker's heartbeat, the PS's master poll) under the
    dead-air window; the stop over the window plus the master's 1 s
    scan; the liveness timeout over the stop plus the stopped worker's
    last heartbeat gap (no requeue)."""
    ps_poll_s = min(5.0, ps_gone_s / 2)
    return {
        "healthy_silence_s": max(heartbeat_s, ps_poll_s),
        "dead_air_over_healthy_s": dead_air_s - max(heartbeat_s, ps_poll_s),
        "stop_over_dead_air_s": stop_s - dead_air_s - 1.0,
        "timeout_over_stop_s": task_timeout_s - stop_s - heartbeat_s,
    }


def linger_worker(argv, linger_s=300.0):
    """``worker.main`` in this process, which then stays up, serving its
    /metrics, until SIGUSR1 (or ``linger_s``): the scrape after a
    worker's last step needs the process after its main returned, and
    a worker's process exits as soon as its job is over."""
    from elasticdl_tpu_torch.worker import main as worker_main

    released = threading.Event()
    signal.signal(signal.SIGUSR1, lambda *_: released.set())
    rc = worker_main.main(argv)
    print(LINGER_MARK, flush=True)
    released.wait(timeout=linger_s)
    return rc


LINGER_MARK = "worker main returned; lingering for the last scrape"
LINGER_WORKER_CHILD = ("import sys, chip_smoke; "
                       "sys.exit(chip_smoke.linger_worker(sys.argv[1:]))")


def read_trace(path):
    """A role's trace events (the writer's "[" + one JSON per line,
    comma-terminated, the array left open)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip().rstrip(",")
            if line and line not in ("[", "]"):
                events.append(json.loads(line))
    return events


def read_journal(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def scrape(url, timeout=2.0):
    """(status, body) of one GET; (None, reason) when it cannot connect."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as reply:
            return reply.status, reply.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    except (OSError, ValueError) as e:
        return None, repr(e)


def series_value(text, name, **labels):
    """The value of one series of a /metrics body (0.0 when absent)."""
    want = "%s{%s}" % (name, ",".join('%s="%s"' % kv for kv in
                                       labels.items())) if labels else name
    total = 0.0
    for line in text.splitlines():
        if line.startswith(want + " "):
            total += float(line.rsplit(" ", 1)[1])
    return total


def tier_series(text):
    """edl_device_tier_hits_total + _misses_total over the tables."""
    total = 0.0
    for line in text.splitlines():
        if line.startswith(("edl_device_tier_hits_total{",
                            "edl_device_tier_misses_total{")):
            total += float(line.rsplit(" ", 1)[1])
    return total


def serving_split(np, spans, first_batch=0):
    """Medians (ms) of a served request's time by part, over every
    request served in a batch numbered ``first_batch`` or later (the
    batch number each ``serve_predict`` root carries): queue wait (the
    root's start, the RPC handler's entry, to its batch's assembly),
    batch assembly, forward, reply (the forward's end to the root's
    end). Returns (medians, the requests counted)."""
    batch_spans = {(e["name"], e["args"].get("batch")): e for e in spans
                   if e["name"] in ("serve_batch_assemble",
                                    "serve_batch_run")}
    parts = {"queue_wait": [], "batch_assembly": [], "forward": [],
             "reply": []}
    for root in (e for e in spans if e["name"] == "serve_predict"):
        number = root["args"].get("batch")
        if number is None or number < first_batch:
            continue
        assemble = batch_spans.get(("serve_batch_assemble", number))
        run = batch_spans.get(("serve_batch_run", number))
        if assemble is None or run is None:
            continue
        parts["queue_wait"].append(assemble["ts"] - root["ts"])
        parts["batch_assembly"].append(assemble["dur"])
        parts["forward"].append(run["dur"])
        parts["reply"].append(root["ts"] + root["dur"]
                              - run["ts"] - run["dur"])
    return {k: float(np.median(v)) / 1e3 if v else None
            for k, v in parts.items()}, len(parts["forward"])


def telemetry_phase(torch, np, tier, workdir, device="cuda",
                    files=TELEMETRY_FILES, per_task=JOB_PER_TASK,
                    batch=SPARSE_BATCH, eval_steps=TELEMETRY_EVAL_STEPS,
                    report_version_steps=JOB_REPORT_VERSION_STEPS,
                    dead_air_s=TELEMETRY_DEAD_AIR_S,
                    stop_s=TELEMETRY_STOP_S,
                    task_timeout_s=TELEMETRY_TASK_TIMEOUT_S,
                    ps_gone_s=TELEMETRY_PS_GONE_S, worker_env=None,
                    job_steps_per_s=None, card=None, out_dir=None):
    """Phase 13, the job: DeepFM with every role observed (the block
    above). Checks (each printed; a failure raises SystemExit): the
    phase's times keep TELEMETRY_MARGIN_S spare; ``/alerts`` shows
    ``dead_air`` for worker 1 during its stop and no other alert, ever;
    the master's journal has ``alert_raised`` then ``alert_cleared``
    for it and ``edl_master_alerts_total{alert="dead_air"}`` is 1; no
    task requeued and none presumed dead; ``/statusz`` lists both
    workers and both PS with their blobs: each worker's bytes in use
    from the allocator (> 0, the limit the card's total memory; on the
    CPU 0 bytes and the EDL_HBM_LIMIT_BYTES limit) and its tier's hits
    and misses, each PS's push and pull rates above 0 in some scrape;
    each worker's ``/metrics`` taken after its last step counts the
    tier's hits and misses its ``stats()`` logged at exit; the PS'
    gRPC server counters count the pushes the workers' client counters
    sent; one training step's trace id is in worker 0's root span, a
    master handler span and a PS handler span; the journal of every
    role that runs a port main (master, both PS, worker 1) has
    ``role_start`` and ``role_stop`` (worker 0's are this script's
    own); the master exits 0 with every
    training task done once; every completed evaluation's AUC at least
    JOB_AUC_FLOOR; worker 0's K1-K3 launches follow phase 7's formula.
    ``job_steps_per_s`` is phase 9's worker 0 (telemetry off), printed
    beside this run's."""
    from elasticdl_tpu_torch.common import overload
    from elasticdl_tpu_torch.common.grpc_utils import (
        find_free_port,
        reserve_port,
    )
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.observability import (
        events,
        http_server,
        metrics,
        trace,
    )
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    device = torch.device(device)
    card = card or nvidia_smi_line()
    worker_env = dict(JOB_WORKER_ENV if worker_env is None else worker_env)
    margins = dead_air_margins(dead_air_s, stop_s, task_timeout_s,
                               ps_gone_s, Worker.HEARTBEAT_SECS)
    record = {"telemetry": "result", "card": card,
              "dead_air_s": dead_air_s, "stop_s": stop_s,
              "task_timeout_s": task_timeout_s, "ps_gone_s": ps_gone_s,
              "heartbeat_s": Worker.HEARTBEAT_SECS, "margins": margins}
    short = {k: v for k, v in margins.items()
             if k != "healthy_silence_s" and v < TELEMETRY_MARGIN_S}
    if short:
        raise SystemExit("telemetry phase: the times leave less than %s s "
                         "spare: %s" % (TELEMETRY_MARGIN_S, short))
    train_dir = os.path.join(workdir, "telemetry_train")
    valid_dir = os.path.join(workdir, "valid")
    shutil.rmtree(train_dir, ignore_errors=True)
    os.makedirs(train_dir)
    for path in sorted(os.listdir(os.path.join(workdir, "train")))[:files]:
        os.symlink(os.path.join(workdir, "train", path),
                   os.path.join(train_dir, path))
    records = sum(n for _, n in RecordIODataReader(
        data_dir=train_dir).create_shards().values())
    out = out_dir or os.path.join(HERE, "build", "chip_smoke_telemetry")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    events_dir, trace_dir = (os.path.join(out, "events"),
                             os.path.join(out, "traces"))
    # a metrics port for each role, held until the phase ends
    reservations = {role: reserve_port() for role in (
        "master", "ps-0", "ps-1", "worker-0", "worker-1")}
    mport = {role: port for role, (_, port) in reservations.items()}
    port = find_free_port()
    addr = "localhost:%d" % port
    obs_env = {"EDL_METRICS": "1", "EDL_EVENTS_DIR": events_dir,
               "EDL_TRACE_DIR": trace_dir, "EDL_TRACE_SAMPLE": "1",
               "EDL_DEAD_AIR_SECS": str(dead_air_s),
               "EDL_PS_MASTER_GONE_SECS": str(ps_gone_s)}
    if device.type != "cuda":
        obs_env["EDL_HBM_LIMIT_BYTES"] = str(1 << 30)
    env = dict(os.environ, PYTHONPATH=HERE, **obs_env)
    logs = {name: os.path.join(out, name + ".log")
            for name in ("master", "ps-0", "ps-1", "worker-1")}
    procs, runner, http0 = [], None, None
    polls = {"alerts": [], "statusz": [], "master": []}
    stop_polling = threading.Event()

    def url(role, path):
        return "http://localhost:%d%s" % (mport[role], path)

    def poll():
        """/alerts every TELEMETRY_SCRAPE_S, /statusz and the master's
        /metrics every fifth time, each with its start time."""
        n = 0
        while not stop_polling.is_set():
            t = time.time()
            status, body = scrape(url("master", "/alerts"))
            if status == 200:
                polls["alerts"].append((t, json.loads(body)))
            if n % 5 == 0:
                status, body = scrape(url("master", "/statusz"))
                if status == 200:
                    polls["statusz"].append((t, json.loads(body)))
                status, body = scrape(url("master", "/metrics"))
                if status == 200:
                    polls["master"].append((t, body))
            n += 1
            stop_polling.wait(TELEMETRY_SCRAPE_S)

    def master_journal():
        paths = [os.path.join(events_dir, p) for p in os.listdir(events_dir)
                 if p.startswith("master-") and p.endswith(".ndjson")] if (
            os.path.isdir(events_dir)) else []
        return read_journal(paths[0]) if paths else []

    def holds(journal, worker_id):
        dispatched = {e["task"] for e in journal
                      if e["event"] == "task_dispatch"
                      and e["worker"] == worker_id}
        reported = {e["task"] for e in journal if e["event"] == "task_report"
                    and e["worker"] == worker_id}
        return dispatched - reported

    def read_log(name):
        with open(logs[name]) as f:
            return f.read()

    saved_env = {k: os.environ.get(k) for k in list(worker_env) + list(
        obs_env)}
    gate = threading.Event()
    gate.set()
    poller = threading.Thread(target=poll, daemon=True)
    try:
        job_t0 = time.monotonic()
        with open(logs["master"], "w") as sink:
            master = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
                 "--model_zoo", zoo, "--training_data", train_dir,
                 "--validation_data", valid_dir,
                 "--records_per_task", str(per_task), "--port", str(port),
                 "--evaluation_steps", str(eval_steps),
                 "--task_timeout_secs", str(task_timeout_s),
                 "--metrics_port", str(mport["master"])],
                cwd=HERE, env=env, stdout=sink, stderr=subprocess.STDOUT)
        procs.append(master)
        ps_ports = [find_free_port() for _ in range(2)]
        ps_addrs = ["localhost:%d" % p for p in ps_ports]
        ps = [start_ps(i, ps_ports[i], logs["ps-%d" % i],
                       ("--use_async", "1", "--master_addr", addr,
                        "--metrics_port", str(mport["ps-%d" % i])), env)
              for i in range(2)]
        procs.extend(ps)
        wait_for_line(master, logs["master"], "Master serving on :%d" % port,
                      "the master")
        # worker.main, kept up after it returns until its last scrape
        with open(logs["worker-1"], "w") as sink:
            worker1 = subprocess.Popen(
                [sys.executable, "-c", LINGER_WORKER_CHILD,
                 "--model_zoo", zoo, "--training_data", train_dir,
                 "--minibatch_size", str(batch), "--master_addr", addr,
                 "--worker_id", "1", "--ps_addrs", ",".join(ps_addrs),
                 "--report_version_steps", str(report_version_steps),
                 "--device", device.type,
                 "--metrics_port", str(mport["worker-1"])],
                cwd=HERE, env=dict(env, **worker_env), stdout=sink,
                stderr=subprocess.STDOUT)
        procs.append(worker1)
        wait_ps_ready([(ps, ps_addrs, [logs["ps-0"], logs["ps-1"]])])
        poller.start()
        deadline = time.monotonic() + JOB_WAIT_S
        while not any(e["event"] == "task_report" and e["worker"] == 1
                      and e["ok"] for e in master_journal()):
            if worker1.poll() is not None or time.monotonic() > deadline:
                raise SystemExit("worker 1 reported no task (exit %s):\n%s"
                                 % (worker1.poll(),
                                    read_log("worker-1")[-3000:]))
            time.sleep(0.05)

        # -- worker 0, in this process, with its own probes ----------------
        os.environ.update(worker_env)
        os.environ.update(obs_env)
        metrics.reset_default_registry()
        # a worker process starts with no breaker tripped: earlier
        # phases' PS kills left this process's books with open circuits,
        # which worker 0's blob would report as fresh (circuit_open)
        overload._reset_for_tests()
        events.configure("worker-0")
        trace.configure("worker-0")
        http0 = http_server.maybe_start("worker-0",
                                        cli_port=mport["worker-0"])
        client = MasterClient(addr, worker_id=0)
        if http0 is not None:
            http0.add_readiness_check("master_channel_ready",
                                      client.channel_ok)
        client.reset_worker()
        # worker 0 runs in this script, not worker.main: its role_start
        # and role_stop are the script's own, outside the journal check
        events.emit("role_start", worker=0, epoch=client.incarnation or 0)
        get_task = client.get_task

        def gated_get_task(task_type=None):
            gate.wait()
            return get_task(task_type)

        client.get_task = gated_get_task
        worker0 = Worker(client, zoo, RecordIODataReader(data_dir=train_dir),
                         minibatch_size=batch,
                         report_version_steps=report_version_steps,
                         wait_sleep_secs=0.1, ps_addrs=ps_addrs,
                         device=device)
        dtier = worker0.trainer.device_tier
        if dtier is None:
            raise SystemExit("worker 0 runs without the device tier")
        counts = count_worker_steps(tier, worker0.trainer)
        reset_tier_launches(tier)  # the phase's count starts here
        runner = threading.Thread(target=worker0.run, daemon=True)
        runner.start()

        # -- worker 1 stopped while it holds a task --------------------------
        while True:
            journal = master_journal()
            w0_done = any(e["event"] == "task_report" and e["worker"] == 0
                          for e in journal)
            if w0_done and holds(journal, 1):
                break
            if worker1.poll() is not None or time.monotonic() > deadline \
                    or not runner.is_alive():
                raise SystemExit("no moment with worker 1 holding a task "
                                 "after worker 0's first report")
            time.sleep(0.02)
        gate.clear()
        worker1.send_signal(signal.SIGSTOP)
        stop_t = time.time()
        time.sleep(stop_s)
        worker1.send_signal(signal.SIGCONT)
        cont_t = time.time()
        # worker 0 fetches again once the alert cleared: until it has
        # been told the job is over, the master keeps serving, so the
        # clear is always seen
        while time.time() - cont_t < dead_air_s:
            if polls["alerts"] and polls["alerts"][-1][0] > cont_t and (
                    not polls["alerts"][-1][1]):
                break
            time.sleep(0.05)
        gate.set()
        runner.join(timeout=JOB_WAIT_S)
        # worker 1's main has returned (its tier stats logged at exit,
        # role_stop journaled): its last scrape, then its exit
        wait_for_line(worker1, logs["worker-1"], LINGER_MARK,
                      "worker 1's end", timeout=JOB_WAIT_S)
        w1_status, w1_metrics = scrape(url("worker-1", "/metrics"))
        worker1.send_signal(signal.SIGUSR1)
        try:
            worker1_rc = worker1.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise SystemExit("worker 1 did not exit:\n%s"
                             % read_log("worker-1")[-3000:])
        launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                            tier_counts(tier)))
        # worker 0's last step is behind it: its scrape, its stats
        w0_stats = dtier.stats()
        log("Worker 0 tier stats at exit: %s"
            % json.dumps(w0_stats, sort_keys=True))
        status, w0_metrics = scrape(url("worker-0", "/metrics"))
        events.emit("role_stop", worker=0)
        events.flush()
        trace.flush()
        # both workers are done: the PS' counters, before the master's
        # exit tells them to go
        ps_metrics = [scrape(url("ps-%d" % i, "/metrics"))[1]
                      for i in range(2)]
        try:
            master_rc = master.wait(timeout=JOB_WAIT_S)
        except subprocess.TimeoutExpired:
            raise SystemExit("the master did not finish:\n%s"
                             % read_log("master")[-3000:])
        job_s = time.monotonic() - job_t0
        stop_polling.set()
        poller.join(timeout=10)
        # the job is over: the PS drain on SIGTERM (role_stop, exit 0)
        # rather than wait out EDL_PS_MASTER_GONE_SECS
        for p in ps:
            p.send_signal(signal.SIGTERM)
        ps_codes = [p.wait(timeout=60) for p in ps]
    finally:
        stop_polling.set()
        gate.set()
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for proc in procs:
            if proc.poll() is None:
                proc.kill()  # SIGKILL ends a stopped process too
                proc.wait()
        if http0 is not None:
            http0.stop()
        if runner is not None:
            runner.join(timeout=10)
        # the process's journal and trace off again (the knobs are
        # restored above); the registry back to the environment's
        events.configure("chip_smoke")
        trace.configure("chip_smoke")
        metrics.reset_default_registry()
        for sock, _ in reservations.values():
            sock.close()

    # -- what the journals, the traces and the scrapes say -----------------
    journal = master_journal()
    alert_polls = polls["alerts"]
    during = [a for t, a in alert_polls if stop_t + dead_air_s + 1.5 < t
              < cont_t]
    seen = sorted({(a["alert"], a.get("role") or str(a.get("worker_id")))
                   for _, alerts in alert_polls for a in alerts})
    raised = [e for e in journal if e["event"] == "alert_raised"]
    cleared = [e for e in journal if e["event"] == "alert_cleared"]
    dead_air_raised = [e for e in raised if e["alert"] == "dead_air"]
    master_metrics = polls["master"][-1][1] if polls["master"] else ""
    alerts_total = {
        kind: series_value(master_metrics, "edl_master_alerts_total",
                           alert=kind)
        for kind in ("dead_air", "straggler", "stuck_round", "version_lag",
                     "nonfinite_loss", "loss_spike", "grad_explosion",
                     "hbm_pressure", "ps_overload", "circuit_open")}
    # every training task done once
    dispatched = {}
    for e in journal:
        if e["event"] == "task_dispatch":
            dispatched.setdefault(e["task"], e["type"])
    ok_reports = [e["task"] for e in journal
                  if e["event"] == "task_report" and e["ok"]]
    training = sorted(t for t, kind in dispatched.items()
                      if kind == "training")
    requeues = [e for e in journal if e["event"] in (
        "task_requeue", "worker_presumed_dead")]
    # the fleet view while the job ran
    statusz = [s for _, s in polls["statusz"]]
    fleet_roles = sorted({r for s in statusz for r in s.get("fleet", {})})
    worker_blobs = {}
    ps_rates = {"ps-0": [0.0, 0.0], "ps-1": [0.0, 0.0]}
    for snap in statusz:
        for role, entry in snap.get("fleet", {}).items():
            if role.startswith("worker-") and "tier_hits" in entry:
                worker_blobs[role] = entry
            if role in ps_rates:
                ps_rates[role][0] = max(ps_rates[role][0],
                                        entry.get("push_rate", 0.0))
                ps_rates[role][1] = max(ps_rates[role][1],
                                        entry.get("pull_rate", 0.0))
    limit_want = (torch.cuda.mem_get_info()[1] if device.type == "cuda"
                  else 1 << 30)
    hbm = {role: [e.get("hbm_bytes_in_use"), e.get("hbm_peak_bytes"),
                  e.get("hbm_limit_bytes")]
           for role, e in worker_blobs.items()}
    # each worker's tier counters after its last step against its stats
    w1_stats = _TIER_EXIT_RE.search(read_log("worker-1"))
    w1_stats = json.loads(w1_stats[2]) if w1_stats else None
    w1_metrics = w1_metrics if w1_status == 200 else None
    tier_check = {
        "worker-0": [tier_series(w0_metrics or ""),
                     w0_stats["hits"] + w0_stats["misses"]],
        "worker-1": [tier_series(w1_metrics) if w1_metrics else None,
                     (w1_stats["hits"] + w1_stats["misses"]) if w1_stats
                     else None],
    }
    # pushes: the PS servers' handled counters against the workers'
    # client counters
    push = dict(service="Pserver", method="push_gradients", code="OK")
    server_pushes = [series_value(text or "", "edl_grpc_server_handled_total",
                                  **push) for text in ps_metrics]
    client_pushes = [
        series_value(w0_metrics or "", "edl_grpc_client_handled_total",
                     **push),
        series_value(w1_metrics or "", "edl_grpc_client_handled_total",
                     **push)]
    # the traces: one training step's trace id in three roles
    traces, trace_bytes = {}, {}
    for name in sorted(os.listdir(trace_dir)):
        role = name.rsplit("-", 1)[0]
        traces[role] = read_trace(os.path.join(trace_dir, name))
        trace_bytes[role] = os.path.getsize(os.path.join(trace_dir, name))
    by_trace = {}
    for role, spans in traces.items():
        for e in spans:
            tid = e.get("args", {}).get("trace_id")
            if tid:
                by_trace.setdefault(tid, set()).add((role, e["name"]))
    roots = {e["args"]["trace_id"] for e in traces.get("worker-0", [])
             if e.get("name") == "train_batch" and e["args"].get("trace_id")}
    three = sorted(
        tid for tid in roots
        if any(r == "master" and n.startswith("Master/")
               for r, n in by_trace[tid])
        and any(r.startswith("ps-") and n.startswith("Pserver/")
                for r, n in by_trace[tid]))
    journal_bytes, role_events = {}, {}
    for name in sorted(os.listdir(events_dir)):
        if name.endswith(".events.ndjson"):
            role = name.rsplit("-", 1)[0]
            path = os.path.join(events_dir, name)
            journal_bytes[role] = os.path.getsize(path)
            role_events[role] = [e["event"] for e in read_journal(path)]
    evaluations = [[int(v), float(auc)]
                   for v, auc in _EVAL_RE.findall(read_log("master"))]
    steps = counts["steps"]
    warm = [s[0] for s in steps[10:]] or [s[0] for s in steps]
    losses = [s[1] for s in steps]
    record.update({
        "job_wall_s": job_s, "master_rc": master_rc,
        "worker1_rc": worker1_rc, "ps_exit_codes": ps_codes,
        "stopped_s": cont_t - stop_t,
        "alerts_seen": seen, "alerts_during_stop": during[-1:] if during
        else [],
        "alert_transitions": [(e["event"], e["alert"], e["target"],
                               e["ts"] - stop_t)
                              for e in raised + cleared],
        "dead_air_raised_after_stop_s": (dead_air_raised[0]["ts"] - stop_t
                                         if dead_air_raised else None),
        "dead_air_cleared_after_cont_s": next(
            (e["ts"] - cont_t for e in cleared
             if e["alert"] == "dead_air"), None),
        "alerts_total": {k: v for k, v in alerts_total.items() if v},
        "requeues_or_deaths": requeues,
        "training_tasks": len(training), "dataset_records": records,
        "done_ok_reports": len(ok_reports),
        "done_exactly_once": sorted(t for t in ok_reports
                                    if t in training) == training,
        "fleet_roles": fleet_roles,
        "worker_hbm_in_use_peak_limit": hbm, "hbm_limit_want": limit_want,
        "worker_tier_hits_misses": {r: [e["tier_hits"], e["tier_misses"]]
                                    for r, e in worker_blobs.items()},
        "ps_max_push_pull_rates": ps_rates,
        "tier_series_vs_stats": tier_check,
        "worker1_last_scrape_status": w1_status,
        "server_pushes": server_pushes, "client_pushes": client_pushes,
        "steps_traced": len(roots), "traces_in_three_roles": len(three),
        "trace_bytes": trace_bytes, "journal_bytes": journal_bytes,
        "evaluations": evaluations, "auc_floor": JOB_AUC_FLOOR,
        "worker0_steps": len(steps), "worker0_version": worker0.model_version,
        "worker0_steps_per_s": len(warm) / sum(warm) if warm else None,
        "worker0_steps_per_s_phase9": job_steps_per_s,
        "all_finite": bool(np.isfinite(losses).all()) if losses else False,
        "launches": launches,
        "launches_per_step": {k: v / max(len(steps), 1)
                              for k, v in launches.items()},
        "launch_formula_mismatches": counts["bad_steps"][:5],
    })
    log(json.dumps(record))
    failures = []
    if master_rc != 0 or worker1_rc != 0 or ps_codes != [0, 0]:
        failures.append("exit codes: master %s, worker 1 %s, PS %s"
                        % (master_rc, worker1_rc, ps_codes))
    if not during or not all(
            [(a["alert"], a.get("role")) for a in alerts]
            == [("dead_air", "worker-1")] for alerts in during):
        failures.append("/alerts during the stop: %s" % during[-3:])
    if seen != [("dead_air", "worker-1")]:
        failures.append("alerts seen over the job: %s" % seen)
    if ([(e["event"], e["alert"], e["target"]) for e in raised + cleared]
            != [("alert_raised", "dead_air", "1"),
                ("alert_cleared", "dead_air", "1")]
            or not raised[0]["ts"] < cleared[0]["ts"]
            or record["alerts_total"] != {"dead_air": 1.0}):
        failures.append("the master's alert transitions %s"
                        % record["alert_transitions"])
    if requeues:
        failures.append("tasks requeued or workers presumed dead: %s"
                        % requeues[:3])
    if not record["done_exactly_once"] or not training:
        failures.append("%d training tasks, done once: %s"
                        % (len(training), record["done_exactly_once"]))
    if not {"worker-0", "worker-1", "ps-0", "ps-1"} <= set(fleet_roles) or (
            set(worker_blobs) != {"worker-0", "worker-1"}):
        failures.append("/statusz roles %s, worker blobs %s"
                        % (fleet_roles, sorted(worker_blobs)))
    for role, (in_use, peak, limit) in hbm.items():
        if device.type == "cuda" and not (in_use > 0 and peak >= in_use
                                          and limit == limit_want):
            failures.append("%s HBM in use %s, peak %s, limit %s (want "
                            "%s)" % (role, in_use, peak, limit, limit_want))
        if device.type != "cuda" and not (in_use == 0
                                          and limit == limit_want):
            failures.append("%s on the CPU: in use %s, limit %s"
                            % (role, in_use, limit))
    for role, entry in worker_blobs.items():
        if not entry["tier_hits"] + entry["tier_misses"] > 0:
            failures.append("%s tier hits %s misses %s" % (
                role, entry["tier_hits"], entry["tier_misses"]))
    if not all(push_rate > 0 and pull_rate > 0
               for push_rate, pull_rate in ps_rates.values()):
        failures.append("PS push/pull rates %s" % ps_rates)
    for role, (series, stats) in tier_check.items():
        if series is None or series != stats:
            failures.append("%s tier series %s, stats at exit %s"
                            % (role, series, stats))
    if not sum(client_pushes) > 0 or sum(server_pushes) != sum(
            client_pushes):
        failures.append("pushes: PS servers %s, worker clients %s"
                        % (server_pushes, client_pushes))
    if not three:
        failures.append("no training step's trace reached the master and "
                        "a PS (%d steps traced)" % len(roots))
    for role in ("master", "ps-0", "ps-1", "worker-1"):
        kinds = role_events.get(role, [])
        if "role_start" not in kinds or "role_stop" not in kinds:
            failures.append("%s's journal: %s" % (role, kinds[:3] + ["..."]
                                                  + kinds[-3:]))
    if not evaluations or any(auc < JOB_AUC_FLOOR for _, auc in evaluations):
        failures.append("evaluations %s (floor %s)"
                        % (evaluations, JOB_AUC_FLOOR))
    if counts["bad_steps"] or min(launches.values()) <= 0 or (
            not record["all_finite"]):
        failures.append("worker 0's K1-K3 launches do not follow the "
                        "path, or a loss is not finite: %s"
                        % counts["bad_steps"][:5])
    if failures:
        raise SystemExit("telemetry phase: " + "; ".join(failures))
    return record


def serve_callers(port, seq, vocab, warmup, requests, seed):
    """The callers of ``telemetry_serve``, in a process of their own:
    ``warmup`` concurrent requests, "warm" on stdout, then on a line
    from stdin ``requests`` concurrent requests; prints one JSON line:
    every answer's (step, shape, finite) in order (None where it
    failed) and the errors. Each answer is checked where it arrives
    (64 held answers would be 4 GB at the zoo widths)."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.serve.client import ServeClient

    tokens = np.random.default_rng(seed).integers(
        0, vocab, size=(warmup + requests, seq), dtype=np.int32)
    answers, errors = [None] * (warmup + requests), []

    def one(i):
        try:
            with ServeClient("localhost:%d" % port) as client:
                outputs, step, _ = client.predict(tokens[i:i + 1],
                                                  deadline_secs=600)
            out = outputs["output"]
            answers[i] = (step, list(out.shape),
                          bool(torch.isfinite(out.float()).all()))
        except Exception as e:  # reported to the parent
            errors.append(repr(e))

    def burst(first, count):
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(first, first + count)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)

    burst(0, warmup)
    print("warm", flush=True)
    sys.stdin.readline()
    burst(warmup, requests)
    print(json.dumps({"answers": answers, "errors": errors}), flush=True)


SERVE_CALLER_CHILD = ("import chip_smoke; "
                      "chip_smoke.serve_callers(%d, %d, %d, %d, %d, %d)")


def telemetry_serve(torch, np, flash, workdir, device="cuda", widths=None,
                    seq=1024, requests=TELEMETRY_SERVE_REQUESTS,
                    export_dir=None, out_dir=None):
    """Phase 13, serving: the serve phase's TransformerLM ``ServeRole``
    (K4 in every batch) with a metrics port, the events journal and a
    trace of every request. One warm-up batch of TELEMETRY_SERVE_BATCH
    concurrent requests goes first and is left out of the split; then
    ``requests`` concurrent requests. Checks (a failure raises
    SystemExit): ``/readyz`` answers 503 before the model loads and 200
    after, ``/healthz`` 200; every request is answered (finite, the
    model's shape); ``edl_serve_requests_total{code="OK"}`` equals the
    requests sent; K4 launched once a layer for every batch of the
    measured burst; the trace holds a ``serve_predict`` root for every
    request and the batcher's ``serve_batch_assemble`` and
    ``serve_batch_run`` spans for every batch, and every measured
    request's part of the split; the journal has ``role_start``,
    ``model_loaded``, ``trace_flushed``, ``serve_drained`` and
    ``role_stop``. Prints the medians of a request's time by part
    (queue wait, batch assembly, forward, reply) over the measured
    burst. ``export_dir`` reuses the serve phase's export; without it
    one is written."""
    from elasticdl_tpu_torch.common.grpc_utils import (
        find_free_port,
        reserve_port,
    )
    from elasticdl_tpu_torch.observability import events, metrics, trace
    from elasticdl_tpu_torch.serve.main import ServeRole, parse_serve_args
    from elasticdl_tpu_torch.train.export import export_state_dict

    widths = dict(ZOO_WIDTHS if widths is None else widths)
    model_params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    rng = np.random.default_rng(SEED + 13)
    if export_dir is None:
        export_dir = os.path.join(workdir, "telemetry_export")
        export_state_dict(zoo_weights(np, rng, **widths), export_dir, step=1)
    out = out_dir or os.path.join(HERE, "build", "chip_smoke_telemetry_serve")
    shutil.rmtree(out, ignore_errors=True)
    events_dir, trace_dir = (os.path.join(out, "events"),
                             os.path.join(out, "traces"))
    obs_env = {"EDL_METRICS": "1", "EDL_EVENTS_DIR": events_dir,
               "EDL_TRACE_DIR": trace_dir, "EDL_TRACE_SAMPLE": "1"}
    saved_env = {k: os.environ.get(k) for k in obs_env}
    reservation, mport = reserve_port()
    port = find_free_port()
    base = "http://localhost:%d" % mport
    role = None
    record = {"telemetry": "serve", "requests": requests}
    try:
        os.environ.update(obs_env)
        metrics.reset_default_registry()
        role = ServeRole(parse_serve_args([
            "--model_zoo", ZOO, "--model_params", model_params,
            "--export_dir", export_dir, "--port", str(port),
            "--device", device, "--compute_dtype", "bfloat16",
            "--max_batch", str(TELEMETRY_SERVE_BATCH),
            "--max_delay_ms", "200",
            "--deadline_ms", "600000", "--watch_secs", "3600",
            "--metrics_port", str(mport)]))
        role.start_observability()
        ready_before = scrape(base + "/readyz")[0]
        health = scrape(base + "/healthz")[0]
        t0 = time.monotonic()
        role.prepare()
        record["load_s"] = time.monotonic() - t0
        ready_after = scrape(base + "/readyz")[0]
        vocab = widths["vocab_size"]
        warmup = TELEMETRY_SERVE_BATCH
        # the callers are another process, as a server's are: in this
        # one they would take the server's GIL to deserialize their
        # answers, and the split would time them. They trace nothing.
        caller_env = {k: v for k, v in os.environ.items()
                      if k not in obs_env}
        caller = subprocess.Popen(
            [sys.executable, "-c", SERVE_CALLER_CHILD % (
                port, seq, vocab, warmup, requests, SEED + 13)],
            cwd=HERE, env=dict(caller_env, PYTHONPATH=HERE),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            said = caller.stdout.readline().strip()
            if said != "warm":
                raise SystemExit("the callers' warm-up burst: %r" % said)
            batches_before = role.engine.batcher.batches_total
            reset_launches(flash)  # the measured burst's count starts here
            t0 = time.monotonic()
            caller.stdin.write("go\n")
            caller.stdin.flush()
            result = json.loads(caller.stdout.readline() or "{}")
            record["burst_s"] = time.monotonic() - t0
            caller.wait(timeout=60)
        finally:
            if caller.poll() is None:
                caller.kill()
                caller.wait()
        answers = [tuple(a) if a else None
                   for a in result.get("answers", [None])]
        errors = result.get("errors", ["the callers said nothing"])
        launches = flash.LAUNCHES
        batches = role.engine.batcher.batches_total - batches_before
        status, served_metrics = scrape(base + "/metrics")
        served_ok = series_value(served_metrics or "",
                                 "edl_serve_requests_total", code="OK")
    finally:
        if role is not None:
            role.drain(reason="smoke_done")
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        events.configure("chip_smoke")
        trace.configure("chip_smoke")
        metrics.reset_default_registry()
        reservation.close()
    spans = []
    for name in sorted(os.listdir(trace_dir)):
        spans += [e for e in read_trace(os.path.join(trace_dir, name))
                  if e.get("ph") == "X"]
    names = [e["name"] for e in spans]
    split, measured = serving_split(np, spans, first_batch=batches_before)
    kinds = []
    for name in sorted(os.listdir(events_dir)):
        if name.endswith(".events.ndjson"):
            kinds += [e["event"] for e in read_journal(
                os.path.join(events_dir, name))]
    record.update({
        "readyz_before_load": ready_before, "readyz_after_load": ready_after,
        "healthz": health, "served_ok_counter": served_ok,
        "batches": batches, "flash_launches": launches,
        "predict_spans": names.count("serve_predict"),
        "batch_run_spans": names.count("serve_batch_run"),
        "batch_assemble_spans": names.count("serve_batch_assemble"),
        "warmup_requests": warmup, "warmup_batches": batches_before,
        "split_ms_median": split, "split_requests": measured,
        "journal": kinds,
        "trace_bytes": sum(os.path.getsize(os.path.join(trace_dir, n))
                           for n in os.listdir(trace_dir)),
    })
    log(json.dumps(record))
    failures = []
    if (ready_before, ready_after, health) != (503, 200, 200):
        failures.append("/readyz %s before the load and %s after, /healthz "
                        "%s" % (ready_before, ready_after, health))
    if errors or any(a is None for a in answers):
        failures.append("requests failed: %s" % errors[:3])
    else:
        for i, (step, shape, finite) in enumerate(answers):
            if step != 1 or tuple(shape) != (1, seq, vocab) or not finite:
                failures.append("bad answer %d: %s step %d finite %s"
                                % (i, shape, step, finite))
    if served_ok != warmup + requests:
        failures.append("edl_serve_requests_total{code=\"OK\"} %s, %d sent"
                        % (served_ok, warmup + requests))
    if launches <= 0 or launches != widths["num_layers"] * batches:
        failures.append("K4 launches %d over %d batches" % (launches,
                                                            batches))
    all_batches = batches_before + batches
    if (record["predict_spans"] != warmup + requests
            or record["batch_run_spans"] != all_batches
            or record["batch_assemble_spans"] != all_batches
            or measured != requests):
        failures.append("spans: %d serve_predict, %d serve_batch_run, %d "
                        "serve_batch_assemble for %d requests in %d batches, "
                        "%d of %d measured requests split"
                        % (record["predict_spans"], record["batch_run_spans"],
                           record["batch_assemble_spans"], warmup + requests,
                           all_batches, measured, requests))
    want = ["role_start", "model_loaded", "trace_flushed", "serve_drained",
            "role_stop"]
    if [k for k in kinds if k in want] != want:
        failures.append("the serve journal %s" % kinds)
    if failures:
        raise SystemExit("telemetry phase (serve): " + "; ".join(failures))
    record["launches"] = launches
    return record


FLEET_SEQ = 256                # tokens a request: 256 x 32000 bf16 logits
FLEET_MAX_BATCH = 8
FLEET_CALLERS = 8              # concurrent closed-loop callers
FLEET_KEYS = 64                # affinity keys 1-64; every 8th request key 0
FLEET_KEY0_EVERY = 8
FLEET_BURST = 64               # requests of each timed burst
FLEET_WAIT_S = 300
# the replica heartbeat's period, and the deadline of one heartbeat RPC
# (serve/main.py's heartbeat loop). A replica whose heartbeat RPC hangs
# until its deadline goes silent for a period, the deadline and another
# period before its next heartbeat lands, so the router's replica
# timeout is those 7 s and 1 s of margin. It was 15 s, the reference
# fleet smoke's; every second of it is a second from the kill to the
# replacement
FLEET_HEARTBEAT_S = 1
FLEET_HEARTBEAT_RPC_S = 5
FLEET_REPLICA_TIMEOUT_S = 2 * FLEET_HEARTBEAT_S + FLEET_HEARTBEAT_RPC_S + 1
# closed-loop traffic runs this long before the kill: the callers start
# at once, so a second is tens of requests in flight on every replica
FLEET_LOOP_BEFORE_KILL_S = 1.0
# the fleet clocks of the reference's fleet smoke but for the replica
# timeout above; the scale cooldown outlasts a replica's cold start on
# the card (no spawn storm)
FLEET_ENV = {
    "EDL_ROUTER_HEARTBEAT_SECS": str(FLEET_HEARTBEAT_S),
    "EDL_ROUTER_REPLICA_TIMEOUT_SECS": str(FLEET_REPLICA_TIMEOUT_S),
    "EDL_CANARY_FRACTION": "0.5",
    "EDL_CANARY_MIN_REQUESTS": "15",
    "EDL_CANARY_TIMEOUT_SECS": "600",
    "EDL_SERVE_SCALE_COOLDOWN_SECS": "30",
}
# the poisoned export: ln_f's bias 1 and lm_head + 0.5 / d lift every
# logit by 0.5 (LayerNorm's centred part sums to 0 over d), so the
# judge's clipped per-request mean moves from bin 0 to bin 5
FLEET_POISON_SHIFT = 0.5
_SPAWN_RE = re.compile(r"spawned serve replica pid=(\d+) port=(\d+)")

# counts K4 inside each replica process from this script's side: the
# router's replicas inherit PYTHONPATH, and this sitecustomize, in a
# process started as elasticdl_tpu_torch.serve.main only, wraps
# ServingModel.predict (one forward each) and reads the wrapper's
# LAUNCHES beside it whenever no forward is in flight, holding its lock
# only around the counts, never across a forward; on the CPU, where the
# wrapper counts nothing, it wraps flash_attention_fwd to count as the
# card's wrapper does
K4_HOOK = '''\
import json, os, sys, threading, time

_dir = os.environ.get("EDL_SMOKE_K4_DIR")
if _dir and "elasticdl_tpu_torch.serve.main" in sys.orig_argv:
    from elasticdl_tpu_torch.ops import flash_attention as _flash
    from elasticdl_tpu_torch.serve import model as _model

    if os.environ.get("EDL_SMOKE_K4_CPU") == "1":
        _fwd = _flash.flash_attention_fwd

        def _counting_fwd(q, *a, **k):
            if q.device.type == "cpu":
                _flash.LAUNCHES += 1
            return _fwd(q, *a, **k)

        _flash.flash_attention_fwd = _counting_fwd
    _lock = threading.Lock()
    # forwards in flight, forwards done, and (forwards, launches) as of
    # the last moment no forward was in flight
    _state = {"inflight": 0, "forwards": 0, "quiet": None}
    _predict = _model.ServingModel.predict

    def _counted(self, features, rows):
        with _lock:
            _state["inflight"] += 1
        done = False
        try:
            out = _predict(self, features, rows)
            done = True
            return out
        finally:
            with _lock:
                _state["inflight"] -= 1
                _state["forwards"] += done
                if not _state["inflight"]:
                    _state["quiet"] = (_state["forwards"], _flash.LAUNCHES)

    _model.ServingModel.predict = _counted

    def _report():
        path = os.path.join(_dir, "k4-%d.json" % os.getpid())
        last = None
        while True:
            time.sleep(0.2)
            with _lock:
                now = _state["quiet"]
            if now != last and now[0]:
                with open(path + ".tmp", "w") as f:
                    json.dump({"pid": os.getpid(), "forwards": now[0],
                               "launches": now[1]}, f)
                os.replace(path + ".tmp", path)
                last = now

    threading.Thread(target=_report, daemon=True).start()
'''


def fleet_callers(seq, vocab, seed):
    """The callers of ``fleet_phase``, in a process of their own. Reads
    one JSON command a line from stdin and answers each with one JSON
    line: ``burst`` sends ``keys`` as requests from ``concurrency``
    callers to ``addr`` and answers every request's latency and the
    errors; ``start`` starts ``concurrency`` closed-loop callers to
    ``addr`` (affinity keys cycling over 1..``keys``, every
    ``key0_every``-th request key 0); ``stop`` stops them and answers
    every request's (start, end, key, status, step). Every answer is
    checked where it arrives: the model's shape, finite logits."""
    import numpy as np
    import torch

    from elasticdl_tpu_torch.serve.client import ServeClient

    tokens = np.random.default_rng(seed).integers(
        0, vocab, size=(256, seq), dtype=np.int32)
    lock = threading.Lock()

    def request(client, i, key):
        t0 = time.time()
        try:
            outputs, step, _ = client.predict(
                tokens[i % len(tokens)][None], deadline_secs=600,
                affinity_key=key)
            out = outputs["output"]
            if (tuple(out.shape) != (1, seq, vocab)
                    or not bool(torch.isfinite(out.float()).all())):
                return (t0, time.time(), key, "BAD_ANSWER", step)
            return (t0, time.time(), key, "OK", step)
        except Exception as e:  # reported to the parent
            code = getattr(e, "code", None)
            name = code().name if callable(code) else repr(e)
            return (t0, time.time(), key, name, -1)

    def burst(addr, keys, concurrency):
        records, todo = [], list(enumerate(keys))

        def caller():
            with ServeClient(addr) as client:
                while True:
                    with lock:
                        if not todo:
                            return
                        i, key = todo.pop(0)
                    rec = request(client, i, key)
                    with lock:
                        records.append(rec)

        threads = [threading.Thread(target=caller)
                   for _ in range(concurrency)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        return {"seconds": time.time() - t0, "records": records}

    loop = {"stop": threading.Event(), "records": [], "threads": []}

    def looper(addr, c, keys, key0_every):
        n = c
        with ServeClient(addr) as client:
            while not loop["stop"].is_set():
                key = 0 if n % key0_every == 0 else 1 + n % keys
                rec = request(client, n, key)
                with lock:
                    loop["records"].append(rec)
                n += len(loop["threads"])

    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["op"] == "burst":
            answer = burst(cmd["addr"], cmd["keys"], cmd["concurrency"])
        elif cmd["op"] == "start":
            loop["threads"] = [threading.Thread(target=looper, args=(
                cmd["addr"], c, cmd["keys"], cmd["key0_every"]))
                for c in range(cmd["concurrency"])]
            for t in loop["threads"]:
                t.start()
            answer = {"started": len(loop["threads"])}
        elif cmd["op"] == "stop":
            loop["stop"].set()
            for t in loop["threads"]:
                t.join(timeout=900)
            answer = {"records": loop["records"]}
        else:
            return
        print(json.dumps(answer), flush=True)


FLEET_CALLER_CHILD = ("import chip_smoke; "
                      "chip_smoke.fleet_callers(%d, %d, %d)")


def kill_if_replica(pid):
    """SIGKILL ``pid`` if it is still a ``serve.main`` replica (a pid of
    an exited replica may belong to another process by now)."""
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            if b"elasticdl_tpu_torch.serve.main" not in f.read():
                return
        os.kill(pid, signal.SIGKILL)
    except OSError:
        pass


def latency_ms(np, records):
    """p50 / p99 / count of (start, end, ...) records, in ms."""
    lat = np.array([1000.0 * (r[1] - r[0]) for r in records])
    if not len(lat):
        return {"n": 0}
    return {"n": int(len(lat)), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def poisoned(np, flat):
    """``flat`` with every logit lifted by FLEET_POISON_SHIFT."""
    dim = flat["ln_f/bias"].shape[0]
    out = dict(flat)
    out["ln_f/bias"] = np.ones(dim, np.float32)
    out["lm_head/kernel"] = flat["lm_head/kernel"] + np.float32(
        FLEET_POISON_SHIFT / dim)
    return out


def fleet_phase(torch, np, flash, device="cuda", widths=None,
                seq=FLEET_SEQ, callers=FLEET_CALLERS, burst=FLEET_BURST,
                fleet_env=None, wait_s=FLEET_WAIT_S, out_dir=None):
    """Phase 14, the serving fleet: ``router_main`` a process of its own
    with ``--min_replicas 2 --max_replicas 3`` over a versioned export
    root, its ``SubprocessReplicaScaler`` spawning port ``serve.main``
    replicas (``--device``, bf16, ``--max_batch 8``) of the zoo
    TransformerLM; the callers a process of their own. In order:
    spin-up (two replicas register and load v1; one answer through the
    router held against an in-process ``ServingModel`` of v1 that
    launches K4 once a layer; a burst over keys 1-64 lands on each
    replica as the ring says; one replica's keys timed as four bursts,
    through the router, direct to it, direct, through the router); then
    closed-loop traffic from ``callers`` callers throughout: one
    replica SIGKILLed (zero failed requests, ``replica_lost``
    journaled, the floor's replacement registers and serves, only the
    victim's keys move on the ring); a v2 export (the same weights,
    step + 7) promoted by the canary and loaded by every replica; a
    poisoned v3 rolled back and never retried. Then the router drains
    on SIGTERM (its replicas deregister) and exits 0. Checks also: no
    request failed; every scale and canary decision journaled with
    reasons; in every replica process K4 launched once a layer for
    every forward. Raises SystemExit on a failure; returns the record
    it logs."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.common.hash_utils import stable_u64
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.serve.client import ServeClient
    from elasticdl_tpu_torch.serve.model import ServingModel, export_signature
    from elasticdl_tpu_torch.serve.router import HashRing
    from elasticdl_tpu_torch.train.export import export_state_dict

    split, stage = stage_clock()  # the phase's seconds stage by stage
    widths = dict(ZOO_WIDTHS if widths is None else widths)
    model_params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    layers, vocab = widths["num_layers"], widths["vocab_size"]
    out = out_dir or os.path.join(HERE, "build", "chip_smoke_fleet")
    shutil.rmtree(out, ignore_errors=True)
    root, logs, events_dir, k4_dir, hook_dir = (
        os.path.join(out, name)
        for name in ("exports", "replicas", "events", "k4", "k4hook"))
    for d in (root, logs, events_dir, k4_dir, hook_dir):
        os.makedirs(d)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(K4_HOOK)
    flat = zoo_weights(np, np.random.default_rng(SEED + 14), **widths)
    v1, v2, v3 = (os.path.join(root, "v%05d" % i) for i in (1, 2, 3))
    export_state_dict(flat, v1, step=1)
    stamp1 = export_signature(v1)
    stage("weights_and_v1")

    rport, mport = find_free_port(), find_free_port()
    router_addr = "localhost:%d" % rport
    base = "http://localhost:%d" % mport
    env = dict(os.environ, **(fleet_env or FLEET_ENV))
    env.update({"EDL_EVENTS_DIR": events_dir, "EDL_SMOKE_K4_DIR": k4_dir,
                "PYTHONPATH": os.pathsep.join([hook_dir, HERE]),
                "EDL_SMOKE_K4_CPU": "1" if device == "cpu" else "0"})
    replica_args = (
        "--model_zoo %s --model_params %s --device %s "
        "--compute_dtype bfloat16 --max_batch %d --max_delay_ms 5 "
        "--deadline_ms 600000 --watch_secs 0.5"
        % (ZOO, model_params, device, FLEET_MAX_BATCH))
    router_log = open(os.path.join(out, "router.log"), "w")
    t_spawn = time.time()
    router = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serve.router_main",
         "--port", str(rport), "--min_replicas", "2",
         "--max_replicas", "3", "--export_root", root,
         "--replica_args", replica_args, "--replica_log_dir", logs,
         "--metrics_port", str(mport)],
        cwd=HERE, env=env, stdout=router_log, stderr=subprocess.STDOUT)
    caller_env = {k: v for k, v in os.environ.items()
                  if not k.startswith("EDL_")}
    caller = subprocess.Popen(
        [sys.executable, "-c", FLEET_CALLER_CHILD % (seq, vocab, SEED + 14)],
        cwd=HERE, env=dict(caller_env, PYTHONPATH=HERE),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    record = {"fleet": "zoo TransformerLM", "seq": seq,
              "callers": callers, "device": device}
    failures = []

    def command(**cmd):
        caller.stdin.write(json.dumps(cmd) + "\n")
        caller.stdin.flush()
        line = caller.stdout.readline()
        if not line:
            raise SystemExit("fleet phase: the callers' process died")
        return json.loads(line)

    heartbeat_ages = {}  # replica -> the largest heartbeat age seen

    def routerz():
        status, body = scrape(base + "/routerz")
        if status != 200:
            return None
        state = json.loads(body)
        for rid, replica in state.get("replicas", {}).items():
            heartbeat_ages[rid] = max(heartbeat_ages.get(rid, 0.0),
                                      replica["heartbeat_age"])
        return state

    def wait_for(cond, what):
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if router.poll() is not None:
                raise SystemExit("fleet phase: the router exited %s while "
                                 "waiting for %s" % (router.returncode,
                                                     what))
            state = routerz()
            if state is not None and cond(state):
                return state
            time.sleep(0.1)
        raise SystemExit("fleet phase: no %s within %d s (routerz %s)"
                         % (what, wait_s, json.dumps(routerz())[:2000]))

    def served_by(replica):
        status, text = scrape(base + "/metrics")
        return series_value(text or "", "edl_router_requests_total",
                            replica=replica, outcome="ok")

    def owners(members, keys):
        ring = HashRing()
        for rid in members:
            ring.add(rid)
        return {k: ring.lookup(stable_u64("k:%d" % k)) for k in keys}

    def all_loaded(export):
        return lambda s: len(s["replicas"]) >= 2 and all(
            r["loaded_export"] == export for r in s["replicas"].values())

    keys = list(range(1, FLEET_KEYS + 1))
    try:
        # -- spin-up ----------------------------------------------------
        state = wait_for(all_loaded(os.path.basename(v1)),
                         "two replicas registered with v1 loaded")
        record["spin_up_s"] = time.time() - t_spawn
        stage("spin_up")
        first = sorted(state["replicas"])
        model = ServingModel(get_model_spec(ZOO, model_params=model_params),
                             v1, max_batch=FLEET_MAX_BATCH,
                             compute_dtype="bfloat16", device=device)
        stage("in_process_model")
        tokens = np.random.default_rng(SEED + 14).integers(
            0, vocab, size=(256, seq), dtype=np.int32)
        with ServeClient(router_addr) as client:
            outputs, step, stamp = client.predict(
                tokens[:1], deadline_secs=600, affinity_key=1)
        stage("first_routed_answer")
        reset_launches(flash)
        want = model.predict(tokens[:1], 1)["output"].float()
        record["inprocess_k4_launches"] = flash.LAUNCHES
        if flash.LAUNCHES != layers:
            failures.append("the in-process ServingModel launched K4 %d "
                            "times for one batch" % flash.LAUNCHES)
        diff = (outputs["output"].float() - want).abs()
        record["vs_inprocess"] = {"max_abs": diff.max().item(),
                                  "mean_abs": diff.mean().item(),
                                  "tol_mean": SERVE_MEAN_TOL,
                                  "tol_max": SERVE_MAX_TOL}
        if (step != 1 or stamp != stamp1
                or record["vs_inprocess"]["mean_abs"] > SERVE_MEAN_TOL
                or record["vs_inprocess"]["max_abs"] > SERVE_MAX_TOL):
            failures.append("served answer %s step %d stamp %s against the "
                            "in-process model" % (record["vs_inprocess"],
                                                  step, stamp))
        del model, want, outputs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        stage("in_process_answer")
        # affinity: a burst over every key lands as the ring says
        ring_owner = owners(first, keys)
        before = {rid: served_by(rid) for rid in first}
        sticky = command(op="burst", addr=router_addr, keys=keys,
                         concurrency=callers)
        got = {rid: served_by(rid) - before[rid] for rid in first}
        want_n = {rid: sum(1 for k in keys if ring_owner[k] == rid)
                  for rid in first}
        record["affinity"] = {"served": got, "ring": want_n}
        if got != want_n:
            failures.append("affinity: replicas served %s, the ring says %s"
                            % (got, want_n))
        stage("affinity_burst")
        # the router's cost: one replica's keys through it and direct to
        # it, in the order via, direct, direct, via
        target = first[0]
        own = [k for k in keys if ring_owner[k] == target] or [1]
        burst_keys = [own[i % len(own)] for i in range(burst)]
        bursts = {"via_router": [], "direct": []}
        for route in ("via_router", "direct", "direct", "via_router"):
            addr = (router_addr if route == "via_router"
                    else state["replicas"][target]["addr"])
            bursts[route].append(command(op="burst", addr=addr,
                                         keys=burst_keys,
                                         concurrency=callers))
        for route, runs in bursts.items():
            record["burst_" + route] = [
                dict(latency_ms(np, b["records"]), seconds=b["seconds"])
                for b in runs]
        spin_errors = [r for b in [sticky] + sum(bursts.values(), [])
                       for r in b["records"] if r[3] != "OK"]
        if spin_errors:
            failures.append("spin-up requests failed: %s" % spin_errors[:3])
        stage("router_cost_bursts")

        # -- SIGKILL one replica mid-traffic -------------------------------
        command(op="start", addr=router_addr, keys=FLEET_KEYS,
                key0_every=FLEET_KEY0_EVERY, concurrency=callers)
        time.sleep(FLEET_LOOP_BEFORE_KILL_S)
        victim = first[0]
        t_kill = time.time()
        os.kill(int(victim.rsplit("-", 1)[1]), signal.SIGKILL)
        state = wait_for(
            lambda s: victim not in s["replicas"] and len(s["replicas"]) >= 2
            and all(r["loaded_stamp"] for r in s["replicas"].values()),
            "replacement of the killed replica")
        now_members = sorted(state["replicas"])
        newcomer = [r for r in now_members if r not in first]
        if device == "cuda":
            free, total = torch.cuda.mem_get_info()
            record["mem_after_replacement"] = {"free": free, "total": total}
        deadline = time.monotonic() + wait_s
        while newcomer and served_by(newcomer[0]) <= 0:
            if time.monotonic() > deadline:
                failures.append("the replacement served nothing")
                break
            time.sleep(0.1)
        record["kill_to_first_served_by_replacement_s"] = time.time() - t_kill
        stage("loop_kill_to_first_served")
        survivors = [r for r in first if r != victim]
        before_ring = owners(first, keys)
        without = owners(survivors, keys)
        with_new = owners(survivors + newcomer, keys)
        moved_out = [k for k in keys if before_ring[k] != without[k]]
        moved_in = [k for k in keys if without[k] != with_new[k]]
        record["ring_moves"] = {"victim_keys": len(moved_out),
                                "to_replacement": len(moved_in)}
        if (any(before_ring[k] != victim for k in moved_out)
                or any(with_new[k] not in newcomer for k in moved_in)
                or len(newcomer) != 1):
            failures.append("keys moved beyond the victim's: out %s in %s "
                            "newcomer %s" % (moved_out, moved_in, newcomer))

        # -- promote v2 -------------------------------------------------
        export_state_dict(flat, v2, step=8)
        stage("v2_export")
        t_v2 = time.time()
        stamp2 = export_signature(v2)
        wait_for(lambda s: s["canary"]["incumbent"]["stamp"] == stamp2,
                 "promotion of v2")
        wait_for(all_loaded(os.path.basename(v2)), "v2 loaded everywhere")
        record["v2_loaded_everywhere_s"] = time.time() - t_v2
        stage("v2_promoted_and_loaded")

        # -- roll back a poisoned v3 -------------------------------------
        export_state_dict(poisoned(np, flat), v3, step=9)
        stage("v3_export")
        t_v3 = time.time()
        stamp3 = export_signature(v3)
        wait_for(lambda s: stamp3 in s["canary"]["rejected"],
                 "rollback of the poisoned v3")
        state = wait_for(all_loaded(os.path.basename(v2)),
                         "v2 back everywhere after the rollback")
        record["v2_back_everywhere_s"] = time.time() - t_v3
        stage("v3_rolled_back")
        time.sleep(3.0)  # three heartbeats with v3 still the newest
        state = routerz()
        if state["canary"]["state"] != "idle":
            failures.append("the canary retried: %s" % state["canary"])
        stopped = command(op="stop")
        stage("no_retry_and_stop")
    finally:
        if caller.poll() is None:
            try:
                caller.stdin.close()
            except OSError:
                pass
            try:
                caller.wait(timeout=30)
            except subprocess.TimeoutExpired:
                caller.kill()
                caller.wait()
        if router.poll() is None:
            router.send_signal(signal.SIGTERM)
            try:
                router.wait(timeout=90)
            except subprocess.TimeoutExpired:
                router.kill()
                router.wait()
        router_log.close()
        # a replica the router failed to stop must not outlive the phase
        with open(os.path.join(out, "router.log")) as f:
            spawned = [int(m.group(1)) for m in _SPAWN_RE.finditer(f.read())]
        for pid in spawned:
            kill_if_replica(pid)
        stage("router_drain")
    # what the replica timeout has to cover: the longest silence the
    # script's polls saw of each replica (the victim's ends at its expiry)
    record["max_heartbeat_age_s"] = heartbeat_ages
    record["replica_timeout_s"] = float(
        (fleet_env or FLEET_ENV)["EDL_ROUTER_REPLICA_TIMEOUT_SECS"])
    record["router_rc"] = router.returncode
    if router.returncode != 0:
        failures.append("the router exited %s" % router.returncode)

    loop = stopped["records"]
    record["loop"] = latency_ms(np, loop)
    failed = [r for r in loop if r[3] != "OK"]
    record["failed_requests"] = len(failed)
    if failed or not loop:
        failures.append("%d of %d looped requests failed: %s"
                        % (len(failed), len(loop), failed[:3]))
    steps_seen = sorted({r[4] for r in loop})
    record["steps_served"] = steps_seen

    journal = []
    for name in sorted(os.listdir(events_dir)):
        if name.endswith(".events.ndjson"):
            journal += read_journal(os.path.join(events_dir, name))
    router_events = [e for e in journal if e["role"].startswith("router")]

    def of(kind, **match):
        return [e for e in router_events if e["event"] == kind
                and all(e.get(k) == v for k, v in match.items())]

    grows = of("scale_decision", direction="grow")
    registered = of("replica_registered")
    lost = of("replica_lost", replica=victim)
    record["journal"] = {
        "replica_registered": len(registered), "replica_lost": len(lost),
        "grows": [(e["delta"], e["reasons"]) for e in grows],
        "canary_started": len(of("canary_started")),
        "promoted": [e["reasons"] for e in of("canary_promoted")],
        "rolled_back": [e["reasons"] for e in of("canary_rolled_back")],
        "drain_acks": len(of("drain_ack")),
    }
    reg_new = [e for e in registered if e["replica"] in newcomer]
    if reg_new:
        record["kill_to_replacement_registered_s"] = reg_new[0]["ts"] - t_kill
    promoted = of("canary_promoted", stamp=stamp2)
    rolled = of("canary_rolled_back", stamp=stamp3)
    if promoted:
        record["v2_land_to_promotion_s"] = promoted[0]["ts"] - t_v2
    if rolled:
        record["v3_land_to_rollback_s"] = rolled[0]["ts"] - t_v3
    # a replica's cold start: its grow decision (the spawn) to its
    # registration
    cold = {}
    for e in registered:
        spawn = [g["ts"] for g in grows if g["ts"] <= e["ts"]]
        if spawn:
            cold[e["replica"]] = e["ts"] - spawn[-1]
    record["cold_start_s"] = cold
    # each cold start in three: the spawn to the replica's role_start
    # (interpreter, imports, the engine's set-up), to its model_loaded
    # (the export read, cast and moved to the device), to its
    # registration
    record["cold_start_split_s"] = cold_start_split(journal, grows,
                                                    registered)
    if not lost or len(reg_new) != 1:
        failures.append("replica_lost for the victim %d, replacement "
                        "registrations %d" % (len(lost), len(reg_new)))
    if (len(grows) < 2 or not all(e.get("reasons") for e in grows)
            or not any(str(r).startswith("below_floor")
                       for e in grows for r in e["reasons"])):
        failures.append("scale decisions: %s" % record["journal"]["grows"])
    if (len(promoted) != 1 or len(rolled) != 1
            or not promoted[0].get("reasons")
            or not rolled[0].get("reasons")
            or not any("drift" in r for r in rolled[0]["reasons"])
            or len(of("canary_started", stamp=stamp3)) != 1
            or len(of("canary_started", stamp=stamp2)) != 1):
        failures.append("canary decisions: %s" % record["journal"])
    # K4 in every replica that served: once a layer a forward
    k4 = []
    for name in sorted(os.listdir(k4_dir)):
        if name.endswith(".json"):
            with open(os.path.join(k4_dir, name)) as f:
                k4.append(json.load(f))
    record["replica_k4"] = k4
    record["replica_k4_launches"] = sum(r["launches"] for r in k4)
    if (len(k4) < 3 or any(r["launches"] != layers * r["forwards"]
                           or r["forwards"] <= 0 for r in k4)):
        failures.append("K4 in the replicas: %s" % k4)
    stage("journal_and_checks")
    record["split_s"] = split
    log(json.dumps(record))
    if failures:
        raise SystemExit("fleet phase: " + "; ".join(failures))
    return record


def cold_start_split(journal, grows, registered):
    """{replica: [spawn to role_start, role_start to model_loaded,
    model_loaded to registration]} in seconds, from the router's grow
    decisions and registrations and each replica's own journal (its
    pid is the replica id's suffix)."""
    split = {}
    for e in registered:
        spawn = [g["ts"] for g in grows if g["ts"] <= e["ts"]]
        pid = int(e["replica"].rsplit("-", 1)[1])
        own = {r["event"]: r["ts"] for r in journal if r.get("pid") == pid
               and r["event"] in ("role_start", "model_loaded")}
        if spawn and len(own) == 2:
            split[e["replica"]] = [own["role_start"] - spawn[-1],
                                   own["model_loaded"] - own["role_start"],
                                   e["ts"] - own["model_loaded"]]
    return split


def zoo_weights(np, rng, vocab_size, num_layers, num_heads, embed_dim):
    """Flax-named fp32 weights: kernels ~ N(0, 1/fan_in), embedding
    ~ N(0, 0.02^2), LayerNorm scale 1 and bias 0."""
    vocab, layers, heads, dim = vocab_size, num_layers, num_heads, embed_dim
    head_dim = dim // heads

    def normal(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            fan_in ** -0.5
        )

    flat = {
        "wte/embedding": rng.standard_normal((vocab, dim), dtype=np.float32)
        * np.float32(0.02),
        "ln_f/scale": np.ones(dim, np.float32),
        "ln_f/bias": np.zeros(dim, np.float32),
        "lm_head/kernel": normal((dim, vocab), dim),
    }
    for i in range(layers):
        b = "block_%d/" % i
        for ln in ("ln_attn", "ln_mlp"):
            flat[b + ln + "/scale"] = np.ones(dim, np.float32)
            flat[b + ln + "/bias"] = np.zeros(dim, np.float32)
        for proj in ("query", "key", "value"):
            flat[b + "attn/%s/kernel" % proj] = normal((dim, heads, head_dim), dim)
        flat[b + "attn/out_proj/kernel"] = normal((heads, head_dim, dim), dim)
        flat[b + "mlp_up/kernel"] = normal((dim, 4 * dim), dim)
        flat[b + "mlp_down/kernel"] = normal((4 * dim, dim), 4 * dim)
    return flat


def device_ms(torch, fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def serve_phase(torch, np, flash, workdir, device="cuda", widths=None,
                seq=1024):
    """The served burst and its checks; returns (launches, the served
    ServingModel, the plain-attention ServingModel, tokens)."""
    from elasticdl_tpu_torch.common.constants import GRPC
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.models.transformer import custom_model
    from elasticdl_tpu_torch.serve.client import ServeClient
    from elasticdl_tpu_torch.serve.main import ServeRole, parse_serve_args
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.train.export import export_state_dict

    widths = dict(ZOO_WIDTHS if widths is None else widths)
    model_params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    rng = np.random.default_rng(SEED)
    t0 = time.monotonic()
    flat = zoo_weights(np, rng, **widths)
    n_params = sum(a.size for a in flat.values())
    with torch.device("meta"):
        expected = sum(p.numel() for p in custom_model(**widths).parameters())
    if n_params != expected:
        raise SystemExit("weights hold %d parameters, the model %d"
                         % (n_params, expected))
    export_dir = os.path.join(workdir, "export")
    export_state_dict(flat, export_dir, step=1)
    del flat
    log("serve: %d parameters exported in %.1f s" % (
        n_params, time.monotonic() - t0))

    port = find_free_port()
    role = ServeRole(parse_serve_args([
        "--model_zoo", ZOO, "--model_params", model_params,
        "--export_dir", export_dir, "--port", str(port),
        "--device", device, "--compute_dtype", "bfloat16",
        "--max_batch", "8", "--max_delay_ms", "200",
        "--deadline_ms", "600000", "--watch_secs", "3600",
    ])).prepare()
    try:
        engine = role.engine
        if not engine.loaded:
            raise SystemExit("serve role did not load the export")
        vocab = widths["vocab_size"]
        # one answer is a bf16 (1, seq, vocab) tensor: 65.5 MB at the zoo
        # widths, which must fit one gRPC message
        answer_bytes = seq * vocab * 2
        if answer_bytes >= GRPC.MAX_RECEIVE_MESSAGE_LENGTH:
            raise SystemExit("a %d-byte answer exceeds the gRPC cap"
                             % answer_bytes)
        tokens = rng.integers(0, vocab, size=(8, seq), dtype=np.int32)
        answers = [None] * 8
        errors = []

        def one(i):
            try:
                with ServeClient("localhost:%d" % port) as client:
                    answers[i] = client.predict(
                        tokens[i:i + 1], deadline_secs=600
                    )
            except Exception as e:  # recorded and re-raised below
                errors.append(repr(e))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        batches_before = engine.batcher.batches_total
        reset_launches(flash)  # the serve path's count starts here
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        burst_s = time.monotonic() - t0
        launches = flash.LAUNCHES
        if flash.DQ_LAUNCHES or flash.DKV_LAUNCHES:
            raise SystemExit("serving launched backward kernels")
        batches = engine.batcher.batches_total - batches_before
        if errors or any(a is None for a in answers):
            raise SystemExit("serve requests failed: %s" % errors)
        log(json.dumps({
            "serve": "burst", "requests": 8, "seconds": burst_s,
            "batches": batches, "flash_launches": launches,
        }))
        layers = widths["num_layers"]
        if launches <= 0 or launches != layers * batches:
            raise SystemExit(
                "K4 launches %d over %d batches (want %d per batch)"
                % (launches, batches, layers)
            )

        model = engine.model
        served = []
        for i, (outputs, step, stamp) in enumerate(answers):
            out = outputs["output"]
            if (step != 1 or stamp != model.stamp
                    or tuple(out.shape) != (1, seq, vocab)
                    or out.dtype != torch.bfloat16
                    or not bool(torch.isfinite(out.float()).all())):
                raise SystemExit("bad answer %d: %s %s step %d" % (
                    i, tuple(out.shape), out.dtype, step))
            direct = model.predict(tokens[i:i + 1], 1)["output"]
            if not torch.equal(direct, out):
                raise SystemExit(
                    "answer %d differs from ServingModel.predict" % i)
            served.append(out)
        served = torch.cat(served).float()

        plain = ServingModel(
            get_model_spec(
                ZOO, model_params=model_params + ";attention_impl='xla'"
            ),
            export_dir, max_batch=8, compute_dtype="bfloat16", device=device,
        )
        reference = plain.predict(tokens, 8)["output"].float()
        diff = (served - reference).abs()
        agreement = {
            "serve": "vs_plain_attention", "max_abs": diff.max().item(),
            "mean_abs": diff.mean().item(),
            "ref_max_abs": reference.abs().max().item(),
            "argmax_agree": (served.argmax(-1) == reference.argmax(-1))
            .float().mean().item(),
            "tol_mean": SERVE_MEAN_TOL, "tol_max": SERVE_MAX_TOL,
        }
        log(json.dumps(agreement))
        if (agreement["mean_abs"] > SERVE_MEAN_TOL
                or agreement["max_abs"] > SERVE_MAX_TOL):
            raise SystemExit("served logits disagree with plain attention")
        return launches, model, plain, tokens
    finally:
        role.drain(reason="smoke_done")
        log("serve: drained, served %d, shed %d" % (
            role.engine.batcher.served_total, role.engine.batcher.shed_total))


def serve_timing(torch, model, plain, tokens):
    """Device time of one 8-row forward through the kernel model and the
    plain-attention model, and host time of one predict (pad, copies,
    forward)."""
    tokens_dev = torch.from_numpy(tokens).cuda()
    with torch.inference_mode():
        fwd_ms = device_ms(torch, lambda: model.model(tokens_dev))
        plain_fwd_ms = device_ms(torch, lambda: plain.model(tokens_dev))
    t0 = time.monotonic()
    model.predict(tokens, 8)
    predict_ms = (time.monotonic() - t0) * 1e3
    log(json.dumps({
        "serve": "timing", "batch_rows": int(tokens.shape[0]),
        "seq": int(tokens.shape[1]), "forward_ms": fwd_ms,
        "plain_attention_forward_ms": plain_fwd_ms,
        "predict_ms_host": predict_ms,
    }))
    serve_profile(torch, model, tokens_dev, fwd_ms)


def serve_profile(torch, model, tokens_dev, fwd_ms):
    """Device time by kernel over one 8-row forward (torch.profiler):
    K4's share inside the forward, where its inputs come warm from the
    projections, and the device's idle share against the forward's
    event-timed wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        model.model(tokens_dev)
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total_us = getattr(evt, "device_time_total", None)
        if total_us is None:
            total_us = evt.cuda_time_total
        kernels[evt.key] = (total_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    if busy_ms <= 0:
        log(json.dumps({"profile": "forward", "device_ms": "not measured"}))
        return
    flash_ms = sum(ms for key, (ms, _) in kernels.items() if "flash_fwd" in key)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    log(json.dumps({
        "profile": "forward", "device_busy_ms": busy_ms,
        "idle_share_vs_forward_ms": max(0.0, 1.0 - busy_ms / fwd_ms),
        "flash_ms": flash_ms, "flash_share": flash_ms / busy_ms,
        "top": [[key[:90], ms, n] for key, (ms, n) in top],
    }))


def model_train_flops(d, layers, seq, batch, vocab, mlp_ratio=4):
    """Matmul FLOPs of one train step, fwd + bwd = 3x fwd (the formula
    of scripts/bench_transformer_mfu.py:72-81)."""
    tokens = batch * seq
    proj = 2 * tokens * ((4 + 2 * mlp_ratio) * d * d) * layers
    attn = 2 * (2 * batch * seq * seq * d) * layers / 2
    head = 2 * tokens * d * vocab
    return 3 * (proj + attn + head)


def reset_launches(flash):
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0


def read_launches(flash):
    return {"fwd": flash.LAUNCHES, "dq": flash.DQ_LAUNCHES,
            "dkv": flash.DKV_LAUNCHES}


def first_step_agreement(torch, model, spec_plain, batch, device):
    """Loss and fp32 master gradients of the first step, from identical
    weights, through the kernel model ``model`` and the same model on
    plain attention (bf16 compute on both), one after the other."""
    from elasticdl_tpu_torch.train.optimizers import sgd
    from elasticdl_tpu_torch.train.step_fns import make_loss_and_grads
    from elasticdl_tpu_torch.train.train_state import create_train_state

    with torch.device(device):
        plain = spec_plain.custom_model()
    plain.load_state_dict(model.state_dict())
    tensors = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    results = []
    for net in (model, plain):
        state = create_train_state(net, sgd(0.0))
        loss, grads = make_loss_and_grads(
            net, spec_plain.loss, compute_dtype=torch.bfloat16)(
            state, tensors)
        results.append((loss.item(), grads))
        del state
    (loss_k, grads_k), (loss_p, grads_p) = results
    names = sorted(grads_p)
    rel = lambda a, b: ((a.double() - b.double()).norm()
                        / b.double().norm()).item()
    leaf_errs = {n: rel(grads_k[n], grads_p[n]) for n in names
                 if ".attn." in n}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    grad_k, grad_p = (torch.cat([g[n].reshape(-1) for n in names]).double()
                      for g in (grads_k, grads_p))
    cosine = (grad_k @ grad_p / (grad_k.norm() * grad_p.norm())).item()
    rel_l2 = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    del plain, results, grads_k, grads_p, grad_k, grad_p
    return {
        "train": "first_step_vs_plain_attention", "loss": loss_k,
        "plain_loss": loss_p, "loss_abs_diff": abs(loss_k - loss_p),
        "tol_loss": TRAIN_LOSS_TOL, "grad_cosine": cosine,
        "tol_grad_cosine": TRAIN_GRAD_COS, "grad_rel_l2": rel_l2,
        "attn_leaves": len(leaf_errs),
        "attn_leaf_worst_rel_l2": leaf_errs[worst_leaf],
        "attn_leaf_worst": worst_leaf,
        "attn_leaf_median_rel_l2": sorted(leaf_errs.values())[
            len(leaf_errs) // 2],
        "tol_attn_leaf_rel_l2": TRAIN_ATTN_LEAF_TOL,
    }


def hold_agreement(agreement, what):
    """Raise unless ``first_step_agreement``'s numbers are within
    TRAIN_LOSS_TOL, TRAIN_GRAD_COS and TRAIN_ATTN_LEAF_TOL."""
    if (agreement["loss_abs_diff"] > TRAIN_LOSS_TOL
            or not agreement["grad_cosine"] >= TRAIN_GRAD_COS
            or not agreement["attn_leaf_worst_rel_l2"] <= TRAIN_ATTN_LEAF_TOL):
        raise SystemExit("%s disagrees with plain attention" % what)


def train_phase(torch, np, flash, workdir, device="cuda", widths=None,
                seq=TRAIN_SEQ, batch=TRAIN_BATCH, steps=TRAIN_STEPS):
    """The train path and its checks; returns what the timing needs."""
    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.train.export import export_train_state
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    widths = dict(ZOO_WIDTHS if widths is None else widths)
    model_params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    layers, vocab = widths["num_layers"], widths["vocab_size"]
    rng = np.random.default_rng(SEED + 2)
    tokens = rng.integers(0, vocab, size=(steps * batch, seq), dtype=np.int32)
    data_dir = os.path.join(workdir, "train_data")
    os.makedirs(data_dir)
    recordio.write_records(os.path.join(data_dir, "part-0.rec"),
                           [encode_example({"tokens": t}) for t in tokens])
    first = {"features": tokens[:batch], "labels": tokens[:batch],
             "_mask": np.ones(batch, np.float32)}

    executor = LocalExecutor(
        ZOO, training_data=data_dir, minibatch_size=batch,
        compute_dtype="bfloat16", seed=SEED, model_params=model_params,
        device=device,
    )
    trainer = executor.trainer
    agreement = first_step_agreement(
        torch, trainer.model,
        get_model_spec(ZOO, model_params=model_params
                       + ";attention_impl='xla'"),
        first, device)
    log(json.dumps(agreement))
    hold_agreement(agreement, "first train step")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    reset_launches(flash)  # the train path's count starts here
    t0 = time.monotonic()
    losses = executor.train()
    train_s = time.monotonic() - t0
    launches = read_launches(flash)
    record = {
        "train": "local_executor", "steps": len(losses), "seconds": train_s,
        "losses": losses, "launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if device == "cuda" else "not measured"),
    }
    log(json.dumps(record))
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise SystemExit("train losses: %s" % losses)
    for name, count in launches.items():
        if count != layers * steps:
            raise SystemExit("%s launches %d over %d steps (want %d a step)"
                             % (name, count, steps, layers))

    state = executor.state
    repeated = []
    for _ in range(REPEAT_STEPS):
        state, loss = trainer.train_step(state, first)
        repeated.append(float(loss))
    log(json.dumps({"train": "repeated_batch", "losses": repeated}))
    if not repeated[-1] < repeated[0]:
        raise SystemExit("loss did not fall on a repeated batch")

    export_dir = os.path.join(workdir, "train_export")
    export_train_state(state, export_dir)
    served = ServingModel(
        get_model_spec(ZOO, model_params=model_params), export_dir,
        max_batch=batch, compute_dtype="bfloat16", device=device,
    ).predict(first["features"], batch)["output"].float().numpy()
    evaluated = trainer.eval_step(state, first)
    diff = np.abs(served - evaluated)
    served_check = {
        "train": "export_served_vs_eval_step", "step": state.step,
        "shape": list(served.shape), "max_abs": float(diff.max()),
        "mean_abs": float(diff.mean()), "bitwise_equal": bool(
            np.array_equal(served, evaluated)),
        "tol_mean": SERVE_MEAN_TOL, "tol_max": SERVE_MAX_TOL,
    }
    log(json.dumps(served_check))
    if (served.shape != (batch, seq, vocab) or not np.isfinite(served).all()
            or served_check["mean_abs"] > SERVE_MEAN_TOL
            or served_check["max_abs"] > SERVE_MAX_TOL):
        raise SystemExit("the exported state serves other outputs")
    return {"trainer": trainer, "state": state, "batch": first,
            "launches": launches, "widths": widths, "seq": seq}


def train_timing(torch, train):
    """Device time of one train step by CUDA events, its host time,
    tokens/s, the model-FLOP share of the bf16 peak, and a
    torch.profiler breakdown of one step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, state, batch = train["trainer"], train["state"], train["batch"]
    step = lambda: trainer.train_step(state, batch)
    step_ms = device_ms(torch, step)
    t0 = time.monotonic()
    step()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) * 1e3
    widths, seq = train["widths"], train["seq"]
    rows = int(batch["features"].shape[0])
    flops = model_train_flops(widths["embed_dim"], widths["num_layers"], seq,
                              rows, widths["vocab_size"])
    log(json.dumps({
        "train": "timing", "batch_rows": rows, "seq": seq,
        "step_ms": step_ms, "step_ms_host": host_ms,
        "tokens_per_s": rows * seq / (step_ms / 1e3),
        "model_tflop_per_step": flops / 1e12,
        "mfu_of_bf16_peak": flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
    }))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total_us = getattr(evt, "device_time_total", None)
        if total_us is None:
            total_us = evt.cuda_time_total
        kernels[evt.key] = (total_us / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    if busy_ms <= 0:
        log(json.dumps({"profile": "train_step", "device_ms": "not measured"}))
        return
    share = lambda tag: sum(ms for key, (ms, _) in kernels.items()
                            if tag in key)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    log(json.dumps({
        "profile": "train_step", "device_busy_ms": busy_ms,
        "idle_share_vs_step_ms": max(0.0, 1.0 - busy_ms / step_ms),
        "k4_ms": share("flash_fwd"), "k5_ms": share("flash_bwd_dq"),
        "k6_ms": share("flash_bwd_dkv"),
        "k4_share": share("flash_fwd") / busy_ms,
        "k5_share": share("flash_bwd_dq") / busy_ms,
        "k6_share": share("flash_bwd_dkv") / busy_ms,
        "top": [[key[:90], ms, n] for key, (ms, n) in top],
    }))


K4_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_fwd.cu"
# faults planted in a copy of K4's source by ``--mutations``: (name,
# ((source text, its replacement), ...)); kernel_phase must fail on each
K4_MUTATIONS = (
    ("skip_diagonal_tile", (
        ("return causal ? min(q_last / kBlockN + 1, all) :",
         "return causal ? min(max(q_last / kBlockN, 1), all) :"),)),
    ("no_output_correction", (
        ("acc_o[i] *= corr[(i >> 1) & 1];", "acc_o[i] *= 1.f;"),)),
    ("wrong_ring_stage", (
        ("const uint32_t k_src = k_s + stage * L::kTileBytes;",
         "const uint32_t k_src = k_s + ((stage + 1) % kStages) "
         "* L::kTileBytes;"),)),
)
# K4's persistent tile loop (one CTA per SM walks the work tiles,
# longest first) against one CTA per work tile, launched longest first or
# head by head (each head's query tiles in order)
K4_ONE_TILE_PER_CTA = (
    ("const int grid = n_work < sms ? n_work : sms;",
     "const int grid = n_work;"),)
K4_SCHEDULES = {
    "persistent": (),
    "one_tile_per_cta": K4_ONE_TILE_PER_CTA,
    "one_tile_per_cta_head_major": K4_ONE_TILE_PER_CTA + (
        ("  bh = t % bh_count;\n  q0 = (m_tiles - 1 - t / bh_count) * kBlockM;",
         "  bh = t / m_tiles;\n  q0 = (t % m_tiles) * kBlockM;"),),
}

BWD_SOURCE = "elasticdl_tpu_torch/ops/csrc/flash_bwd.cu"
# faults planted in a copy of K5/K6's source: bwd_kernel_phase must fail
# on each (K6's query mask matters only where a query tile is ragged:
# the S = 1000 cases)
BWD_MUTATIONS = (
    ("k5_skip_diagonal_tile", (
        ("return causal ? min(q_last / kN + 1, all) :",
         "return causal ? min(max(q_last / kN, 1), all) :"),)),
    ("k5_no_delta", (
        ("ds[e] = p * (acc_dp[j + e] - delta_r[h]) * scale;",
         "ds[e] = p * acc_dp[j + e] * scale;"),)),
    ("k6_no_query_mask_past_s", (
        ("if (q_pos >= seq_q || (causal && k_pos > q_pos)) s = kNegInf;",
         "if (causal && k_pos > q_pos) s = kNegInf;"),)),
    ("k6_q_wrong_ring_stage", (
        ("const uint32_t q_src = q_s + stage * L::kTileBytes;",
         "const uint32_t q_src = q_s + ((stage + 1) % kStages) "
         "* L::kTileBytes;"),)),
    # K6 at D 256 (flash_bwd_dkv_bf16_wgmma_d256_kernel): the query mask
    # past S; a tile's product reading the next stage over (behind the
    # right barrier); the work tile's last query tile never reaching dV
    # and dK (its B skipped; the handover's barriers are in the exchange,
    # which still runs); warpgroup 1 reading another thread's P^T in the
    # handover. None can hang the kernel
    ("k6_d256_no_query_mask_past_s", (
        ("const bool masked = q_pos >= seq_q || (causal && k_pos > q_pos);",
         "const bool masked = causal && k_pos > q_pos;"),)),
    ("k6_d256_a_wrong_stage", (
        ("const uint64_t b_desc = sw128_desc(ring + stage * L::kTileBytes, 16);",
         "const uint64_t b_desc =\n"
         "      sw128_desc(ring + ((stage + 1) % L::kStages) * L::kTileBytes, "
         "16);"),)),
    ("k6_d256_last_tile_not_accumulated", (
        ("  d256_issue_b(acc_g, frag, at, full_other, other_ring);\n",
         "  if (!kLast) d256_issue_b(acc_g, frag, at, full_other, other_ring);\n"),
    )),
    ("k6_d256_p_handover_wrong_thread", (
        ("      const float4 x = x_tile[i * 128 + tid];",
         "      const float4 x = x_tile[i * 128 + (tid ^ 4)];"),)),
)
# K6 at D 256 as built against candidate redesigns of it, each a copy
# with these edits, raw-launched on the same inputs by --against-parent
# (bits against the parent's, and times in turns): the work tiles always
# longest first over all heads, and always head by head (the kernel picks
# head by head when a head has few key tiles)
K6_D256_HEAD_MAJOR = "  const bool head_major = 4 * k_tiles <= (int)gridDim.x;\n"
K6_D256_VARIANTS = {
    "longest_first": ((K6_D256_HEAD_MAJOR,
                       "  const bool head_major = false;\n"),),
    "head_major": ((K6_D256_HEAD_MAJOR, "  const bool head_major = true;\n"),),
}
TIER_SOURCE = "elasticdl_tpu_torch/ops/csrc/embedding_tier.cu"
K3_HIT = "const bool hit = s >= 0 && s < table_rows - 1;"
K1_IN_TABLE = "  const bool in_table = s >= 0 && s < table_rows;\n"
K1_TABLE_LOAD = "      v = __ldcg(table_row + c);\n"
K1_RACE = "k1_table_read_before_wait"
# the race's child runs: each is one tier_kernel_phase (its chain check
# makes CHAIN_REPS runs of the chain at each width)
K1_RACE_RUNS = 3
# faults planted in a copy of K1-K3's source: tier_kernel_phase's checks
# must fail on each (K3's count fault shows where a row has two lanes or
# more: d 8, not d 1)
TIER_MUTATIONS = (
    ("k2_skips_second_slot_buffer", (
        ("    if (slot1 != nullptr) reinterpret_cast<T*>(slot1)[base + c] "
         "= C::zero();\n", ""),)),
    ("k2_keeps_step_count", (
        ("  if (lane == 0 && steps != nullptr) steps[s] = 0;\n", ""),)),
    ("k3_lanes_reread_step_count", (
        ("  if (OPT == kAdam) {\n"
         "    bc1 = __shfl_sync(live, c1, 0, group);\n"
         "    bc2 = __shfl_sync(live, c2, 0, group);\n"
         "  }\n"
         "  if (lane == 0) steps[s] = t;\n",
         "  if (lane == 0) steps[s] = t;\n"
         "  __syncwarp(live);\n"
         "  if (lane != 0) t = steps[s] + 1;\n"
         "  if (OPT == kAdam) {\n"
         "    bc1 = __fsub_rn(1.0f, powf(h.beta1, (float)t));\n"
         "    bc2 = __fsub_rn(1.0f, powf(h.beta2, (float)t));\n"
         "  }\n"),)),
    ("k3_miss_to_slot_0", (
        (K3_HIT, "if (s < 0 || s >= table_rows - 1) s = 0;\n"
                 "  const bool hit = true;"),)),
    ("k1_miss_reads_slot_0", (
        (K1_IN_TABLE, "  if (s < 0 || s >= table_rows) s = 0;\n"
                      "  const bool in_table = true;\n"),)),
    ("k1_lane_reads_wrong_chunk", (
        (K1_TABLE_LOAD, "      v = __ldcg(table_row + (c + 1) % chunks);\n"),)),
    # a race: K1 of the combined buffer may read a row before K2 of the
    # chain has written it; tier_kernel_phase's chain check counts the
    # runs that saw it
    (K1_RACE, (
        ("  wait_for_previous_grid();\n  if (!live) return;\n" + K1_IN_TABLE,
         "  if (!live) return;\n" + K1_IN_TABLE
         + "  T early = C::zero();\n"
         "  if (in_table && lane < chunks)\n"
         "    early = __ldcg(reinterpret_cast<const T*>(table) +\n"
         "                   (long long)s * chunks + lane);\n"
         "  wait_for_previous_grid();\n"),
        (K1_TABLE_LOAD, "      v = c == lane ? early : __ldcg(table_row + c);"
                        "\n"))),
)
# K3 as it is (a miss returns at once) against K3 sending every miss to
# the scratch row, as the reference does: timed in turns on the real mix
# and on all hits
K3_VARIANTS = {
    "misses_return": (),
    "misses_to_scratch": (
        (K3_HIT, "if (s < 0 || s >= table_rows - 1) s = table_rows - 1;\n"
                 "  const bool hit = true;"),),
}
# phase 17's planted fault: the promoted column's "mean" divides by the
# padded length instead of the real slots' count (the "features" child)
FC_MUTATIONS = (
    ("fc_mean_padded_length",
     "elasticdl_tpu_torch/preprocessing/feature_column.py",
     (("    denom = torch.sum(w, dim=1, keepdim=True)\n",
       "    denom = torch.full_like(w[:, :1], w.shape[1])\n"),)),
)
# a child run in a copy: K4's kernel_phase at every case ("check") or
# the main case alone ("time"), bwd_kernel_phase's checks at every case
# ("bwd"), tier_kernel_phase's checks ("tier"), phase 17's promoted
# model over a short run ("features"), or K3's hit-mix timing
# ("tier_time")
MUTATION_CHILD = (
    "import os, sys, numpy as np, torch, chip_smoke\n"
    "from elasticdl_tpu_torch.ops import embedding_tier as tier\n"
    "from elasticdl_tpu_torch.ops import flash_attention as flash\n"
    "mode = sys.argv[1]\n"
    "if mode == 'bwd':\n"
    "    chip_smoke.bwd_kernel_phase(torch, flash, timing=False)\n"
    "elif mode == 'tier':\n"
    "    chip_smoke.tier_kernel_phase(torch, np, tier, timing=False)\n"
    "elif mode == 'features':\n"
    "    torch.backends.cuda.matmul.allow_tf32 = False\n"
    "    work = os.path.join('build', 'features_work')\n"
    "    os.makedirs(work, exist_ok=True)\n"
    "    chip_smoke.promoted_phase(torch, np, tier, work, steps=40)\n"
    "elif mode == 'tier_time':\n"
    "    chip_smoke.k3_hit_mix_timing(torch, np)\n"
    "else:\n"
    "    cases = chip_smoke.CASES[:1] if mode == 'time' "
    "else chip_smoke.CASES + chip_smoke.UNEQUAL_CASES\n"
    "    chip_smoke.kernel_phase(torch, flash, cases, baselines=False)\n"
)


def apply_edits(text, edits, name):
    """``text`` with each (old, new) of ``edits`` replaced; raises unless
    every old text occurs exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit("%s: %r is not in the source exactly once"
                             % (name, old))
        text = text.replace(old, new)
    return text


def kernel_copy(name, source, edits):
    """The port and this script copied under build/mut_<name>, with
    ``edits`` applied to the kernel source ``source`` (a path from the
    checkout's root); the copy builds its own library (the name carries
    the source's hash)."""
    root = os.path.join(HERE, "build", "mut_" + name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    for name_ in ("chip_smoke.py", "pyproject.toml"):
        shutil.copy(os.path.join(HERE, name_), root)
    shutil.copytree(os.path.join(HERE, "elasticdl_tpu_torch"),
                    os.path.join(root, "elasticdl_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, source)
    with open(path) as f:
        text = apply_edits(f.read(), edits, name)
    with open(path, "w") as f:
        f.write(text)
    return root


def mutation_child(root, mode):
    return subprocess.run([sys.executable, "-c", MUTATION_CHILD, mode],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)


# the A/B of phase 7 across two checkouts, each running its own
# sparse_phase and store_splits in a child process, in the order parent,
# change, change, parent: python3 chip_smoke.py --sparse-ab <parent>
SPARSE_AB_CHILD = (
    "import sys\n"
    "import numpy as np\n"
    "import torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke as cs\n"
    "from elasticdl_tpu_torch.ops import _build\n"
    "from elasticdl_tpu_torch.ops import embedding_tier as tier\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "_build.build(['embedding_tier'])\n"
    "sparse = cs.sparse_phase(torch, np, tier)\n"
    "cs.store_splits(torch, sparse)\n"
    "sparse['trainer'].close()\n"
)


def sparse_ab(parent):
    """Phase 7's main-run rate (110 steps, the tier on, the in-process
    native store) and its host stage split on the native store, for the
    checkout at ``parent`` and this one, in turns; logs each run and the
    medians by checkout."""
    import numpy as np

    parent = os.path.abspath(parent)
    if not os.path.exists(os.path.join(parent, "chip_smoke.py")):
        raise SystemExit("no chip_smoke.py in %s" % parent)
    runs = []
    for label, root in (("parent", parent), ("change", HERE),
                        ("change", HERE), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", SPARSE_AB_CHILD],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            raise SystemExit("the %s run failed:\n%s" % (
                label, (out.stdout + out.stderr)[-3000:]))
        main = split = None
        for line in out.stdout.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("sparse") == "main_run":
                main = rec
            elif (rec.get("profile") == "sparse_host_split"
                  and rec.get("store") == "NativeEmbeddingStore"):
                split = rec
        run = {"sparse_ab": label, "root": root,
               "steps_per_s": main["steps_per_s"],
               "step_ms_host_median": main["step_ms_host_median"],
               "split_wall_ms_median": split["wall_ms_median"],
               "split_stage_ms_median": split["stage_ms_median"],
               "split_other_ms_median": split["other_ms_median"]}
        log(json.dumps(run))
        runs.append(run)
    summary = {}
    for label in ("parent", "change"):
        mine = [r for r in runs if r["sparse_ab"] == label]
        stages = sorted({k for r in mine for k in r["split_stage_ms_median"]})
        summary[label] = {
            "steps_per_s": [r["steps_per_s"] for r in mine],
            "split_wall_ms_median": float(np.median(
                [r["split_wall_ms_median"] for r in mine])),
            "split_stage_ms_median": {k: float(np.median(
                [r["split_stage_ms_median"].get(k, 0.0) for r in mine]))
                for k in stages}}
    log(json.dumps({"sparse_ab": "summary", **summary}))


# phase 9's job across checkouts, each running its own job_data and
# job_phase in a child process, the others around this one in mirrored
# order (A, B, change, change, B, A): python3 chip_smoke.py --job-ab
# <parent> [<other checkout> ...]
JOB_AB_CHILD = (
    "import os, sys\n"
    "import numpy as np\n"
    "import torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke as cs\n"
    "from elasticdl_tpu_torch.ops import _build\n"
    "from elasticdl_tpu_torch.ops import embedding_tier as tier\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "_build.build(['embedding_tier'])\n"
    "d = os.path.join(cs.HERE, 'build', 'chip_smoke_jobdata')\n"
    "cs.job_data(np, d)\n"
    "cs.job_phase(torch, np, tier, d, data_written=True)\n"
)
JOB_AB_KEYS = ("job_wall_s", "training_window_s",
               "examples_per_s_training_window", "worker0_steps_per_s")


def job_ab(others):
    """Phase 9 (the DeepFM job with its worker kill and requeue) for
    each checkout in ``others`` and this one, in mirrored turns; logs
    each run's job wall, training window and worker 0's steps/s, and the
    runs by checkout."""
    roots = []
    for other in others:
        other = os.path.abspath(other)
        if not os.path.exists(os.path.join(other, "chip_smoke.py")):
            raise SystemExit("no chip_smoke.py in %s" % other)
        roots.append((os.path.basename(other), other))
    order = roots + [("change", HERE)] * 2 + roots[::-1]
    runs = []
    for label, root in order:
        t0 = time.monotonic()
        out = subprocess.run([sys.executable, "-c", JOB_AB_CHILD],
                             cwd=root, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            raise SystemExit("the %s run failed:\n%s" % (
                label, (out.stdout + out.stderr)[-3000:]))
        result = None
        for line in out.stdout.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("job") == "result":
                result = rec
        run = dict({"job_ab": label, "root": root,
                    "child_s": time.monotonic() - t0},
                   **{k: result.get(k) for k in JOB_AB_KEYS})
        log(json.dumps(run))
        runs.append(run)
    log(json.dumps({"job_ab": "summary", **{
        label: {k: [r[k] for r in runs if r["job_ab"] == label]
                for k in JOB_AB_KEYS + ("child_s",)}
        for label in dict(order)}}))


# K4-K6 of two checkouts on the same inputs (python3 chip_smoke.py
# --against-parent <parent>), as (name, bh, seq_q, seq_k, dim, dtype,
# causal): every CASES entry at head_dim 64 or 128 at its own shape, the
# bf16 head_dim 256 shapes K6's D-256 kernel runs on the main path and
# at its edges (bench.py's transformer and s16k_flash, the ragged S
# 1000, q 200 / k 1000 under the causal mask), and the tile edges of
# each head_dim (one row, one row past a tile) in both dtypes at 64 and
# 128 and in bf16 at 256, causal and not
AGAINST_PARENT_D256 = ("bench_bf16_d256_causal", "s16k_bf16_d256_causal",
                       "bf16_d256_ragged_s1000_causal",
                       "uneq_bf16_d256_q200_k1000_causal")
AGAINST_PARENT_CASES = tuple(
    case_lengths(case) for case in CASES + UNEQUAL_CASES
    if case[-3] in (64, 128) and len(case) == 6
    or case[0] in AGAINST_PARENT_D256) + tuple(
    ("edge_%s_d%d_s%d_%s" % (dtype, dim, seq,
                             "causal" if causal else "full"),
     6, seq, seq, dim, dtype, causal)
    for dim in (64, 128, 256) for dtype in ("bfloat16", "float32")
    if dim < 256 or dtype == "bfloat16"
    for seq in (1, 129) for causal in (False, True))
# K6's raw launches timed in turns (parent, change, each variant, the
# variants again in reverse, change, parent, K6_TURN_ROUNDS times) at the
# two D-256 shapes of the main path: bench.py's transformer and s16k_flash
AGAINST_PARENT_TIMED = ("bench_bf16_d256_causal", "s16k_bf16_d256_causal")
# each round times every build twice, in mirrored order: the card's
# clocks drift by a few percent over seconds at the s16k shape
K6_TURN_ROUNDS = 3
# a child in a checkout builds its K4-K6 and prints where
AGAINST_PARENT_CHILD = (
    "import json, sys\n"
    "sys.path.insert(0, '.')\n"
    "from elasticdl_tpu_torch.ops import _build\n"
    "_build.build(['flash_fwd', 'flash_bwd'])\n"
    "for text in _build.build_logs.values():\n"
    "    for line in text.splitlines():\n"
    "        print('ptxas', line.strip())\n"
    "print(json.dumps({n: _build.library_path(n) "
    "for n in ('flash_fwd', 'flash_bwd')}))\n"
)
# the lines of ptxas's report worth keeping: each entry, its registers and
# shared memory, spills, and any wgmma serialization, injected wait or
# other warning
PTXAS_KEYS = ("Compiling entry", "Used", "spill", "wgmma", "warpgroup",
              "arning")


def flash_raw_outputs(torch, libs, q, k, v, do, causal):
    """(o, lse, dq, dk, dv) from raw launches of ``libs``' K4, K5 and K6
    (delta from this o, as the wrapper computes it)."""
    bh, seq, dim = q.shape
    common = (bh, seq, k.shape[1], dim, int(q.dtype == torch.bfloat16),
              int(causal), 1.0 / dim ** 0.5)
    o = torch.empty_like(q)
    lse = torch.empty(bh, 1, seq, device="cuda")
    raw_launch(torch, libs["flash_fwd"].edl_flash_fwd, q.data_ptr(),
               k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
               *common)()
    delta = (o.float() * do.float()).sum(-1).unsqueeze(1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    raw_launch(torch, libs["flash_bwd"].edl_flash_bwd_dq, *inputs,
               dq.data_ptr(), *common)()
    raw_launch(torch, libs["flash_bwd"].edl_flash_bwd_dkv, *inputs,
               dk.data_ptr(), dv.data_ptr(), *common)()
    torch.cuda.synchronize()
    return o, lse, dq, dk, dv


def build_libraries(root):
    """Start building K4-K6 in the checkout at ``root`` (a child
    process); returns the process, whose last line of output names the
    libraries."""
    return subprocess.Popen([sys.executable, "-c", AGAINST_PARENT_CHILD],
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def built_libraries(label, child):
    """The libraries ``child`` (``build_libraries``) built, bound."""
    from elasticdl_tpu_torch.ops import _build

    out, _ = child.communicate(timeout=900)
    if child.returncode:
        raise SystemExit("the %s kernels did not build:\n%s"
                         % (label, out[-3000:]))
    for line in out.splitlines():
        if line.startswith("ptxas") and any(k in line for k in PTXAS_KEYS):
            log("%s %s" % (label, line))
    paths = json.loads(out.strip().splitlines()[-1])
    return paths, {n: _build.bind(path, n) for n, path in paths.items()}


def against_parent(torch, parent):
    """K4-K6 built from the checkout at ``parent``, from this one and
    from copies of this one under each of K6_D256_VARIANTS, raw-launched
    on the same inputs at every AGAINST_PARENT_CASES entry (the variants
    at head_dim 256 only): raises unless this checkout's o, lse, dq, dk
    and dv are the parent's bits (each variant's bits are logged). Then
    K6's raw launches at AGAINST_PARENT_TIMED, in turns."""
    from elasticdl_tpu_torch.ops import _build

    parent = os.path.abspath(parent)
    if not os.path.exists(os.path.join(parent, BWD_SOURCE)):
        raise SystemExit("no %s in %s" % (BWD_SOURCE, parent))
    children = {"parent": build_libraries(parent)}
    children.update({
        name: build_libraries(kernel_copy("k6_" + name, BWD_SOURCE, edits))
        for name, edits in K6_D256_VARIANTS.items()})
    _build.build(["flash_fwd", "flash_bwd"])
    paths, libs = {}, {}
    for label, child in children.items():
        paths[label], libs[label] = built_libraries(label, child)
    libs["change"] = {n: _build.load(n) for n in paths["parent"]}
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(key in line for key in PTXAS_KEYS):
                log("change ptxas %s: %s" % (name, line.strip()))
    variants = list(K6_D256_VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    differ, variant_differ, timed = [], {v: [] for v in variants}, {}
    for name, bh, seq, seq_k, dim, dtype_name, causal in AGAINST_PARENT_CASES:
        q, k, v, do = (
            torch.randn(bh, rows, dim, device="cuda", generator=gen).to(
                getattr(torch, dtype_name))
            for rows in (seq, seq_k, seq_k, seq))
        labels = ["parent", "change"] + (variants if dim == 256 else [])
        got = {label: flash_raw_outputs(torch, libs[label], q, k, v, do,
                                        causal) for label in labels}
        equal = {}
        for label in labels[1:]:
            equal[label] = {out_name: torch.equal(a, b) for out_name, a, b
                            in zip(("o", "lse", "dq", "dk", "dv"),
                                   got["parent"], got[label])}
        log(json.dumps({"against_parent": name, "shape": [bh, seq, dim],
                        "seq_k": seq_k, "dtype": dtype_name,
                        "causal": causal, "bit_equal": equal["change"],
                        "variants_bit_equal": {
                            label: all(equal[label].values())
                            for label in labels[2:]}}))
        if not all(equal["change"].values()):
            differ.append(name)
        for label in labels[2:]:
            if not all(equal[label].values()):
                variant_differ[label].append(name)
        if name in AGAINST_PARENT_TIMED:
            timed[name] = k6_turns(torch, libs, labels, q, k, v, do,
                                   got["parent"], causal)
            log(json.dumps({"k6_turns_ms": timed[name], "case": name,
                            "shape": [bh, seq, dim]}))
        del q, k, v, do, got
    log(json.dumps({"against_parent": "summary", "parent": parent,
                    "libraries": paths, "cases": len(AGAINST_PARENT_CASES),
                    "differ": differ, "variants_differ": variant_differ,
                    "k6_turns_ms": timed}))
    if differ:
        raise SystemExit("K4-K6 differ from the parent's at %s" % differ)


def k6_turns(torch, libs, labels, q, k, v, do, outs, causal):
    """K6's raw launch of each library set in ``labels`` on the same
    inputs (lse and delta from the parent's K4, ``outs``), timed in
    turns: the labels in order, then in reverse, K6_TURN_ROUNDS times; ms
    by label."""
    bh, seq, dim = q.shape
    delta = (outs[0].float() * do.float()).sum(-1).unsqueeze(1)
    common = (bh, seq, k.shape[1], dim, int(q.dtype == torch.bfloat16),
              int(causal), 1.0 / dim ** 0.5)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    times = {label: [] for label in labels}
    for label in (labels + labels[::-1]) * K6_TURN_ROUNDS:
        launch = raw_launch(
            torch, libs[label]["flash_bwd"].edl_flash_bwd_dkv, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), outs[1].data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common)
        times[label].append(time_ms(torch, launch, flush))
    return times


# phase 16's step times (bench.py's transformer and s16k_flash) across
# checkouts, each child in its own checkout, parent, change, change,
# parent: python3 chip_smoke.py --lm-ab <parent>
LM_AB_CHILD = (
    "import json, sys\n"
    "import numpy as np\n"
    "import torch\n"
    "sys.path.insert(0, '.')\n"
    "import chip_smoke as cs\n"
    "from elasticdl_tpu_torch.ops import _build\n"
    "from elasticdl_tpu_torch.ops import flash_attention as flash\n"
    "torch.backends.cuda.matmul.allow_tf32 = False\n"
    "torch.backends.cudnn.allow_tf32 = False\n"
    "_build.build(['flash_fwd', 'flash_bwd'])\n"
    "bench = cs.bench_lm_phase(torch, np, flash)\n"
    "s16k = cs.s16k_phase(torch, np, flash, bench.pop('flat'), "
    "bench['widths'])\n"
    "print(json.dumps({'lm_ab': 'result', "
    "'transformer_step_ms': bench['record']['step_ms'], "
    "'s16k_step_ms': s16k['step_ms'], "
    "'s16k_step_ms_after_first': s16k['step_ms_after_first']}))\n"
)


def lm_ab(parent):
    """Phase 16's transformer step (the best window) and s16k_flash steps
    for the checkout at ``parent`` and this one, in turns; logs each run
    and the runs by checkout."""
    parent = os.path.abspath(parent)
    if not os.path.exists(os.path.join(parent, "chip_smoke.py")):
        raise SystemExit("no chip_smoke.py in %s" % parent)
    runs = []
    for label, root in (("parent", parent), ("change", HERE),
                        ("change", HERE), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", LM_AB_CHILD], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise SystemExit("the %s run failed:\n%s" % (
                label, (out.stdout + out.stderr)[-3000:]))
        result = [json.loads(line) for line in out.stdout.splitlines()
                  if line.startswith('{"lm_ab"')][-1]
        run = dict(result, lm_ab=label, root=root)
        log(json.dumps(run))
        runs.append(run)
    keys = ("transformer_step_ms", "s16k_step_ms_after_first")
    log(json.dumps({"lm_ab": "summary", **{
        label: {key: [r[key] for r in runs if r["lm_ab"] == label]
                for key in keys} for label in ("parent", "change")}}))


def mutation_phase():
    """Plant each of K4_MUTATIONS, BWD_MUTATIONS, TIER_MUTATIONS and
    FC_MUTATIONS in its own copy and require kernel_phase (K4),
    bwd_kernel_phase (K5, K6), tier_kernel_phase (K1-K3) or phase 17's
    promoted_phase (the feature columns) to fail there. K1_RACE is a race:
    its copy runs K1_RACE_RUNS times, each run's chain mismatches are
    logged, and it counts as missed only if no run caught it. Then time
    K4 at the main case under each of K4_SCHEDULES, in turns (A B C C B
    A), and K3 under each of K3_VARIANTS (A B B A)."""
    # copy name -> (root, the child's mode); the backward's phase runs
    # K4 too, so its copies build both flash sources
    copies = {name: (kernel_copy(name, K4_SOURCE, edits), "check")
              for name, edits in K4_MUTATIONS}
    copies.update({name: (kernel_copy(name, BWD_SOURCE, edits), "bwd")
                   for name, edits in BWD_MUTATIONS})
    copies.update({name: (kernel_copy(name, TIER_SOURCE, edits), "tier")
                   for name, edits in TIER_MUTATIONS})
    copies.update({name: (kernel_copy(name, source, edits), "features")
                   for name, source, edits in FC_MUTATIONS})
    schedules = {name: kernel_copy(name, K4_SOURCE, edits)
                 for name, edits in K4_SCHEDULES.items()}
    k3_variants = {name: kernel_copy("k3_" + name, TIER_SOURCE, edits)
                   for name, edits in K3_VARIANTS.items()}
    built = {"check": ["flash_fwd"], "bwd": ["flash_fwd", "flash_bwd"],
             "tier": ["embedding_tier"], "features": ["embedding_tier"]}
    targets = [(root, built[mode]) for root, mode in copies.values()]
    targets += [(root, ["flash_fwd"]) for root in schedules.values()]
    targets += [(root, ["embedding_tier"]) for root in k3_variants.values()]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from elasticdl_tpu_torch.ops import _build; "
         "_build.build(%r)" % kernels], cwd=root)
        for root, kernels in targets]
    if any(proc.wait() for proc in builds):
        raise SystemExit("a mutated copy did not build")
    missed, race = [], []
    for name, (root, mode) in copies.items():
        for _ in range(K1_RACE_RUNS if name == K1_RACE else 1):
            proc = mutation_child(root, mode)
            lines = (proc.stdout + proc.stderr).strip().splitlines()
            chain = [json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith('{"tier_chain"')]
            log(json.dumps({
                "mutation": name, "caught": proc.returncode != 0,
                "rc": proc.returncode,
                "chain_mismatches": [[r["dim"], r["mismatches"], r["reps"]]
                                     for r in chain],
                "last_line": lines[-1][:300] if lines else ""}))
            if name == K1_RACE:
                race.append(proc.returncode != 0)
            elif proc.returncode == 0:
                missed.append(name)
    log(json.dumps({"race": K1_RACE, "runs_caught": sum(race),
                    "runs": len(race)}))
    if not any(race):
        missed.append(K1_RACE)
    times = {key: [] for key in schedules}
    for key in [*schedules, *reversed(schedules)]:
        proc = mutation_child(schedules[key], "time")
        records = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith('{"case"')]
        if proc.returncode or not records:
            raise SystemExit("K4 (%s) failed:\n%s"
                             % (key, proc.stdout + proc.stderr))
        times[key].append(records[-1]["ms"])
    log(json.dumps({"k4_schedule_ms": times, "case": CASES[0][0]}))
    k3_times = {key: [] for key in k3_variants}
    for key in [*k3_variants, *reversed(k3_variants)]:
        proc = mutation_child(k3_variants[key], "tier_time")
        records = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith('{"k3_hit_mix"')]
        if proc.returncode or not records:
            raise SystemExit("K3 (%s) failed:\n%s"
                             % (key, proc.stdout + proc.stderr))
        k3_times[key].append(records[-1]["k3_hit_mix"])
    log(json.dumps({"k3_variant_ms": k3_times, "table": "deepfm_emb",
                    "opt": "adam"}))
    if missed:
        raise SystemExit("planted faults not caught: %s" % missed)


# ---------------------------------------------------------------------------
# phase 15: the vision zoo and the rest of the dense step
# ---------------------------------------------------------------------------

RESNET_ZOO = "elasticdl_tpu_torch.models.resnet"
# bench.py:441-461: resnet50(num_classes=1000, stem="space_to_depth"),
# Momentum lr 0.1 momentum 0.9 nesterov, bf16 compute, batch 256, 224x224
RESNET_BATCH = 256
RESNET_IMAGE = 224
RESNET_CLASSES = 1000
RESNET_WARMUP = 3
RESNET_WINDOWS = 3        # bench.py: best of 5 windows of 100 steps
RESNET_WINDOW_STEPS = 10
# card (TF32 off) against CPU, fp32, batch 8, one step from the same
# weights: convolutions summed in other orders through 53 BatchNorms;
# the loss to 1e-4 relative, logits and the updated running statistics
# to 1e-3 of each one's largest entry
RESNET_AGREE_BATCH = 8
RESNET_AGREE_LOSS_RTOL = 1e-4
RESNET_AGREE_RTOL = 1e-3
# ResNet-50 as a job: 512 planted-class records (the job's data cut from
# ImageNet's 1.28 M), batch 64, 4 tasks of 2 steps
VISION_JOB_RECORDS = 512
VISION_JOB_CLASSES = 4
VISION_JOB_BATCH = 64
VISION_JOB_PER_TASK = 128
VISION_SERVE_REQUESTS = 8
VISION_JOB_WAIT_S = 300
# the zoo TransformerLM under remat: S 1024, batch 8 (phase 6's shape)
REMAT_POLICIES = (("none", False, "full"), ("dots", True, "dots"),
                  ("flash", True, "flash"), ("full", True, "full"))
REMAT_STEPS = 3
REMAT_LONG_SEQ = 16384    # bench.py's s16k length and batch 1
REMAT_DROPOUT = 0.1
# tests/test_transformer_spmd.py's remat tolerances
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_RTOL = 1e-5
REMAT_GRAD_ATOL = 1e-7
# the small zoo models' short LocalExecutor runs
SMALL_ZOO = (("mnist", 28), ("cifar10", 16), ("mobilenet", 16))
SMALL_RECORDS = 384
SMALL_BATCH = 32


def card_line(device):
    """The card's name and power limit beside a number (``cpu`` in a
    rehearsal)."""
    return nvidia_smi_line() if str(device).startswith("cuda") else "cpu"


def vision_images(np, rng, n, size, classes, channels=3):
    """uint8 images with a planted class: a bright block in the quadrant
    of ``label % 4`` and, with 3 channels, a colour of ``label // 4``."""
    labels = rng.integers(0, classes, n)
    shape = (n, size, size, channels) if channels > 1 else (n, size, size)
    images = (rng.random(shape, dtype=np.float32) * 60).astype(np.uint8)
    half = size // 2
    for i, label in enumerate(labels):
        row, col = divmod(int(label) % 4, 2)
        block = (slice(row * half, (row + 1) * half),
                 slice(col * half, (col + 1) * half))
        if channels > 1:
            images[i][block + ((int(label) // 4) % channels,)] += 180
        else:
            images[i][block] += 180
    return images, labels


def write_vision_records(np, path, images, labels):
    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.data.example import encode_example

    os.makedirs(path, exist_ok=True)
    recordio.write_records(os.path.join(path, "part-0.rec"), [
        encode_example({"image": image, "label": np.int64(label)})
        for image, label in zip(images, labels)])
    return path


def conv_dense_flops(torch, model, features):
    """FLOPs of one forward from the model's Conv and Dense shapes
    (2 x output elements x inputs a product), counted by forward hooks
    in eval mode."""
    from elasticdl_tpu_torch.models.layers import Conv

    total = [0]

    def hook(module, inputs, output):
        weight = module.weight
        if isinstance(module, Conv):
            per_out = weight.shape[1] * weight.shape[2] * weight.shape[3]
        else:
            per_out = weight.shape[1]
        total[0] += 2 * output.numel() * per_out

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, torch.nn.Linear))]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(features)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return total[0]


def profile_dense_step(torch, step, what):
    """One step under torch.profiler (the card alone, opened with
    ``profiler_warmup``): wall ms beside device-busy ms, the idle share
    and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_warmup(torch)
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        total_us = getattr(evt, "device_time_total", None)
        if total_us is None:
            total_us = evt.cuda_time_total
        kernels[evt.key] = (total_us / 1e3, evt.count)
    for key in [k for k in kernels if PROFILER_WARMUP_NAME in k]:
        kernels.pop(key)
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"profile": what, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
            "idle_share": (max(0.0, 1.0 - busy_ms / wall_ms) if busy_ms > 0
                           else "not measured"),
            "top": [[key[:90], ms, n] for key, (ms, n) in top]}


def resnet_bench(torch, np, device="cuda", batch=RESNET_BATCH,
                 image=RESNET_IMAGE, classes=RESNET_CLASSES,
                 warmup=RESNET_WARMUP, windows=RESNET_WINDOWS,
                 window_steps=RESNET_WINDOW_STEPS):
    """bench.py's ResNet-50 configuration through the port's step
    (``make_train_step`` as bench.py calls it, the batch on the card
    once): warm-up steps, then windows of steps, each fenced by its last
    loss; images/s of the best window, the step's device-busy time, idle
    share and top ops from one profiled step, peak memory, and the FLOP
    share of the card's bf16 peak (989 TFLOP/s)."""
    from elasticdl_tpu_torch.models import resnet
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.step_fns import make_train_step
    from elasticdl_tpu_torch.train.train_state import create_train_state

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = resnet.resnet50(num_classes=classes, stem="space_to_depth")
    model = model.to(device)
    tx = create_optimizer("Momentum", learning_rate=0.1, momentum=0.9,
                          nesterov=True)
    step_fn = make_train_step(model, resnet.loss, tx,
                              compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    features = torch.from_numpy(
        rng.rand(batch, image, image, 3).astype(np.float32)).to(device)
    labels = torch.from_numpy(
        rng.randint(0, classes, size=batch).astype(np.int32)).to(device)
    step_batch = {"features": features, "labels": labels,
                  "_mask": torch.ones(batch, device=device)}
    state = create_train_state(model, tx)
    flops = 3 * conv_dense_flops(torch, model, features[:1]) * batch
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(warmup):
        state, loss = step_fn(state, step_batch)
        losses.append(float(loss))
    best = float("inf")
    for _ in range(windows):
        sync(torch, torch.device(device))
        t0 = time.perf_counter()
        for _ in range(window_steps):
            state, loss = step_fn(state, step_batch)
        losses.append(float(loss))  # the fetch fences the window
        best = min(best, time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise SystemExit("resnet50 bench losses: %s" % losses)
    step_s = best / window_steps
    record = {
        "vision": "resnet50_bench", "config": "bench.py:441-461",
        "batch": batch, "image": image, "compute_dtype": "bfloat16",
        "windows": windows, "window_steps": window_steps,
        "images_per_s": batch / step_s, "step_ms": step_s * 1e3,
        "losses": losses, "model_tflop_per_step": flops / 1e12,
        "peak_tflops": PEAK_FLOPS["bfloat16"] / 1e12,
        "flop_share_of_bf16_peak": flops / step_s / PEAK_FLOPS["bfloat16"],
    }
    if device == "cuda":
        record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        holder = {"state": state}

        def one():
            holder["state"], _ = step_fn(holder["state"], step_batch)

        record["step_profile"] = profile_dense_step(torch, one,
                                                    "resnet50_train_step")
    log(json.dumps(dict(record, card=card_line(device))))
    del state, step_batch, features
    return record


def resnet_agreement(torch, np, device="cuda", batch=RESNET_AGREE_BATCH,
                     image=RESNET_IMAGE, classes=RESNET_CLASSES):
    """One fp32 step of bench.py's ResNet-50 on the card (TF32 off for
    matmuls and convolutions) and on the CPU from the same weights: the
    loss, the training-mode logits and the updated running
    statistics."""
    from elasticdl_tpu_torch.models import resnet
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.step_fns import (
        _fresh_model_state,
        apply_model,
        make_train_step,
    )
    from elasticdl_tpu_torch.train.train_state import (
        create_train_state,
        flat_model_state,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 15)
        weights = resnet.resnet50(num_classes=classes,
                                  stem="space_to_depth").state_dict()
    rng = np.random.RandomState(1)
    images = rng.rand(batch, image, image, 3).astype(np.float32)
    labels = rng.randint(0, classes, size=batch).astype(np.int32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    try:
        for where in (device, "cpu"):
            model = resnet.resnet50(num_classes=classes,
                                    stem="space_to_depth")
            model.load_state_dict(weights)
            model = model.to(where)
            tx = create_optimizer("Momentum", learning_rate=0.1,
                                  momentum=0.9, nesterov=True)
            state = create_train_state(model, tx)
            x = torch.from_numpy(images).to(where)
            model.train()
            with torch.no_grad():
                logits = apply_model(model, state.params,
                                     _fresh_model_state(state.model_state),
                                     x).cpu().numpy()
            state, loss = make_train_step(model, resnet.loss, tx)(state, {
                "features": x, "labels": torch.from_numpy(labels).to(where),
                "_mask": torch.ones(batch, device=where)})
            results[where] = (float(loss), logits, {
                k: v.cpu().numpy() for k, v in
                flat_model_state(state.model_state).items()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (loss_d, logits_d, stats_d), (loss_c, logits_c, stats_c) = (
        results[device], results["cpu"])
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                       1e-12))
    stats_err = {k: rel(stats_d[k], stats_c[k]) for k in stats_c}
    worst = max(stats_err, key=stats_err.get)
    record = {"vision": "resnet50_card_vs_cpu_fp32", "batch": batch,
              "loss": loss_d, "cpu_loss": loss_c,
              "loss_rel_diff": abs(loss_d - loss_c) / abs(loss_c),
              "tol_loss_rel": RESNET_AGREE_LOSS_RTOL,
              "logits_rel_err": rel(logits_d, logits_c),
              "stats_leaves": len(stats_err),
              "stats_worst_rel_err": stats_err[worst],
              "stats_worst": worst, "tol_rel": RESNET_AGREE_RTOL,
              "tf32": False, "card": card_line(device)}
    log(json.dumps(record))
    if (not np.isfinite(loss_d)
            or record["loss_rel_diff"] > RESNET_AGREE_LOSS_RTOL
            or record["logits_rel_err"] > RESNET_AGREE_RTOL
            or record["stats_worst_rel_err"] > RESNET_AGREE_RTOL):
        raise SystemExit("ResNet-50 on the card disagrees with the CPU")
    return record


def vision_job(torch, np, workdir, device="cuda",
               records=VISION_JOB_RECORDS, image=RESNET_IMAGE,
               classes=VISION_JOB_CLASSES, batch=VISION_JOB_BATCH,
               per_task=VISION_JOB_PER_TASK, model_params="",
               requests=VISION_SERVE_REQUESTS, compute_dtype="bfloat16"):
    """ResNet-50 as a job: the port's ``Master`` in this process with
    ``--output`` (``saved_model_path``), one ``python -m
    elasticdl_tpu_torch.worker.main`` on the card (bf16), planted-class
    RecordIO images; then ``python -m elasticdl_tpu_torch.serve.main``
    on the export and ``requests`` one-image requests, each answer held
    against an in-process ``ServingModel`` (an eval forward) within
    SERVE_MEAN_TOL / SERVE_MAX_TOL. Checks: master rc 0, worker rc 0,
    every task done once, the export at the final step with every
    ``model_state/batch_stats`` leaf and trained statistics."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.serve.client import ServeClient
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.train.export import load_exported

    params = ";".join(p for p in ("num_classes=%d" % classes, model_params)
                      if p)
    out = os.path.join(HERE, "build", "chip_smoke_vision")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    rng = np.random.default_rng(SEED + 15)
    images, labels = vision_images(np, rng, records, image, classes)
    t0 = time.monotonic()
    train_dir = write_vision_records(np, os.path.join(workdir, "vision"),
                                     images, labels)
    data_s = time.monotonic() - t0
    export_dir = os.path.join(workdir, "vision_export")
    master = Master(RESNET_ZOO, training_data=train_dir,
                    records_per_task=per_task, num_epochs=1,
                    port=find_free_port(), saved_model_path=export_dir,
                    task_timeout_secs=60.0, seed=SEED, model_params=params)
    dispatcher = master.task_dispatcher
    done = []
    report = dispatcher.report

    def on_report(task_id, success, worker_id=None, count_failure=True):
        ok, task = report(task_id, success, worker_id=worker_id,
                          count_failure=count_failure)
        if success and task is not None:
            done.append((task.type, task.shard_name, task.start, task.end))
        return ok, task

    dispatcher.report = on_report
    addr = "localhost:%d" % master._port
    env = dict(os.environ, PYTHONPATH=HERE)
    result, procs = {}, []
    try:
        job_t0 = time.monotonic()
        master.prepare()
        thread = threading.Thread(
            target=lambda: result.setdefault("rc", master.run(
                poll_secs=0.5)), daemon=True)
        thread.start()
        worker_log = os.path.join(out, "worker-0.log")
        worker = start_worker_process(worker_log, [
            "--model_zoo", RESNET_ZOO, "--model_params", params,
            "--training_data", train_dir, "--minibatch_size", str(batch),
            "--master_addr", addr, "--worker_id", "0",
            "--compute_dtype", compute_dtype, "--device",
            torch.device(device).type], env)
        procs.append(worker)
        thread.join(VISION_JOB_WAIT_S)
        worker_rc = worker.wait(60)
        job_s = time.monotonic() - job_t0
        with open(worker_log) as f:
            worker_tail = f.read()[-3000:]
        training = sorted((s, a, b) for t, s, a, b in done
                          if t == pb.TRAINING)
        expected = [(s, a, min(a + per_task, records))
                    for s in {x for x, _, _ in training}
                    for a in range(0, records, per_task)]
        trained = sum(b - a for _, a, b in training)
        _, model_state, export_step = load_exported(export_dir)
        var_leaves = [v for k, v in model_state.items() if k.endswith("/var")]
        record = {
            "vision": "resnet50_job", "records": records, "image": image,
            "batch": batch, "tasks": len(training), "records_trained":
            trained, "master_rc": result.get("rc"), "worker_rc": worker_rc,
            "export_step": export_step, "job_seconds": job_s,
            "data_seconds": data_s,
            "export_batch_stats_arrays": len(model_state),
            "export_bytes": dir_bytes(export_dir),
            "card": card_line(device)}
        log(json.dumps(record))
        steps = -(-per_task // batch) * len(training)
        failures = [
            what for what, bad in (
                ("master rc", result.get("rc") != 0),
                ("worker rc", worker_rc != 0),
                ("every task done once", training != sorted(expected)
                 or trained != records),
                ("export step", export_step != steps),
                ("batch_stats exported", not model_state or any(
                    not k.startswith("batch_stats/") for k in model_state)),
                ("trained statistics", not any(
                    not np.allclose(v, 1.0) for v in var_leaves)))
            if bad]
        if failures:
            raise SystemExit("vision job: %s\n%s" % (failures, worker_tail))

        serve_port = find_free_port()
        serve_log = os.path.join(out, "serve.log")
        serve_t0 = time.monotonic()
        with open(serve_log, "w") as sink:
            serve_proc = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.serve.main",
                 "--model_zoo", RESNET_ZOO, "--model_params", params,
                 "--export_dir", export_dir, "--port", str(serve_port),
                 "--max_batch", str(requests), "--compute_dtype",
                 compute_dtype, "--device", torch.device(device).type,
                 "--deadline_ms", "600000", "--watch_secs", "3600"],
                cwd=HERE, env=env, stdout=sink, stderr=subprocess.STDOUT)
        procs.append(serve_proc)
        wait_for_line(serve_proc, serve_log, "serve 0 on :%d" % serve_port,
                      "the ResNet-50 server")
        cold_s = time.monotonic() - serve_t0
        rows = (images[:requests].astype(np.float32) / 255.0)
        # one warm-up request first (the server's first forward sets up
        # cuDNN), left out of the latencies
        t = time.monotonic()
        with ServeClient("localhost:%d" % serve_port) as client:
            client.predict(rows[:1], deadline_secs=300)
        warmup_ms = (time.monotonic() - t) * 1e3
        answers, latencies = [None] * requests, [None] * requests

        def call(i):
            with ServeClient("localhost:%d" % serve_port) as client:
                t = time.monotonic()
                outputs, _, _ = client.predict(rows[i:i + 1],
                                               deadline_secs=300)
                latencies[i] = time.monotonic() - t
                answers[i] = outputs["output"].float().numpy()

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if any(a is None for a in answers):
            raise SystemExit("a ResNet-50 request failed")
        served = np.concatenate(answers)
        reference = ServingModel(
            get_model_spec(RESNET_ZOO, model_params=params), export_dir,
            max_batch=requests, compute_dtype=compute_dtype or None,
            device=device).predict(rows, requests)["output"].float().numpy()
        diff = np.abs(served - reference)
        serve_record = {
            "vision": "resnet50_served", "requests": requests,
            "shape": list(served.shape), "max_abs": float(diff.max()),
            "mean_abs": float(diff.mean()), "bitwise_equal": bool(
                np.array_equal(served, reference)),
            "tol_mean": SERVE_MEAN_TOL, "tol_max": SERVE_MAX_TOL,
            "cold_start_s": cold_s, "warmup_request_ms": warmup_ms,
            "p50_ms": float(np.median(latencies)) * 1e3,
            "max_ms": float(max(latencies)) * 1e3,
            "card": card_line(device)}
        log(json.dumps(serve_record))
        if (served.shape != (requests, classes)
                or not np.isfinite(served).all()
                or serve_record["mean_abs"] > SERVE_MEAN_TOL
                or serve_record["max_abs"] > SERVE_MAX_TOL):
            raise SystemExit("the served ResNet-50 answers disagree")
        return dict(record, serve=serve_record)
    finally:
        master.stop()
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()


def lm_model(torch, flat, widths, device, remat=False, policy="full",
             dropout=0.0):
    """``(model, spec)``: the zoo TransformerLM at ``widths`` (remat and
    dropout through its model params, the default attention) built on
    ``device`` holding the flax-named weights ``flat``."""
    from elasticdl_tpu_torch.models.registry import get_model_spec

    params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    params += ";remat=%s;remat_policy='%s';dropout=%r" % (remat, policy,
                                                          dropout)
    spec = get_model_spec(ZOO, model_params=params)
    with torch.device(device):
        model = spec.custom_model()
    model.load_state_dict(spec.params_from_flax(flat), strict=True)
    return model, spec


def remat_trainer(torch, np, flat, widths, remat, policy, dropout=0.0,
                  device="cuda"):
    """A TorchTrainer over ``lm_model``, bf16 compute, AdamW."""
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    model, spec = lm_model(torch, flat, widths, device, remat, policy,
                           dropout)
    return TorchTrainer(model, spec.loss, spec.optimizer(),
                        compute_dtype="bfloat16", health=False,
                        device=device), spec


def remat_phase(torch, np, flash, device="cuda", widths=None,
                seq=TRAIN_SEQ, batch=TRAIN_BATCH, long_seq=REMAT_LONG_SEQ,
                steps=REMAT_STEPS):
    """The zoo TransformerLM under no remat, "dots", "flash" and "full":
    per policy a train step's K4 / K5 / K6 launches (12, 12, 12 and 24;
    12 and 12), its time and peak memory, and its gradients against no
    remat's; then one "flash" and one no-remat step at S ``long_seq``,
    batch 1 (peak memory: "flash" lower); then two steps with dropout
    0.1 under "flash" against the same steps without remat."""
    from elasticdl_tpu_torch.train.step_fns import make_loss_and_grads

    widths = dict(ZOO_WIDTHS if widths is None else widths)
    layers, vocab = widths["num_layers"], widths["vocab_size"]
    flat = zoo_weights(np, np.random.default_rng(SEED + 15), **widths)
    rng = np.random.default_rng(SEED + 16)
    tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    step_batch = {"features": tokens, "labels": tokens,
                  "_mask": np.ones(batch, np.float32)}
    records, base_grads, launches = [], None, {}
    for name, remat, policy in REMAT_POLICIES:
        trainer, spec = remat_trainer(torch, np, flat, widths, remat, policy,
                                      device=device)
        state = trainer.create_state()
        tensors = {k: torch.from_numpy(v).to(device)
                   for k, v in step_batch.items()}
        loss, grads = make_loss_and_grads(
            trainer.model, spec.loss, compute_dtype=torch.bfloat16)(
            state, tensors)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_launches(flash)
        state, first_loss = trainer.train_step(state, step_batch)
        sync(torch, torch.device(device))
        launches[name] = read_launches(flash)
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if device == "cuda" else "not measured")
        t0 = time.monotonic()
        for _ in range(steps):
            state, _ = trainer.train_step(state, step_batch)
        sync(torch, torch.device(device))
        step_ms = (time.monotonic() - t0) / steps * 1e3
        record = {"remat": name, "seq": seq, "batch": batch,
                  "launches_per_step": launches[name], "step_ms": step_ms,
                  "peak_mem_gb": peak, "loss": float(loss),
                  "first_step_loss": float(first_loss)}
        if base_grads is None:
            base_grads, base_loss = grads, float(loss)
        else:
            errs = {n: float((grads[n] - base_grads[n]).abs().max()
                             / max(float(base_grads[n].abs().max()), 1e-30))
                    for n in base_grads}
            worst = max(errs, key=errs.get)
            bad = [n for n in base_grads if not torch.allclose(
                grads[n], base_grads[n], rtol=REMAT_GRAD_RTOL,
                atol=REMAT_GRAD_ATOL)]
            record.update(
                loss_rel_diff=abs(float(loss) - base_loss) / abs(base_loss),
                grad_worst_rel=errs[worst], grad_worst=worst,
                grad_leaves_outside_tol=len(bad),
                tol=[REMAT_LOSS_RTOL, REMAT_GRAD_RTOL, REMAT_GRAD_ATOL])
        record["card"] = card_line(device)
        log(json.dumps(record))
        records.append(record)
        want_fwd = layers * (2 if name == "full" else 1)
        if launches[name] != {"fwd": want_fwd, "dq": layers, "dkv": layers}:
            raise SystemExit("remat %s launches %s (want K4 %d, K5/K6 %d)"
                             % (name, launches[name], want_fwd, layers))
        if "grad_leaves_outside_tol" in record and (
                record["grad_leaves_outside_tol"]
                or record["loss_rel_diff"] > REMAT_LOSS_RTOL):
            raise SystemExit("remat %s gradients differ from no remat's"
                             % name)
        del trainer, state, grads, tensors
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    del base_grads

    long_tokens = rng.integers(0, vocab, size=(1, long_seq), dtype=np.int32)
    long_batch = {"features": long_tokens, "labels": long_tokens,
                  "_mask": np.ones(1, np.float32)}
    long = {}
    for name, remat, policy in (("flash", True, "flash"),
                                ("none", False, "full")):
        trainer, _ = remat_trainer(torch, np, flat, widths, remat, policy,
                                   device=device)
        state = trainer.create_state()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_launches(flash)
        t0 = time.monotonic()
        state, loss = trainer.train_step(state, long_batch)
        sync(torch, torch.device(device))
        long[name] = {
            "seconds": time.monotonic() - t0, "loss": float(loss),
            "launches": read_launches(flash),
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if device == "cuda" else "not measured")}
        del trainer, state
    long_record = {"remat": "long_sequence", "seq": long_seq, "batch": 1,
                   **long, "card": card_line(device)}
    log(json.dumps(long_record))
    if not all(np.isfinite(v["loss"]) for v in long.values()) or (
            device == "cuda"
            and not long["flash"]["peak_mem_gb"] < long["none"]["peak_mem_gb"]):
        raise SystemExit("remat flash at S %d: %s" % (long_seq, long))

    dropout = {}
    for name, remat, policy in (("flash", True, "flash"),
                                ("none", False, "full")):
        trainer, _ = remat_trainer(torch, np, flat, widths, remat, policy,
                                   dropout=REMAT_DROPOUT, device=device)
        state = trainer.create_state()
        losses = []
        for _ in range(2):
            state, loss = trainer.train_step(state, step_batch)
            losses.append(float(loss))
        dropout[name] = (losses, {n: p.detach().float().cpu()
                                  for n, p in state.params.items()})
        del trainer, state
    (losses_r, params_r), (losses_n, params_n) = (dropout["flash"],
                                                  dropout["none"])
    param_diff = max(float((params_r[n] - params_n[n]).abs().max())
                     for n in params_n)
    drop_record = {"remat": "dropout_flash_vs_none", "rate": REMAT_DROPOUT,
                   "losses_flash": losses_r, "losses_none": losses_n,
                   "param_max_abs_diff": param_diff,
                   "tol": [REMAT_LOSS_RTOL, REMAT_GRAD_ATOL],
                   "card": card_line(device)}
    log(json.dumps(drop_record))
    if (not all(np.isfinite(losses_r))
            or not np.allclose(losses_r, losses_n, rtol=REMAT_LOSS_RTOL)
            or param_diff > REMAT_GRAD_ATOL):
        raise SystemExit("dropout under remat differs from no remat")
    del dropout, params_r, params_n
    gc.collect()
    return {"policies": records, "launches": launches, "long": long_record,
            "dropout": drop_record}


def small_zoo_phase(torch, np, workdir, device="cuda",
                    records=SMALL_RECORDS, batch=SMALL_BATCH):
    """mnist, cifar10 and mobilenet (its cifar variant, the zoo module's
    ``custom_model``) each one LocalExecutor epoch on small seeded
    planted-class RecordIO data; the loss falls (the mean of the last
    three steps below the first three's)."""
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    results = {}
    for name, size in SMALL_ZOO:
        rng = np.random.default_rng(SEED + len(results))
        channels = 1 if name == "mnist" else 3
        images, labels = vision_images(np, rng, records, size, 4,
                                       channels=channels)
        data = write_vision_records(np, os.path.join(workdir, name),
                                    images, labels)
        executor = LocalExecutor("elasticdl_tpu_torch.models." + name,
                                 training_data=data, minibatch_size=batch,
                                 num_epochs=1, seed=SEED, device=device)
        t0 = time.monotonic()
        losses = executor.train()
        results[name] = {"steps": len(losses), "seconds":
                         time.monotonic() - t0, "first": losses[:3],
                         "last": losses[-3:]}
        del executor
    record = {"vision": "small_zoo_local_executor", **results,
              "card": card_line(device)}
    log(json.dumps(record))
    for name, r in results.items():
        if not (np.isfinite(r["last"]).all()
                and np.mean(r["last"]) < np.mean(r["first"])):
            raise SystemExit("%s did not learn: %s" % (name, r))
    return record


def vision_phase(torch, np, flash, workdir):
    """Phase 15 on the card (see the module docstring)."""
    bench = resnet_bench(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    agreement = resnet_agreement(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    job = vision_job(torch, np, workdir)
    gc.collect()
    torch.cuda.empty_cache()
    remat = remat_phase(torch, np, flash)
    gc.collect()
    torch.cuda.empty_cache()
    small = small_zoo_phase(torch, np, workdir)
    return {"bench": bench, "agreement": agreement, "job": job,
            "remat": remat, "small": small}


# ---------------------------------------------------------------------------
# phase 16: heads of 256 (bench.py's transformer and s16k_flash) and the
# CTR zoo
# ---------------------------------------------------------------------------

# bench.py's transformer configuration (bench.py:265-280, the model and
# step scripts/bench_transformer_mfu.py:136-155 builds): d 2048, 10
# layers, 8 heads of 256, vocab 32000, mlp_ratio 4, S 1024, batch 12, no
# remat, AdamW lr 3e-4 wd 0.01, bf16 compute, the default attention
BENCH_LM_WIDTHS = dict(vocab_size=32000, num_layers=10, num_heads=8,
                       embed_dim=2048)
BENCH_LM_SEQ = 1024
BENCH_LM_BATCH = 12
BENCH_LM_WARMUP = 2
BENCH_LM_WINDOWS = 3
BENCH_LM_WINDOW_STEPS = 4
# bench.py's s16k_flash (bench.py:299-313): the same model at S 16384,
# batch 1, remat "flash" (K4's outputs saved, so K4 runs once a layer)
S16K_SEQ = 16384
S16K_STEPS = 3
# the CTR zoo at its defaults (vocab 1M, dim 8) over 39 fields of
# Zipf(1.2) ids, as phase 9's data makes them (a planted linear signal
# in the label), batch 512: 32 steps an epoch, 2 epochs
CTR_ZOO = ("wide_deep", "dcn", "xdeepfm")
CTR_RECORDS = 16384
CTR_VALID = 4096
CTR_BATCH = 512
CTR_EPOCHS = 2
# the validation AUC each variant must reach: phase 9's floor and the
# reference test's (tests/test_model_zoo.py); the CPU rehearsal of this
# configuration (the same records and seeds) reads 0.78 (DCN, which has
# no linear term), 0.86 (Wide&Deep) and 0.89 (xDeepFM)
CTR_AUC_FLOOR = 0.70
# one fp32 step at batch 64 on the card and on the CPU from the same
# weights: the loss (fp32 sums in another order), every gradient leaf
# as the optimizer receives it, and the updated parameters. The
# gradients are what hold magnitudes: a leaf's relative L2 error,
# ||g_card - g_cpu|| / ||g_cpu||, is fp32 summation order over the
# batch (a few 1e-7), and a gradient wrong by any factor on one side
# reads that factor less one. Adam's first step moves a weight by
# lr * g / (|g| + eps), about lr * sign(g), so the updated parameters
# show which way each weight moved and that the update landed, not how
# large its gradient was: the tables' atol of 1e-5 is a thousandth of
# one step (a table row's gradient is a sum over the few examples
# holding its id); a dense weight's gradient sums over the batch and
# can cancel to within a few eps of 0, where the division turns the two
# sums' rounding into up to a few percent of a step (the card read
# 1.8e-5 on Wide&Deep), so the dense weights are held to a tenth of a
# step: a sign check, with their magnitudes held by the gradients
CTR_AGREE_BATCH = 64
CTR_AGREE_LOSS_RTOL = 1e-5
CTR_AGREE_GRAD_RTOL = 1e-5
CTR_AGREE_ATOL = 1e-5
CTR_AGREE_DENSE_ATOL = 1e-3


def check_launches(record, launches, layers, what):
    """Every step of ``launches`` launched K4, K5 and K6 ``layers``
    times."""
    want = {"fwd": layers, "dq": layers, "dkv": layers}
    if any(step != want for step in launches):
        log(json.dumps(record))
        raise SystemExit("%s: launches a step %s, want %s" % (
            what, launches, want))


def bench_lm_phase(torch, np, flash, device="cuda", widths=None,
                   seq=BENCH_LM_SEQ, batch=BENCH_LM_BATCH,
                   warmup=BENCH_LM_WARMUP, windows=BENCH_LM_WINDOWS,
                   window_steps=BENCH_LM_WINDOW_STEPS):
    """bench.py's ``transformer`` through the port's ``make_train_step``
    (heads of 256 through K4-K6): the first step's loss and gradients
    from the carried weights against the same model on plain attention
    (phase 6's rules), then warm-up steps and windows of steps, each
    fenced by its loss; K4, K5 and K6 launches counted in every step.
    Step ms and tokens/s of the best window, peak memory, the FLOP share
    of the bf16 peak (``model_train_flops``) and a profiled step."""
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.train.step_fns import make_train_step
    from elasticdl_tpu_torch.train.train_state import create_train_state

    widths = dict(BENCH_LM_WIDTHS if widths is None else widths)
    layers = widths["num_layers"]
    flat = zoo_weights(np, np.random.default_rng(SEED + 17), **widths)
    model, spec = lm_model(torch, flat, widths, device)
    tokens = np.random.RandomState(0).randint(
        0, widths["vocab_size"], size=(batch, seq)).astype(np.int32)
    step_batch = {"features": tokens, "labels": tokens,
                  "_mask": np.ones(batch, np.float32)}
    params = ";".join("%s=%d" % kv for kv in sorted(widths.items()))
    agreement = first_step_agreement(
        torch, model, get_model_spec(
            ZOO, model_params=params + ";attention_impl='xla'"),
        step_batch, device)
    log(json.dumps(dict(agreement, phase="16_bench_transformer",
                        card=card_line(device))))
    hold_agreement(agreement, "bench transformer's first step")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    tx = spec.optimizer()  # AdamW lr 3e-4, weight decay 0.01
    step_fn = make_train_step(model, spec.loss, tx,
                              compute_dtype=torch.bfloat16)
    tensors = {k: torch.from_numpy(v).to(device)
               for k, v in step_batch.items()}
    state = create_train_state(model, tx)
    losses, launches, best = [], [], float("inf")

    def counted_step(state):
        reset_launches(flash)
        state, loss = step_fn(state, tensors)
        launches.append(read_launches(flash))
        return state, loss

    for _ in range(warmup):
        state, loss = counted_step(state)
        losses.append(float(loss))
    for _ in range(windows):
        sync(torch, torch.device(device))
        t0 = time.perf_counter()
        for _ in range(window_steps):
            state, loss = counted_step(state)
        losses.append(float(loss))  # the fetch fences the window
        best = min(best, time.perf_counter() - t0)
    step_s = best / window_steps
    flops = model_train_flops(widths["embed_dim"], layers, seq, batch,
                              widths["vocab_size"])
    record = {
        "phase": "16_bench_transformer",
        "config": "bench.py:265-280, scripts/bench_transformer_mfu.py:"
                  "136-155", "widths": widths, "head_dim":
        widths["embed_dim"] // widths["num_heads"], "seq": seq,
        "batch": batch, "remat": "none", "attention_impl": "auto",
        "compute_dtype": "bfloat16", "warmup": warmup, "windows": windows,
        "window_steps": window_steps, "step_ms": step_s * 1e3,
        "tokens_per_s": batch * seq / step_s, "losses": losses,
        "launches_per_step": launches,
        "model_tflop_per_step": flops / 1e12,
        "flop_share_of_bf16_peak": flops / step_s / PEAK_FLOPS["bfloat16"],
    }
    if not all(np.isfinite(losses)):
        log(json.dumps(record))
        raise SystemExit("bench transformer losses: %s" % losses)
    check_launches(record, launches, layers, "bench transformer")
    if device == "cuda":
        record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        holder = {"state": state}

        def one():
            holder["state"], _ = step_fn(holder["state"], tensors)

        record["step_profile"] = profile_dense_step(
            torch, one, "bench_transformer_train_step")
        state = holder["state"]
    else:
        record["peak_mem_gb"] = "not measured"
    record["card"] = card_line(device)
    log(json.dumps(record))
    del state, model, tensors, step_fn
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"record": record, "agreement": agreement, "flat": flat,
            "widths": widths}


def s16k_phase(torch, np, flash, flat, widths, device="cuda",
               seq=S16K_SEQ, steps=S16K_STEPS):
    """bench.py's ``s16k_flash``: the same model at S ``seq``, batch 1,
    remat "flash" through ``TorchTrainer``; every step launches K4, K5
    and K6 once a layer ("flash" saves K4's outputs); step ms (the steps
    after the first), tokens/s, the FLOP share of the bf16 peak (the
    formula's, without the recompute) and peak memory."""
    layers = widths["num_layers"]
    trainer, _ = remat_trainer(torch, np, flat, widths, True, "flash",
                               device=device)
    tokens = np.random.RandomState(0).randint(
        0, widths["vocab_size"], size=(1, seq)).astype(np.int32)
    step_batch = {"features": tokens, "labels": tokens,
                  "_mask": np.ones(1, np.float32)}
    state = trainer.create_state()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, launches, step_ms = [], [], []
    for _ in range(steps):
        reset_launches(flash)
        sync(torch, torch.device(device))
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, step_batch)
        losses.append(float(loss))  # fences the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches(flash))
    timed = step_ms[1:] or step_ms
    mean_s = sum(timed) / len(timed) / 1e3
    flops = model_train_flops(widths["embed_dim"], layers, seq, 1,
                              widths["vocab_size"])
    record = {
        "phase": "16_s16k_flash", "config": "bench.py:299-313",
        "seq": seq, "batch": 1, "remat": "flash", "steps": steps,
        "step_ms": step_ms, "step_ms_after_first": mean_s * 1e3,
        "tokens_per_s": seq / mean_s, "losses": losses,
        "launches_per_step": launches,
        "model_tflop_per_step": flops / 1e12,
        "flop_share_of_bf16_peak": flops / mean_s / PEAK_FLOPS["bfloat16"],
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if device == "cuda" else "not measured"),
        "card": card_line(device),
    }
    log(json.dumps(record))
    if not all(np.isfinite(losses)):
        raise SystemExit("s16k_flash losses: %s" % losses)
    check_launches(record, launches, layers, "s16k_flash")
    del trainer, state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return record


class RecordGrads:
    """An optimizer that keeps a CPU copy of the gradients its last
    ``update`` received and otherwise is ``tx``."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def update(self, grads, opt_state, params):
        self.grads = {n: g.detach().cpu().clone() for n, g in grads.items()}
        return self.tx.update(grads, opt_state, params)


def ctr_agreement(torch, np, variant, device="cuda",
                  batch=CTR_AGREE_BATCH, fields=SPARSE_FIELDS,
                  vocab=SPARSE_VOCAB):
    """One fp32 step of ``variant`` at ``batch`` through TorchTrainer on
    ``device`` and on the CPU from the same weights (sized by the batch,
    drawn from SEED): the loss, every gradient leaf as the optimizer
    receives it, and every updated parameter."""
    import copy

    from elasticdl_tpu_torch.models import ctr
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    (step_batch,) = ctr_batches(np, 1, batch=batch, fields=fields,
                                vocab=vocab, seed=SEED + 18)
    model = ctr.VARIANTS[variant](vocab=vocab)
    with torch.no_grad():
        model({"ids": torch.from_numpy(step_batch["features"]["ids"])})
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    results = []
    for where, net in ((device, copy.deepcopy(model)), ("cpu", model)):
        tx = RecordGrads(ctr.optimizer())
        trainer = TorchTrainer(net, ctr.loss, tx, health=False,
                               device=where)
        state, loss = trainer.train_step(trainer.create_state(),
                                         step_batch)
        params = {n: p.detach().cpu() for n, p in state.params.items()}
        results.append((loss.item(), tx.grads, params))
        del trainer, state
    (loss_d, grads_d, params_d), (loss_c, grads_c, params_c) = results
    grad_rel = {n: float((grads_d[n] - grads_c[n]).norm()
                         / grads_c[n].norm().clamp(min=1e-30))
                for n in grads_c}
    diffs = {n: float((params_d[n] - params_c[n]).abs().max())
             for n in params_c}
    tables = [n for n in diffs if n.endswith("embeddings")]
    # how far the step moved each table (a step that leaves a table as
    # it was fails the phase)
    moved = {n: float((params_c[n] - initial[n]).abs().max())
             for n in tables}
    dense = max(d for n, d in diffs.items() if n not in tables)
    return {
        "loss": loss_d, "cpu_loss": loss_c,
        "loss_rel_diff": abs(loss_d - loss_c) / abs(loss_c),
        "grad_rel_l2": grad_rel,
        "grad_worst_rel_l2": max(grad_rel.values()),
        "grad_worst": max(grad_rel, key=grad_rel.get),
        "table_max_abs_diff": max(diffs[n] for n in tables),
        "dense_max_abs_diff": dense,
        "dense_worst": max((n for n in diffs if n not in tables),
                           key=diffs.get),
        "tables_moved": moved, "params": len(diffs),
        "tol": {"loss_rel": CTR_AGREE_LOSS_RTOL,
                "grad_rel_l2": CTR_AGREE_GRAD_RTOL,
                "table_abs": CTR_AGREE_ATOL,
                "dense_abs": CTR_AGREE_DENSE_ATOL},
    }


def ctr_phase(torch, np, workdir, device="cuda", records=CTR_RECORDS,
              valid=CTR_VALID, batch=CTR_BATCH, epochs=CTR_EPOCHS,
              fields=SPARSE_FIELDS, vocab=SPARSE_VOCAB,
              agree_batch=CTR_AGREE_BATCH, auc_floor=CTR_AUC_FLOOR):
    """Wide&Deep, DCN and xDeepFM at the zoo's defaults through the
    port's ``LocalExecutor`` over RecordIO records with a planted signal
    (``job_data``'s, in one file): every loss finite and falling (the
    mean of the last four steps below the first four's), the validation
    AUC at least ``auc_floor``, and ``ctr_agreement`` within its
    tolerances. Steps/s of the run (the host's reading and batching
    included), peak memory and the AUC."""
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    train_dir, valid_dir = job_data(np, os.path.join(workdir, "ctr"),
                                    records=records, valid=valid, files=1,
                                    fields=fields, vocab=vocab)
    results = {}
    for variant in CTR_ZOO:
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        executor = LocalExecutor(
            "elasticdl_tpu_torch.models." + variant,
            training_data=train_dir, validation_data=valid_dir,
            minibatch_size=batch, num_epochs=epochs, seed=SEED,
            device=device)
        t0 = time.monotonic()
        losses = executor.train()
        seconds = time.monotonic() - t0
        auc = float(executor.evaluate()["auc"])
        record = {
            "phase": "16_ctr", "variant": variant, "vocab": vocab,
            "dim": 8, "fields": fields, "batch": batch, "epochs": epochs,
            "records": records, "compute_dtype": "float32",
            "steps": len(losses), "steps_per_s": len(losses) / seconds,
            "examples_per_s": len(losses) * batch / seconds,
            "first_losses": losses[:4], "last_losses": losses[-4:],
            "auc": auc, "auc_floor": auc_floor,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if device == "cuda" else "not measured"),
        }
        del executor
        gc.collect()
        record["agreement"] = ctr_agreement(torch, np, variant, device,
                                            batch=agree_batch, fields=fields,
                                            vocab=vocab)
        record["card"] = card_line(device)
        log(json.dumps(record))
        ctr_check(np, variant, losses, record)
        results[variant] = record
    return results


def ctr_check(np, variant, losses, record):
    """Raise unless ``variant`` learned (finite losses, the last four
    steps' mean below the first four's), reached its AUC floor, and its
    card step agreed with the CPU's (the loss, every gradient leaf, the
    updated parameters) and moved every table."""
    agree = record["agreement"]
    if not (np.isfinite(losses).all()
            and np.mean(losses[-4:]) < np.mean(losses[:4])):
        raise SystemExit("%s did not learn: %s" % (variant, losses))
    if not record["auc"] >= record["auc_floor"]:
        raise SystemExit("%s AUC %.4f below %.2f" % (
            variant, record["auc"], record["auc_floor"]))
    if not min(agree["tables_moved"].values()) > 0:
        raise SystemExit("%s: a table did not move in one step: %s"
                         % (variant, agree["tables_moved"]))
    if not agree["grad_worst_rel_l2"] <= CTR_AGREE_GRAD_RTOL:
        raise SystemExit("%s: the card's gradients disagree with the "
                         "CPU's: %s reads %.3g" % (
                             variant, agree["grad_worst"],
                             agree["grad_worst_rel_l2"]))
    if not (agree["loss_rel_diff"] <= CTR_AGREE_LOSS_RTOL
            and agree["table_max_abs_diff"] <= CTR_AGREE_ATOL
            and agree["dense_max_abs_diff"] <= CTR_AGREE_DENSE_ATOL):
        raise SystemExit("%s: the card's step disagrees with the CPU's: "
                         "%s" % (variant, agree))


def heads256_ctr_phase(torch, np, flash, workdir):
    """Phase 16 on the card (see the module docstring)."""
    bench = bench_lm_phase(torch, np, flash)
    s16k = s16k_phase(torch, np, flash, bench.pop("flat"), bench["widths"])
    ctr_records = ctr_phase(torch, np, workdir)
    return {"bench": bench, "s16k": s16k, "ctr": ctr_records}


# ---------------------------------------------------------------------------
# phase 17: the feature-column family
# ---------------------------------------------------------------------------

# the promoted model: tests/test_model_handler.py's columns with cat_big
# at 1,000,000 buckets x dim 8 (32 MB of fp32, over the reference's
# 2 MiB: promoted at the default threshold), 1-5 ids a row under "mean"
FEATURE_VOCAB = 1_000_000
FEATURE_DIM = 8
FEATURE_MAX_IDS = 5
FEATURE_BATCH = 512
FEATURE_STEPS = 200
FEATURE_LR = 0.05              # the reference test's Adam, dense and PS
# once the tier is this many steps old, K1, K2 and K3 each launch in
# every step
FEATURE_WARM = 20
# batch rows past the mask hold ids no real slot holds: 0 (the padded
# slots' id after materialize_ids) and FEATURE_VOCAB - 1
FEATURE_PAD_ROWS = 8
FEATURE_LOSS_DROP = 0.7        # last-10 mean below 0.7 x first-10 mean
FEATURE_TIER_ENV = {"EDL_DEVICE_TIER": "1",
                    "EDL_DEVICE_TIER_OPT_ARGS": "lr=%g" % FEATURE_LR}
# card against CPU: fp32 (TF32 off), three steps from carried weights
# and one store seed, adam eps 1e-3 (phase 7's reason); the loss, every
# dense gradient leaf and the row gradients per step
FEATURE_AGREE_STEPS = 3
FEATURE_AGREE_RTOL = 1e-5
# the promoted column's output against a float64 numpy mean of the
# same PS rows over the real slots
FEATURE_COMBINE_RTOL = 1e-6
# the four LocalExecutor models at the reference tests' sizes and floors:
# (module, records (train, valid), epochs, AUC floor)
FEATURE_ZOO = (
    ("census_wide_deep", (2048, 256), 8, 0.75),
    ("census_dnn", (2048, 512), 6, 0.75),
    ("census_sqlflow_wide_deep", (2048, 512), 6, 0.75),
    ("heart", (1024, 256), 10, 0.7),
)
FEATURE_ZOO_BATCH = 64
# the weights' seed. The floors were set on the reference's own draws,
# and both packages' draws move the AUC past them: on the CPU the port's
# seed 0 leaves census_sqlflow_wide_deep at 0.636 after its 6 epochs
# (seeds 1-7: 0.81-0.93), and the reference's heart reads 0.68-0.80
# over seeds 0-5 (PERF.md §6). The zoo trains from seed 1, the first
# after 0.
FEATURE_ZOO_SEED = 1
FEATURE_ZOO_AGREE = "census_wide_deep"
# iris as a job: rows as tests/test_model_zoo.py's create_iris_csv
# makes them (with a header row), two training files and one
# validation file of 120 rows, 16 rows a task, 10 epochs
IRIS_COLUMNS = ("sepal_length", "sepal_width", "petal_length",
                "petal_width", "label")
IRIS_FILES = 2
IRIS_ROWS = 120
IRIS_PER_TASK = 16
IRIS_EPOCHS = 10
IRIS_BATCH = 16
IRIS_ACCURACY_FLOOR = 0.85
IRIS_SERVE_ROWS = 32
IRIS_WAIT_S = 240


class patched_env:
    """``os.environ`` with ``values`` set inside the block."""

    def __init__(self, values):
        self.values, self.saved = dict(values), {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for key, value in self.saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def feature_columns(vocab=FEATURE_VOCAB):
    from elasticdl_tpu_torch.preprocessing import feature_column as fc

    big = fc.embedding_column(
        fc.categorical_column_with_identity("cat_big", vocab),
        dimension=FEATURE_DIM, combiner="mean")
    small = fc.embedding_column(
        fc.categorical_column_with_identity("cat_small", 10), dimension=4)
    return [big, small, fc.numeric_column("x")]


def feature_model(torch, plan, seed=SEED):
    """tests/test_model_handler.py's ``_Model`` over the plan's columns:
    DenseFeatures, Dense 16 + ReLU, Dense 1; weights from ``seed``."""
    from elasticdl_tpu_torch.models.layers import Dense
    from elasticdl_tpu_torch.models.feature_net import FeatureNet
    from elasticdl_tpu_torch.train import model_handler as mh

    class Model(FeatureNet):
        def __init__(self):
            super().__init__()
            self.features_layer = mh.dense_features(plan)
            self.Dense_0 = Dense(self.features_layer.output_dim, 16)
            self.Dense_1 = Dense(16, 1)

        def forward(self, features):
            x = torch.relu(self.Dense_0(self.features_layer(features)))
            return self.Dense_1(x)[:, 0]

    model = Model()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def feature_batches(np, plan, n, batch=FEATURE_BATCH, vocab=FEATURE_VOCAB,
                    seed=SEED + 17):
    """``n`` batches, ids materialized: each row 1-5 Zipf(1.2) ids in
    [1, vocab - 2] through ``from_row_lists``, cat_small in [0, 10), x
    normal; the last FEATURE_PAD_ROWS rows masked out, holding id
    vocab - 1. The label is a planted linear signal over per-id weights
    (mean over the row's ids, as the combiner) and x."""
    from elasticdl_tpu_torch.preprocessing.sparse import from_row_lists

    rng = np.random.RandomState(seed)
    weights = np.random.RandomState(JOB_SIGNAL_SEED).randn(vocab).astype(
        np.float32)
    out = []
    for _ in range(n):
        lengths = rng.randint(1, FEATURE_MAX_IDS + 1, size=batch)
        ids = rng.zipf(1.2, size=(batch, FEATURE_MAX_IDS)) % (vocab - 2) + 1
        rows = [list(ids[i, :lengths[i]]) for i in range(batch)]
        for i in range(batch - FEATURE_PAD_ROWS, batch):
            rows[i] = [vocab - 1] * len(rows[i])
        x = rng.normal(size=batch).astype(np.float32)
        score = np.array([weights[r].mean() for r in rows]) + 0.5 * x
        mask = np.ones(batch, np.float32)
        mask[batch - FEATURE_PAD_ROWS:] = 0
        out.append({
            "features": plan.materialize_ids({
                "cat_big": from_row_lists(rows, max_len=FEATURE_MAX_IDS),
                "cat_small": rng.randint(0, 10, size=(batch, 1)),
                "x": x}),
            "labels": (score > 0).astype(np.float32),
            "_mask": mask,
        })
    return out


def feature_trainer(torch, plan, model, device, eps=None):
    """SparseTrainer over the plan's host-PS table: the in-process store
    ``LocalPSClient`` picks (adam, seed SEED), the tier on through
    ``EDL_DEVICE_TIER=1`` (its default knobs, adam at FEATURE_LR)."""
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train.losses import sigmoid_binary_cross_entropy
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.sparse import SparseTrainer

    eps_args = {} if eps is None else {"epsilon": eps}
    env = dict(FEATURE_TIER_ENV)
    if eps is not None:
        env["EDL_DEVICE_TIER_OPT_ARGS"] += ";epsilon=%g" % eps
    tx = RecordGrads(create_optimizer("Adam", learning_rate=FEATURE_LR,
                                      **eps_args))
    with patched_env(env):
        trainer = SparseTrainer(
            model, sigmoid_binary_cross_entropy, tx, plan.sparse_specs,
            LocalPSClient(seed=SEED, opt_type="adam", lr=FEATURE_LR,
                          **eps_args),
            seed=SEED, device=device, health=False)
    if trainer.device_tier is None:
        raise SystemExit("EDL_DEVICE_TIER=1 left the tier off")
    return trainer, tx


def combiner_check(torch, np, plan, batch, device):
    """The promoted column's output on ``device`` (the pulled rows
    gathered and combined under "mean") against a float64 numpy mean of
    the same PS rows over each real row's real slots."""
    from elasticdl_tpu_torch.ps.local_client import LocalPSClient
    from elasticdl_tpu_torch.train import model_handler as mh
    from elasticdl_tpu_torch.train.sparse import (
        SparseBatchPreparer,
        _to_device,
    )

    (column,) = plan.promoted
    ps = LocalPSClient(seed=SEED)
    prepared, _ = SparseBatchPreparer(plan.sparse_specs, ps).prepare(batch)
    got = column(_to_device(prepared["features"], torch.device(device)))
    got = got.detach().cpu().numpy()
    ids = batch["features"][mh.IDS_PREFIX + column.table_name]
    slots = batch["features"][column.table_name + mh.MASK_SUFFIX]
    real = batch["_mask"] > 0
    rows = ps.pull_embedding_vectors(column.table_name, ids.reshape(-1))
    rows = rows.reshape(ids.shape + (FEATURE_DIM,)).astype(np.float64)
    want = (rows * slots[..., None]).sum(1) / np.maximum(
        slots.sum(1, keepdims=True), 1)
    err = float(np.abs(got[real] - want[real]).max()
                / np.abs(want[real]).max())
    return {"max_rel_err": err, "tol": FEATURE_COMBINE_RTOL,
            "rows": int(real.sum())}


def feature_agreement(torch, np, plan, batches, device="cuda"):
    """FEATURE_AGREE_STEPS steps of the promoted model on ``device`` and
    on the CPU from the same weights, each over its own store of one
    seed with the tier on (adam eps 1e-3): per step the loss, every
    dense gradient leaf (as the optimizer receives it) and the row
    gradients d(loss)/d(rows) of the whole pulled buffer, hits and
    misses, as relative L2 errors."""
    import copy

    model = feature_model(torch, plan)
    runs = []
    for where, net in ((device, copy.deepcopy(model)), ("cpu", model)):
        trainer, tx = feature_trainer(torch, plan, net, where,
                                      eps=SPARSE_AGREE_EPS)
        step_fn, rows = trainer._train_step, []

        def recording(state, b, step_fn=step_fn, rows=rows):
            out = step_fn(state, b)
            rows.append({k: v.detach().cpu().clone()
                         for k, v in out[2].items()})
            return out

        trainer._train_step = recording
        state, steps = None, []
        for b in batches[:FEATURE_AGREE_STEPS]:
            state = trainer.ensure_state(state, b)
            state, loss = trainer.train_step(state, b)
            steps.append((loss.item(), tx.grads, rows[-1]))
        hits = trainer.device_tier.stats()
        trainer.close()
        runs.append((steps, hits))
        del trainer, state

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    (card, card_stats), (cpu, _) = runs
    per_step = []
    for (loss_d, grads_d, rows_d), (loss_c, grads_c, rows_c) in zip(card,
                                                                    cpu):
        dense = {n: rel(grads_d[n], grads_c[n]) for n in grads_c}
        row = {n: rel(rows_d[n], rows_c[n]) for n in rows_c}
        per_step.append({"loss_rel": abs(loss_d - loss_c) / abs(loss_c),
                         "dense_worst": max(dense.values()),
                         "dense_worst_leaf": max(dense, key=dense.get),
                         "rows": row})
    worst = max(max(s["loss_rel"], s["dense_worst"], *s["rows"].values())
                for s in per_step)
    return {"steps": per_step, "worst_rel_l2": worst,
            "tol": FEATURE_AGREE_RTOL,
            "card_tier_hits": card_stats.get("hits"),
            "dense_leaves": len(card[0][1])}


def promoted_phase(torch, np, tier, workdir, device="cuda",
                   vocab=FEATURE_VOCAB, batch=FEATURE_BATCH,
                   steps=FEATURE_STEPS, warm=FEATURE_WARM):
    """The promoted model (see the module docstring, phase 17)."""
    from elasticdl_tpu_torch.train import model_handler as mh

    t0 = time.monotonic()
    plan = mh.promote_large_embeddings(feature_columns(vocab))
    (column,) = plan.promoted
    name = column.table_name
    if plan.table_shapes != {name: (vocab, FEATURE_DIM)} or len(
            plan.kept) != 2:
        raise SystemExit("the plan did not promote cat_big alone: %s"
                         % plan.table_shapes)
    batches = feature_batches(np, plan, steps, batch=batch, vocab=vocab)
    data_s = time.monotonic() - t0
    combine = combiner_check(torch, np, plan, batches[0], device)
    log(json.dumps({"phase": "17_features", "part": "combiner", **combine}))
    if not combine["max_rel_err"] <= FEATURE_COMBINE_RTOL:
        raise SystemExit("the promoted column's mean disagrees with numpy: "
                         "%s" % combine)
    agree = feature_agreement(torch, np, plan, batches, device)
    log(json.dumps({"phase": "17_features", "part": "agreement", **agree}))
    if not agree["worst_rel_l2"] <= FEATURE_AGREE_RTOL:
        raise SystemExit("the promoted step on the card disagrees with the "
                         "CPU's: %s" % agree)

    trainer, _ = feature_trainer(torch, plan, feature_model(torch, plan),
                                 device)
    ps = trainer.preparer._ps
    rec = count_worker_steps(tier, trainer, tables=1)
    reset_tier_launches(tier)
    state, losses = None, []
    run_t0 = time.monotonic()
    for b in batches:
        state = trainer.ensure_state(state, b)
        state, loss = trainer.train_step(state, b)
        losses.append(float(loss))
    sync(torch, torch.device(device))
    run_s = time.monotonic() - run_t0
    totals = tier_counts(tier)
    stats = trainer.device_tier.stats()
    store_ids, _ = ps.store.export_table(name)
    resident, _ = trainer.device_tier.table_rows(name)
    candidates = trainer.device_tier._tables[name].cand_ids
    padded_only = np.array([0, vocab - 1])
    leaked = sorted(int(i) for i in np.intersect1d(
        padded_only, np.concatenate([store_ids, resident, candidates])))
    warm_launches = rec["launches"][warm:]
    t = time.monotonic()
    trainer.close()  # the tier's flush: every resident row to the PS
    export_dir = os.path.join(workdir, "promoted_export")
    mh.export_promoted_train_state(state, plan, ps, export_dir)
    export_s = time.monotonic() - t
    table = mh.load_exported_tables(export_dir)[name]
    live = ps.pull_embedding_vectors(name, np.arange(vocab, dtype=np.int64))
    record = {
        "phase": "17_features", "part": "promoted", "vocab": vocab,
        "dim": FEATURE_DIM, "batch": batch, "steps": steps,
        "table_mb": vocab * FEATURE_DIM * 4 / 2**20,
        "threshold_mb": mh.EMBEDDING_PROMOTION_THRESHOLD_BYTES / 2**20,
        "store": type(ps.store).__name__,
        "steps_per_s": steps / run_s,
        "examples_per_s": steps * batch / run_s,
        "first_losses_mean": float(np.mean(losses[:10])),
        "last_losses_mean": float(np.mean(losses[-10:])),
        "launches": dict(zip(("gather", "insert_rows", "scatter_apply"),
                             totals)),
        "launches_per_step": {k: v / steps for k, v in zip(
            ("gather", "insert_rows", "scatter_apply"), totals)},
        "warm_steps_missing": [[warm + i, launches] for i, launches in
                               enumerate(warm_launches) if min(launches) < 1],
        "bad_steps": rec["bad_steps"][:5], "n_bad_steps":
        len(rec["bad_steps"]), "tier": stats,
        "ps_rows": int(store_ids.size), "padded_only_ids_created": leaked,
        "export_rows_equal_ps": bool(np.array_equal(table, live)),
        "export_seconds": export_s, "data_seconds": data_s,
        "card": card_line(device)}
    log(json.dumps(record))
    failures = [what for what, bad in (
        ("finite losses", not np.isfinite(losses).all()),
        ("the loss falls", not record["last_losses_mean"]
         < FEATURE_LOSS_DROP * record["first_losses_mean"]),
        ("K1-K3 by the path's formula", record["n_bad_steps"]),
        ("K1, K2 and K3 in every warm step", record["warm_steps_missing"]),
        ("no row or slot for a padded-only id", leaked),
        ("exported rows bit-equal to the PS", not record[
            "export_rows_equal_ps"])) if bad]
    if failures:
        raise SystemExit("promoted model: %s" % failures)
    return dict(record, combiner=combine, agreement=agree)


def zoo_agreement(torch, np, name, batch, device):
    """One fp32 step of zoo model ``name`` through TorchTrainer on
    ``device`` and on the CPU from the same weights: the loss and every
    gradient leaf as the optimizer receives it (relative L2)."""
    import copy
    import importlib

    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    mod = importlib.import_module("elasticdl_tpu_torch.models." + name)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(FEATURE_ZOO_SEED)
        model = mod.custom_model()
    results = []
    for where, net in ((device, copy.deepcopy(model)), ("cpu", model)):
        tx = RecordGrads(mod.optimizer())
        trainer = TorchTrainer(net, mod.loss, tx, health=False, device=where)
        _, loss = trainer.train_step(trainer.create_state(), batch)
        results.append((loss.item(), tx.grads))
    (loss_d, grads_d), (loss_c, grads_c) = results
    rel = {n: float((grads_d[n] - grads_c[n]).norm()
                    / grads_c[n].norm().clamp(min=1e-30)) for n in grads_c}
    return {"loss_rel": abs(loss_d - loss_c) / abs(loss_c),
            "grad_worst_rel_l2": max(rel.values()),
            "grad_worst": max(rel, key=rel.get), "leaves": len(rel),
            "tol": FEATURE_AGREE_RTOL}


def feature_zoo_phase(torch, np, workdir, device="cuda", zoo=FEATURE_ZOO,
                      batch=FEATURE_ZOO_BATCH):
    """census_wide_deep, census_dnn, census_sqlflow_wide_deep and heart
    through the port's LocalExecutor on ``device`` over RecordIO from the
    port's generators (training seed 0, validation seed 1), from
    FEATURE_ZOO_SEED's weights: finite losses, the last below the first,
    the validation AUC above the reference test's floor; census_wide_deep
    also one card-against-CPU step (``zoo_agreement``)."""
    from elasticdl_tpu_torch.data.gen import (
        gen_census_recordio,
        gen_heart_recordio,
    )
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    results = {}
    for name, (n_train, n_valid), epochs, floor in zoo:
        maker = gen_heart_recordio if name == "heart" else (
            gen_census_recordio)
        root = os.path.join(workdir, "features_" + name)
        train_dir, valid_dir = (os.path.join(root, "train"),
                                os.path.join(root, "valid"))
        maker(train_dir, num_records=n_train, seed=0)
        maker(valid_dir, num_records=n_valid, seed=1)
        executor = LocalExecutor(
            "elasticdl_tpu_torch.models." + name, training_data=train_dir,
            validation_data=valid_dir, minibatch_size=batch,
            num_epochs=epochs, seed=FEATURE_ZOO_SEED, device=device)
        t0 = time.monotonic()
        losses = executor.train()
        seconds = time.monotonic() - t0
        auc = float(executor.evaluate()["auc"])
        record = {
            "phase": "17_features", "part": "zoo", "model": name,
            "records": n_train, "batch": batch, "epochs": epochs,
            "seed": FEATURE_ZOO_SEED, "steps": len(losses),
            "steps_per_s": len(losses) / seconds,
            "examples_per_s": len(losses) * batch / seconds,
            "first_loss": losses[0], "last_loss": losses[-1], "auc": auc,
            "auc_floor": floor, "card": card_line(device)}
        if name == FEATURE_ZOO_AGREE:
            first = next(iter(executor._batches(executor._train_reader,
                                                "training")))
            record["agreement"] = zoo_agreement(torch, np, name, first,
                                                device)
        log(json.dumps(record))
        agree = record.get("agreement")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise SystemExit("%s did not learn: %s ... %s"
                             % (name, losses[:3], losses[-3:]))
        if not auc > floor:
            raise SystemExit("%s AUC %.4f not above %.2f" % (name, auc, floor))
        if agree is not None and not max(
                agree["loss_rel"], agree["grad_worst_rel_l2"]) <= (
                    FEATURE_AGREE_RTOL):
            raise SystemExit("%s: the card's step disagrees with the CPU's: "
                             "%s" % (name, agree))
        results[name] = record
        del executor
        gc.collect()
    return results


def iris_records(np, num_records=IRIS_ROWS, seed=0):
    """tests/test_model_zoo.py's create_iris_csv rows: four features at
    the file's three decimals and an int label a row."""
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(num_records):
        label = rng.randint(0, 3)
        base = np.array([4.5, 3.0, 1.5, 0.2]) + label * np.array(
            [1.0, 0.2, 1.8, 0.9])
        row = base + rng.randn(4) * 0.2
        rows.append(tuple(float("%.3f" % v) for v in row) + (int(label),))
    return rows


def iris_rows(np, path, num_records=IRIS_ROWS, seed=0):
    """``iris_records`` as a CSV file with a header row (the CSV reader
    takes the first line as one)."""
    with open(path, "w") as f:
        f.write(",".join(IRIS_COLUMNS) + "\n")
        for row in iris_records(np, num_records, seed):
            f.write(",".join("%.3f" % v for v in row[:4])
                    + ",%d\n" % row[4])
    return path


def iris_job(torch, np, workdir, device="cuda", files=IRIS_FILES,
             rows=IRIS_ROWS, per_task=IRIS_PER_TASK, epochs=IRIS_EPOCHS,
             batch=IRIS_BATCH, wait_s=IRIS_WAIT_S):
    """iris as a job (see the module docstring, phase 17)."""
    from elasticdl_tpu_torch.common.grpc_utils import (
        build_server,
        find_free_port,
    )
    from elasticdl_tpu_torch.master.state_store import (
        JOURNAL_NAME,
        STATE_DIR_ENV,
    )
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.proto.services import (
        add_serve_servicer_to_server,
    )
    from elasticdl_tpu_torch.serve.client import ServeClient
    from elasticdl_tpu_torch.serve.engine import ServingEngine
    from elasticdl_tpu_torch.serve.servicer import ServeServicer
    from elasticdl_tpu_torch.train.export import load_exported
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    zoo = "elasticdl_tpu_torch.models.iris_dnn"
    out = os.path.join(HERE, "build", "chip_smoke_iris")
    shutil.rmtree(out, ignore_errors=True)
    root = os.path.join(workdir, "iris")
    train_dir, valid_dir = (os.path.join(root, "train"),
                            os.path.join(root, "valid"))
    for d in (out, train_dir, valid_dir):
        os.makedirs(d)
    for i in range(files):
        iris_rows(np, os.path.join(train_dir, "part-%d.csv" % i), rows,
                  seed=2 * i)
    iris_rows(np, os.path.join(valid_dir, "valid.csv"), rows, seed=1)
    state_dir, export_dir = (os.path.join(out, "state"),
                             os.path.join(out, "export"))
    port = find_free_port()
    env = dict(os.environ, PYTHONPATH=HERE, **{STATE_DIR_ENV: state_dir})
    master_log, worker_log = (os.path.join(out, "master.log"),
                              os.path.join(out, "worker-0.log"))
    procs = []
    try:
        t0 = time.monotonic()
        with open(master_log, "w") as sink:
            master = subprocess.Popen(
                [sys.executable, "-m", "elasticdl_tpu_torch.master.main",
                 "--model_zoo", zoo, "--training_data", train_dir,
                 "--records_per_task", str(per_task), "--num_epochs",
                 str(epochs), "--minibatch_size", str(batch), "--port",
                 str(port), "--output", export_dir], cwd=HERE, env=env,
                stdout=sink, stderr=subprocess.STDOUT)
        procs.append(master)
        wait_for_line(master, master_log, "Master serving on :%d" % port,
                      "the iris master")
        worker = start_worker_process(worker_log, [
            "--model_zoo", zoo, "--training_data", train_dir,
            "--minibatch_size", str(batch), "--master_addr",
            "localhost:%d" % port, "--worker_id", "0", "--device",
            torch.device(device).type], env)
        procs.append(worker)
        master_rc = master.wait(wait_s)
        worker_rc = worker.wait(60)
        job_s = time.monotonic() - t0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ops = journal_ops(os.path.join(state_dir, JOURNAL_NAME))
    created = {t[0]: t[1] for op in ops if op["op"] == "tasks_created"
               for t in op["tasks"]}
    done = [op["task"] for op in ops if op["op"] == "done"]
    training = [t for t, kind in created.items() if kind == pb.TRAINING]
    train_end = [t for t, kind in created.items()
                 if kind == pb.TRAIN_END_CALLBACK]
    # the export's accuracy on the validation rows, on the card
    spec = get_model_spec(zoo)
    params, _, export_step = load_exported(export_dir)
    model = spec.custom_model()
    model.load_state_dict(spec.params_from_flax(params), strict=True)
    trainer = TorchTrainer(model, spec.loss, spec.optimizer(), health=False,
                           device=device)
    state = trainer.create_state()
    valid = np.loadtxt(os.path.join(valid_dir, "valid.csv"), delimiter=",",
                       skiprows=1, dtype=np.float32)
    x, labels = valid[:, :4], valid[:, 4].astype(np.int64)
    logits = trainer.eval_step(state, {"features": x})
    accuracy = float((logits.argmax(-1) == labels).mean())
    # the export served by an in-process engine over gRPC
    engine = ServingEngine(zoo, export_dir, max_batch=IRIS_SERVE_ROWS,
                           max_delay_ms=2.0, deadline_ms=60000.0,
                           device=device).start(block=True)
    server = build_server()
    add_serve_servicer_to_server(ServeServicer(engine), server)
    serve_port = find_free_port()
    server.add_insecure_port("localhost:%d" % serve_port)
    server.start()
    try:
        with ServeClient("localhost:%d" % serve_port) as client:
            served, served_step, _ = client.predict(
                x[:IRIS_SERVE_ROWS], deadline_secs=120)
    finally:
        server.stop(0)
        engine.drain(timeout=10)
    served = served["output"].numpy()
    want = trainer.eval_step(state, {"features": x[:IRIS_SERVE_ROWS],
                                     "_mask": np.ones(IRIS_SERVE_ROWS)})
    # the worker batches its task stream across task boundaries
    steps = -(-files * rows * epochs // batch)
    record = {
        "phase": "17_features", "part": "iris_job", "files": files,
        "rows": rows, "per_task": per_task, "epochs": epochs,
        "batch": batch, "master_rc": master_rc, "worker_rc": worker_rc,
        "tasks": len(training), "done": len(done),
        "train_end_tasks": len(train_end), "export_step": export_step,
        "job_seconds": job_s, "steps_per_s": steps / job_s,
        "accuracy": accuracy, "accuracy_floor": IRIS_ACCURACY_FLOOR,
        "served_step": served_step,
        "served_bit_equal": bool(np.array_equal(served, want)),
        "card": card_line(device)}
    log(json.dumps(record))
    with open(worker_log) as f:
        worker_tail = f.read()[-3000:]
    failures = [what for what, bad in (
        ("master rc", master_rc != 0), ("worker rc", worker_rc != 0),
        ("every task done once", sorted(done) != sorted(created)
         or len(training) != files * -(-rows // per_task) * epochs),
        ("one train-end task", len(train_end) != 1),
        ("export at the final step", export_step != steps),
        ("accuracy", not accuracy > IRIS_ACCURACY_FLOOR),
        ("served bit-equal to eval_step", not record["served_bit_equal"]
         or served_step != export_step)) if bad]
    if failures:
        raise SystemExit("iris job: %s\n%s" % (failures, worker_tail))
    return record


# phase 17's table job: iris over an in-process table (the rows
# iris_job writes to its CSV files), then its predictions landed in a
# table
TABLE_ZOO = "chip_smoke_iris_table"
TABLE_ORIGIN = "odps://smoke/iris"


def table_zoo(sink):
    """A model-zoo module made in this process and registered as
    TABLE_ZOO: iris_dnn's contract, and a PredictionOutputsProcessor
    that lands each prediction batch in ``sink`` (one module object, so
    the master, the worker and this script see the same sink)."""
    import types

    from elasticdl_tpu_torch.data.table_writer import (
        TablePredictionOutputsProcessor,
    )
    from elasticdl_tpu_torch.models import iris_dnn

    module = types.ModuleType(TABLE_ZOO)
    for name in ("custom_model", "dataset_fn", "eval_metrics_fn", "loss",
                 "optimizer", "params_from_flax"):
        setattr(module, name, getattr(iris_dnn, name))

    class PredictionOutputsProcessor(TablePredictionOutputsProcessor):
        def make_sink(self):
            return sink

    module.PredictionOutputsProcessor = PredictionOutputsProcessor
    sys.modules[TABLE_ZOO] = module
    return module


def table_job(torch, np, workdir, device="cuda"):
    """iris as an in-process job over a table: the port's ``Master``
    (``training_data`` an ``odps://`` origin, its table client through
    ``data_reader_params``) and one ``Worker`` on ``device`` over a
    ``TableDataReader`` of an ``InMemoryTableClient`` holding the rows
    iris_job writes to its CSV files (``iris_records``, same seeds), with
    a dense checkpoint at the final step. Checks: every row trained once an epoch by the
    dispatcher's books, the final version, accuracy on the validation
    rows at or above IRIS_ACCURACY_FLOOR. Then a prediction-only job
    over the validation table restoring that checkpoint: its rows land
    through a ``TablePredictionOutputsProcessor`` in an
    ``InMemoryWritableTable``, are read back through ``TableDataReader``
    and must equal the trained state's ``eval_step`` over the same rows
    bit for bit."""
    from elasticdl_tpu_torch.common.constants import Mode
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.data.pipeline import Dataset, batch_real_count
    from elasticdl_tpu_torch.data.readers import create_data_reader
    from elasticdl_tpu_torch.data.table_reader import (
        InMemoryTableClient,
        TableDataReader,
    )
    from elasticdl_tpu_torch.data.table_writer import InMemoryWritableTable
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.models import iris_dnn
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.worker import Worker

    train_rows = sum((iris_records(np, IRIS_ROWS, seed=2 * i)
                      for i in range(IRIS_FILES)), [])
    valid_rows = iris_records(np, IRIS_ROWS, seed=1)
    sink = InMemoryWritableTable(column_names=["output"])
    table_zoo(sink)
    ckpt_dir = os.path.join(workdir, "iris_table_ckpt")
    steps = -(-len(train_rows) * IRIS_EPOCHS // IRIS_BATCH)

    def job(table_rows, mode, data_key, **worker_kwargs):
        client = InMemoryTableClient(table_rows, IRIS_COLUMNS)
        port = find_free_port()
        master = Master(TABLE_ZOO, records_per_task=IRIS_PER_TASK,
                        port=port, num_epochs=(
                            IRIS_EPOCHS if mode == Mode.TRAINING else 1),
                        task_timeout_secs=60.0,
                        data_reader_params={"table_client": client},
                        **{data_key: TABLE_ORIGIN})
        done = []
        master.task_dispatcher.add_task_completed_callback(
            lambda t: done.append((t.type, t.shard_name, t.start, t.end)))
        master.prepare()
        t0 = time.monotonic()
        try:
            worker = Worker(
                MasterClient("localhost:%d" % port, worker_id=0), TABLE_ZOO,
                create_data_reader(TABLE_ORIGIN, table_client=client),
                minibatch_size=IRIS_BATCH, mode=mode, wait_sleep_secs=0.1,
                device=device, **worker_kwargs)
            worker.run()
            finished = master.task_dispatcher.finished()
        finally:
            master.stop()
        return worker, done, finished, time.monotonic() - t0

    trainer, done, train_finished, train_s = job(
        train_rows, Mode.TRAINING, "training_data", checkpoint_dir=ckpt_dir,
        checkpoint_steps=steps)
    trained = sorted((start, end) for kind, _, start, end in done
                     if kind == pb.TRAINING)
    want_ranges = sorted((lo, min(lo + IRIS_PER_TASK, len(train_rows)))
                         for lo in range(0, len(train_rows), IRIS_PER_TASK)
                         for _ in range(IRIS_EPOCHS))
    x = np.asarray([r[:4] for r in valid_rows], np.float32)
    labels = np.asarray([r[4] for r in valid_rows])
    logits = trainer.trainer.eval_step(trainer.state, {"features": x})
    accuracy = float((np.asarray(logits).argmax(-1) == labels).mean())

    scorer, pred_done, pred_finished, pred_s = job(
        valid_rows, Mode.PREDICTION, "prediction_data",
        checkpoint_dir_for_init=ckpt_dir)
    written = sink.rows("worker=0")
    back = TableDataReader(
        table_client=InMemoryTableClient(written, ["output"]),
        table="predictions", records_per_task=max(1, len(written)))
    read = [row[0] for name, (start, count) in back.create_shards().items()
            for row in back.read_records(
                pb.Task(shard_name=name, start=start, end=start + count))]
    read = np.asarray(read, np.float32)
    # the trained state's forward over the same rows, task by task in
    # the order they were done, in the worker's batches
    reader = TableDataReader(
        table_client=InMemoryTableClient(valid_rows, IRIS_COLUMNS),
        table="iris")
    want = []
    for _, shard, lo, hi in pred_done:
        task = pb.Task(shard_name=shard, start=lo, end=hi)
        for one in iris_dnn.dataset_fn(Dataset(
                lambda task=task: reader.read_records(task)),
                Mode.PREDICTION).batch(IRIS_BATCH):
            outputs = trainer.trainer.eval_step(trainer.state, one)
            want.append(np.asarray(outputs)[:batch_real_count(one)])
    want = np.concatenate(want) if want else np.zeros((0, 3), np.float32)
    record = {
        "phase": "17_features", "part": "table_job", "rows": len(train_rows),
        "per_task": IRIS_PER_TASK, "epochs": IRIS_EPOCHS,
        "batch": IRIS_BATCH,
        "train_tasks_done": len(trained), "train_seconds": train_s,
        "steps": steps, "model_version": trainer.model_version,
        "steps_per_s": steps / train_s, "accuracy": accuracy,
        "accuracy_floor": IRIS_ACCURACY_FLOOR,
        "prediction_tasks_done": len(pred_done),
        "prediction_seconds": pred_s, "scored_step": int(scorer.state.step),
        "partitions": sorted(sink.partitions), "rows_written": len(written),
        "read_back_bit_equal": bool(read.shape == want.shape
                                    and np.array_equal(read, want)),
        "card": card_line(device)}
    log(json.dumps(record))
    failures = [what for what, bad in (
        ("the training job finished", not train_finished),
        ("every row once an epoch", trained != want_ranges),
        ("the final version", trainer.model_version != steps),
        ("accuracy", not accuracy >= IRIS_ACCURACY_FLOOR),
        ("the prediction job finished", not pred_finished
         or [d[0] for d in pred_done]
         != [pb.PREDICTION] * -(-len(valid_rows) // IRIS_PER_TASK)),
        ("scored the final checkpoint", record["scored_step"] != steps),
        ("one partition of every row", record["partitions"] != ["worker=0"]
         or len(written) != len(valid_rows)),
        ("predictions read back bit-equal to eval_step",
         not record["read_back_bit_equal"])) if bad]
    if failures:
        raise SystemExit("table job: %s" % failures)
    return record


def feature_phase(torch, np, tier, workdir):
    """Phase 17 on the card (see the module docstring)."""
    t0 = time.monotonic()
    promoted = promoted_phase(torch, np, tier, workdir)
    zoo = feature_zoo_phase(torch, np, workdir)
    iris = iris_job(torch, np, workdir)
    table = table_job(torch, np, workdir)
    seconds = time.monotonic() - t0
    log(json.dumps({"phase": "17_features", "part": "summary",
                    "seconds": seconds, "card": nvidia_smi_line()}))
    return {"promoted": promoted, "zoo": zoo, "iris": iris, "table": table,
            "seconds": seconds}


# phase 18: continual streaming. Named continual_phase: phase 8's
# stream_phase is the sparse trainer's pipelined train_stream, another
# path. The stream is phase 9's size (JOB_RECORDS, 384 steps of 512)
# minted in windows by the master's feeder; its vocabulary slides by
# CONTINUAL_DRIFT ids a window while its tail (a tenth of the draws past
# rank 2,000) keeps bringing ids the shards have not seen, so the
# admitted vocabulary outgrows each shard's row bound. A Zipf(1.3)
# window puts a quarter of its id slots on its rank-1 id and most on its
# first hundred ranks, and a label is a draw over the mean planted
# weight of its ids, so the holdout is learnable only where its head
# was trained: an oracle knowing the weight of every id seen 20 times in
# training scores the holdout's logloss at 0.693 against a base rate's
# 0.645 with a slide of 2,000, at 0.503 against 0.677 with a slide of 20
# (tests/test_torch_stream_source.py computes it). The reference's own
# streaming bench slides 30 ids a 256-record window at k = 4
# (scripts/bench_streaming.py:58-69)
CONTINUAL_WINDOW = 8192
CONTINUAL_WINDOWS = 24
CONTINUAL_HOT_VOCAB = 200_000
CONTINUAL_ZIPF_A = 1.3
CONTINUAL_DRIFT = 20
CONTINUAL_BACKLOG = 32_768          # 4 windows minted ahead at most
CONTINUAL_CKPT_EVERY = 49_152       # 4 checkpoint boundaries
CONTINUAL_EXPORT_EVERY = 98_304     # 2 exports at the cadence
CONTINUAL_SEED = 7                  # EDL_STREAM_SEED
# a worker's step sights an id 4 times on its shard's one sketch: the
# deduplicated pull and push of both tables (deepfm_emb, deepfm_linear
# share ids), so below 4 every id admits at its first step and no
# gradient is ever dropped; at 4 an id's first push of deepfm_emb drops
CONTINUAL_ADMIT_K = 4
# rows a table a shard: under the 32,768 the tier's 65,536 rows a
# table put on each of the two shards (every boundary re-asserts them
# all), and under the 55,000 deepfm_emb rows a shard admits unbounded
# on an H100 (PERF.md). The LFU protection keeps its default (1 s): the
# ids the shards sighted in the last second must fit under the bound
CONTINUAL_MAX_ROWS = 24_000
CONTINUAL_SWEEP_S = 1.0
CONTINUAL_LFU_DECAY = 0.9
# evaluation over the holdout at versions 128 and 256 of the 384
CONTINUAL_EVAL_STEPS = 128
CONTINUAL_FAULT_BURST = 3           # unavailable on PS 1's push_gradients
# the holdout's logloss served by the PS against the same export scored
# with the rows the tier held at the job's end: the PS's row bound cuts
# a third of those rows, and a cut of the tier's hottest rows moved the
# logloss by 0.084 on an H100 (PERF.md); rows the holdout barely reads
# move it by under 1e-4
CONTINUAL_SERVED_GAP = 0.01
CONTINUAL_WAIT_S = 300
CONTINUAL_PS_GONE_S = 60            # the PS outlive the master: SIGTERMed
_FAULT_FIRE_RE = re.compile(r"fault injection: unavailable fired on "
                            r"push_gradients \((\S+), fire (\d+)\)")
_SWEEP_RE = re.compile(
    r"^(\S+ \S+) .*lifecycle sweep: evicted ttl (\d+) lfu (\d+) in "
    r"([0-9.]+) s; resident rows (\{[^}]*\}); in flight (\{[^}]*\}); "
    r"totals admitted (\d+) evicted ttl (\d+) lfu (\d+), grad rows "
    r"dropped (\d+)", re.M)


def tier_lookup(tier_ids, ids):
    """(held, at): which of ``ids`` the non-empty, unsorted ``tier_ids``
    hold, and each held id's position in ``tier_ids``."""
    import numpy as np

    order = np.argsort(tier_ids)
    pos = np.searchsorted(tier_ids, ids, sorter=order)
    at = order[np.minimum(pos, tier_ids.size - 1)]
    return tier_ids[at] == ids, at


def continual_phase(torch, np, tier, workdir, device="cuda",
                    batch=SPARSE_BATCH, fields=SPARSE_FIELDS,
                    window=CONTINUAL_WINDOW, windows=CONTINUAL_WINDOWS,
                    hot_vocab=CONTINUAL_HOT_VOCAB, zipf_a=CONTINUAL_ZIPF_A,
                    drift=CONTINUAL_DRIFT, backlog=CONTINUAL_BACKLOG,
                    ckpt_every=CONTINUAL_CKPT_EVERY,
                    export_every=CONTINUAL_EXPORT_EVERY,
                    admit_k=CONTINUAL_ADMIT_K, max_rows=CONTINUAL_MAX_ROWS,
                    sweep_s=CONTINUAL_SWEEP_S, lfu_decay=CONTINUAL_LFU_DECAY,
                    eval_steps=CONTINUAL_EVAL_STEPS,
                    report_version_steps=JOB_REPORT_VERSION_STEPS,
                    task_timeout_s=JOB_TASK_TIMEOUT_S,
                    fault_burst=CONTINUAL_FAULT_BURST, worker_env=None,
                    lfu_protect_s=None, wait_s=CONTINUAL_WAIT_S, card=None):
    """Phase 18: DeepFM trains as a continual stream job. The port's
    master in this process with ``EDL_STREAM=synthetic`` (its feeder
    mints ``windows`` windows of ``window`` records of the drifting
    clickstream into a spool directory, at most ``backlog`` records
    ahead of the watermark, and an export task each ``export_every``
    records of watermark), ``EDL_STATE_DIR``, ``EDL_EVENTS_DIR``,
    ``--output`` and ``--tensorboard_log_dir``, evaluating every
    ``eval_steps`` versions over a holdout of the two windows after the
    stream's end (written from the same source); two PS processes (async,
    ``--master_addr``, one ``--checkpoint_dir``) with the embedding
    lifecycle (``EDL_EMB_ADMIT_K``, ``EDL_EMB_MAX_ROWS``,
    ``EDL_EMB_SWEEP_SECS``, ``EDL_EMB_LFU_DECAY``) and
    ``EDL_STREAM_CHECKPOINT_EVERY=ckpt_every``, PS 1 with
    ``EDL_FAULT_SPEC`` an ``unavailable`` burst of ``fault_burst`` on
    ``push_gradients``; worker 0 a ``Worker`` in this process with the
    device tier on (``worker_env``), its K1-K3 launches counted.
    Checks (each printed; a failure raises SystemExit): (1) every window
    minted once, in the journal too, every window task done once, the
    final watermark the minted records; (2) each checkpoint boundary
    gives a ``stream_watermark`` event on the worker and on each PS, one
    sparse checkpoint per PS shard and one worker barrier whose tier
    flush launched K1; (3) the feeder's exports at the cadence, the
    train-end export after them, the last export loads and scores the
    holdout; (4) after every sweep until the watermark reaches the
    stream's end each table of each shard holds at most ``max_rows``
    rows, and after every later sweep (the evaluation's, the final
    check's and the scoring's reads) at most that many or only rows the
    sweep found in flight, counted under the sweep's lock; LFU evictions
    and pre-admission gradient drops above 0, ``row_evicted`` tombstones
    in the PS journals; (5) K1-K3 by phase 7's formula in every step,
    and at each flush at the stream's end every tier-resident row pulled
    back bit-equal from its shard right after a re-assert that no sweep
    of that shard overtook;
    (6) the holdout's logloss under its labels' base-rate logloss, and
    within ``CONTINUAL_SERVED_GAP`` of the same export scored with the
    rows the tier held at the job's end; (7)
    PS 1's interceptor fired exactly ``fault_burst`` times, PS 0's
    never, and each shard's store version at its SIGTERM equals the
    version worker 0 holds for it; (8) the TensorBoard event file reads
    back, CRC checked, with every evaluation's scalars at its version.
    The job must end within ``wait_s``. ``EDL_EMB_LFU_PROTECT_SECS``
    keeps its default (1 s) unless ``lfu_protect_s`` is given: a
    rehearsal whose whole stream takes seconds scales it down with the
    stream.
    ``card`` is the nvidia-smi line printed with the numbers."""
    from elasticdl_tpu_torch.common.grpc_utils import find_free_port
    from elasticdl_tpu_torch.data.readers import RecordIODataReader
    from elasticdl_tpu_torch.master import tensorboard_service
    from elasticdl_tpu_torch.master.master import Master
    from elasticdl_tpu_torch.master.state_store import (
        MasterStateJournal,
        apply_op,
    )
    from elasticdl_tpu_torch.models.registry import get_model_spec
    from elasticdl_tpu_torch.proto import elasticdl_tpu_pb2 as pb
    from elasticdl_tpu_torch.serve.model import ServingModel
    from elasticdl_tpu_torch.stream.source import SyntheticClickstreamSource
    from elasticdl_tpu_torch.worker.master_client import MasterClient
    from elasticdl_tpu_torch.worker.ps_client import PSClient
    from elasticdl_tpu_torch.worker.worker import Worker

    zoo = "elasticdl_tpu_torch.models.deepfm"
    device = torch.device(device)
    card = card or nvidia_smi_line()
    worker_env = dict(JOB_WORKER_ENV if worker_env is None else worker_env)
    total = window * windows
    phase_t0 = time.monotonic()
    out = os.path.join(HERE, "build", "chip_smoke_continual")
    shutil.rmtree(out, ignore_errors=True)
    dirs = {name: os.path.join(out, name) for name in (
        "spool", "holdout", "ckpt", "export", "tb", "state", "events")}
    for path in dirs.values():
        os.makedirs(path)
    # the holdout: windows ``windows`` and ``windows + 1`` of the same
    # source, the two the stream never reaches
    source_kwargs = dict(records_per_window=window, num_features=fields,
                         hot_vocab=hot_vocab, zipf_a=zipf_a,
                         drift_per_window=drift, seed=CONTINUAL_SEED)
    holdout = SyntheticClickstreamSource(dirs["holdout"], **source_kwargs)
    holdout.seek(windows)
    for _ in range(2):
        holdout.next_window()
    hold = [holdout.window_examples(windows + k) for k in range(2)]
    hold_ids = np.concatenate([h[0] for h in hold])
    hold_labels = np.concatenate([h[1] for h in hold]).astype(np.float64)
    job_env = dict(worker_env, **{
        "EDL_STREAM": "synthetic", "EDL_STREAM_FEATURES": str(fields),
        "EDL_STREAM_WINDOW_RECORDS": str(window),
        "EDL_STREAM_TOTAL_RECORDS": str(total),
        "EDL_STREAM_HOT_VOCAB": str(hot_vocab),
        "EDL_STREAM_ZIPF_A": str(zipf_a), "EDL_STREAM_DRIFT": str(drift),
        "EDL_STREAM_MAX_BACKLOG": str(backlog),
        "EDL_STREAM_CHECKPOINT_EVERY": str(ckpt_every),
        "EDL_STREAM_EXPORT_EVERY": str(export_every),
        "EDL_STREAM_SEED": str(CONTINUAL_SEED),
        "EDL_STATE_DIR": dirs["state"], "EDL_EVENTS_DIR": dirs["events"],
    })
    ps_env = {
        "EDL_EMB_ADMIT_K": str(admit_k), "EDL_EMB_MAX_ROWS": str(max_rows),
        "EDL_EMB_SWEEP_SECS": str(sweep_s),
        "EDL_EMB_LFU_DECAY": str(lfu_decay),
        "EDL_STREAM_CHECKPOINT_EVERY": str(ckpt_every),
        "EDL_EVENTS_DIR": dirs["events"],
        "EDL_PS_MASTER_GONE_SECS": str(CONTINUAL_PS_GONE_S),
        "PYTHONPATH": HERE,
    }
    if lfu_protect_s is not None:
        ps_env["EDL_EMB_LFU_PROTECT_SECS"] = str(lfu_protect_s)
    saved_env = {k: os.environ.get(k) for k in job_env}
    os.environ.update(job_env)
    procs, started, result = [], [], {}
    runner = master = probe = stream_end = None
    try:
        master = Master(zoo, training_data=dirs["spool"],
                        validation_data=dirs["holdout"],
                        records_per_task=window, num_epochs=1,
                        port=find_free_port(), eval_steps=eval_steps,
                        saved_model_path=dirs["export"],
                        task_timeout_secs=task_timeout_s, seed=SEED,
                        tensorboard_log_dir=dirs["tb"])
        dispatcher = master.task_dispatcher
        if master.stream_feeder is None:
            raise SystemExit("the master built no stream feeder")
        addr = "localhost:%d" % master._port
        # the dispatcher's decisions, recorded as the feeder and the
        # servicer drive it: windows minted, exports minted, tasks done
        minted, exports, done, lag = [], [], [], []
        add_window, add_export = (dispatcher.add_stream_window,
                                  dispatcher.add_stream_export_task)
        report = dispatcher.report

        def on_window(shard_name, start, end, model_version=-1):
            task_id = add_window(shard_name, start, end, model_version)
            minted.append((task_id, os.path.basename(shard_name),
                           int(start), int(end)))
            return task_id

        def on_export(extended_config=None):
            task_id = add_export(extended_config)
            exports.append((task_id, dispatcher.stream_watermark()))
            return task_id

        def on_report(task_id, success, worker_id=None, count_failure=True):
            doing = dispatcher.doing_tasks().get(task_id)
            ok, task = report(task_id, success, worker_id=worker_id,
                              count_failure=count_failure)
            if success and task is not None and doing is not None:
                done.append((task_id, task.type))
            return ok, task

        dispatcher.add_stream_window = on_window
        dispatcher.add_stream_export_task = on_export
        dispatcher.report = on_report
        job_t0 = time.monotonic()
        master.prepare()
        master_thread = threading.Thread(
            target=lambda: result.setdefault("rc", master.run(poll_secs=0.5)),
            daemon=True)
        master_thread.start()
        ports = [find_free_port(), find_free_port()]
        addrs = ["localhost:%d" % p for p in ports]
        logs = [os.path.join(out, "ps-%d.log" % i) for i in range(2)]
        extra = ("--use_async", "1", "--master_addr", addr,
                 "--checkpoint_dir", dirs["ckpt"])
        env = dict(os.environ, **ps_env)
        fault_spec = "ps-1:push_gradients:unavailable:%d" % fault_burst
        procs.append(start_ps(0, ports[0], logs[0], extra, env))
        procs.append(start_ps(1, ports[1], logs[1], extra,
                              dict(env, EDL_FAULT_SPEC=fault_spec)))
        started.append((procs, addrs, logs))
        lines = wait_ps_ready(started)
        if not all("(NativeEmbeddingStore store, async)" in ln
                   for ln in lines):
            raise SystemExit("a stream PS does not serve the native store "
                             "async: %s" % lines)
        client = MasterClient(addr, worker_id=0)
        client.reset_worker()
        worker0 = Worker(client, zoo, RecordIODataReader(
            data_dir=dirs["spool"]), minibatch_size=batch,
            report_version_steps=report_version_steps, wait_sleep_secs=0.1,
            ps_addrs=addrs, device=device)
        trainer = worker0.trainer
        dtier = trainer.device_tier
        if dtier is None:
            raise SystemExit("worker 0 runs without the device tier")
        ps_client = trainer.preparer._ps
        probe = PSClient(addrs)
        counts = count_worker_steps(tier, trainer)
        # the train-end tasks worker 0 runs, each flush's launches, and
        # after each flush at the stream's end the tier-resident rows
        # held against the PS's
        train_ends, flushes, finals, at_end = [], [], [], [False]
        flush, train_end = (worker0._flush_device_tier,
                            worker0._process_train_end_task)

        def final_check(shard):
            held = {}
            for name in ("deepfm_emb", "deepfm_linear"):
                ids, rows = dtier.table_rows(name)
                mine = ids % len(addrs) == shard
                ids, rows = ids[mine], rows[mine]
                served = probe.pull_embedding_vectors(name, ids)
                held[name] = {
                    "rows": int(ids.size),
                    "differ": int((served != rows).any(axis=1).sum())
                    if ids.size else 0,
                    "all_zero": int((rows == 0).all(axis=1).sum())}
            return held

        def sweeps_logged():
            counts = []
            for path in logs:
                with open(path) as f:
                    counts.append(f.read().count("lifecycle sweep:"))
            return counts

        def next_sweep(shard):
            seen = sweeps_logged()[shard]
            deadline = time.monotonic() + 4 * sweep_s + 2.0
            while (sweeps_logged()[shard] == seen
                   and time.monotonic() < deadline):
                time.sleep(0.02)

        def noted_flush():
            before = tier_counts(tier)
            t0 = time.monotonic()
            flush()
            flushes.append({"reassert": dtier.reassert, "launches": [
                a - c for a, c in zip(tier_counts(tier), before)],
                "s": time.monotonic() - t0, "at_end": at_end[0]})
            if not at_end[0]:
                return
            # each shard is read back right after a re-assert that no
            # sweep of that shard followed (a sweep may rightly cut the
            # re-asserted rows down to the bound): the tier re-asserts
            # right after one of the shard's sweeps, and again after the
            # next where a sweep still overtook the read, three times
            final = {"tables": {}, "attempts": [], "overtaken": []}
            for shard in range(len(addrs)):
                for attempt in range(1, 4):
                    next_sweep(shard)
                    swept = sweeps_logged()[shard]
                    dtier.flush()
                    held = final_check(shard)
                    overtaken = sweeps_logged()[shard] != swept
                    if not overtaken:
                        break
                for name, c in held.items():
                    total_c = final["tables"].setdefault(
                        name, {"rows": 0, "differ": 0, "all_zero": 0})
                    for key in total_c:
                        total_c[key] += c[key]
                final["attempts"].append(attempt)
                final["overtaken"].append(overtaken)
            finals.append(final)

        def noted_train_end(task):
            state = dispatcher.stream_state()
            at_end[0] = state["watermark"] >= total
            train_ends.append((task.task_id, state["watermark"]))
            try:
                return train_end(task)
            finally:
                at_end[0] = False

        worker0._flush_device_tier = noted_flush
        worker0._process_train_end_task = noted_train_end
        reset_tier_launches(tier)  # the phase's count starts here
        runner = threading.Thread(target=worker0.run, daemon=True)
        runner.start()
        deadline = time.monotonic() + wait_s
        while master_thread.is_alive() and time.monotonic() < deadline:
            state = dispatcher.stream_state()
            lag.append(state["minted_records"] - state["watermark"])
            if state["watermark"] >= total and stream_end is None:
                stream_end = time.time()
            master_thread.join(timeout=0.25)
        if master_thread.is_alive():
            raise SystemExit("the stream job did not finish in %d s "
                             "(watermark %s)" % (
                                 wait_s, dispatcher.stream_state()))
        job_s = time.monotonic() - job_t0
        runner.join(timeout=60)
        launches = dict(zip(("gather", "insert_rows", "scatter_apply"),
                            tier_counts(tier)))
        shard_versions = dict(ps_client._shard_versions)
        # the last export scores the holdout through the PS it pairs with;
        # each pull's rows are noted and held against the tier's, and the
        # holdout is scored again with the tier's rows where it holds them
        reader = PSClient(addrs)
        pull, served = reader.pull_embedding_batch, []
        tier_rows = {name: dtier.table_rows(name)
                     for name in ("deepfm_emb", "deepfm_linear")}

        def noted_pull(ids_by_table):
            rows = pull(ids_by_table)
            served.append({name: (np.asarray(ids), np.asarray(rows[name]))
                           for name, ids in ids_by_table.items()})
            return rows

        def tier_pull(ids_by_table):
            rows = pull(ids_by_table)
            for name, ids in ids_by_table.items():
                held, at = tier_lookup(tier_rows[name][0], ids)
                rows[name] = np.array(rows[name], dtype=np.float32)
                rows[name][held] = tier_rows[name][1][at[held]]
            return rows

        model = ServingModel(get_model_spec(zoo), dirs["export"],
                             max_batch=batch, ps_client=reader,
                             device=device)

        def score(pull_fn):
            reader.pull_embedding_batch = pull_fn
            return np.concatenate([
                model.predict({"ids": hold_ids[i:i + batch]},
                              len(hold_ids[i:i + batch]))["output"].numpy()
                for i in range(0, len(hold_ids), batch)]).astype(np.float64)

        logits = score(noted_pull)
        logits_tier = score(tier_pull)
        reader.close()
        export_step = model.step
        ps_codes = stop_ps(started)
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if probe is not None:
            probe.close()
        if master is not None:
            master.stop()
        # the journal knob is gone again: later roles of this process
        # journal nothing
        from elasticdl_tpu_torch.observability import events

        events.configure("master")
    # -- read back what the roles wrote -----------------------------------
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    # the journal as a relaunched master would replay it: the snapshot
    # compaction wrote, then the ops after it
    store = MasterStateJournal(dirs["state"])
    replayed, _, snap_seq = store._read_snapshot()
    journal, _, _ = store._read_journal(snap_seq)
    if replayed is None:
        from elasticdl_tpu_torch.master.state_store import empty_state

        replayed = empty_state()
    for op in journal:
        apply_op(replayed, op)
    role_events = {}
    for name in sorted(os.listdir(dirs["events"])):
        if name.endswith(".events.ndjson"):
            role = name.rsplit("-", 1)[0]
            role_events.setdefault(role, []).extend(
                read_journal(os.path.join(dirs["events"], name)))
    watermark_events = {
        role: [(e.get("kind"), e.get("watermark")) for e in evs
               if e.get("event") == "stream_watermark"]
        for role, evs in role_events.items()}
    tombstones = {role: sum(1 for e in evs if e.get("event") == "row_evicted")
                  for role, evs in role_events.items()}
    sweeps = [[{"at": datetime.datetime.strptime(
                    m[1], "%Y-%m-%d %H:%M:%S,%f").timestamp(),
                "rows": json.loads(m[5]), "in_flight": json.loads(m[6]),
                "s": float(m[4]), "admitted": int(m[7]), "ttl": int(m[8]),
                "lfu": int(m[9]), "dropped": int(m[10])}
               for m in _SWEEP_RE.finditer(text)] for text in texts]
    stream_saves = [[(int(m[2]), m[3], int(m[4]), float(m[7]))
                     for m in _SAVE_RE.finditer(text)
                     if m[1] == "sparse_stream"] for text in texts]
    final_versions = [int(m[1]) if m else None for m in
                      (_FINAL_SAVE_RE.search(text) for text in texts)]
    fires = [[(spec, int(n)) for spec, n in _FAULT_FIRE_RE.findall(text)]
             for text in texts]
    summaries = master.evaluation_service.completed_summaries
    tb_events = tensorboard_service.read_events(
        master.tensorboard_service.event_file)
    tb_scalars = {e["step"]: e["scalars"] for e in tb_events
                  if e["scalars"]}
    # -- the numbers ----------------------------------------------------
    steps, bad_steps = counts["steps"], counts["bad_steps"]
    warm = [s[0] for s in steps[10:]] or [s[0] for s in steps]
    losses = [s[1] for s in steps]
    p0 = float(np.clip(hold_labels.mean(), 1e-7, 1 - 1e-7))
    base_logloss = -(p0 * np.log(p0) + (1 - p0) * np.log(1 - p0))
    holdout_logloss = float(np.mean(np.logaddexp(0.0, logits)
                                    - hold_labels * logits))
    tier_logloss = float(np.mean(np.logaddexp(0.0, logits_tier)
                                 - hold_labels * logits_tier))
    # of the ids each scoring pull asked for: how many the tier held at
    # the job's end, and of those how many the PS served as the tier
    # held them (a row the PS's LFU bound evicted comes back cold)
    tier_served = {name: [0, 0, 0] for name in tier_rows}
    for pulled in served:
        for name, (ids, rows) in pulled.items():
            held, at = tier_lookup(tier_rows[name][0], ids)
            same = (rows[held] == tier_rows[name][1][at[held]]).all(axis=1)
            counts = tier_served[name]
            counts[0] += int(ids.size)
            counts[1] += int(held.sum())
            counts[2] += int(same.sum())
    window_done = [d for d in done if d[1] == pb.TRAINING]
    train_end_done = [d for d in done if d[1] == pb.TRAIN_END_CALLBACK]
    journal_windows = [op for op in journal if op.get("op") == "stream_window"]
    left_training = [t for t in replayed["tasks"].values()
                     if int(t[1]) == pb.TRAINING]
    peak_rows = [{name: max((s["rows"].get(name, 0) for s in shard),
                            default=0)
                  for name in ("deepfm_emb", "deepfm_linear")}
                 for shard in sweeps]
    # while the stream runs every sweep holds the bound; after it, the
    # evaluation's, the final check's and the scoring's reads leave ids
    # LFU-protected for EDL_EMB_LFU_PROTECT_SECS, and a sweep may then
    # keep more rows than the bound only where every row over it is one
    # of those (the reference's in-flight protection)
    stream_end = stream_end or time.time()
    peak_rows_in_stream = [
        {name: max((s["rows"].get(name, 0) for s in shard
                    if s["at"] < stream_end), default=0)
         for name in ("deepfm_emb", "deepfm_linear")} for shard in sweeps]
    over_in_stream = [(k, name, rows) for k, shard in enumerate(sweeps)
                      for s in shard if s["at"] < stream_end
                      for name, rows in s["rows"].items() if rows > max_rows]
    held_in_flight = [(k, name, rows, s["in_flight"].get(name))
                      for k, shard in enumerate(sweeps) for s in shard
                      for name, rows in s["rows"].items() if rows > max_rows]
    # the tallies are cumulative: each shard's last sweep has its totals
    last_sweep = [shard[-1] for shard in sweeps if shard]
    evicted_lfu = sum(s["lfu"] for s in last_sweep)
    dropped = sum(s["dropped"] for s in last_sweep)
    admitted = [s["admitted"] for s in last_sweep]
    over_bound = [(k, name, rows, flying)
                  for k, name, rows, flying in held_in_flight
                  if rows > flying] + over_in_stream
    barriers = worker0.stream_barriers
    worker_marks = [w for kind, w in watermark_events.get("master", ())
                    if kind == "checkpoint"]
    ps_marks = [[w for kind, w in watermark_events.get("ps-%d" % k, ())
                 if kind == "checkpoint"] for k in range(2)]
    export_marks = [w for kind, w in watermark_events.get("master", ())
                    if kind == "export"]
    boundaries = list(range(1, total // ckpt_every + 1))
    tb_missing = [
        v for v, summary in summaries
        if v not in tb_scalars or any(
            tb_scalars[v].get(k) != np.float32(float(val))
            for k, val in summary.items())]
    record = {
        "phase": "18_continual", "master_rc": result.get("rc"),
        "job_wall_s": job_s, "steps": len(steps),
        "steps_per_s": len(warm) / sum(warm) if warm else None,
        "examples_per_s_job": total / job_s,
        "step_ms_host_median": (float(np.median(warm)) * 1e3 if warm
                                else None),
        "losses_first_last": [losses[0], losses[-1]] if losses else None,
        "all_finite": bool(np.isfinite(losses).all()) if losses else False,
        "windows_minted": len(minted),
        "distinct_windows": len({m[1] for m in minted}),
        "journal_stream": replayed["stream"],
        "journal_windows_done": replayed["done_counts"].get(pb.TRAINING, 0),
        "journal_training_left": len(left_training),
        "journal_tail_positions": [op["pos"] for op in journal_windows],
        "window_tasks_done": len(window_done),
        "distinct_window_tasks_done": len({d[0] for d in window_done}),
        "final_watermark": dispatcher.stream_watermark(),
        "minted_records": dispatcher.stream_state()["minted_records"],
        "watermark_lag_records_max": max(lag) if lag else None,
        "watermark_lag_records_mean": (float(np.mean(lag)) if lag
                                       else None),
        "worker_checkpoint_watermarks": worker_marks,
        "ps_checkpoint_watermarks": ps_marks,
        "ps_stream_checkpoints": [[s[0] for s in shard]
                                  for shard in stream_saves],
        "checkpoint_seconds": [[s[3] for s in shard]
                               for shard in stream_saves],
        "checkpoint_modes": [[s[1] for s in shard] for shard in stream_saves],
        "worker_barriers": barriers,
        "exports_minted_at": [w for _, w in exports],
        "export_events": export_marks,
        "train_end_tasks": train_ends,
        "train_end_tasks_done": len(train_end_done),
        "export_step": export_step,
        "flushes": flushes, "final_checks": finals,
        "lifecycle_sweeps": [len(shard) for shard in sweeps],
        "peak_resident_rows_after_sweep": peak_rows,
        "peak_resident_rows_in_stream": peak_rows_in_stream,
        "sweeps_in_stream": [sum(s["at"] < stream_end for s in shard)
                             for shard in sweeps],
        "rows_over_bound": over_bound[:5],
        "sweeps_over_bound_all_in_flight": held_in_flight[:5],
        "max_rows": max_rows,
        "evictions": {"lfu": evicted_lfu,
                      "ttl": sum(s["ttl"] for s in last_sweep)},
        "admissions": admitted, "preadmission_grads_dropped": dropped,
        "sweep_s_max": max((s["s"] for shard in sweeps for s in shard),
                           default=None),
        "tombstone_events": tombstones,
        "launches": launches,
        "launches_per_step": {k: v / max(len(steps), 1)
                              for k, v in launches.items()},
        "launch_formula_mismatches": bad_steps[:5],
        "tier_stats": dtier.stats(),
        "evaluations": [[v, s] for v, s in summaries],
        "holdout_logloss": holdout_logloss,
        "holdout_base_rate_logloss": float(base_logloss),
        "holdout_logloss_tier_rows": tier_logloss,
        "holdout_pulled_tier_held_served": tier_served,
        "fault_fires": fires, "fault_burst": fault_burst,
        "worker_shard_versions": shard_versions,
        "ps_final_versions": final_versions, "ps_exit_codes": ps_codes,
        "tensorboard_events": len(tb_events),
        "tensorboard_missing_versions": tb_missing,
        "seconds": time.monotonic() - phase_t0, "card": card,
    }
    log(json.dumps(record))
    failures = []
    # (1) exactly once
    positions = record["journal_tail_positions"]
    if (result.get("rc") != 0 or record["windows_minted"] != windows
            or record["distinct_windows"] != windows
            or record["journal_stream"] != {
                "open": False, "pos": windows, "minted_records": total,
                "done_records": total}
            or record["journal_windows_done"] != windows
            or record["journal_training_left"]
            or len(set(positions)) != len(positions)
            or record["window_tasks_done"] != windows
            or record["distinct_window_tasks_done"] != windows
            or {d[0] for d in window_done} != {m[0] for m in minted}
            or record["final_watermark"] != total
            or record["minted_records"] != total):
        failures.append("exactly once: master rc %s, %d windows minted "
                        "(%d distinct), the journal replays to %s with %d "
                        "windows done and %d left (tail positions %s), %d "
                        "window tasks done, watermark %d of %d"
                        % (result.get("rc"), record["windows_minted"],
                           record["distinct_windows"],
                           record["journal_stream"],
                           record["journal_windows_done"],
                           record["journal_training_left"], positions[:30],
                           record["window_tasks_done"],
                           record["final_watermark"], total))
    # (2) the checkpoint cadence
    if ([w // ckpt_every for w in worker_marks] != boundaries
            or any([w // ckpt_every for w in marks] != boundaries
                   for marks in ps_marks)
            or any(len(shard) != len(boundaries) for shard in stream_saves)
            or len(barriers) != len(boundaries)
            or any(b.get("k1_launches", 0) < 1 for b in barriers)):
        failures.append("checkpoint cadence: worker events %s, PS events "
                        "%s, PS stream saves %s, worker barrier K1 %s "
                        "(boundaries %s)" % (
                            worker_marks, ps_marks,
                            record["ps_stream_checkpoints"],
                            [b.get("k1_launches") for b in barriers],
                            boundaries))
    # (3) exports
    cadence = list(range(1, total // export_every + 1))
    if ([w // export_every for _, w in exports] != cadence
            or [w // export_every for w in export_marks] != cadence
            or [t for t, _ in train_ends][:len(exports)]
            != [t for t, _ in exports]
            or len(train_ends) != len(exports) + 1
            or record["train_end_tasks_done"] != len(exports) + 1):
        failures.append("exports: minted at %s, events %s, train-end "
                        "tasks run %s" % (record["exports_minted_at"],
                                          export_marks, train_ends))
    # (4) the lifecycle
    if (over_bound or evicted_lfu <= 0 or dropped <= 0
            or any(not shard for shard in sweeps)
            or sum(v for r, v in tombstones.items()
                   if r.startswith("ps")) <= 0):
        failures.append("lifecycle: rows over the bound %s, LFU evictions "
                        "%d, dropped gradient rows %d, sweeps %s, "
                        "tombstones %s" % (over_bound[:3], evicted_lfu,
                                           dropped,
                                           record["lifecycle_sweeps"],
                                           tombstones))
    # (5) the tier
    if (bad_steps or min(launches.values()) <= 0 or not finals
            or any(any(final["overtaken"]) for final in finals)
            or any(c["differ"] or not c["rows"]
                   for final in finals for c in final["tables"].values())):
        failures.append("tier: formula mismatches %s, launches %s, after "
                        "the final flush %s" % (bad_steps[:5], launches,
                                                finals))
    # (6) learning, and the PS serving what the tier learned
    if (not record["all_finite"] or not holdout_logloss < base_logloss
            or not holdout_logloss - tier_logloss < CONTINUAL_SERVED_GAP):
        failures.append("holdout logloss %.6f not under the base rate's "
                        "%.6f or not within %s of the tier rows' %.6f "
                        "(losses finite %s, pulled/tier-held/served as "
                        "held %s)" % (
                            holdout_logloss, base_logloss,
                            CONTINUAL_SERVED_GAP, tier_logloss,
                            record["all_finite"], tier_served))
    # (7) faults and the version books
    if (len(fires[1]) != fault_burst or fires[0]
            or [n for _, n in fires[1]] != list(range(1, fault_burst + 1))
            or final_versions != [shard_versions.get(k) for k in range(2)]
            or ps_codes != [0, 0]):
        failures.append("faults: PS fires %s, PS final versions %s against "
                        "worker 0's %s, PS exit codes %s" % (
                            fires, final_versions, shard_versions,
                            ps_codes))
    # (8) TensorBoard
    if len(summaries) < 2 or tb_missing:
        failures.append("tensorboard: %d evaluations, versions missing "
                        "from the event file %s" % (len(summaries),
                                                    tb_missing))
    if failures:
        raise SystemExit("continual phase: " + "; ".join(failures))
    for i, name in enumerate(("exactly once", "checkpoint cadence",
                              "exports", "lifecycle", "tier", "learning",
                              "faults", "tensorboard"), 1):
        log("phase 18 check %d (%s): ok" % (i, name))
    record.pop("tier_stats")
    return record


def continual_summary(record):
    """Phase 18's printed summary: steps/s, K1-K3 a step, peak resident
    rows per shard, evictions, admissions, the watermark's lag, each
    checkpoint's seconds, the phase's seconds and the card."""
    keys = ("steps_per_s", "launches_per_step",
            "peak_resident_rows_after_sweep", "peak_resident_rows_in_stream",
            "evictions", "admissions",
            "watermark_lag_records_max", "watermark_lag_records_mean",
            "checkpoint_seconds", "holdout_logloss",
            "holdout_base_rate_logloss", "holdout_logloss_tier_rows",
            "holdout_pulled_tier_held_served", "seconds", "card")
    log(json.dumps(dict({"phase": "18_continual", "part": "summary"},
                        **{k: record[k] for k in keys})))


# phase 19: bench.py's MoE (bench.py:316-334 runs scripts/bench_moe.py at
# d 1024, 8 layers, S 1024, batch 16, 8 experts; that script's defaults
# give 8 heads (of 128), vocab 32000, MLP ratio 4, top-2, capacity factor
# 1.25, AdamW lr 3e-4 wd 0.01, bf16 compute and the one-hot dispatch)
# beside the dense LM at the matched active MLP ratio, both through the
# port's make_train_step and the default attention (K4-K6 at head_dim
# 128). Cut from bench_moe.py's one warm-up scan and one timed scan of 10
# steps to 2 warm-up steps and 10 timed ones
MOE_ZOO = "elasticdl_tpu_torch.models.moe_transformer"
MOE_WIDTHS = dict(vocab_size=32000, num_layers=8, num_heads=8,
                  embed_dim=1024)
MOE_ROUTING = dict(num_experts=8, top_k=2, capacity_factor=1.25)
MOE_MLP_RATIO = 4
MOE_SEQ = 1024
MOE_BATCH = 16
MOE_WARMUP = 2
MOE_STEPS = 10
# "compact" against "onehot": three AdamW steps each from the same
# weights in fp32 (TF32 off), the losses within the rtol of
# tests/test_moe.py::test_moe_lm_compact_matches_onehot_losses. In bf16
# the per-sample losses are bf16 values (an ulp is 0.0625 at 8-16), so a
# one-ulp difference in one sample's mean would move the batch loss by
# 4e-4 relative: the two dispatches round at other points (the one-hot
# einsum once over its k terms, the gather per term)
MOE_COMPACT_STEPS = 3
MOE_COMPACT_RTOL = 1e-4
MOE_COMPACT_BF16_STEPS = 3     # the compact arm's bf16 step time, after 1
# the zoo's custom_model (vocab 32000, 12 layers, 12 heads, d 768, 8
# experts) through LocalExecutor over RecordIO token records: 3 steps of 4
MOE_ZOO_BATCH = 4
MOE_ZOO_STEPS = 3
# the one-rank mesh arm: bench.py's MoE trained through SpmdTrainer
# (moe_sharding_rules) on a process group of one rank, from the one-hot
# arm's starting weights, beside TorchTrainer's steps
MOE_MESH_STEPS = 3


def moe_flops(d, layers, seq, batch, vocab, mlp_ratio, num_experts, k,
              capacity_factor, compact_dispatch):
    """Matmul FLOPs of one MoeTransformerLM train step, fwd + bwd = 3x
    fwd (the formula of scripts/bench_moe.py:45-77): the MoE FFN in every
    other block runs every (expert, slot) of the static capacity, full
    or not; the one-hot dispatch and combine einsums count as matmuls,
    the compact gathers do not."""
    from elasticdl_tpu_torch.ops.moe import expert_capacity

    tokens = batch * seq
    moe_layers = layers // 2
    dense_layers = layers - moe_layers
    capacity = expert_capacity(seq, num_experts, k, capacity_factor)
    ff = mlp_ratio * d
    proj_attn = 2 * tokens * (4 * d * d) * layers
    attn = 2 * (2 * batch * seq * seq * d) * layers / 2
    ffn_dense = 2 * tokens * (2 * mlp_ratio * d * d) * dense_layers
    slots = batch * num_experts * capacity
    ffn_moe = 2 * slots * (2 * d * ff) * moe_layers
    router = 2 * tokens * d * num_experts * moe_layers
    dispatch = 0 if compact_dispatch else (
        2 * 2 * batch * seq * num_experts * capacity * d * moe_layers)
    head = 2 * tokens * d * vocab
    return 3 * (proj_attn + attn + ffn_dense + ffn_moe + router + dispatch
                + head)


def matched_mlp_ratio(mlp_ratio, top_k, capacity_factor):
    """The dense arm's MLP ratio at the MoE arm's active FFN FLOPs
    (scripts/bench_moe.py:222-227): half the blocks carry k*cf times the
    FFN, so the mean ratio is r * (1 + k*cf) / 2; 7 at bench's config."""
    return max(1, round(mlp_ratio * (1 + top_k * capacity_factor) / 2))


def expert_load(torch, model, params, tokens, routing):
    """One training-mode forward of ``model`` at ``params`` (bf16) on
    ``tokens``, no gradient: the aux loss and, per MoE block, the share of
    tokens whose first choice is each expert and the share of (token,
    rank) assignments dropped past the capacity."""
    from torch.func import functional_call

    from elasticdl_tpu_torch.models.moe_transformer import MoeBlock
    from elasticdl_tpu_torch.ops.moe import (
        expert_capacity,
        top_k_routing_compact,
    )
    from elasticdl_tpu_torch.train.train_state import cast_floating

    logits = []
    hooks = [b.moe_mlp.router.register_forward_hook(
        lambda mod, args, out: logits.append(out.detach().float()))
        for b in model.blocks if isinstance(b, MoeBlock)]
    model.train()
    try:
        with torch.no_grad():
            out = functional_call(
                model, cast_floating(dict(params), torch.bfloat16),
                (tokens,))
    finally:
        for hook in hooks:
            hook.remove()
    experts, k = routing["num_experts"], routing["top_k"]
    capacity = expert_capacity(tokens.shape[1], experts, k,
                               routing["capacity_factor"])
    layers = []
    for lg in logits:
        _, slot, _ = top_k_routing_compact(lg, k, capacity)
        first = torch.bincount(lg.argmax(dim=-1).reshape(-1),
                               minlength=experts).float()
        layers.append({
            "first_choice_share": (first / first.sum()).tolist(),
            "dropped_share": (slot == experts * capacity).float().mean()
            .item()})
    return {"aux_loss": out["aux_loss"].item(), "capacity": capacity,
            "layers": layers}


def lm_arm(torch, np, flash, model, spec_plain, loss_fn, tokens, device,
           what, warmup=MOE_WARMUP, steps=MOE_STEPS):
    """One arm: the first step against ``spec_plain`` (the same model on
    plain attention; phase 6's rules), then ``warmup`` steps and
    ``steps`` timed ones through ``make_train_step`` (AdamW lr 3e-4 wd
    0.01, bf16 compute), fenced by the last loss, K4-K6 counted in every
    step; step ms, tokens/s, peak memory and a profiled step. Returns
    (record, agreement, state)."""
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.step_fns import make_train_step
    from elasticdl_tpu_torch.train.train_state import create_train_state

    batch, seq = tokens.shape
    step_batch = {"features": tokens, "labels": tokens,
                  "_mask": np.ones(batch, np.float32)}
    agreement = first_step_agreement(torch, model, spec_plain, step_batch,
                                     device)
    log(json.dumps(dict(agreement, phase="19_moe", arm=what,
                        card=card_line(device))))
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tx = create_optimizer("AdamW", learning_rate=3e-4, weight_decay=0.01)
    step_fn = make_train_step(model, loss_fn, tx,
                              compute_dtype=torch.bfloat16)
    tensors = {k: torch.from_numpy(v).to(device)
               for k, v in step_batch.items()}
    state = create_train_state(model, tx)
    losses, launches = [], []

    def counted_step(state):
        reset_launches(flash)
        state, loss = step_fn(state, tensors)
        launches.append(read_launches(flash))
        return state, loss

    for _ in range(warmup):
        state, loss = counted_step(state)
        losses.append(float(loss))
    sync(torch, torch.device(device))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = counted_step(state)
    losses.append(float(loss))  # the fetch fences the timed steps
    step_s = (time.perf_counter() - t0) / steps
    record = {"phase": "19_moe", "arm": what, "seq": seq, "batch": batch,
              "warmup": warmup, "steps": steps, "step_ms": step_s * 1e3,
              "tokens_per_s": batch * seq / step_s, "losses": losses,
              "launches_per_step": launches}
    if device == "cuda":
        record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        holder = {"state": state}

        def one():
            holder["state"], _ = step_fn(holder["state"], tensors)

        record["step_profile"] = profile_dense_step(
            torch, one, "moe_%s_train_step" % what)
        state = holder["state"]
    else:
        record["peak_mem_gb"] = "not measured"
    del step_fn, tensors
    return record, agreement, state


def moe_compact_check(torch, np, init, widths, routing, tokens, device):
    """"compact" against "onehot" from the same weights ``init``: three
    AdamW steps each in fp32, the losses within MOE_COMPACT_RTOL; each
    arm's fp32 step times; then the compact arm's bf16 step time (one
    warm-up step, then MOE_COMPACT_BF16_STEPS)."""
    from elasticdl_tpu_torch.models.moe_transformer import (
        MoeTransformerLM,
        loss,
    )
    from elasticdl_tpu_torch.train.optimizers import create_optimizer
    from elasticdl_tpu_torch.train.step_fns import make_train_step
    from elasticdl_tpu_torch.train.train_state import create_train_state

    batch = tokens.shape[0]
    tensors = {"features": torch.from_numpy(tokens).to(device),
               "labels": torch.from_numpy(tokens).to(device),
               "_mask": torch.ones(batch, device=device)}

    def arm(impl, compute_dtype, n):
        with torch.device(device):
            net = MoeTransformerLM(mlp_ratio=MOE_MLP_RATIO,
                                   dispatch_impl=impl,
                                   **widths, **routing)
        net.load_state_dict(init)
        tx = create_optimizer("AdamW", learning_rate=3e-4, weight_decay=0.01)
        step_fn = make_train_step(net, loss, tx, compute_dtype=compute_dtype)
        state = create_train_state(net, tx)
        losses, step_ms = [], []
        for _ in range(n):
            sync(torch, torch.device(device))
            t0 = time.perf_counter()
            state, value = step_fn(state, tensors)
            losses.append(float(value))  # fences the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
        del net, state, step_fn
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        return losses, step_ms

    onehot, onehot_ms = arm("onehot", None, MOE_COMPACT_STEPS)
    compact, compact_ms = arm("compact", None, MOE_COMPACT_STEPS)
    bf16_losses, bf16_ms = arm("compact", torch.bfloat16,
                               1 + MOE_COMPACT_BF16_STEPS)
    rel = [abs(c - o) / abs(o) for c, o in zip(compact, onehot)]
    return {"phase": "19_moe", "part": "compact_vs_onehot",
            "compute_dtype": "float32", "steps": MOE_COMPACT_STEPS,
            "onehot_losses": onehot, "compact_losses": compact,
            "loss_rel_diff": rel, "rtol": MOE_COMPACT_RTOL,
            "onehot_fp32_step_ms": onehot_ms,
            "compact_fp32_step_ms": compact_ms,
            "compact_bf16_losses": bf16_losses,
            "compact_bf16_step_ms": (sum(bf16_ms[1:])
                                     / MOE_COMPACT_BF16_STEPS),
            "ok": max(rel) <= MOE_COMPACT_RTOL
            and all(np.isfinite(bf16_losses))}


def moe_mesh_arm(torch, np, flash, init, widths, routing, tokens, device,
                 steps=MOE_MESH_STEPS):
    """The MoE through the mesh: ``steps`` bf16 AdamW steps of
    ``TorchTrainer`` from the weights ``init``, then as many of
    ``SpmdTrainer`` over a one-rank mesh (NCCL on the card, gloo on the
    CPU; a group this arm starts is destroyed at its end), its model
    built on the host and its blocks moved, with moe_sharding_rules.
    Refuses unless the losses, the parameters and AdamW's slots are the
    same bits, K4-K6 ran once a layer in every mesh step, and the dense
    plan reads every parameter local and 0 collective bytes (recorded
    bytes too)."""
    import torch.distributed as dist

    from elasticdl_tpu_torch.models import moe_transformer
    from elasticdl_tpu_torch.parallel.collectives import (
        track_collective_bytes,
    )
    from elasticdl_tpu_torch.parallel.mesh import (
        MeshConfig,
        build_mesh,
        init_local_group,
    )
    from elasticdl_tpu_torch.parallel.spmd_trainer import SpmdTrainer
    from elasticdl_tpu_torch.worker.trainer import TorchTrainer

    t_arm = time.monotonic()
    batch = {"features": tokens, "labels": tokens,
             "_mask": np.ones(tokens.shape[0], np.float32)}
    layers = widths["num_layers"]
    started = init_local_group(device)
    try:
        mesh = build_mesh(MeshConfig(dp=1))

        def net(on, **kw):
            with torch.device(on):
                model = moe_transformer.MoeTransformerLM(
                    mlp_ratio=MOE_MLP_RATIO, **widths, **routing, **kw)
            model.load_state_dict(init, assign=on == "meta")
            return model

        def optimizer():
            return moe_transformer.optimizer()

        def run(trainer):
            state, losses, launches, step_ms = None, [], [], []
            with track_collective_bytes() as moved:
                for _ in range(steps):
                    sync(torch, torch.device(device))
                    reset_launches(flash)
                    t0 = time.perf_counter()
                    state, loss = trainer.train_step(state, dict(batch))
                    losses.append(float(loss))  # fences the step
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    launches.append(read_launches(flash))
            return state, losses, launches, step_ms, moved.total

        common = dict(loss_fn=moe_transformer.loss,
                      compute_dtype=torch.bfloat16, health=False,
                      device=device, seed=SEED)
        plain = TorchTrainer(model=net(device), optimizer=optimizer(),
                             **common)
        p_state, p_losses, p_launches, p_ms, _ = run(plain)
        # host weights: on "meta", assigned CPU copies of init
        init = {k: v.cpu() for k, v in init.items()}
        spmd = SpmdTrainer(model=net("meta", mesh=mesh),
                           optimizer=optimizer(), mesh=mesh,
                           sharding_rules=moe_transformer.sharding_rules(),
                           batch_spec=moe_transformer.batch_spec(), **common)
        m_state, m_losses, m_launches, m_ms, moved = run(spmd)
        same = all(torch.equal(p_state.params[k], m_state.params[k])
                   for k in p_state.params)
        slots = all(torch.equal(p_state.opt_state[s][k],
                                m_state.opt_state[s][k])
                    for s in ("mu", "nu") for k in p_state.params)
        summary = spmd.dense_plan.summary()
        record = {
            "phase": "19_moe", "part": "mesh", "mesh": spmd.mesh_shape_str,
            "backend": dist.get_backend(), "world": dist.get_world_size(),
            "steps": steps, "plain_losses": p_losses,
            "mesh_losses": m_losses, "params_bit_equal": same,
            "adam_slots_bit_equal": slots,
            "launches_per_step": m_launches,
            "plain_launches_per_step": p_launches,
            "plain_step_ms": p_ms, "mesh_step_ms": m_ms,
            "plan": summary,
            "collective_bytes_per_step": spmd.collective_bytes_per_step,
            "recorded_collective_bytes": moved,
            "seconds": time.monotonic() - t_arm,
        }
        want = {"fwd": layers, "dq": layers, "dkv": layers}
        n_params = len(p_state.params)
        failures = [what for what, bad in (
            ("mesh losses bit-equal", m_losses != p_losses),
            ("mesh params bit-equal", not same),
            ("mesh adam slots bit-equal", not slots),
            ("mesh K4-K6 %d a step" % layers,
             any(s != want for s in m_launches)),
            ("mesh plan all local",
             summary["local_params"] != n_params
             or summary["reduce_scatter_params"]
             or summary["psum_params"]),
            ("mesh 0 collective bytes",
             spmd.collective_bytes_per_step != 0 or moved != 0)) if bad]
        record["ok"] = not failures
        log(json.dumps(record))
        if failures:
            raise SystemExit("moe phase: %s" % failures)
        del p_state, m_state, plain, spmd
        return record
    finally:
        if started:
            dist.destroy_process_group()


def moe_zoo_job(torch, np, flash, workdir, device="cuda", widths=None,
                seq=TRAIN_SEQ):
    """The zoo's custom_model (or ``widths``) through ``LocalExecutor``
    (bf16, AdamW) over RecordIO token records made with numpy from a
    seed: finite losses, K4-K6 once a layer in every step; its export
    answered once by an in-process ``ServingEngine``: bare logits of
    the request's shape, K4 once a layer in that forward, within the
    serve tolerances of the trainer's ``eval_step``."""
    from elasticdl_tpu_torch.data import recordio
    from elasticdl_tpu_torch.data.example import encode_example
    from elasticdl_tpu_torch.serve.engine import ServingEngine
    from elasticdl_tpu_torch.train.export import export_train_state
    from elasticdl_tpu_torch.train.local_executor import LocalExecutor

    params = "" if widths is None else ";".join(
        "%s=%r" % kv for kv in sorted(widths.items()))
    # the zoo's defaults (the reference's custom_model) where not given
    layers = (widths or {}).get("num_layers", 12)
    vocab = (widths or {}).get("vocab_size", 32000)
    tokens = np.random.default_rng(SEED + 19).integers(
        0, vocab, size=(MOE_ZOO_STEPS * MOE_ZOO_BATCH, seq), dtype=np.int32)
    data_dir = os.path.join(workdir, "moe_zoo_data")
    os.makedirs(data_dir)
    recordio.write_records(os.path.join(data_dir, "part-0.rec"),
                           [encode_example({"tokens": t}) for t in tokens])
    executor = LocalExecutor(MOE_ZOO, training_data=data_dir,
                             minibatch_size=MOE_ZOO_BATCH,
                             compute_dtype="bfloat16",
                             seed=SEED, model_params=params, device=device)
    reset_launches(flash)
    losses = executor.train()
    launches = read_launches(flash)
    export_dir = os.path.join(workdir, "moe_zoo_export")
    export_train_state(executor.state, export_dir)
    engine = ServingEngine(MOE_ZOO, export_dir, model_params=params,
                           compute_dtype="bfloat16", max_batch=1,
                           max_delay_ms=2.0, deadline_ms=600000.0,
                           device=device).start(block=True)
    try:
        reset_launches(flash)
        outputs, served_step, _ = engine.predict(tokens[:1], 1,
                                                 deadline_secs=600)
        serve_k4 = flash.LAUNCHES
    finally:
        engine.drain(timeout=30)
    served = outputs["output"]
    want = executor.trainer.eval_step(executor.state, {"features": tokens[:1]})
    got = served.float().cpu().numpy()
    diff = np.abs(got - np.asarray(want, np.float32))
    record = {
        "phase": "19_moe", "part": "zoo_job", "layers": layers,
        "steps": len(losses), "losses": losses, "launches": launches,
        "served_shape": list(served.shape), "served_step": served_step,
        "serve_k4_launches": serve_k4, "served_vs_eval_max_abs":
        float(diff.max()), "served_vs_eval_mean_abs": float(diff.mean()),
        "tol_mean": SERVE_MEAN_TOL, "tol_max": SERVE_MAX_TOL,
        "card": card_line(device)}
    log(json.dumps(record))
    failures = [what for what, bad in (
        ("finite losses", len(losses) != MOE_ZOO_STEPS
         or not all(np.isfinite(losses))),
        ("K4-K6 once a layer a step",
         launches != {k: layers * MOE_ZOO_STEPS
                      for k in ("fwd", "dq", "dkv")}),
        ("bare logits", not isinstance(served, torch.Tensor)
         or list(served.shape) != [1, seq, vocab]
         or not np.isfinite(got).all()),
        ("served at the final step", served_step != MOE_ZOO_STEPS),
        ("K4 once a layer in the served forward", serve_k4 != layers),
        ("served against eval_step",
         record["served_vs_eval_mean_abs"] > SERVE_MEAN_TOL
         or record["served_vs_eval_max_abs"] > SERVE_MAX_TOL)) if bad]
    if failures:
        raise SystemExit("moe zoo job: %s" % failures)
    del executor, engine
    return record


def moe_phase(torch, np, flash, workdir, device="cuda", widths=None,
              routing=None, seq=MOE_SEQ,
              batch=MOE_BATCH, warmup=MOE_WARMUP, steps=MOE_STEPS,
              zoo_widths=None, zoo_seq=TRAIN_SEQ):
    """Phase 19 (see the module docstring): the MoE arm and the matched
    dense arm, the compact dispatch against the one-hot, the MoE through
    a one-rank mesh (``moe_mesh_arm``), the expert load, and the zoo's
    MoE LM as a job served once."""
    from types import SimpleNamespace

    from elasticdl_tpu_torch.models import transformer
    from elasticdl_tpu_torch.models.moe_transformer import (
        MoeTransformerLM,
        loss,
    )

    t_phase = time.monotonic()
    widths = dict(MOE_WIDTHS if widths is None else widths)
    routing = dict(MOE_ROUTING if routing is None else routing)
    layers = widths["num_layers"]
    tokens = np.random.RandomState(0).randint(
        0, widths["vocab_size"], size=(batch, seq)).astype(np.int32)

    def moe_model(attention_impl="auto"):
        with torch.device(device):
            return MoeTransformerLM(mlp_ratio=MOE_MLP_RATIO,
                                    attention_impl=attention_impl,
                                    **widths, **routing)

    torch.manual_seed(SEED + 19)
    model = moe_model()
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    moe, moe_agree, state = lm_arm(
        torch, np, flash, model, SimpleNamespace(
            custom_model=lambda: moe_model("xla"), loss=loss), loss, tokens,
        device, "moe", warmup, steps)
    moe["params_m"] = n_params / 1e6
    moe["config"] = dict(widths, **routing, mlp_ratio=MOE_MLP_RATIO,
                         dispatch_impl="auto (onehot)",
                         source="bench.py:316-334, scripts/bench_moe.py")
    flops = moe_flops(widths["embed_dim"], layers, seq, batch,
                      widths["vocab_size"], MOE_MLP_RATIO,
                      routing["num_experts"], routing["top_k"],
                      routing["capacity_factor"], False)
    moe["model_tflop_per_step"] = flops / 1e12
    moe["flop_share_of_bf16_peak"] = (flops / (moe["step_ms"] / 1e3)
                                      / PEAK_FLOPS["bfloat16"])
    load = expert_load(torch, model, state.params,
                       torch.from_numpy(tokens).to(device), routing)
    moe["expert_load"] = load
    moe["card"] = card_line(device)
    log(json.dumps(moe))
    del state, model
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    compact = moe_compact_check(torch, np, init, widths, routing, tokens,
                                device)
    compact["card"] = card_line(device)
    log(json.dumps(compact))
    mesh = moe_mesh_arm(torch, np, flash, init, widths, routing, tokens,
                        device)
    mesh["card"] = card_line(device)
    del init
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ratio = matched_mlp_ratio(MOE_MLP_RATIO, routing["top_k"],
                              routing["capacity_factor"])

    def dense_model(attention_impl="auto"):
        with torch.device(device):
            return transformer.TransformerLM(mlp_ratio=ratio,
                                             attention_impl=attention_impl,
                                             **widths)

    torch.manual_seed(SEED + 20)
    dense_net = dense_model()
    dense, dense_agree, state = lm_arm(
        torch, np, flash, dense_net, SimpleNamespace(
            custom_model=lambda: dense_model("xla"), loss=transformer.loss),
        transformer.loss, tokens, device, "dense_matched_active", warmup,
        steps)
    dense["params_m"] = sum(p.numel() for p in dense_net.parameters()) / 1e6
    dense["mlp_ratio"] = ratio
    flops = model_train_flops(widths["embed_dim"], layers, seq, batch,
                              widths["vocab_size"], ratio)
    dense["model_tflop_per_step"] = flops / 1e12
    dense["flop_share_of_bf16_peak"] = (flops / (dense["step_ms"] / 1e3)
                                        / PEAK_FLOPS["bfloat16"])
    dense["card"] = card_line(device)
    log(json.dumps(dense))
    del state, dense_net
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    hold_agreement(moe_agree, "the moe arm's first step")
    hold_agreement(dense_agree, "the dense arm's first step")
    want = {"fwd": layers, "dq": layers, "dkv": layers}
    failures = [what for what, bad in (
        ("moe losses finite", not all(np.isfinite(moe["losses"]))),
        ("dense losses finite", not all(np.isfinite(dense["losses"]))),
        ("moe K4-K6 %d a step" % layers,
         any(s != want for s in moe["launches_per_step"])),
        ("dense K4-K6 %d a step" % layers,
         any(s != want for s in dense["launches_per_step"])),
        ("compact against onehot", not compact["ok"]),
        ("aux loss finite", not np.isfinite(load["aux_loss"]))) if bad]
    if failures:
        raise SystemExit("moe phase: %s" % failures)
    zoo = moe_zoo_job(torch, np, flash, workdir, device, widths=zoo_widths,
                      seq=zoo_seq)
    summary = {
        "phase": "19_moe", "part": "summary",
        "moe_step_ms": moe["step_ms"], "dense_step_ms": dense["step_ms"],
        "moe_step_overhead_vs_dense": moe["step_ms"] / dense["step_ms"],
        "moe_tokens_per_s": moe["tokens_per_s"],
        "dense_tokens_per_s": dense["tokens_per_s"],
        "moe_flop_share": moe["flop_share_of_bf16_peak"],
        "dense_flop_share": dense["flop_share_of_bf16_peak"],
        "moe_peak_mem_gb": moe["peak_mem_gb"],
        "dense_peak_mem_gb": dense["peak_mem_gb"],
        "compact_bf16_step_ms": compact["compact_bf16_step_ms"],
        "mesh_step_ms": mesh["mesh_step_ms"],
        "mesh_plain_step_ms": mesh["plain_step_ms"],
        "mesh_seconds": mesh["seconds"],
        "aux_loss": load["aux_loss"],
        "dropped_share": [l["dropped_share"] for l in load["layers"]],
        "seconds": time.monotonic() - t_phase, "card": card_line(device)}
    log(json.dumps(summary))
    return {"moe": moe, "dense": dense, "compact": compact, "zoo": zoo,
            "mesh": mesh,
            "agreement": {"moe": moe_agree, "dense": dense_agree},
            "summary": summary}


def kernel_entry(name, source, replaces, launches, case, kind):
    """One kernel's record of the kernels line, at the main shape. K5
    and K6 have no library call of their own (library_ms null); the
    backward of scaled_dot_product_attention, which computes what both
    compute, stands once, on K6's record, beside the two kernels' sum.
    Their wrapper_ms is one call of flash_attention_bwd, the one wrapper
    that launches them both (checks, delta, K5 and K6)."""
    if kind == "fwd":
        err, ms, plain_ms = case["max_abs_err"], case["ms"], case["plain_ms"]
        bound_ms, bound_by = case["bound_ms"], case["bound_by"]
        library_ms, wrapper_ms = case["library_ms"], case["wrapper_ms"]
    else:
        grads = ("dq",) if kind == "dq" else ("dk", "dv")
        err = max(case["max_abs_err"][g] for g in grads)
        ms, plain_ms = case["%s_ms" % kind], case["%s_plain_ms" % kind]
        bound_ms, bound_by = case["%s_bound" % kind]
        library_ms, wrapper_ms = None, case["wrapper_ms_dq_dk_dv"]
    entry = {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "wrapper_ms": wrapper_ms,
    }
    if kind == "dkv":
        entry["ms_k5_k6"] = case["dq_ms"] + case["dkv_ms"]
        entry["library_ms_k5_k6"] = case["library_ms_dq_dk_dv"]
    return entry


def tier_kernel_entry(name, replaces, kind, tier_cases, sparse, stream,
                      job, restart, artifact, control, telemetry):
    """One device-tier kernel's record of the kernels line: times at
    the deepfm_emb table's shape (d 8; K3 under adam, the deployment's
    optimizer), launches from the sparse train path's main run (and,
    beside them, from the stream phase's tier rung, from worker 0 of
    the job phase, of the PS-restart phase, of the artifact phase and of
    the control phase and of the telemetry phase, K1 with the restart
    flush's reads, the train-end
    and checkpoint barriers' launches and worker 1's drain flush named),
    and the deepfm_linear (d 1) time beside; K3's all-hits times
    too."""
    emb = tier_cases[kind]["deepfm_emb"]
    lin = tier_cases[kind]["deepfm_linear"]
    if kind == "scatter_apply":
        emb, lin = emb["adam"], lin["adam"]
    launches = sparse["launches"][kind]
    entry = {
        "name": name, "route": "cuda", "source": TIER_SOURCE,
        "replaces": replaces, "launches": launches,
        "launches_per_step": launches / sparse["steps"],
        "launches_stream": stream["launches"][kind],
        "launches_job": job["launches"][kind],
        "launches_per_step_job": job["launches_per_step"][kind],
        "launches_restart": restart["launches"][kind],
        "launches_per_step_restart": restart["launches_per_step"][kind],
        "launches_artifact": artifact["launches"][kind],
        "launches_per_step_artifact": artifact["launches_per_step"][kind],
        "launches_control": control["launches"][kind],
        "launches_per_step_control": control["launches_per_step"][kind],
        "launches_telemetry": telemetry["launches"][kind],
        "launches_per_step_telemetry": telemetry["launches_per_step"][kind],
        "max_abs_err": emb["max_abs_err"], "ms": emb["ms"],
        "wrapper_ms": emb["wrapper_ms"],
        "plain_ms": emb["plain_ms"], "bound_ms": emb["bound_ms"],
        "bound_by": emb["bound_by"], "library_ms": emb["library_ms"],
        "shape": emb["shape"], "ms_linear_d1": lin["ms"],
    }
    for key in ("library_calls", "real_mix_ms", "device_ms",
                "all_hits_ms", "real_mix_device_ms", "all_hits_device_ms",
                "real_mix_hits", "all_hits_hits"):
        if key in emb:
            entry[key] = emb[key]
    if kind == "gather":
        entry["launches_restart_flush"] = restart["tier_flush"]["reads"]
        # K1 at the artifact job's barriers: the train-end task's flush
        # and each dense checkpoint's, one K1 per table with dirty rows
        entry["launches_train_end_flush"] = sum(
            k[0] for k in artifact["launches_train_end_flush"])
        entry["launches_checkpoint_flush"] = sum(
            k[0] for k in artifact["launches_checkpoint_flush"])
        # K1 at worker 1's drain: its flush of the tier's dirty rows
        entry["launches_drain_flush"] = control["drain_flush"]["k1_launches"]
        # the staging chunk's chain (K1 -> K2 -> K1) at d 8: median
        # device span by events and by the profiler, with programmatic
        # dependent launch and serial, in turns
        chain = tier_cases["chain_timing"]["deepfm_emb"]
        for key in ("pdl", "serial"):
            entry["chain_%s_span_ms" % key] = [r["span_ms"]
                                               for r in chain[key]]
            entry["chain_%s_profiled_span_ms" % key] = [
                (r["profiler"] or {}).get("span_ms") for r in chain[key]]
        entry["chain_wrapper_ms"] = chain["wrapper_ms"]
    return entry


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs on the GPU only", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("card: %s (%d visible); torch %s, CUDA %s" % (
        smi, torch.cuda.device_count(), torch.__version__, torch.version.cuda))
    if argv == ["--mutations"]:
        mutation_phase()
        log(smi)
        return 0
    if len(argv) == 2 and argv[0] == "--sparse-ab":
        sparse_ab(argv[1])
        log(nvidia_smi_line())
        return 0
    if len(argv) >= 2 and argv[0] == "--job-ab":
        job_ab(argv[1:])
        log(nvidia_smi_line())
        return 0
    if len(argv) == 2 and argv[0] == "--against-parent":
        against_parent(torch, argv[1])
        log(nvidia_smi_line())
        return 0
    if len(argv) == 2 and argv[0] == "--lm-ab":
        lm_ab(argv[1])
        log(nvidia_smi_line())
        return 0
    if argv:
        print("usage: chip_smoke.py [--mutations | --sparse-ab PARENT | "
              "--job-ab PARENT [OTHER ...] | --against-parent PARENT | "
              "--lm-ab PARENT]", file=sys.stderr)
        return 2

    # phase 9's data is written by a child process during the build
    job_dir = os.path.join(HERE, "build", "chip_smoke_jobdata")
    shutil.rmtree(job_dir, ignore_errors=True)
    data_proc = subprocess.Popen([sys.executable, "-c",
                                  JOB_DATA_CHILD % job_dir], cwd=HERE)
    try:
        return run_phases(torch, np, job_dir, data_proc)
    finally:
        if data_proc.poll() is None:
            data_proc.kill()
            data_proc.wait()
        shutil.rmtree(job_dir, ignore_errors=True)


def run_phases(torch, np, job_dir, data_proc):
    """Phases 1-19 and the last lines (see the module docstring)."""
    from elasticdl_tpu_torch.ops import _build
    from elasticdl_tpu_torch.ops import embedding_tier as tier
    from elasticdl_tpu_torch.ops import flash_attention as flash

    # each phase's seconds of command time, printed before the last lines
    seconds, done = stage_clock()
    # the serial chain's copy builds beside the checkout's kernels
    serial_root = kernel_copy("k1_chain_serial", TIER_SOURCE,
                              K1_CHAIN_VARIANTS["serial"])
    serial_build = subprocess.Popen(
        [sys.executable, "-c", "from elasticdl_tpu_torch.ops import _build; "
         "_build.build(['embedding_tier'])"], cwd=serial_root)
    build_s = _build.build()
    if serial_build.wait():
        raise SystemExit("the serial chain's copy did not build")
    log(json.dumps({"phase": "build", "seconds": build_s}))
    # ptxas's report per kernel entry: registers, shared memory, spills
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(key in line for key in PTXAS_KEYS):
                log("ptxas %s: %s" % (name, line.strip()))
    done("1_build")

    cases = kernel_phase(torch, flash)
    bwd_cases = bwd_kernel_phase(torch, flash)
    tier_cases = tier_kernel_phase(torch, np, tier)
    serial_lib = _build.bind(_build.library_path(
        "embedding_tier", os.path.join(serial_root, TIER_SOURCE),
        os.path.join(serial_root, "build", "edl_kernels")), "embedding_tier")
    tier_cases["chain_timing"] = chain_timing(torch, np, tier, serial_lib)
    done("2-4_kernels")

    workdir = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        serve_launches, model, plain, tokens = serve_phase(
            torch, np, flash, workdir)
        serve_timing(torch, model, plain, tokens)
        done("5_serve")
        del model, plain
        gc.collect()
        torch.cuda.empty_cache()
        train = train_phase(torch, np, flash, workdir)
        train_timing(torch, train)
        done("6_train")
        del train["trainer"], train["state"]
        gc.collect()
        torch.cuda.empty_cache()
        sparse = sparse_phase(torch, np, tier)
        store_splits(torch, sparse)
        sparse_timing(torch, tier, sparse)
        sparse["trainer"].close()
        del sparse["trainer"], sparse["state"]
        gc.collect()
        torch.cuda.empty_cache()
        done("7_sparse")
        stream = stream_phase(torch, np, tier)
        done("8_stream")
        if data_proc.wait():
            raise SystemExit("the job's data was not written (exit %d)"
                             % data_proc.returncode)
        job = job_phase(torch, np, tier, job_dir, data_written=True)
        done("9_job")
        restart = ps_restart_phase(torch, np, tier, job_dir)
        done("10_restart")
        artifact = artifact_phase(torch, np, tier, job_dir)
        done("11_artifact")
        control = control_phase(torch, np, tier, job_dir)
        done("12_control")
        telemetry = telemetry_phase(
            torch, np, tier, job_dir,
            job_steps_per_s=job["worker0_steps_per_s"])
        telemetry["serve"] = telemetry_serve(
            torch, np, flash, workdir,
            export_dir=os.path.join(workdir, "export"))
        done("13_telemetry")
        gc.collect()
        torch.cuda.empty_cache()
        fleet = fleet_phase(torch, np, flash)
        done("14_fleet")
        gc.collect()
        torch.cuda.empty_cache()
        vision = vision_phase(torch, np, flash, workdir)
        done("15_vision")
        gc.collect()
        torch.cuda.empty_cache()
        heads256 = heads256_ctr_phase(torch, np, flash, workdir)
        done("16_heads256_ctr")
        gc.collect()
        torch.cuda.empty_cache()
        features = feature_phase(torch, np, tier, workdir)
        done("17_features")
        gc.collect()
        torch.cuda.empty_cache()
        continual = continual_phase(torch, np, tier, workdir)
        continual_summary(continual)
        done("18_continual")
        gc.collect()
        torch.cuda.empty_cache()
        moe = moe_phase(torch, np, flash, workdir)
        done("19_moe")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(json.dumps({"phase_seconds": seconds}))

    # launches: the train path's count, the slice's main path (the
    # serve path's K4 count is beside it)
    launches = train["launches"]
    main_case = "serve_bf16_causal"  # the served and the trained shape
    fwd = kernel_entry(
        "flash_attention_fwd", K4_SOURCE,
        "elasticdl_tpu/ops/flash_attention.py:66", launches["fwd"],
        cases[main_case], "fwd")
    fwd["launches_serve"] = serve_launches
    fwd["launches_serve_telemetry"] = telemetry["serve"]["launches"]
    # K4 in the fleet's replica processes, counted by K4_HOOK
    fwd["launches_fleet_replicas"] = fleet["replica_k4_launches"]
    # phase 15: a train step's launches under each remat policy
    remat = vision["remat"]["launches"]
    fwd["launches_per_step_remat"] = {p: c["fwd"] for p, c in remat.items()}
    dq = kernel_entry("flash_attention_bwd_dq", BWD_SOURCE,
                      "elasticdl_tpu/ops/flash_attention.py:229",
                      launches["dq"], bwd_cases[main_case], "dq")
    dq["launches_per_step_remat"] = {p: c["dq"] for p, c in remat.items()}
    dkv = kernel_entry("flash_attention_bwd_dkv", BWD_SOURCE,
                       "elasticdl_tpu/ops/flash_attention.py:293",
                       launches["dkv"], bwd_cases[main_case], "dkv")
    dkv["launches_per_step_remat"] = {p: c["dkv"] for p, c in remat.items()}
    # phase 16: heads of 256, at bench.py's transformer shape and at
    # its s16k_flash shape; phase 19: heads of 128 at bench.py's MoE shape
    for entry, kind, source in ((fwd, "fwd", cases), (dq, "dq", bwd_cases),
                                (dkv, "dkv", bwd_cases)):
        for key, case in (("d256", "bench_bf16_d256_causal"),
                          ("d256_s16k", "s16k_bf16_d256_causal"),
                          ("d128_moe", "moe_bf16_d128_causal")):
            other = kernel_entry(entry["name"], entry["source"],
                                 entry["replaces"], None, source[case], kind)
            entry[key] = {k: other[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "wrapper_ms", "ms_k5_k6", "library_ms_k5_k6")
                if k in other}
            entry[key]["shape"] = source[case]["shape"]
        # unequal query and key lengths (UNEQUAL_CASES)
        entry["unequal"] = {}
        for case in UNEQUAL_CASES:
            other = kernel_entry(entry["name"], entry["source"],
                                 entry["replaces"], None, source[case[0]],
                                 kind)
            entry["unequal"][case[0]] = {k: other[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "wrapper_ms", "ms_k5_k6", "library_ms_k5_k6")
                if k in other}
        # every step's count is the same (phases 16 and 19 check it)
        entry["launches_per_step_d256"] = {
            "transformer": heads256["bench"]["record"][
                "launches_per_step"][0][kind],
            "s16k_flash": heads256["s16k"]["launches_per_step"][0][kind]}
        entry["launches_per_step_moe"] = {
            "moe": moe["moe"]["launches_per_step"][0][kind],
            "dense_matched": moe["dense"]["launches_per_step"][0][kind],
            "moe_mesh": moe["mesh"]["launches_per_step"][0][kind]}
    tier_entries = [
        tier_kernel_entry("embedding_tier_gather",
                          "elasticdl_tpu/ops/embedding_tier.py:163",
                          "gather", tier_cases, sparse, stream, job,
                          restart, artifact, control, telemetry),
        tier_kernel_entry("embedding_tier_insert_rows",
                          "elasticdl_tpu/ops/embedding_tier.py:197",
                          "insert_rows", tier_cases, sparse, stream, job,
                          restart, artifact, control, telemetry),
        tier_kernel_entry("embedding_tier_scatter_apply",
                          "elasticdl_tpu/ops/embedding_tier.py:253",
                          "scatter_apply", tier_cases, sparse, stream, job,
                          restart, artifact, control, telemetry),
    ]
    # phase 17: the promoted feature-column model's run
    promoted = features["promoted"]
    for entry, kind in zip(tier_entries, ("gather", "insert_rows",
                                          "scatter_apply")):
        entry["launches_features"] = promoted["launches"][kind]
        entry["launches_per_step_features"] = promoted[
            "launches_per_step"][kind]
        # phase 18: worker 0 of the continual stream job
        entry["launches_continual"] = continual["launches"][kind]
        entry["launches_per_step_continual"] = continual[
            "launches_per_step"][kind]
    log(json.dumps({"kernels": [fwd, dq, dkv, *tier_entries]}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
