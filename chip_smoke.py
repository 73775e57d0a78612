"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device facts: the card's name and power limit, TF32 switched off.
2. Build every CUDA kernel from ``tpu_tfrecord_torch/csrc`` with nvcc for
   sm_90a (all sources at once), print ptxas' registers and spills for each
   kernel instance (a spill fails the run), and hold each instance against
   its plain PyTorch version on the card at the main-path shape and at the
   edges of its design.
3. Time each instance at the main-path shape beside its plain version, one
   PyTorch library call computing the same function, and the least time
   the card could take (bytes over 3.35 TB/s or operations over the peak
   rate). Device times come from CUDA-graph replays of many calls, so the
   host's launch time is not counted (it is printed apart: eager calls back
   to back). Warm: one input (partly L2-resident, as on the main path where
   E was just written by the concat). Cold: the calls cycle over inputs
   that together exceed the 50 MB L2, so no call finds its input there;
   the share of the bound is stated for the cold time.
4. The main path at full Criteo width. Host facts first (CPU model and
   cores, ``g++ --version``): host rates depend on them. The native host
   library (``tpu_tfrecord_torch/csrc/tfrecord_native.cc``, g++) is built
   beside the CUDA kernels and its build time printed. Then: write 2 shards
   x 16,384 Example rows through the port's writer; iterate them for 8
   epochs with ``TFRecordDataset`` (native decode on its producer thread,
   hashing into 2^20 buckets, packing dense/cat) without scoring, for the
   decode-only rate; score the same 8 epochs (16 batches) with the
   26 x 2^20 x 32 DLRM (3.49 GB table) through ``score_files`` in bf16
   (the bf16 instance), and the same 8 epochs in f32 activations (the f32
   instance). Each path's launch counts must match the batches it scored,
   and its logits must match a run whose interaction is the plain version.
   One 16,384-row batch decoded natively and by the Python oracle must give
   identical dense and cat matrices. Then, for each dtype, the forward's
   device time, its kernels (torch.profiler), the rows/s whole and steady
   (batches 2-16), host and H2D ms per batch, and the card's idle share.

5. Training at full width, in phase 4's shards. The sparse path:
   ``train_files(sparse=True, shuffle=True, shuffle_window=2, seed=0)``
   over 8 epochs (16 steps of 16,384 rows: Adam(1e-3) on the MLPs,
   row-wise AdaGrad on the table at embed_lr 0.01) with its own counter
   window; every loss finite, 16 ``bf16_mma`` launches and 0 ``f32_tiled``;
   the losses and the table match a run from the same weights under the
   plain interaction (plain forward, autograd backward). The same sparse
   run in f32 activations (16 ``f32_tiled`` launches, 0 ``bf16_mma``), with
   the same checks and its own step profile. The dense path (bf16 only):
   ``train_files(sparse=False)`` over one shard for 2 epochs (2 steps,
   Adam over every parameter, the table's 3.49 GB gradient included),
   the same checks. The interaction's backward (``DotInteraction``)
   against autograd through the plain version at (16384, 27, 32) in bf16
   and f32, with its device time (graph replay) beside the kernel's. Then
   where a training step's time goes: one sparse step's time on a resident
   batch (CUDA events, back to back), its profile by part (gather,
   forward, interaction backward, the rest of the backward, Adam, sort,
   segment sums, scatters), the loop's rows/s (whole and steps 2-16), host,
   H2D and step ms per step, and the device's idle share.

6. The feed at full width, in phase 4's shards. Decode-only rows/s at 1, 2,
   4 and 6 decode workers over the same 8 epochs, with every batch's
   checksum equal across the worker counts. bf16 serving through
   ``score_files(num_workers=n)`` at the same counts against the direct loop
   (decode on one thread, densify inline, a synchronized copy out of fresh
   pinned buffers) in the same run: logits bit-equal. The host side alone
   (decode and densify at 4 workers, nothing sent to the card), and which
   stage binds serving and training. bf16 sparse training, 16
   shuffled steps at 4 decode workers, through three feeds (dispatch-ahead,
   the transfer thread, the 20-bit wire), each against the direct loop at
   phase 5's tolerances (before the wire run, the first and second call of
   its unpack and dense transform, timed); one f32 sparse run through the
   fastest of them, against the direct loop in f32. For each run: whole and steady rows/s, the
   host-wait, H2D and step medians, the duty cycle and the launches. Last,
   the staging race check: 64 batches of distinct contents through
   ``DeviceIterator(depth=2)`` in both modes while the consumer runs a long
   device op on each; every device batch's checksum must equal its host
   batch's.

7. The data-source API at full width, in phase 4's temp dir, host CPU facts
   first. (a) ``DatasetWriter.write_batches`` at bench_write.py's shape
   (6 x 16,384 Criteo columnar rows): sequential (1 worker) and pipelined
   (4 workers, 4 shards), uncompressed and deflate, 2 interleaved pairs,
   best of each, beside bench_write.py's two-thread zlib probe; the
   pipelined files' bytes must be identical at 2 and 4 workers. (b) Phase
   4's rows with ``day`` = the shard's index through ``io.write(...,
   partition_by=["day"], codec="gzip")`` at 1 and 4 write workers, the same
   records both ways. (c) ``reader().schema()`` and
   ``infer_schema_all_files(num_workers=4)`` must give the written schema
   with ``day`` appended as LongType, and ``read(limit=1024)`` the first
   1,024 source rows. (d) bf16 scoring of the partitioned root over 8
   epochs (``day`` read and ignored by the model): logits bit-equal to
   phase 4's bf16 logits, 16 ``bf16_mma`` launches in its own window.
   (e) Shard00's records through snappy, lz4 and bzip2 (and zstd where
   ``zstandard`` is installed): every decoded batch digest equal to the
   uncompressed shard's.

8. Resumable training at full width, in phase 4's shards (bf16, sparse
   steps through ``harness.run_train_loop``, phase 5's shuffled read:
   ``shuffle_window=2, seed=0``, 8 epochs, 16 steps). The free disk is
   printed beside the checkpoint's size (3.6 GB; keep=1 holds two during a
   commit) and the phase fails if it is short. An uninterrupted run with no
   checkpoint records each step's batch digest and loss. A run from the
   same seed with a ``TrainCheckpointer`` (async, keep=1) saving every 8
   steps stops at step 12; a model from another seed restores step 8 and
   its input position (every tensor bit-equal to the step-8 snapshot),
   then runs steps 9-16: digests equal to the uninterrupted run's, losses
   within 2e-2, table rows within 5e-3 (phase 5's gates). An async twin of
   16 steps saving at 8 and 16 (keep=1: one generation left) and a sync
   twin saving at 16 only split what the background commit hides: snapshot (the first save of the process apart: it pins the host
   buffers), commit, commit wait, drain, StepPhases shares and verdict,
   rows/s beside phase 5's loop. 68 ``bf16_mma`` launches (16 + 12 + 8 +
   16 + 16). Last, the kill drill: ``python -m tpu_tfrecord_torch.train_dlrm``
   (sparse, on the card, 2 of its shards) is killed with SIGKILL once its
   step-8 position is saved (its commits delayed DRILL_COMMIT_DELAY_S, so
   it cannot end first) and run again; it must resume from a nonzero
   position and finish, the saved step plus its steps making the 16-step
   epoch budget. The drill runs beside phase 9 (it is checked for
   correctness only; phase 9's rates are contended already).

9. The sequence models (no DLRM kernel runs here: every instance's launch
   count over the phase must be 0). The twins' SequenceExamples are
   written (``train_lm``'s 4 x 256 token documents, ``train_longdoc``'s
   4 x 256 frame documents). (1) The LM at the twin's width (vocab 256,
   d_model 64, 4 heads, 2 layers, L = 64, B = 32, f32, TF32 off) with one
   set of weights on the card and on the CPU: logits within 1e-4, then 16
   Adam steps with losses within a relative 1e-4, on slice-packed batches
   and on ``TokenPacker(32, 64, "best_fit")`` batches with segment ids.
   (2) The long_doc feed's bf16 frames (native pad and round,
   ``DeviceIterator``) bit-equal to the float32 pad cast on the card, and
   the classifier's logits card against CPU (bf16 within 2e-2, f32 within
   1e-4). (3) ``python -m tpu_tfrecord_torch.train_lm`` for 64 steps
   saving every 8, then killed with SIGKILL after step 20 and run again:
   it must resume at step 16 with the uninterrupted run's digests for
   steps 17-64 and its losses (bit-equal, or within a relative 1e-4: the
   line says which), and its tokens/s whole and steady. (4) ``python -m
   tpu_tfrecord_torch.train_longdoc`` whole (32 steps, bf16 frames):
   finite losses, the phase shares and verdict. The uninterrupted run, the
   killed run and train_longdoc run at once (three processes on the card,
   as in phase 11): their tokens/s are contended rates, read beside one
   another, and not comparable with those of a run alone. (5) Rates
   beside the card's name and power limit: LM and long_doc train steps/s eager on a
   resident batch, with device ms a step (torch.profiler) and the idle
   share; ``TokenPacker`` docs/s and density at the bench's pack shape.

10. LM serving (no DLRM kernel runs here: every instance's launch count
   over the phase must be 0), under deterministic algorithms. (a) The
   serve_lm LM (vocab 256, d_model 64, 4 heads, 4 layers, L = 64) trained
   16 Adam steps on ``make_synthetic_tokens`` and saved through
   ``train_lm.LMCheckpoint``; a second generation parked before its
   manifest by a writer killed there; ``serve_lm.load_checkpoint`` must
   return the complete one, bit-equal. (b) serve_lm's timed pass (32
   requests of mb 8) at (S, V) = (1, 2) and (2, 2): streamed logits
   bitwise equal to ``batch_reference``, the layouts within 1e-5 of each
   other and the card within 1e-4 of a CPU run; requests/s, sequences/s,
   p50/p99. (c) A replica (``ServingEngine`` + ``ServeServer`` on
   127.0.0.1, S = 1, V = 2, mb 8, max_queue 16) under 8 concurrent
   ``ServeClient`` threads of 4 requests x 16 new tokens: every request's
   tokens equal ``sequential_reference`` on the card; meanwhile a client
   hangs up mid-generation (counted once), a ``burst`` of 8 past a full
   queue on a second replica is shed by exactly 8 with a Retry-After hint,
   and two deadlines (at admission, mid-generation) are dropped and
   counted; tokens/s, requests/s, latencies, ticks, ``serve.*`` counters
   and the verdict. (d) One engine tick at (1, 2) under torch.profiler:
   host ms, device ms, kernels, idle share. (e) ``python -m
   tpu_tfrecord_torch.serving --device cuda`` as a subprocess, started
   with (a) and checked right after it (before the measured (b)-(d)): its
   ready line, 4 requests equal to the reference, SIGTERM, exit 0 within
   60 s.

11. Mixture-of-Experts on one card (no DLRM kernel runs here: every
   instance's launch count over the phase must be 0), under deterministic
   algorithms. (a) ``moe_apply`` at T = 2048 (d_model 64, d_ff 256, 4
   experts, f32) on the card against the CPU at top_k 2, top_k 1, capacity
   factor 0.25 and a quarter of the tokens masked out: y and aux within
   1e-4, the routing (each rank's expert and slot) and the counts equal,
   the gradients of x and the three weights within 1e-4 of their scale,
   and the smallest probability margin of a choice. (b) The MoE LM of
   ``train_lm --moe 4`` (top-2) with one set of weights on the card and on
   the CPU: logits within 1e-4, then 16 Adam steps in lockstep (the CPU
   takes the card's parameters and moments before each step) with losses
   within a relative 1e-4 and each step's ``expert_tokens`` and
   ``expert_kept`` equal; the same steps run free are printed, not gated.
   (c) ``python -m tpu_tfrecord_torch.train_lm --moe 4 --diagnostics
   --trace-out`` for 32 steps saving every 8, then killed with SIGKILL
   after step 12 and run again: it must resume at step 8 with the
   uninterrupted run's digests and losses for steps 9-32 (bit-equal, or
   within a relative 1e-4: the line says which), finite ``moe.*`` gauges
   and ``train.step`` spans in its trace. (d) The MoE long_doc's logits
   card against CPU (bf16 within 2e-2, f32 within 1e-4) and
   ``LONGDOC_MOE_EXPERTS=4 python -m tpu_tfrecord_torch.train_longdoc``
   whole (finite losses, the phase shares and verdict), run beside (c).
   (e) Under the default algorithms, beside the card's name and power
   limit: the MoE LM train step and phase 9's dense step on a resident
   batch (host ms, device ms and kernels a step, idle share) and
   ``moe_apply``'s forward at T = 2048.

12. The rest of the decode pool, on the card's host (``readpool_path``):
   (a) 4 uncompressed shards of 262,144 Criteo rows (phase 4's rows, drawn
   as arrays) through ``DatasetWriter.write_batches``, their bytes, and
   the filesystem under them from ``/proc/mounts`` (the checkout's
   ``_scratch/`` in place of a tmpfs or overlay temp dir). (b) The serial
   read rate after ``fsync`` + ``POSIX_FADV_DONTNEED``, a warm pass (the
   reference digests), then four passes at 2 workers after a drop, mmap
   and stream routes at readahead 0 and 64 MiB: rows/s, MB/s,
   ``ru_majflt``, CPU s over wall s, the share of the serial rate, and the
   share of pages ``mincore`` finds resident after the drop (a pass is
   cold only where it is 0); the pool at 1, 2 and 4 workers at the JAX
   per-shard queue depth and at 16. (c) The warm host loop with 60 s
   deadlines and watchdog against none, A/B/B/A, best of each.
   (d) Drills under a ``FaultPlan`` on the real files (3 s stalls,
   released at the end): a stalled read beaten by a 50 ms hedge (batches
   bit-equal, ``read.hedge_wins`` >= 1), a stalled open retried past a
   200 ms deadline (``read.retries`` >= 1), a wedged worker failed by a
   500 ms watchdog at 4 workers (one restart, one ``shard_stalled`` skip,
   the other shards' batches equal, the epoch's lost time), and the same
   under ``on_stall="raise"`` (``WatchdogError``). (e) The bf16 DLRM
   scores the 64 batches through the feed three times, autotuned from 1
   worker with a pulse every 0.25 s (the pulse lines taken off the
   package logger: decisions, pool over time), at 1 and at 4 fixed
   workers: rows/s whole and steady, the device's idle share, logits
   bit-equal, 64 ``bf16_mma`` launches each; a state taken under autotune
   after a resize resumes on a fixed pool to the same batches.

13. The columnar epoch cache on phase 12's shards (``cache_path``), its
   directory on the same mount: (a) a decode-only pass with
   ``cache="auto"`` populates one entry a shard (rows/s, 4 misses, bytes
   written against the shards' bytes, batches equal phase 12's); (b) the
   bf16 DLRM scores the 64 batches uncached and then from a new dataset on
   the cache, both traced, the second with ``telemetry_port=0``: 4 hits
   and 0 misses, logits bit-equal, 64 ``bf16_mma`` launches and none of
   ``f32_tiled`` in the warm run (``cache_launches``), rows/s whole and
   steady and the idle share of each, one ``cache.serve`` span a cached
   chunk, the two Chrome traces merged by ``merge_chrome_traces``, and one
   scrape of ``/metrics`` holding the ``cache.hits`` family; (c) a state
   taken on a cached read resumes on an uncached read to the
   uninterrupted batches; (d) one byte of one entry's section flipped: the
   next read counts one ``cache.corrupt_fallbacks``, gives the same
   batches and rewrites the entry. The entries are unmapped
   (``release_registry``) before the directory is removed.

14. Multi-process ingest on phase 12's shards (``multiproc_path``): this
   process scores all 4 shards with the bf16 DLRM through phase 12's
   fixed-4 feed, then spawns 2 ranks on the one card over a gloo group
   (``device.distributed``). Each rank adopts rank 0's trace id, infers the
   schema across the group (``infer_schema_multihost``, checked with
   ``assert_same_across_hosts``), reads its interleaved slot (shards 0, 2
   or 1, 3) through dataset -> HostPrefetcher -> ``DeviceIterator(mesh=
   create_mesh())`` and scores each batch, handed over as DTensors of
   2 x 16,384 rows sharded on 'data', with the same DLRM built from the
   same seed. It saves its position after 5 batches (``save_state``),
   resumes a fresh dataset on its slot from it and refuses the other
   rank's state; it writes (shard, row, logit) rows with
   ``DatasetWriter(write_success=False, task_id=rank)`` and commits with
   ``finalize_distributed_write``. Gates: both ranks exit 0 within
   MULTI_TIMEOUT_S (killed after it); both schemas equal this process's
   ``infer_schema_all_files``; every rank's logit bit-equal to this
   process's for the same (shard, row), all 1,048,576 rows read back; one
   ``_SUCCESS``, part files of both task ids; one trace id, rank 1's
   parent span rank 0's; both resumes exact; 32 ``bf16_mma`` launches a
   rank (its 32 batches), 0 ``f32_tiled``. Printed: each rank's rows/s
   (whole and steady) and idle share, both ranks' rows/s together and the
   card's idle share over their run (the union of their synchronized
   forwards on the host's monotonic clock) and the time of a process's
   first DTensor (a warm-up before the run). The check of the first global
   batch gathers a CPU copy: ``DTensor.full_tensor()`` over gloo on CUDA
   tensors ends both ranks (a finding of earlier runs, no longer
   re-measured).
   (c) The DLRM over a mesh of the same two ranks (``mesh_rank``): after
   scoring, each rank frees its model, builds the full-width bf16 DLRM from
   TRAIN_SEED and keeps its pieces (``dlrm.shard_model``), then takes 4
   ``sharded_sparse_train_step``s on mesh {'model': 2} (a [26, 2^19, 32]
   table shard each, both ranks on the same 16,384-row batches: the first
   4 of the shards' one slot), 4 on {'data': 2} (each rank its own slot's
   16,384 rows of a 32,768-row global batch, through
   ``make_global_batch``) and 1 ``sharded_train_step`` on {'model': 2}.
   The sharded forward collects over gloo with ``all_reduce`` and the list
   ``all_gather`` only. Each rank writes its losses, a digest of its table
   piece and of its MLP pieces after every step, and its table rows that
   moved. This process then runs the same steps in one process on the
   same (for {'data': 2} the concatenated) batches: losses within
   TRAIN_LOSS_TOL and every moved row within TRAIN_TABLE_ATOL (phase 5's
   gates), the sparse steps' AdaGrad accumulators of the moved rows within
   MESH_ACCUM_RTOL of their largest (the one state that carries the
   gradients' scale: a gradient counted twice leaves the Adam and AdaGrad
   moves as they were), the same rows moved, the data replicas' digests equal at every
   step, the model ranks' losses equal, one ``bf16_mma`` launch per sharded
   forward in each rank's window (``mesh_launches``). Two ranks of
   ``python -m tpu_tfrecord_torch.train_dlrm --max-steps 8`` under
   torchrun's environment start with the scoring ranks (they run while
   those import; the scoring waits for their exit) and must both exit 0
   after 8 steps. Printed with the
   card's name and power limit: each rank's step ms, the ms of its
   collectives (CUDA events around them) and the card's idle share for its
   kernels over its last step of each mesh (torch.profiler).
   (d) The sequence axis over the same two ranks (``seq_mesh_rank``),
   after (c), on mesh {'seq': 2}, the counts of ``dot_interaction`` set to
   0 before and read after (``sp_launches``, which must be 0: the sequence
   models bypass the DLRM). (a) ``ring_attention`` contiguous causal, zigzag
   causal with packed-document segments and GQA (Hkv 2), and
   ``ulysses_attention`` causal with lengths, at the LM twin's widths
   (B 32, L 64, 4 heads of 16) in float32: each rank's chunk and the
   gradients of its q, k, v held against the dense attention over the whole
   sequence (atol 1e-4; gradients 1e-4 of the largest); then a long probe,
   B 1, L 8192, 8 heads of 64, bf16, forward only, ring zigzag and Ulysses
   (atol 2e-2). Each call's ms and its collectives' ms (CUDA events,
   median of SP_REPS) and the dense attention's ms on the rank alone. (b)
   4 bf16 ``long_doc`` train steps at the JAX trainer's widths with ring
   and with Ulysses attention, each rank its half of every document's
   frames, beside the one-process steps on the whole batch (losses within
   2e-2). (c) 4 float32 LM train steps (the ``train_lm`` twin's model) with
   the zigzag ring and best_fit packed segments beside the one-process
   steps, under deterministic algorithms (losses within 1e-4). The ranks'
   losses must be equal. Two ranks each of ``train_lm --mesh dp_sp`` and
   of ``train_longdoc`` (phase 9's documents) start with (c)'s
   ``train_dlrm`` ranks, while the scoring ranks import (which score only
   after all of them exited), and run SP_TWIN_STEPS steps under torchrun's
   environment: both ranks of each exit 0 after the steps on the (data 1,
   seq 2) mesh with equal, finite losses. The hops pass through host memory (gloo on CUDA tensors):
   the collectives' ms are not NVLink or NCCL figures.
   (e) FSDP for the LM over the same two ranks (``fsdp_mesh_rank``), after
   (d), on mesh {'fsdp': 2}, the counts of ``dot_interaction`` set to 0
   before and read after (``fsdp_launches``, which must be 0). 4 float32
   LM train steps at the ``train_lm`` twin's widths on each rank's
   ``lm.shard_params`` slices, gathered on use, under deterministic
   algorithms, beside the one-process steps on the same batches: losses
   within 1e-4, ``unshard_params`` within 1e-4 of the one-process
   parameters, the two ranks' losses equal, and each rank's at-rest bytes
   (parameters + Adam state) below 0.65 of one process's. Printed with the
   card's name and power limit: each step's host ms, its gathers' ms (CUDA
   events, through host memory: not NVLink or NCCL figures) and the
   one-process step's ms. Four ranks of ``train_lm --mesh dp_fsdp`` ({'data':
   2, 'fsdp': 2}) start with (d)'s trainers and run SP_TWIN_STEPS steps:
   all four exit 0 with equal, finite losses, each printing its mesh line
   and its ``fsdp param bytes/device``.
   (f) The MoE over the same two ranks (``moe_mesh_rank``), after (e), the
   counts of ``dot_interaction`` set to 0 before and read after
   (``ep_launches``, which must be 0). (a) ``moe.moe_apply_ep`` on
   {'expert': 2} over the ``train_lm`` twin's 32 x 64 tokens as one stream
   (4 experts of d_ff 256 over d_model 64, top-2, float32): y within 1e-4
   of ``moe_reference(shards=2)`` at capacity factors 1.25 and 0.75, and
   at 4.0 (no drops) y and the gradients of router, w_in, w_out and x
   within 1e-4 (of each one's largest) of one process's ``moe_apply``, the
   router's nonzero. (b) 4 float32 LM train steps of the twin's model with
   ``--moe 4`` under deterministic algorithms: on {'data': 2} (the global
   route: each rank its half of the rows, the routing and the capacity of
   the whole batch) and on {'expert': 2} at factor 4.0 (each rank 2 of the
   4 experts and their Adam moments), each beside the one-process steps:
   losses within 1e-4, equal on both ranks, the gathered parameters within
   1e-4. (c) Printed with the card's name and power limit: each step's
   host ms, its all_to_alls' ms (CUDA events, through host memory: not
   NVLink or NCCL figures) and the one-process step's ms. (d) Two ranks of
   ``train_lm --mesh dp --moe 4 --diagnostics`` start with (d)'s trainers
   and run SP_TWIN_STEPS steps: both exit 0 on {'data': 2} with equal,
   finite losses and the same ``moe.*`` gauges.

15. Remote filesystems on phase 12's shards (``remote_path``): the port's
   ``httpfs.serve_directory`` serves them from a spawned process on
   127.0.0.1 (loopback: the rates are what the client and the decoder
   cost, not what a remote store gives; the server's per-request delay is
   the only model of a round trip). (1) Bare sequential reads of one shard
   through ``fs.PrefetchReader`` (8 MiB blocks) at 1 and 4 block fetches in
   flight, at a delay of 0 and 20 ms a request: MB/s. (2) Discovery over ``http://``
   lists the shards with their local sizes and ``infer_schema_all_files``
   equals the local one; the bf16 DLRM scores the 64 batches through phase
   12's fixed-4 feed over ``http://``: logits bit-equal to phase 12's local
   run for every row, 64 ``bf16_mma`` and 0 ``f32_tiled`` launches in its
   window (``remote_launches``), rows/s whole and steady, MB/s, the idle
   share, the ``remote.*`` / ``read.retries`` counters. (3) A decode-only
   read under a seeded server-side ``FaultPlan`` (a reset mid-body, a
   truncated body, a 503 with Retry-After 0.05 s, a trickle; one block
   request each) with ``read_retries=4``, twice: batches equal the clean
   read's, ``remote.fetch_retries`` at least the failing faults fired, the
   same ledger both times; then a shifted ``Content-Range`` with no retries
   raises ``BadContentRangeError`` before any row. (4) A populate pass over
   ``http://`` into a local ``cache_dir`` (4 misses, 4 entries), then the
   bf16 DLRM from a new dataset on the cache: 4 hits, no file GET at the
   server, logits bit-equal, 64 ``bf16_mma`` launches. The entries are
   unmapped before the directory is removed.

16. The fleet flight recorder and the SLO engine on phase 12's shards
   (``fleet_path``), with the spool dir on the same mount; three processes
   spool into it at once, each under its own trace id. (1) This process
   scores the 64 batches with the bf16 DLRM through phase 12's fixed-4 feed
   with ``telemetry_spool_dir``, ``spool_interval_s=0.2`` and
   ``telemetry_role="scorer"``: logits bit-equal to phase 12's local run,
   64 ``bf16_mma`` and 0 ``f32_tiled`` launches in its window
   (``fleet_launches``), rows/s whole beside phase 12's fixed-4 rate. (2)
   ``python -m tpu_tfrecord_torch.serving --device cuda --spool-dir D``
   (phase 10 (e)'s model), started while (1) scores, answers 4 requests
   equal to the reference, then
   SIGTERM: exit 0 within 60 s, a ``final: true`` last line. (3) ``python
   -m tpu_tfrecord_torch.train_lm --device cuda --spool D --spool-interval
   0.2`` for 32 steps (a synchronous save a step), SIGKILLed after its
   step-12 line once its spool counts a step. (4) ``fleet.TelemetryAggregator(D)`` past 2 x 0.2 s: 3
   processes with roles {scorer, serving, trainer}, the scorer and the
   replica alive through ``final``, the trainer dead; every counter the sum
   of the three files' newest lines, every merged histogram
   ``Histogram.from_states`` of the three states bucket for bucket,
   ``serve.requests`` 4, the trainer's phase shares summing to 1, the
   scorer's trace id selecting 1 process; the federated page served once
   on port 0 with every role. (5) ``slo.engine_from_spool`` with
   ``availability:0.999`` and ``latency:0.95:250`` over the default windows
   scaled to the run: the availability objective's bad / total is the
   aggregate's sheds and misses over those plus the requests. Then the
   scoring again without the spool and with it, back to back, for the
   spool's cost on a quiet host.

17. Pipelined LM training and the data service. (a) ``pipe_path``: the
   4-layer LM of ``train_lm --mesh dp_pp`` (vocab 256, d_model 64, 4
   heads, L = 64, B = 32, f32, weights from seed 0) takes one
   ``train_step`` through the one-card schedule (2 stages, 8 microbatches,
   V = 1 and V = 2) and the same step without it: losses and every
   gradient within 1e-4, the bubble exactly 1/9 and 1/17. Each step's host
   ms, device ms, kernels and idle share beside the step without the
   schedule and phase 9's LM step, taken after ``python -m
   tpu_tfrecord_torch.train_lm --mesh dp_pp --virtual 2 --diagnostics``
   ran for 16 steps in a subprocess beside the checks (which time
   nothing): its batches are this process's stream,
   its losses those of the same steps here without the schedule (within
   1e-4), its gauges 1/17; ``dot_interaction`` launches 0 times
   (``pipe_launches``). (b) ``service_path`` on phase 12's shards: a
   ``python -m tpu_tfrecord_torch.service dispatcher --journal`` and two
   workers, subprocesses with ``CUDA_VISIBLE_DEVICES=`` that join a trace
   context minted here, serve phase 12's fixed-4 feed with
   ``service=<addr>``: logits bit-equal to phase 12's local run for all
   1,048,576 rows, 64 ``bf16_mma`` and 0 ``f32_tiled`` launches
   (``service_launches``), no fallback; rows/s beside phase 12's fixed-4
   rate and the card's idle share. Then the chaos drill: after the
   consumer's first chunk the worker that holds the lease is SIGKILLed,
   then the dispatcher, which restarts on its port from its journal; the
   epoch finishes bit-equal, 1,048,576 rows, no fallback, at least one
   lease reassignment, the surviving worker alive and the minted trace id
   in ``fetch_status``.

18. The data service's warm standby and elastic scaling (``elastic_path``)
   on phase 12's shards, every service process a subprocess off the card
   (``CUDA_VISIBLE_DEVICES=``), the consumer phase 12's fixed-4 bf16 DLRM
   feed in this process. (a) ``ha_failover``: a primary ``dispatcher
   --journal J``, its standby ``dispatcher --standby-of <primary>
   --journal J --ping-interval 0.25 --takeover-misses 3`` and two workers
   registered through ``primary|standby``; the primary is SIGKILLed after
   the consumer's first chunk. Gates: logits bit-equal to phase 12's local
   run for all 1,048,576 rows, 64 ``bf16_mma`` and 0 ``f32_tiled``
   launches (``ha_launches``), no fallback, the standby's status
   ``failed_over``, generation 1, role ``dispatcher``, 4 shards done.
   Printed: the promotion and the first granted route after the kill,
   rows/s beside phase 17's rate through the service, the idle share. (b)
   ``elastic_resize``: one dispatcher and a ``FleetScaler`` here over it
   (``DispatcherHandle``, ``subprocess_spawner``, policy 1..3, hysteresis
   1, no cooldown, its verdicts scripted through ``aggregator=``): one
   worker at the start, grown to 3 before batch 4, one drained before
   batch 20 and a second drained and SIGKILLed before batch 36. Gates:
   logits bit-equal, 64 launches (``elastic_launches``), no fallback, two
   producer_bound scale-ups, the drained worker's goodbye, the killed one
   stale in ``draining``. The consumer spools as ``trainer``: what a real
   ``fleet.TelemetryAggregator`` reads of that spool is printed, a
   finding. (c) ``serving_scale``: a ``ServingScaler`` here over
   ``ServingReplicaSpawner`` replicas on the card (phase 10 (e)'s LM,
   ``--mb 2 --max-queue 4 --slo-p99-ms 50``), policy 1..2, hysteresis 2: its
   first tick, on a thread while (a) and (b) run, spawns the floor, and
   the second replica starts beside it on another thread; 8 clients make
   the scaler queue_bound until it takes that second replica, then idle
   ticks drain one, which exits 0. Gates:
   every request's tokens equal to ``sequential_reference`` of the seeded
   model on this card, 1 drain and no replica lost. Printed: each
   replica's ready time and the requests/s.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Without
a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import hashlib
import itertools
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity

CRITEO_ROWS_PER_SHARD = 16384
CRITEO_SHARDS = 2
BATCH = 16384
VOCAB = 1 << 20
EPOCHS = 8  # of the main path: 16 batches


def device_facts() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return smi


def graph_ms(fn, reps: int = 15, calls: int = 20) -> float:
    """Median over ``reps`` replays of the device time per call of a CUDA
    graph that holds ``calls`` calls of ``fn`` (captured after a warm-up on
    a side stream): no host launch time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def median_ms(fn, warmup: int = 10, reps: int = 15, calls: int = 20) -> float:
    """Median over ``reps`` windows of the device time per call, each window
    ``calls`` back-to-back calls between two CUDA events (so the queue stays
    full and host launch time is not counted)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


# the main path's shape, then the edges of the bf16 kernel's design
CHECK_SHAPES = [
    (16384, 27, 32),  # main path
    (1, 27, 32),      # one sample
    (13, 27, 32),     # ragged last tile
    (37, 17, 24),     # F and D not multiples of 16 (row and K padding)
    (40, 27, 8),      # D=8: K padding, one 16-byte chunk per row
    (21, 27, 12),     # rows not whole 16-byte chunks: scalar staging
    (64, 64, 16),     # large F
    (9, 128, 16),     # F=128
    (11, 127, 32),    # odd P and a tile below 8: spans start mid-chunk
    (8, 2, 8),        # F=2, P=1
    (21, 27, 7),      # D % 4 != 0: f32 rows not whole 16-byte chunks either
]
MAIN_SHAPE = (BATCH, 27, 32)
INSTANCE_DTYPE = {"bf16_mma": torch.bfloat16, "f32_tiled": torch.float32}
DTYPE_INSTANCE = {v: k for k, v in INSTANCE_DTYPE.items()}


def check_build_log(log: str) -> None:
    """Print registers and spills of each kernel instance in ptxas' report;
    fail on any spill."""
    names = re.findall(r"Compiling entry function '(\w+)'", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    regs = re.findall(r"Used (\d+) registers", log)
    if not names or not len(names) == len(spills) == len(regs):
        raise SystemExit("could not read ptxas' report of the kernel build")
    for mangled, (st, ld), r in zip(names, spills, regs):
        m = re.search(r"(dot_interaction_[a-z]+_kernel)(?:ILb([01])E(?:Li(\d+)E)?E)?", mangled)
        name = mangled if m is None else m[1] + (
            "" if not m[2] else f"<vec_loads={m[2] == '1'}, k_steps={m[3]}>" if m[3]
            else f"<vec_loads={m[2] == '1'}>")
        print(f"ptxas {name}: {r} registers, spill stores {st} B, spill loads {ld} B")
        if int(st) or int(ld):
            raise SystemExit(f"kernel {name} spills registers")


def check_interaction() -> dict:
    """Both kernel instances vs the plain version on the card at every
    listed shape, and on an E whose base is not 16-byte aligned; returns the max abs error of each instance at the main-path
    shape."""
    from tpu_tfrecord_torch.models.interaction import (
        dot_interaction_cuda,
        dot_interaction_reference,
    )

    tol = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = {}

    def check(emb, label):
        got = dot_interaction_cuda(emb)
        torch.cuda.synchronize()
        want = dot_interaction_reference(emb)
        err = (got.float() - want.float()).abs().max().item()
        ok = got.shape == want.shape and torch.allclose(got.float(), want.float(), **tol[emb.dtype])
        print(f"dot_interaction {label} {str(emb.dtype)[6:]}: max_abs_err={err} "
              f"{'ok' if ok else 'MISMATCH'} ({tol[emb.dtype]})")
        if not ok:
            raise SystemExit(f"dot_interaction kernel disagrees at {label} {emb.dtype}")
        return err

    for shape in CHECK_SHAPES:
        for instance, dtype in INSTANCE_DTYPE.items():
            err = check(torch.randn(shape, generator=gen, device="cuda").to(dtype), shape)
            if shape == MAIN_SHAPE:
                main_err[instance] = err
    for dtype in INSTANCE_DTYPE.values():
        flat = torch.randn(13 * 27 * 32 + 1, generator=gen, device="cuda").to(dtype)
        check(flat[1:].view(13, 27, 32),
              f"(13, 27, 32) at a base {flat.element_size()} bytes past 16-byte alignment")
    return main_err


def time_interaction(dtype, cold_inputs: int = 6) -> dict:
    """Warm and cold device times of the kernel instance for ``dtype`` at
    the main-path shape, beside the plain version, one library call and the
    bound."""
    from tpu_tfrecord_torch.models.interaction import (
        _interaction_plan,
        dot_interaction_cuda,
        dot_interaction_reference,
        tril_pairs,
    )

    b, f, d = MAIN_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"plan at {MAIN_SHAPE} {str(dtype)[6:]}: {_interaction_plan(b, f, d, dtype, sms)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embs = [torch.randn(MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
            for _ in range(cold_inputs)]
    emb = embs[0]
    rows, cols = (t.long() for t in tril_pairs(f, emb.device))
    p = f * (f - 1) // 2

    def library(e):  # one PyTorch call's worth of work; never used by the port
        return torch.einsum("bfd,bgd->bfg", e, e)[:, rows, cols]

    cycle = itertools.cycle(embs)
    elt = emb.element_size()
    nbytes = b * f * d * elt + b * p * elt
    nops = 2 * b * p * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S[dtype] * 1e3
    out = {
        "ms": graph_ms(lambda: dot_interaction_cuda(emb)),
        "cold_ms": graph_ms(lambda: dot_interaction_cuda(next(cycle)), calls=4 * cold_inputs),
        "eager_ms": median_ms(lambda: dot_interaction_cuda(emb)),
        "plain_ms": graph_ms(lambda: dot_interaction_reference(emb)),
        "library_ms": graph_ms(lambda: library(emb)),
        "library_cold_ms": graph_ms(lambda: library(next(cycle)), calls=4 * cold_inputs),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    out["cold_bytes_per_s"] = nbytes / (out["cold_ms"] / 1e3)
    out["cold_share_of_bound"] = out["bound_ms"] / out["cold_ms"]
    print(f"dot_interaction timing at {MAIN_SHAPE} {str(dtype)[6:]} (device time per call, "
          f"CUDA graph replay): kernel warm {out['ms']:.4f} ms, cold {out['cold_ms']:.4f} ms "
          f"({cold_inputs} inputs, {cold_inputs * b * f * d * elt / 1e6:.0f} MB, cycled); "
          f"plain {out['plain_ms']:.4f} ms; library einsum+index warm {out['library_ms']:.4f} ms, "
          f"cold {out['library_cold_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP); cold: "
          f"{out['cold_bytes_per_s'] / 1e12:.3f} TB/s, {out['cold_share_of_bound']:.3f} of the bound; "
          f"eager wrapper calls back to back (CUDA events, host launch included): "
          f"{out['eager_ms']:.4f} ms per call")
    return out


def check_small_forward() -> None:
    """A small f32 DLRM (dot + sequence tower) gives the same logits on the
    card as on the CPU."""
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import DLRMConfig, init_params, make_synthetic_batch

    cfg = DLRMConfig(num_dense=4, num_categorical=3, vocab_size=16, embed_dim=8,
                     bottom_mlp=(8, 8), top_mlp=(8, 1), seq_len=4, seq_dim=4,
                     dtype=torch.float32, interaction="dot")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    host = make_synthetic_batch(cfg, 13, seed=3)
    got = model(make_device_batch(host, "cuda")).cpu()
    want = model.to("cpu")(make_device_batch(host, "cpu"))
    err = (got - want).abs().max().item()
    print(f"small f32 DLRM forward, card vs CPU: max_abs_err={err}")
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise SystemExit("small DLRM forward on the card disagrees with the CPU")


def criteo_write_schema():
    """The write-side Criteo schema: int64 label and ints, 26 strings."""
    from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType

    return StructType(
        [StructField("label", LongType(), nullable=False)]
        + [StructField(f"I{i}", LongType()) for i in range(1, 14)]
        + [StructField(f"C{i}", StringType()) for i in range(1, 27)]
    )


def criteo_shard_rows():
    """The rows of each of phase 4's shards, as lazy generators: Criteo-shaped
    (label, 13 ints, 26 8-letter strings), as bench.py generates them."""
    rng = np.random.default_rng(0)
    shards = []
    for _ in range(CRITEO_SHARDS):
        n = CRITEO_ROWS_PER_SHARD
        ints = rng.integers(0, 1 << 31, size=(n, 13))
        labels = rng.integers(0, 2, size=n)
        cats = rng.integers(0, 16, size=(n, 26, 8), dtype=np.uint8) + 97
        shards.append((
            [int(labels[r])] + [int(v) for v in ints[r]]
            + [cats[r, c].tobytes().decode() for c in range(26)]
            for r in range(n)
        ))
    return shards


def write_criteo(data_dir: str) -> None:
    """Phase 4's shards through the port's writer, one dir per shard."""
    from tpu_tfrecord_torch import io as tfio

    schema = criteo_write_schema()
    for s, rows in enumerate(criteo_shard_rows()):
        tfio.write(rows, schema, os.path.join(data_dir, f"shard{s:02d}"), mode="overwrite")


@contextlib.contextmanager
def plain_interaction():
    """Run the DLRM with the plain interaction in place of the kernel."""
    from tpu_tfrecord_torch.models import dlrm, interaction

    dlrm.dot_interaction = interaction.dot_interaction_reference
    try:
        yield
    finally:
        dlrm.dot_interaction = interaction.dot_interaction


def with_dtype(model, dtype):
    """The same DLRM parameters (shared, not copied: the 3.49 GB table stays
    one) under a config whose activations are ``dtype``."""
    twin = copy.copy(model)
    twin.cfg = dataclasses.replace(model.cfg, dtype=dtype)
    return twin


def host_facts() -> None:
    """The host CPU's model and cores, and the C++ compiler that builds the
    native library: host rates depend on them."""
    with open("/proc/cpuinfo") as fh:
        cpuinfo = fh.read()
    logical = len(re.findall(r"^processor\s*:", cpuinfo, re.M))
    first = {}
    for line in cpuinfo.split("\n\n")[0].splitlines():
        key, sep, value = line.partition(":")
        if sep:
            first[key.strip()] = value.strip()
    model = first.get("model name", "unknown")
    if model == "unknown":  # some virtual machines do not report it there
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        found = re.search(r"^Model name:\s*(.+)$", lscpu, re.M)
        model = found[1].strip() if found else "not reported"
    ident = ", ".join(f"{k} {first[k]}" for k in ("vendor_id", "cpu family", "model",
                                                   "stepping", "cpu MHz", "cache size")
                      if k in first)
    flags = set(first.get("flags", "").split())
    usable = len(os.sched_getaffinity(0))
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    print(f"host CPU: {model} ({ident}; sse4_2={'sse4_2' in flags}, bmi2={'bmi2' in flags}); "
          f"{logical} logical CPUs, {usable} usable by this process")
    print(f"host C++ compiler: {gxx}")


def build_native() -> None:
    """Build (or find) and load the native host library, and say how long
    it took."""
    from tpu_tfrecord_torch import _native

    existed = _native.lib_path().exists()
    t0 = time.perf_counter()
    _native.load()
    secs = time.perf_counter() - t0
    how = "found already built" if existed else "built with " + " ".join(
        _native.compile_command(_native.lib_path()))
    print(f"native host library {_native.lib_path().name}: {how}, {secs:.1f} s")


def criteo_read_kw() -> dict:
    """The read side of the main path: the Criteo schema with int32 ints,
    categoricals hashed into VOCAB buckets, dense and cat packed."""
    from tpu_tfrecord_torch.schema import IntegerType, StringType, StructField, StructType

    schema = StructType(
        [StructField("label", IntegerType(), nullable=False)]
        + [StructField(f"I{i}", IntegerType()) for i in range(1, 14)]
        + [StructField(f"C{i}", StringType()) for i in range(1, 27)]
    )
    return dict(schema=schema, recordType="Example",
                hash_buckets={f"C{i}": VOCAB for i in range(1, 27)},
                pack={"dense": [f"I{i}" for i in range(1, 14)],
                      "cat": [f"C{i}" for i in range(1, 27)]})


def shard_dirs(data_dir: str) -> list:
    return sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir) if d.startswith("shard"))


def decode_only(data_dir: str) -> None:
    """Rows/s of the dataset alone (native decode, hash and pack on the
    producer thread) over the shards, EPOCHS times, with no scoring."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(shard_dirs(data_dir), BATCH, num_epochs=EPOCHS, **criteo_read_kw())
    rows = 0
    t0 = time.perf_counter()
    with ds.batches() as it:
        for cb in it:
            rows += cb.num_rows
    secs = time.perf_counter() - t0
    want = CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD * EPOCHS
    if ds.decoder != "native" or rows != want:
        raise SystemExit(f"decode-only: {rows} rows from the {ds.decoder} decoder, want {want}")
    print(f"decode only ({ds.decoder} decoder, producer thread, {EPOCHS} epochs of "
          f"{CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} rows): {rows} rows in {secs:.3f} s "
          f"= {rows / secs:.1f} rows/s (host)")


def check_native_vs_python(data_dir: str) -> None:
    """One full batch decoded by the native decoder and by the Python
    oracle on this host: the dense and cat matrices must be identical."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    got = {}
    for decoder in ("native", "python"):
        ds = TFRecordDataset(shard_dirs(data_dir)[0], BATCH, decoder=decoder, **criteo_read_kw())
        t0 = time.perf_counter()
        with ds.batches() as it:
            cb = next(it)
        got[decoder] = (cb, time.perf_counter() - t0)
    (nat, nat_s), (py, py_s) = got["native"], got["python"]
    for name in ("dense", "cat"):
        a, b = nat[name].values, py[name].values
        if a.dtype != b.dtype or a.shape != b.shape or not (a == b).all():
            raise SystemExit(f"native and Python decoders disagree on {name}: "
                             f"{a.dtype}{a.shape} vs {b.dtype}{b.shape}")
    print(f"native vs Python decoder, one {BATCH}-row batch: dense {nat['dense'].values.shape} "
          f"and cat {nat['cat'].values.shape} identical; native {nat_s * 1e3:.1f} ms, "
          f"Python {py_s:.2f} s (first batch of a fresh dataset, host)")


def score_path(label, paths, cfg, model, tol, **kw):
    """Score ``paths`` through ``score_files`` with the counts set to 0 just
    before and read just after; check the logits against a run with the
    plain interaction. Returns (ScoreResult, {instance: launches})."""
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    reset_launch_counts()
    res = score_files(paths, cfg, model, BATCH, "cuda", **kw)
    launches = dict(dot_interaction.instance_launches)
    with plain_interaction():
        ref = score_files(paths, cfg, model, BATCH, "cuda", **kw)
    for i in range(res.batches):
        print(f"{label} batch {i}: host (wait) {res.host_s[i] * 1e3:.2f} ms, "
              f"h2d {res.h2d_s[i] * 1e3:.3f} ms, forward {res.forward_s[i] * 1e3:.3f} ms, "
              f"done at {res.done_s[i]:.4f} s")
    logits = res.logits
    n_rows = res.batches * BATCH
    if res.batches == 0 or logits.shape != (n_rows,) or not torch.isfinite(logits).all():
        raise SystemExit(f"{label}: bad logits: shape {tuple(logits.shape)}, "
                         f"finite={bool(torch.isfinite(logits).all())}")
    want = {k: (res.batches if k == DTYPE_INSTANCE[cfg.dtype] else 0) for k in launches}
    if launches != want:
        raise SystemExit(f"{label}: kernel launches {launches} for {res.batches} batches")
    err = (logits - ref.logits).abs().max().item()
    print(f"{label}: {res.batches} batches, {n_rows} logits, kernel launches {launches}, "
          f"max |logit - plain-interaction logit| = {err}")
    if not torch.allclose(logits, ref.logits, rtol=tol, atol=tol):
        raise SystemExit(f"{label}: logits disagree with the plain-interaction forward")
    return res, launches


def criteo_cfg(dtype=torch.bfloat16):
    from tpu_tfrecord_torch.models.dlrm import DLRMConfig

    return DLRMConfig(num_dense=13, num_categorical=26, vocab_size=VOCAB, embed_dim=32,
                      bottom_mlp=(64, 32), top_mlp=(64, 1), interaction="dot", dtype=dtype)


def criteo_files_kw() -> dict:
    """The keywords of ``score_files`` / ``train_files`` for the Criteo shards."""
    read = criteo_read_kw()
    return dict(recordType="Example", schema=read["schema"],
                dense_cols=read["pack"]["dense"], cat_cols=read["pack"]["cat"])


def main_path(data_dir: str) -> dict:
    """Full-width Criteo DLRM scoring from TFRecord files written into
    ``data_dir``, in bf16 (the main path) and in f32 activations, each over
    the same 8 epochs; returns each kernel instance's launches on the path
    that runs it."""
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch

    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    model_f32 = with_dtype(model, torch.float32)
    table_gb = model.embeddings.numel() * model.embeddings.element_size() / 1e9
    print(f"DLRM at Criteo width: table {tuple(model.embeddings.shape)} f32 = {table_gb:.2f} GB on the card")
    kw = dict(criteo_files_kw(), log1p_dense=True)
    # warm-up forwards (cuBLAS handles, allocator) outside the counted runs
    warm = make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), "cuda")
    model(warm)
    model_f32(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_criteo(data_dir)
    print(f"wrote {CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} Example rows in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    decode_only(data_dir)
    runs = {}
    for label, m, tol in (("main path (bf16)", model, 2e-2), ("f32 path", model_f32, 1e-3)):
        res, launches = score_path(label, data_dir, m.cfg, m, tol, num_epochs=EPOCHS, **kw)
        if res.batches != EPOCHS * CRITEO_SHARDS:
            raise SystemExit(f"{label} scored {res.batches} batches, want {EPOCHS * CRITEO_SHARDS}")
        runs[DTYPE_INSTANCE[m.cfg.dtype]] = (label, m, res, launches)
    check_native_vs_python(data_dir)
    for label, m, res, _ in runs.values():
        profile_forward(label, m, warm, res)
    bf16 = runs["bf16_mma"][2]
    MAIN_BF16.update(logits=bf16.logits.cpu(), whole=bf16.batches * BATCH / bf16.wall_s,
                     steady=steady_rate(bf16))
    return {k: launches[k] for k, (_, _, _, launches) in runs.items()}


# phase 4's bf16 logits and rates, which phase 7 holds its serving run against
MAIN_BF16: dict = {}


def steady_rate(res) -> float:
    """Rows/s over batches 2 to the last of a scoring run."""
    return (res.batches - 1) * BATCH / (res.done_s[-1] - res.done_s[0])


def profile_forward(label, model, batch, res) -> None:
    """Where a full-width batch's time goes on the card: the forward's device
    time (CUDA events), its kernels by device time (torch.profiler), and
    the scoring run's rows/s and the card's idle share, over the whole run
    and over its steady state (batches 2 to the last)."""
    from torch.profiler import ProfilerActivity, profile

    eager_ms = median_ms(lambda: model(batch), warmup=3, reps=7, calls=5)
    fwd_ms = graph_ms(lambda: model(batch), reps=7, calls=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    print(f"{label}: forward at batch {BATCH}: {fwd_ms:.4f} ms device time per call (CUDA graph "
          f"replay); {eager_ms:.4f} ms per call eager, back to back (CUDA events, host launch "
          "included); one forward by torch.profiler:")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    busy = sum(res.h2d_s) + res.batches * fwd_ms / 1e3
    print(f"{label}: scoring run, {res.batches} batches: {res.batches * BATCH / res.wall_s:.1f} rows/s end "
          f"to end over {res.wall_s:.4f} s of wall time (first batch's decode included); device "
          f"idle share ~{1 - busy / res.wall_s:.4f} (1 - (h2d + forward device time) / wall time)")
    steady = res.batches - 1
    window = res.done_s[-1] - res.done_s[0]
    busy = sum(res.h2d_s[1:]) + steady * fwd_ms / 1e3
    host_ms = np.array(res.host_s[1:]) * 1e3
    h2d_ms = np.array(res.h2d_s[1:]) * 1e3
    print(f"{label}: steady state, batches 2-{res.batches}: {steady * BATCH / window:.1f} rows/s; per batch "
          f"host (wait) {host_ms.mean():.3f} ms mean, {np.median(host_ms):.3f} median; "
          f"h2d {h2d_ms.mean():.3f} ms mean, {np.median(h2d_ms):.3f} median; device idle share "
          f"~{1 - busy / window:.4f}")


# tolerances of phase 5 against the plain-interaction runs: the losses at
# the bf16 tolerance of the scoring path; the table after the steps
# absolutely (a row moves by about embed_lr = 0.01 a step)
TRAIN_LOSS_TOL = 2e-2
TRAIN_TABLE_ATOL = 5e-3
MESH_ACCUM_RTOL = 1e-2   # phase 14 (c): |accumulator - one process| over its largest
TRAIN_SPARSE_EPOCHS = 8  # both shards: 16 steps
TRAIN_DENSE_EPOCHS = 2   # one shard: 2 steps
TRAIN_SEED = 0


def new_criteo_model(dtype=torch.bfloat16):
    from tpu_tfrecord_torch.models.dlrm import init_params

    return init_params(criteo_cfg(dtype), torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                       "cuda")


def free_cuda() -> None:
    """Collect what the caller dropped and hand the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def train_run(label, paths, steps, sparse, epochs, dtype=torch.bfloat16, **kw):
    """``train_files`` on a fresh full-width model in ``dtype`` activations,
    with the counts set to 0
    just before and read just after; then the same run from the same seed
    under the plain interaction. Checks the launches, finite losses, the
    losses and the table against the plain run (rows neither run moved must
    be bit-equal). Returns (TrainResult, launches, model)."""
    from tpu_tfrecord_torch.entry import train_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    cfg = criteo_cfg(dtype)
    model = new_criteo_model(dtype)
    reset_launch_counts()
    res = train_files(paths, cfg, model, BATCH, "cuda", sparse=sparse, num_epochs=epochs, **kw)
    launches = dict(dot_interaction.instance_launches)
    want = {k: (steps if k == DTYPE_INSTANCE[dtype] else 0) for k in INSTANCE_DTYPE}
    if res.steps != steps or not torch.isfinite(res.losses).all() or launches != want:
        raise SystemExit(f"{label}: {res.steps} steps (want {steps}), launches {launches} "
                         f"(want {want}), losses {res.losses}")
    # the plain twin: the table is compared row by row, then the twin is freed
    twin = new_criteo_model(dtype)
    with plain_interaction():
        ref = train_files(paths, cfg, twin, BATCH, "cuda", sparse=sparse, num_epochs=epochs, **kw)
    ref.opt = None  # the twin's optimizer state goes with the twin
    for i in range(res.steps):
        print(f"{label} step {i}: loss {res.losses[i].item():.6f} (plain "
              f"{ref.losses[i].item():.6f}); host (wait) {res.host_s[i] * 1e3:.2f} ms, "
              f"h2d {res.h2d_s[i] * 1e3:.3f} ms, step {res.step_s[i] * 1e3:.3f} ms, "
              f"done at {res.done_s[i]:.4f} s")
    check_training(label, res.losses, model, ref.losses, twin, dtype, "plain", launches)
    del twin
    free_cuda()
    return res, launches, model


def check_training(label, losses, model, ref_losses, ref_model, dtype, ref_name, launches) -> None:
    """Phase 5's check of a training run against a reference run from the
    same weights: the losses within TRAIN_LOSS_TOL, every table row within
    TRAIN_TABLE_ATOL, and the rows neither run moved bit-equal."""
    loss_err = (losses - ref_losses).abs().max().item()
    with torch.no_grad():
        init = new_criteo_model(dtype).embeddings
        moved = torch.maximum((model.embeddings - init).abs().amax(-1),
                              (ref_model.embeddings - init).abs().amax(-1)) > 0     # [F, V]
        del init
        row_err = (model.embeddings - ref_model.embeddings).abs().amax(-1)          # [F, V]
        table_err = row_err.max().item()
        still_equal = bool((row_err[~moved] == 0).all())
        n_moved = int(moved.sum())
        del row_err, moved
    free_cuda()
    print(f"{label}: {len(losses)} steps, kernel launches {launches}; max |loss - {ref_name} loss| = "
          f"{loss_err} (tol {TRAIN_LOSS_TOL}); {n_moved} table rows moved, max |row - {ref_name} "
          f"row| = {table_err} (atol {TRAIN_TABLE_ATOL}); rows neither run moved bit-equal: "
          f"{still_equal}")
    if len(losses) != len(ref_losses):
        raise SystemExit(f"{label}: {len(losses)} steps against the {ref_name} run's {len(ref_losses)}")
    if not torch.allclose(losses, ref_losses, rtol=TRAIN_LOSS_TOL, atol=TRAIN_LOSS_TOL):
        raise SystemExit(f"{label}: losses {losses} disagree with the {ref_name} run's {ref_losses}")
    if table_err > TRAIN_TABLE_ATOL or not still_equal:
        raise SystemExit(f"{label}: the table disagrees with the {ref_name} run")


def check_backward() -> dict:
    """``DotInteraction``'s gradient against autograd through the plain
    version at the main-path shape, both dtypes, and the backward's device
    time (graph replay) and bound. Returns per instance
    {backward_max_abs_err, backward_ms, backward_bound_ms}."""
    from tpu_tfrecord_torch.models.interaction import (
        dot_interaction,
        dot_interaction_backward_reference,
        dot_interaction_reference,
    )

    tol = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}
    b, f, d = MAIN_SHAPE
    p = f * (f - 1) // 2
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for instance, dtype in INSTANCE_DTYPE.items():
        base = torch.randn(MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
        g = torch.randn((b, p), generator=gen, device="cuda").to(dtype)
        emb = base.clone().requires_grad_()
        dot_interaction(emb).backward(g)
        ref = base.clone().requires_grad_()
        dot_interaction_reference(ref).backward(g)
        torch.cuda.synchronize()
        err = (emb.grad.float() - ref.grad.float()).abs().max().item()
        ok = torch.allclose(emb.grad.float(), ref.grad.float(), **tol[dtype])
        elt = base.element_size()
        nbytes = 2 * b * f * d * elt + b * p * elt        # E and g in, dE out
        nops = 4 * b * p * d                               # each pair feeds two rows
        bound = max(nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[torch.float32]) * 1e3
        out[instance] = dict(
            backward_max_abs_err=err,
            backward_ms=graph_ms(lambda: dot_interaction_backward_reference(base, g)),
            backward_bound_ms=bound,
        )
        print(f"interaction backward at {MAIN_SHAPE} {str(dtype)[6:]}: DotInteraction vs autograd "
              f"through the plain version max_abs_err={err} {'ok' if ok else 'MISMATCH'} "
              f"({tol[dtype]}); device time per call (CUDA graph replay): backward "
              f"{out[instance]['backward_ms']:.4f} ms (torch ops: scatter, transpose add, f32 bmm); "
              f"bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP at the f32 rate)")
        if not ok:
            raise SystemExit(f"interaction backward disagrees with autograd at {dtype}")
    return out


def step_split(events):
    """(device ms of all kernels, {part: device ms}) of one profiled sparse
    step. The step's named ranges ("sparse_step.<part>") hold the kernels
    their ops launched; the backward runs on autograd's device thread, so
    it is read from the engine's per-node events instead: the interaction's
    node (DotInteractionBackward) and all the others (the MLPs, the casts,
    the concat and the gather's row gradient)."""
    from torch.autograd import DeviceType

    kernels = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    parts = {name: sum(e.device_time_total for e in cpu if e.name == f"sparse_step.{name}") / 1e3
             for name in ("gather", "forward", "dense_opt", "dedup_sort", "segment_sums",
                          "scatters")}
    nodes = [e for e in cpu if e.name.startswith("autograd::engine::evaluate_function:")]
    inter = sum(e.device_time_total for e in nodes if "DotInteractionBackward" in e.name) / 1e3
    parts["interaction_backward"] = inter
    parts["rest_of_backward"] = sum(e.device_time_total for e in nodes) / 1e3 - inter
    return kernels / 1e3, parts


def profile_sparse_step(label, model, opt, res) -> None:
    """Where a sparse step's time goes: its time on a resident full-width
    batch (CUDA events over steps back to back), one step by
    torch.profiler split by part, and the training loop's rows/s, host /
    H2D / step ms and the card's idle share, whole and over steps 2-16."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import make_synthetic_batch, sparse_train_step

    cfg = model.cfg
    batch = make_device_batch(make_synthetic_batch(cfg, BATCH, seed=2), "cuda")
    batch["cat"] = batch["cat"].int()
    step = lambda: sparse_train_step(model, opt, batch, cfg)  # noqa: E731
    step_ms = median_ms(step, warmup=3, reps=7, calls=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    print(f"{label}: sparse step at batch {BATCH}: {step_ms:.4f} ms per step, back to back (CUDA events; "
          "host launch included where it is slower than the card); one step by torch.profiler:")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    kernels_ms, parts = step_split(prof.events())
    print(f"{label}: sparse step split (device ms of the kernels each part launched, torch.profiler): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"; all kernels {kernels_ms:.4f}")
    if kernels_ms <= 0:
        print("torch.profiler recorded no device time: the split is not measured")
    dev_step_ms = kernels_ms if kernels_ms > 0 else step_ms
    busy = sum(res.h2d_s) + res.steps * dev_step_ms / 1e3
    print(f"{label}: sparse training run, {res.steps} steps: {res.steps * BATCH / res.wall_s:.1f} rows/s end to "
          f"end over {res.wall_s:.4f} s of wall time (first batch's decode included); device idle "
          f"share ~{1 - busy / res.wall_s:.4f} (1 - (h2d + steps x {dev_step_ms:.4f} ms device "
          "time) / wall time)")
    steady = res.steps - 1
    window = res.done_s[-1] - res.done_s[0]
    busy = sum(res.h2d_s[1:]) + steady * dev_step_ms / 1e3
    host_ms, h2d_ms, st_ms = (np.array(x[1:]) * 1e3 for x in (res.host_s, res.h2d_s, res.step_s))
    print(f"{label}: steady state, steps 2-{res.steps}: {steady * BATCH / window:.1f} rows/s; per step host "
          f"(wait) {host_ms.mean():.3f} ms mean, {np.median(host_ms):.3f} median; h2d "
          f"{h2d_ms.mean():.3f} ms mean, {np.median(h2d_ms):.3f} median; step (host clock, "
          f"synchronized) {st_ms.mean():.3f} ms mean, {np.median(st_ms):.3f} median; device idle "
          f"share ~{1 - busy / window:.4f}")


# phase 5's bf16 sparse rows/s (train_files, one decode worker), beside which
# phase 8 prints the harness loop's
TRAIN_BF16: dict = {}


def train_path(data_dir: str) -> dict:
    """Phase 5: the sparse training path at full width over phase 4's
    shards in bf16 and in f32, the dense one in bf16, the backward check and
    each sparse step's profile. Returns each kernel instance's launches over
    the training paths and the backward's numbers."""
    kw = criteo_files_kw()
    launches = dict.fromkeys(INSTANCE_DTYPE, 0)
    for dtype in (torch.bfloat16, torch.float32):
        label = f"sparse training (shuffled, {str(dtype)[6:]})"
        res, sparse, model = train_run(
            label, data_dir, TRAIN_SPARSE_EPOCHS * CRITEO_SHARDS, True, TRAIN_SPARSE_EPOCHS,
            dtype, shuffle=True, shuffle_window=2, seed=0, **kw)
        profile_sparse_step(label, model, res.opt, res)
        if dtype == torch.bfloat16:
            TRAIN_BF16.update(whole=res.steps * BATCH / res.wall_s,
                              steady=(res.steps - 1) * BATCH / (res.done_s[-1] - res.done_s[0]))
        launches = {k: launches[k] + sparse[k] for k in launches}
        del model, res
        free_cuda()
    torch.cuda.reset_peak_memory_stats()
    _, dense, model = train_run(
        "dense training (shard00)", os.path.join(data_dir, "shard00"), TRAIN_DENSE_EPOCHS, False,
        TRAIN_DENSE_EPOCHS, **kw)
    print(f"dense path: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          "(the model, its dense gradient and Adam state, and the plain twin's)")
    del model
    free_cuda()
    backward = check_backward()
    return {k: dict(train_launches=launches[k] + dense[k], **backward[k]) for k in INSTANCE_DTYPE}


# -- phase 6: the feed -------------------------------------------------------------

FEED_DECODE_WORKERS = (1, 2, 4, 6)
FEED_WORKERS = 4
WIRE_BITS = 20
TRAIN_FEEDS = {
    "dispatch-ahead": {},
    "transfer thread": dict(transfer_thread=True),
    "20-bit wire": dict(wire_bits=WIRE_BITS),
}
RACE_BATCHES = 64
RACE_SLEEP_CYCLES = 4_000_000  # about 2 ms of one SM's clock on an H100


def batch_digest(cb) -> str:
    """A digest of a decoded batch's columns, names and bytes."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(cb.columns):
        h.update(name.encode())
        h.update(np.ascontiguousarray(cb[name].values).tobytes())
    return h.hexdigest()


def decode_workers(data_dir: str) -> dict:
    """Decode-only rows/s at each worker count over the same EPOCHS epochs;
    every batch's digest must be the same at every count. The batches are
    kept during the timed read and digested after it."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    want = CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD * EPOCHS
    rates, digests = {}, {}
    for n in FEED_DECODE_WORKERS:
        ds = TFRecordDataset(shard_dirs(data_dir), BATCH, num_epochs=EPOCHS, num_workers=n,
                             **criteo_read_kw())
        t0 = time.perf_counter()
        with ds.batches() as it:
            kept = list(it)
        secs = time.perf_counter() - t0
        rows = sum(cb.num_rows for cb in kept)
        if rows != want:
            raise SystemExit(f"decode at {n} workers: {rows} rows, want {want}")
        digests[n] = [batch_digest(cb) for cb in kept]
        rates[n] = rows / secs
        print(f"feed: decode only at {n} workers ({EPOCHS} epochs of {CRITEO_SHARDS} x "
              f"{CRITEO_ROWS_PER_SHARD} rows): {rows} rows in {secs:.4f} s = {rates[n]:.1f} rows/s "
              f"(host)")
        del kept
    same = all(digests[n] == digests[1] for n in FEED_DECODE_WORKERS)
    print(f"feed: batch digests at {FEED_DECODE_WORKERS} workers identical: {same} "
          f"({len(digests[1])} batches)")
    if not same:
        raise SystemExit("feed: the batches differ between worker counts")
    return rates


def direct_loop(data_dir, step, *, train: bool, **read):
    """The loop without the feed, kept as the reference of phase 6: the
    dataset at one decode worker, densify (``log1p``, and the label cast
    when training) on the consumer thread, ``make_device_batch`` (fresh
    pinned buffers) synchronized, then ``step`` synchronized. Returns
    (outputs, wall_s, host_s, h2d_s, step_s, done_s)."""
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(shard_dirs(data_dir), BATCH, **criteo_read_kw(), **read)
    outs, host_s, h2d_s, step_s, done_s = [], [], [], [], []
    start = time.perf_counter()
    with ds.batches() as it:
        while True:
            t0 = time.perf_counter()
            cb = next(it, None)
            if cb is None:
                break
            hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
            hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
            if train:
                hb["label"] = hb["label"].astype(np.float32)
            t1 = time.perf_counter()
            batch = make_device_batch(hb, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            outs.append(step(batch))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host_s.append(t1 - t0)
            h2d_s.append(t2 - t1)
            step_s.append(t3 - t2)
            done_s.append(t3 - start)
    return outs, time.perf_counter() - start, host_s, h2d_s, step_s, done_s


def loop_stats(label, wall_s, host_s, h2d_s, step_s, done_s, duty=None, launches=None) -> dict:
    """Print and return a loop's rows/s, whole and steady (batches 2 to the
    last), and its per-batch medians over the steady batches."""
    n = len(step_s)
    out = dict(whole=n * BATCH / wall_s, steady=(n - 1) * BATCH / (done_s[-1] - done_s[0]),
               host_ms=float(np.median(host_s[1:])) * 1e3, h2d_ms=float(np.median(h2d_s[1:])) * 1e3,
               step_ms=float(np.median(step_s[1:])) * 1e3, duty_cycle=duty)
    print(f"{label}: {n} batches, {out['whole']:.1f} rows/s whole, {out['steady']:.1f} steady "
          f"(batches 2-{n}); medians over batches 2-{n}: host wait {out['host_ms']:.3f} ms, "
          f"h2d {out['h2d_ms']:.3f} ms, step {out['step_ms']:.3f} ms; duty cycle {duty}"
          + ("" if launches is None else f"; kernel launches {launches}"))
    return out


def feed_serving(data_dir: str) -> tuple:
    """bf16 scoring through ``score_files(num_workers=n)`` for each decode
    worker count, against the direct loop over the same 8 epochs: logits
    bit-equal, 16 launches each. Returns ({n: stats}, the launches of the
    FEED_WORKERS run)."""
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    model = new_criteo_model(torch.bfloat16)
    with torch.no_grad():
        outs, *times = direct_loop(data_dir, model, train=False, num_epochs=EPOCHS)
    want = torch.cat(outs)
    loop_stats("feed: serving bf16, the direct loop", *times)
    stats, named = {}, None
    for n in FEED_DECODE_WORKERS:
        reset_launch_counts()
        res = score_files(data_dir, model.cfg, model, BATCH, "cuda", num_epochs=EPOCHS,
                          num_workers=n, log1p_dense=True, **criteo_files_kw())
        launches = dict(dot_interaction.instance_launches)
        stats[n] = loop_stats(f"feed: serving bf16, score_files(num_workers={n})", res.wall_s,
                              res.host_s, res.h2d_s, res.forward_s, res.done_s, res.duty_cycle,
                              launches)
        err = (res.logits.float() - want.float()).abs().max().item()
        equal = res.logits.shape == want.shape and torch.equal(res.logits, want)
        print(f"feed: serving at {n} workers, logits against the direct loop: bit-equal {equal}, "
              f"max |diff| {err}")
        expect = {"bf16_mma": EPOCHS * CRITEO_SHARDS, "f32_tiled": 0}
        if not equal or launches != expect or not torch.isfinite(res.logits).all():
            raise SystemExit(f"feed: serving disagrees with the direct loop (launches {launches})")
        if n == FEED_WORKERS:
            named = launches
        del res
    del model
    free_cuda()
    return stats, named


def host_feed_rate(data_dir: str, workers: int) -> float:
    """Rows/s of the feed's host side alone: the dataset at ``workers``
    decode workers and the prefetch thread's densify and ``log1p``, over
    the same EPOCHS epochs, with nothing sent to the card."""
    from tpu_tfrecord_torch.device.ingest import HostPrefetcher, host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(shard_dirs(data_dir), BATCH, num_epochs=EPOCHS, num_workers=workers,
                         **criteo_read_kw())

    def densify(cb):
        hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
        return hb

    t0 = time.perf_counter()
    with ds.batches() as it, HostPrefetcher(map(densify, it)) as pf:
        rows = sum(len(hb["label"]) for hb in pf)
    rate = rows / (time.perf_counter() - t0)
    print(f"feed: host side alone at {workers} workers (decode, densify and log1p on the "
          f"prefetch thread, no device): {rows} rows, {rate:.1f} rows/s (host)")
    return rate


def binding_stage(label, rates: dict) -> str:
    """Print the stages' rates (rows/s) and name the slowest."""
    slowest = min(rates, key=rates.get)
    print(f"{label}: binds at {slowest} ("
          + ", ".join(f"{k} {v:.1f} rows/s" for k, v in rates.items()) + ")")
    return slowest


def consumer_rate(stats: dict) -> float:
    """Rows/s the consumer thread alone could take: a batch per median step
    plus median inline transfer."""
    return BATCH / ((stats["step_ms"] + stats["h2d_ms"]) / 1e3)


def wire_first_call() -> dict:
    """Host-clock ms of the wire's unpack and dense transform on a
    full-width batch, first call in the process and second, each
    synchronized; then their device time per batch (graph replay) and
    their eager time back to back (CUDA events)."""
    from tpu_tfrecord_torch.device.bitpack import pack_mixed, unpack_bits

    rng = np.random.default_rng(7)
    host = np.concatenate([rng.integers(0, 2, size=(BATCH, 1)),
                           rng.integers(0, 1 << 31, size=(BATCH, 13)),
                           rng.integers(0, VOCAB, size=(BATCH, 26))], axis=1).astype(np.int32)
    m = torch.from_numpy(pack_mixed(host, 14, WIRE_BITS)).cuda()
    torch.cuda.synchronize()
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return got

    for call in ("first", "second"):
        cat = timed(f"unpack_bits {call}", lambda: unpack_bits(m[:, 14:], 26, WIRE_BITS))
        timed(f"log1p f64 {call}", lambda: torch.log1p(m[:, 1:14].clamp(min=0).double()).float())
        timed(f"label cast {call}", lambda: m[:, 0].float())
    if not torch.equal(cat.cpu(), torch.from_numpy(host[:, 14:])):
        raise SystemExit("feed: unpack_bits on the card disagrees with the host matrix")

    def split():
        return (m[:, 0].float(), torch.log1p(m[:, 1:14].clamp(min=0).double()).float(),
                unpack_bits(m[:, 14:], 26, WIRE_BITS))

    out["unpack_bits device"] = graph_ms(lambda: unpack_bits(m[:, 14:], 26, WIRE_BITS))
    out["split device"] = graph_ms(split)
    out["split eager"] = median_ms(split)
    print("feed: wire split on a full-width batch, host-clock ms, synchronized: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items() if "device" not in k
                      and "eager" not in k)
          + f"; device time per batch (CUDA graph replay): unpack_bits "
          f"{out['unpack_bits device']:.4f} ms, the whole split (label cast, log1p in f64, "
          f"unpack) {out['split device']:.4f} ms; eager back to back {out['split eager']:.4f} ms")
    return out


def feed_train_reference(data_dir: str, dtype):
    """The direct training loop: sparse, shuffled, 16 steps, on a fresh model."""
    from tpu_tfrecord_torch.entry import TRAIN_LR
    from tpu_tfrecord_torch.models.dlrm import sparse_opt_init, sparse_train_step

    cfg = criteo_cfg(dtype)
    model = new_criteo_model(dtype)
    opt = sparse_opt_init(model, cfg, lambda ps: torch.optim.Adam(ps, lr=TRAIN_LR))
    losses, *times = direct_loop(
        data_dir, lambda b: sparse_train_step(model, opt, b, cfg), train=True,
        num_epochs=TRAIN_SPARSE_EPOCHS, shuffle=True, shuffle_window=2, seed=TRAIN_SEED)
    loop_stats(f"feed: sparse training {str(dtype)[6:]}, the direct loop", *times)
    return torch.stack(losses).cpu(), model


def feed_train(data_dir: str, dtype, name: str, feed_kw: dict, ref) -> tuple:
    """Sparse shuffled training through one feed at FEED_WORKERS decode
    workers, on a fresh model, against the direct loop ``ref``. Returns (stats,
    launches)."""
    from tpu_tfrecord_torch.entry import train_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    label = f"feed: sparse training {str(dtype)[6:]}, {name}"
    model = new_criteo_model(dtype)
    reset_launch_counts()
    res = train_files(data_dir, criteo_cfg(dtype), model, BATCH, "cuda", sparse=True,
                      num_epochs=TRAIN_SPARSE_EPOCHS, shuffle=True, shuffle_window=2,
                      seed=TRAIN_SEED, num_workers=FEED_WORKERS, **criteo_files_kw(), **feed_kw)
    launches = dict(dot_interaction.instance_launches)
    steps = TRAIN_SPARSE_EPOCHS * CRITEO_SHARDS
    want = {k: (steps if k == DTYPE_INSTANCE[dtype] else 0) for k in INSTANCE_DTYPE}
    stats = loop_stats(label, res.wall_s, res.host_s, res.h2d_s, res.step_s, res.done_s,
                       res.duty_cycle, launches)
    print(f"{label}: step 1 {res.step_s[0] * 1e3:.1f} ms (host clock, synchronized)")
    if res.steps != steps or launches != want or not torch.isfinite(res.losses).all():
        raise SystemExit(f"{label}: {res.steps} steps, launches {launches} (want {want})")
    res.opt = None
    check_training(label, res.losses, model, ref[0], ref[1], dtype, "direct loop", launches)
    del model, res
    free_cuda()
    return stats, launches


def staging_race_check(transfer_thread: bool) -> None:
    """RACE_BATCHES batches of distinct contents through
    ``DeviceIterator(depth=2)``: the consumer spins the card for a while on
    each batch and then digests it, and drops the batch before the digest
    has run. A ring slot rewritten before its copy finished, a copy the
    consumer did not wait for, or a block the allocator handed out again
    too early would change a digest."""
    from tpu_tfrecord_torch.device.ingest import DeviceIterator

    rng = np.random.default_rng(6)
    base = rng.integers(0, 1 << 31, size=(1024, 1024), dtype=np.int64).astype(np.int32)
    weights_np = (np.arange(base.size, dtype=np.int64) % 251 + 1).reshape(base.shape)
    weights = torch.from_numpy(weights_np).cuda()

    def host_batches():
        for i in range(RACE_BATCHES):
            a = (base ^ np.int32((i * 0x9E3779B) & 0x7FFFFFFF)) & np.int32(0x7FFFFFFF)
            yield {"a": a, "b": np.full(4096, i, np.int64)}

    want = [int((hb["a"].astype(np.int64) * weights_np).sum()) + int(hb["b"].sum())
            for hb in host_batches()]
    got = []
    with DeviceIterator(host_batches(), "cuda", transfer_thread=transfer_thread, depth=2) as it:
        for batch in it:
            torch.cuda._sleep(RACE_SLEEP_CYCLES)
            got.append((batch["a"].long() * weights).sum() + batch["b"].sum())
            del batch
    got = [int(x) for x in torch.stack(got).cpu()]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    mode = "transfer thread" if transfer_thread else "dispatch-ahead"
    print(f"feed: staging race check ({mode}, {RACE_BATCHES} batches of 4.2 MB, "
          f"{RACE_SLEEP_CYCLES} spin cycles each): {len(got)} digests, {len(bad)} wrong")
    if len(got) != RACE_BATCHES or bad:
        raise SystemExit(f"feed: staging race check ({mode}) failed at batches {bad[:8]}")


def feed_path(data_dir: str) -> dict:
    """Phase 6: decode at 1-6 workers, serving at 1-6 workers and sparse
    training through the feeds against the direct loop, the f32 run through the
    fastest feed, which stage binds each path, and the staging race check.
    Returns each instance's launches by path."""
    decode = decode_workers(data_dir)
    serve, serve_launches = feed_serving(data_dir)
    host_rate = host_feed_rate(data_dir, FEED_WORKERS)
    binds = {"serving": binding_stage(
        f"feed: serving at {FEED_WORKERS} workers (whole {serve[FEED_WORKERS]['whole']:.1f} rows/s)",
        {"decode pool": decode[FEED_WORKERS], "host side (decode + densify)": host_rate,
         "consumer (forward + inline transfer)": consumer_rate(serve[FEED_WORKERS])})}
    paths = {"feed serving bf16": serve_launches}
    ref = feed_train_reference(data_dir, torch.bfloat16)
    train, wire = {}, None
    for name, kw in TRAIN_FEEDS.items():
        if "wire_bits" in kw:
            wire = wire_first_call()
        train[name], paths[f"feed training bf16, {name}"] = feed_train(
            data_dir, torch.bfloat16, name, kw, ref)
    del ref
    free_cuda()
    best = max(train, key=lambda k: train[k]["steady"])
    print(f"feed: the fastest training feed, by steady rows/s: {best}")
    binds["training"] = binding_stage(
        f"feed: sparse training bf16, {best} (steady {train[best]['steady']:.1f} rows/s)",
        {"decode pool": decode[FEED_WORKERS], "host side (decode + densify)": host_rate,
         "consumer (step + inline transfer)": consumer_rate(train[best])})
    ref = feed_train_reference(data_dir, torch.float32)
    _, paths[f"feed training f32, {best}"] = feed_train(
        data_dir, torch.float32, best, TRAIN_FEEDS[best], ref)
    del ref
    free_cuda()
    for transfer_thread in (False, True):
        staging_race_check(transfer_thread)
    print("feed: " + json.dumps({
        "decode_rows_per_s": decode, "host_side_rows_per_s": host_rate, "serving": serve,
        "training": train, "best": best, "binds": binds, "wire_first_call_ms": wire}))
    return {k: {p: launches[k] for p, launches in paths.items()} for k in INSTANCE_DTYPE}

# -- phase 7: the data-source API ----------------------------------------------------

WRITE_BATCHES = 6      # bench_write.py's shape: 6 batches of BATCH Criteo rows
WRITE_REPS = 1         # interleaved sequential/pipelined pairs, best of each
WRITE_WORKERS = 4
WRITE_SHARDS = 4
CAT_LEN = 8
OTHER_CODECS = ("snappy", "lz4", "bzip2")


def bench_write_batches():
    """Criteo-shaped ColumnarBatches built from numpy buffers, as
    bench_write.py builds them: int64 label, 13 int64 ints, 26 8-byte
    categoricals, WRITE_BATCHES x BATCH rows."""
    from tpu_tfrecord_torch.columnar import Column, ColumnarBatch

    schema = criteo_write_schema()
    rng = np.random.default_rng(0)
    offsets = np.arange(BATCH + 1, dtype=np.int64) * CAT_LEN
    batches = []
    for _ in range(WRITE_BATCHES):
        cols = {"label": Column("label", schema["label"].data_type,
                                values=rng.integers(0, 2, size=BATCH, dtype=np.int64))}
        for i in range(1, 14):
            cols[f"I{i}"] = Column(f"I{i}", schema[f"I{i}"].data_type,
                                   values=rng.integers(0, 1 << 31, size=BATCH, dtype=np.int64))
        for i in range(1, 27):
            blob = (rng.integers(0, 16, size=BATCH * CAT_LEN, dtype=np.uint8) + 97).tobytes()
            cols[f"C{i}"] = Column(f"C{i}", schema[f"C{i}"].data_type, blob=blob,
                                   blob_offsets=offsets)
        batches.append(ColumnarBatch(cols, BATCH))
    return schema, batches


def zlib_scaling_probe() -> float:
    """bench_write.py's probe: wall(1 thread, 2N zlib.compress of 4 MiB) /
    wall(2 threads, N each); 2.0 = two unshared cores for GIL-free work."""
    import threading
    import zlib

    data = os.urandom(4 << 20)

    def spin(count):
        for _ in range(count):
            zlib.compress(data)

    spin(1)
    t0 = time.perf_counter()
    spin(6)
    serial = time.perf_counter() - t0
    threads = [threading.Thread(target=spin, args=(3,)) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return serial / (time.perf_counter() - t0)


def file_digests(root: str) -> list:
    """(relative dir, file name without the job id, sha256) of every data
    file under ``root``."""
    out = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.startswith("part-"):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()
                # part-<task>-<12-hex job id>.c<n>.tfrecord[.ext]
                out.append((os.path.relpath(dirpath, root), name[:10] + name[23:], digest))
    return sorted(out)


def write_once(schema, batches, out, codec, workers, shards) -> float:
    """One DatasetWriter.write_batches job; its rows/s."""
    from tpu_tfrecord_torch.io.writer import DatasetWriter
    from tpu_tfrecord_torch.options import TFRecordOptions

    opts = TFRecordOptions.from_map(codec=codec, write_workers=workers, num_shards=shards)
    t0 = time.perf_counter()
    DatasetWriter(out, schema, opts, mode="overwrite").write_batches(batches)
    return sum(b.num_rows for b in batches) / (time.perf_counter() - t0)


def write_rates(work: str) -> dict:
    """Phase 7 (a): DatasetWriter.write_batches at bench_write.py's shape,
    sequential (1 worker) and pipelined (WRITE_WORKERS, WRITE_SHARDS shards),
    uncompressed and deflate, repeats interleaved, best of each; the
    pipelined files at 2 and 4 workers must be byte-identical."""
    from tpu_tfrecord_torch.metrics import METRICS

    host_facts()
    probe = zlib_scaling_probe()
    print(f"datasource: two-thread zlib scaling probe (bench_write.py): {probe:.3f}x")
    schema, batches = bench_write_batches()
    rates = {}
    for codec in (None, "deflate"):
        name = codec or "none"
        out = os.path.join(work, f"write_{name}")
        write_once(schema, batches, out, codec, 1, None)  # warm both paths
        write_once(schema, batches, out, codec, WRITE_WORKERS, WRITE_SHARDS)
        seq = par = 0.0
        for _ in range(WRITE_REPS):
            seq = max(seq, write_once(schema, batches, out, codec, 1, None))
            METRICS.reset()
            par = max(par, write_once(schema, batches, out, codec, WRITE_WORKERS, WRITE_SHARDS))
        stages = {k: round(v["seconds"], 4) for k, v in METRICS.snapshot("write").items()
                  if "seconds" in v}
        print(f"datasource: write_batches {WRITE_BATCHES} x {BATCH} Criteo rows, codec {name}: "
              f"sequential {seq:.1f} rows/s, pipelined ({WRITE_WORKERS} workers, {WRITE_SHARDS} "
              f"shards) {par:.1f} rows/s, {par / seq:.3f}x (best of {WRITE_REPS} interleaved "
              f"pairs, host); last pipelined run's stage seconds {stages}")
        digests = {}
        for workers in (2, 4):
            sub = os.path.join(work, f"write_{name}_{workers}")
            write_once(schema, batches, sub, codec, workers, WRITE_SHARDS)
            digests[workers] = file_digests(sub)
            shutil.rmtree(sub)
        same = digests[2] == digests[4] and len(digests[2]) == WRITE_SHARDS
        print(f"datasource: pipelined files, codec {name}, 2 vs 4 workers: {len(digests[2])} "
              f"files, bytes identical {same}")
        if not same:
            raise SystemExit(f"datasource: pipelined output differs between 2 and 4 workers ({name})")
        shutil.rmtree(out)
        rates[name] = {"sequential": seq, "pipelined": par}
    rates["zlib_probe"] = probe
    return rates


def partitioned_write(work: str) -> tuple:
    """Phase 7 (b): phase 4's rows with ``day`` = the shard's index through
    ``io.write(partition_by=["day"], codec="gzip")`` at 1 and WRITE_WORKERS
    write workers. Both layouts must hold the same records. Returns (the
    root written at WRITE_WORKERS, the written schema, {workers: seconds})."""
    from tpu_tfrecord_torch import io as tfio, wire
    from tpu_tfrecord_torch.schema import LongType, StructField, StructType

    schema = StructType(list(criteo_write_schema().fields) + [StructField("day", LongType())])
    secs, records = {}, {}
    for workers in (1, WRITE_WORKERS):
        root = os.path.join(work, f"days_w{workers}")
        rows = (row + [day] for day, shard in enumerate(criteo_shard_rows()) for row in shard)
        t0 = time.perf_counter()
        tfio.write(rows, schema, root, partition_by=["day"], codec="gzip", write_workers=workers)
        secs[workers] = time.perf_counter() - t0
        records[workers] = {
            (os.path.basename(os.path.dirname(sh.path)), i): rec
            for sh in tfio.discover_shards(root)
            for i, rec in enumerate(wire.read_records(sh.path))
        }
        layout = sorted(os.listdir(root))
        print(f"datasource: io.write of {CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} Criteo rows, "
              f"partition_by day, gzip, write_workers={workers}: {secs[workers]:.2f} s "
              f"({CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD / secs[workers]:.1f} rows/s, host); "
              f"layout {layout}")
        if layout != ["_SUCCESS"] + [f"day={d}" for d in range(CRITEO_SHARDS)]:
            raise SystemExit(f"datasource: partitioned layout {layout}")
    print("datasource: the row-by-row writer this one replaced took 4.7-9.6 s for the same "
          "rows, unpartitioned and uncompressed, measured on other H100 hosts")
    if records[1] != records[WRITE_WORKERS]:
        raise SystemExit("datasource: partitioned records differ between 1 and "
                         f"{WRITE_WORKERS} write workers")
    return os.path.join(work, f"days_w{WRITE_WORKERS}"), schema, secs


def read_back(root: str, schema) -> dict:
    """Phase 7 (c): the reader's schema, inference over every file at 4
    workers, and the head of ``read``, against what was written."""
    from tpu_tfrecord_torch import io as tfio
    from tpu_tfrecord_torch.schema import LongType

    def types(s):
        return [(f.name, f.data_type) for f in s]

    want = sorted(types(schema)[:-1]) + [("day", LongType())]
    t0 = time.perf_counter()
    got = tfio.reader(root).schema()
    reader_s = time.perf_counter() - t0
    r = tfio.reader(root)
    t0 = time.perf_counter()
    all_files = r.infer_schema_all_files(num_workers=4)
    infer_s = time.perf_counter() - t0
    all_files = list(all_files.fields) + list(r.partition_schema.fields)
    print(f"datasource: reader().schema() {reader_s * 1e3:.1f} ms (first file), "
          f"infer_schema_all_files(num_workers=4) over {len(r.shards)} files "
          f"{infer_s * 1e3:.1f} ms ({CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD / infer_s:.1f} rows/s, "
          f"host); {len(want)} fields")
    if types(got) != want or [(f.name, f.data_type) for f in all_files] != want:
        raise SystemExit(f"datasource: inferred schema {types(got)} != written {want}")
    t0 = time.perf_counter()
    head = tfio.read(root, limit=1024)
    read_s = time.perf_counter() - t0
    source = [dict(zip(schema.names, row + [day])) for day, shard in enumerate(criteo_shard_rows())
              for row in shard][:1024]
    equal = head.to_dicts() == source
    print(f"datasource: read(limit=1024) {read_s * 1e3:.1f} ms "
          f"({1024 / read_s:.1f} rows/s, host); rows equal to the source {equal}")
    if not equal:
        raise SystemExit("datasource: read() head differs from the written rows")
    return {"infer_all_files_s": infer_s, "read_head_s": read_s}


def serve_partitioned(root: str) -> tuple:
    """Phase 7 (d): bf16 scoring of the partitioned root over EPOCHS epochs
    (``day`` is read and ignored by the model): logits bit-equal to phase
    4's bf16 run, one bf16_mma launch a batch."""
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    model = new_criteo_model(torch.bfloat16)
    reset_launch_counts()
    res = score_files(root, model.cfg, model, BATCH, "cuda", num_epochs=EPOCHS,
                      log1p_dense=True, **criteo_files_kw())
    launches = dict(dot_interaction.instance_launches)
    equal = res.logits.shape == MAIN_BF16["logits"].shape and torch.equal(
        res.logits.cpu(), MAIN_BF16["logits"])
    whole, steady = res.batches * BATCH / res.wall_s, steady_rate(res)
    print(f"datasource: bf16 scoring of the partitioned gzip root, {res.batches} batches: "
          f"{whole:.1f} rows/s whole, {steady:.1f} steady (phase 4, uncompressed shards: "
          f"{MAIN_BF16['whole']:.1f} whole, {MAIN_BF16['steady']:.1f} steady); launches "
          f"{launches}; logits bit-equal to phase 4's {equal}")
    want = {"bf16_mma": EPOCHS * CRITEO_SHARDS, "f32_tiled": 0}
    if not equal or launches != want or not torch.isfinite(res.logits).all():
        raise SystemExit(f"datasource: partitioned serving disagrees with phase 4 "
                         f"(launches {launches})")
    del model, res
    free_cuda()
    return launches, {"whole": whole, "steady": steady}


def codec_round_trips(data_dir: str, work: str) -> dict:
    """Phase 7 (e): shard00's records through snappy, lz4 and bzip2 (and
    zstd where ``zstandard`` is installed); each decoded batch's digest must
    equal the uncompressed shard's."""
    from tpu_tfrecord_torch import wire
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    def digests(path):
        ds = TFRecordDataset(path, BATCH, **criteo_read_kw())
        with ds.batches() as it:
            return [batch_digest(cb) for cb in it]

    src = shard_dirs(data_dir)[0]
    (plain,) = [os.path.join(src, n) for n in os.listdir(src) if n.startswith("part-")]
    records = list(wire.read_records(plain))
    want = digests(src)
    codecs = list(OTHER_CODECS) + (["zstd"] if wire._zstandard() is not None else [])
    out = {}
    for codec in codecs:
        path = os.path.join(work, f"codec_{codec}", "part-00000" + ".tfrecord"
                            + wire.codec_extension(codec))
        os.makedirs(os.path.dirname(path))
        t0 = time.perf_counter()
        wire.write_records(path, records, codec=codec)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = digests(os.path.dirname(path))
        read_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"datasource: {codec}: {len(records)} records, {size} bytes "
              f"({size / os.path.getsize(plain):.3f} of uncompressed), write {write_s:.3f} s, "
              f"decode {read_s:.3f} s (host); batch digests equal to the uncompressed shard's "
              f"{got == want}")
        if got != want:
            raise SystemExit(f"datasource: {codec} round trip changed the batches")
        out[codec] = {"write_s": write_s, "decode_s": read_s, "ratio": size / os.path.getsize(plain)}
    if "zstd" not in codecs:
        print("datasource: zstd: the zstandard module is not installed here, not run")
    return out


def datasource_path(data_dir: str) -> dict:
    """Phase 7: the data-source API at full width. Returns the bf16_mma
    launches of its serving run."""
    with tempfile.TemporaryDirectory(prefix="datasource_", dir=data_dir) as work:
        rates = write_rates(work)
        root, schema, row_write_s = partitioned_write(work)
        reads = read_back(root, schema)
        launches, serving = serve_partitioned(root)
        codecs = codec_round_trips(data_dir, work)
    print("datasource: " + json.dumps({
        "write_batches_rows_per_s": rates, "row_write_s": row_write_s, "reads": reads,
        "serving": serving, "codecs": codecs}))
    return launches


# -- phase 8: resumable training -------------------------------------------------------

RESUME_EPOCHS = 8          # both shards: 16 steps
RESUME_SAVE_EVERY = 8
RESUME_STOP = 12           # the interrupted run's last step
RESUME_SEED = 1            # the resumed model's own weights, before the restore
DRILL_STEPS = 16           # train_dlrm on 2 shards: 2 epochs of 8 batches
DRILL_KILL_AT = "step 8"
DRILL_COMMIT_DELAY_S = 1.0  # run 1's commits: its step-8 save lands 1 s before it could end
DRILL_TIMEOUT_S = 300


def resume_dataset(data_dir: str):
    """Phase 8's read: phase 5's shuffled read of phase 4's shards."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    return TFRecordDataset(shard_dirs(data_dir), BATCH, shuffle=True, shuffle_window=2, seed=0,
                           num_epochs=RESUME_EPOCHS, **criteo_read_kw())


def sparse_state(seed: int = TRAIN_SEED):
    """A fresh full-width bf16 model from ``seed`` and its sparse optimizer
    (Adam 1e-3 on the MLPs, row-wise AdaGrad accumulators)."""
    from tpu_tfrecord_torch.models.dlrm import init_params, sparse_opt_init

    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    opt = sparse_opt_init(model, cfg, lambda ps: torch.optim.Adam(ps, lr=1e-3))
    return model, opt


def harness_run(model, opt, data_dir, state=None, *, save=None, max_steps=None, metrics=None,
                save_every=RESUME_SAVE_EVERY):
    """Sparse steps through ``harness.run_train_loop`` over phase 8's read
    from ``state``: produce = densify + log1p + label cast +
    ``make_device_batch``. Returns a dict of the batch digests and losses
    of every step, the StepPhases recorder and the loop's rows/s (whole:
    from opening the iterator to the last step's end; steady: from step 2's
    dispatch, which waits for step 1, to the end)."""
    from tpu_tfrecord_torch import harness
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
    from tpu_tfrecord_torch.models.dlrm import sparse_train_step

    ds = resume_dataset(data_dir)
    cfg = model.cfg
    kept, losses, dispatched = [], [], []

    def produce(cb):
        kept.append(cb)  # digested after the run, outside the timed loop
        hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
        hb["label"] = hb["label"].astype(np.float32)
        return make_device_batch(hb, "cuda")

    def step(st, gb):
        dispatched.append(time.perf_counter())
        loss = sparse_train_step(model, opt, gb, cfg)
        losses.append(loss)
        return st, loss

    phases = harness.StepPhases(metrics=metrics)
    t0 = time.perf_counter()
    with ds.batches(state) as it:
        _, steps, duty = harness.run_train_loop(it, produce, step, (), save=save,
                                                save_every=save_every, log_every=1 << 30,
                                                max_steps=max_steps, phases=phases)
    end = time.perf_counter()
    return dict(
        ds=ds, steps=steps, digests=[batch_digest(cb) for cb in kept],
        losses=torch.stack(losses).float().cpu() if losses else torch.empty(0),
        phases=phases, duty=duty.value(), whole=steps * BATCH / (end - t0),
        steady=(steps - 1) * BATCH / (end - dispatched[1]) if steps > 1 else None,
    )


def tree_bytes(tree) -> int:
    from tpu_tfrecord_torch.checkpoint import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as an integer tensor of the same element size."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def print_run(label, run, ref=None) -> None:
    shares = {k: round(v, 4) for k, v in run["phases"].shares().items()}
    print(f"resume: {label}: {run['steps']} steps, {run['whole']:.1f} rows/s whole, "
          f"{run['steady']:.1f} steady (steps 2-{run['steps']}); duty cycle {run['duty']:.4f}; "
          f"StepPhases shares {shares}, verdict {run['phases'].verdict()}")
    if ref is not None:
        n = run["steps"]
        if run["digests"] != ref["digests"][:n]:
            raise SystemExit(f"resume: {label}: batch digests differ from the uninterrupted run's")
        err = (run["losses"] - ref["losses"][:n]).abs().max().item()
        print(f"resume: {label}: batch digests of steps 1-{n} equal the uninterrupted run's; "
              f"max |loss - uninterrupted loss| = {err} (tol {TRAIN_LOSS_TOL})")
        if not torch.allclose(run["losses"], ref["losses"][:n], rtol=TRAIN_LOSS_TOL,
                              atol=TRAIN_LOSS_TOL):
            raise SystemExit(f"resume: {label}: losses disagree with the uninterrupted run's")


def save_times(metrics, saves: list):
    """A save callback's wrapper that records each save's snapshot, commit
    wait and (sync) commit seconds from the run's own registry."""
    def timed_save(ck, step, it, tree) -> None:
        before = {k: metrics.stage(k).seconds for k in ("ckpt.snapshot", "ckpt.commit_wait",
                                                        "ckpt.commit")}
        t0 = time.perf_counter()
        ck.save(step, tree, it)
        saves.append(dict(step=step, call_s=time.perf_counter() - t0,
                          **{k: metrics.stage(k).seconds - v for k, v in before.items()}))
    return timed_save


def checkpoint_twin(data_dir, ckpt_dir, sync: bool, ref) -> dict:
    """16 sparse steps with a TrainCheckpointer (keep=1), async saving at 8
    and 16 (the retention check: one generation left), or sync saving at 16
    only (one 3.6 GB commit on the step's thread): the commit's cost split
    by where it lands."""
    from tpu_tfrecord_torch.checkpoint import TrainCheckpointer
    from tpu_tfrecord_torch.metrics import Metrics
    from tpu_tfrecord_torch.models.dlrm import train_state

    label = "sync twin" if sync else "async twin"
    model, opt = sparse_state()
    m = Metrics()
    saves: list = []
    timed_save = save_times(m, saves)
    with TrainCheckpointer(ckpt_dir, max_to_keep=1, async_save=not sync, metrics=m) as ck:
        run = harness_run(model, opt, data_dir, metrics=m,
                          save=lambda s, it, _: timed_save(ck, s, it, train_state(model, opt)),
                          save_every=16 if sync else RESUME_SAVE_EVERY)
        t0 = time.perf_counter()
        ck.wait()
        drain = time.perf_counter() - t0
        gens = sorted(os.listdir(ckpt_dir))
        ck.clear()
    print_run(label, run, ref)
    commit = m.stage("ckpt.commit")
    out = dict(saves=saves, drain_s=drain, commit_s=commit.seconds / max(1, commit.records),
               commits=commit.records, bytes_written=m.counter("ckpt.bytes_written"),
               commit_wait_s=m.stage("ckpt.commit_wait").seconds,
               shares=run["phases"].shares(), verdict=run["phases"].verdict(),
               whole=run["whole"], steady=run["steady"])
    print(f"resume: {label}: saves {saves}; commit {out['commit_s']:.3f} s each over "
          f"{commit.records} commits, {out['bytes_written']} bytes written; commit wait "
          f"{out['commit_wait_s']:.3f} s; drain after the loop {drain:.3f} s; generations on "
          f"disk at the end (keep=1): {gens}")
    if gens != ["gen-00000016"]:
        raise SystemExit(f"resume: {label}: generations {gens}, want the last only")
    del model, opt, run
    free_cuda()
    return out


def kill_drill(work: str) -> dict:
    """The twin trainer (``python -m tpu_tfrecord_torch.train_dlrm``, sparse,
    on the card, over 2 shards of its rows) killed with SIGKILL once its
    step-8 position is saved (its commits delayed DRILL_COMMIT_DELAY_S, so
    the run cannot end in the meantime), then run again: it must resume
    from a nonzero position, finish with "done:", and the saved step plus
    the second run's steps must be the epoch budget."""
    import signal

    from tpu_tfrecord_torch import checkpoint, train_dlrm

    repo = os.path.dirname(os.path.abspath(__file__))
    data, ckpt = os.path.join(work, "drill_data"), os.path.join(work, "drill_ckpt")
    train_dlrm.generate(data, shards=2)
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.train_dlrm", "--data-dir", data,
           "--ckpt-dir", ckpt]
    env = dict(os.environ, DLRM_SPARSE="1", PYTHONPATH=repo)
    state = checkpoint.state_path(ckpt, 0)
    t0 = time.perf_counter()
    with open(os.path.join(work, "drill_1.err"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=subprocess.PIPE, stderr=err, text=True,
                                env=dict(env, TFR_CKPT_COMMIT_THROTTLE_S=str(DRILL_COMMIT_DELAY_S)))
        first = []
        timer = threading.Timer(DRILL_TIMEOUT_S, proc.kill)  # a hung run ends the read
        timer.start()
        try:
            for line in proc.stdout:
                first.append(line.rstrip())
                if line.startswith(DRILL_KILL_AT + " "):
                    while not os.path.exists(state) and proc.poll() is None:
                        time.sleep(0.002)
                    proc.send_signal(signal.SIGKILL)
                    break
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
    killed_s = time.perf_counter() - t0
    print("resume: drill run 1 (killed): " + " | ".join(first))
    if proc.returncode != -signal.SIGKILL:
        raise SystemExit(f"resume: drill run 1 ended with {proc.returncode} before {DRILL_KILL_AT!r}; "
                         f"stderr: {open(os.path.join(work, 'drill_1.err')).read()[-2000:]}")
    with open(checkpoint.state_path(ckpt, 0)) as fh:
        saved = json.load(fh)
    t0 = time.perf_counter()
    second = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                            timeout=DRILL_TIMEOUT_S)
    resumed_s = time.perf_counter() - t0
    lines = second.stdout.strip().splitlines()
    print("resume: drill run 2: " + " | ".join(lines))
    if second.returncode != 0:
        raise SystemExit(f"resume: drill run 2 failed ({second.returncode}): {second.stderr[-2000:]}")
    resumed = [ln for ln in lines if ln.startswith("resuming from")]
    done = [ln for ln in lines if ln.startswith("done:")]
    pos = saved["state"]
    nonzero = any(pos.get(k, 0) for k in ("epoch", "shard_cursor", "record_offset"))
    steps2 = int(done[0].split()[1]) if done else -1
    ok = (bool(resumed) and nonzero and saved.get("step") == 8
          and steps2 + saved["step"] == DRILL_STEPS
          and not os.path.exists(checkpoint.state_path(ckpt, 0)))
    print(f"resume: drill: saved position {pos} at step {saved.get('step')}; run 2 took "
          f"{steps2} steps; {saved.get('step')} + {steps2} = {DRILL_STEPS} (the epoch budget): "
          f"{ok}; run 1 {killed_s:.1f} s to the kill, run 2 {resumed_s:.1f} s (host clock)")
    if not ok:
        raise SystemExit("resume: the kill drill did not resume and finish the epoch budget")
    return dict(saved_step=saved["step"], second_steps=steps2, killed_s=killed_s,
                resumed_s=resumed_s)


def resume_path(data_dir: str) -> dict:
    """Phase 8: resumable sparse training at full width through the harness
    and the TrainCheckpointer. Returns each kernel instance's launches."""
    from tpu_tfrecord_torch.checkpoint import TrainCheckpointer, tree_flatten_with_path
    from tpu_tfrecord_torch.metrics import Metrics
    from tpu_tfrecord_torch.models.dlrm import load_train_state, train_state
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    model, opt = sparse_state()
    need = tree_bytes(train_state(model, opt))
    free = shutil.disk_usage(data_dir).free
    print(f"resume: a checkpoint of the full-width sparse state is {need} bytes; keep=1 holds "
          f"at most 2 on disk during a commit; free in {data_dir}: {free} bytes")
    if free < 2 * need + (1 << 30):
        raise SystemExit(f"resume: {2 * need + (1 << 30)} bytes of free disk needed, {free} free")
    reset_launch_counts()
    ref = harness_run(model, opt, data_dir)
    ref_model = model
    del opt
    print_run("uninterrupted (no checkpoint)", ref)
    print(f"resume: phase 5's bf16 sparse loop (train_files, one decode worker) in this call: "
          f"{TRAIN_BF16.get('whole', float('nan')):.1f} rows/s whole, "
          f"{TRAIN_BF16.get('steady', float('nan')):.1f} steady")

    # interrupted at step 12, with one async save at step 8
    ckpt_dir = os.path.join(data_dir, "resume_ckpt")
    model, opt = sparse_state()
    m = Metrics()
    saves: list = []
    timed_save = save_times(m, saves)
    snap = {}

    def save(step, it, _):
        tree = train_state(model, opt)
        timed_save(ck, step, it, tree)
        # the snapshot's bits, kept on the card, to hold the restore against
        snap.update({p: t.detach().clone() for p, t in tree_flatten_with_path(tree)[0]})

    ck = TrainCheckpointer(ckpt_dir, max_to_keep=1, metrics=m)
    part = harness_run(model, opt, data_dir, save=save, max_steps=RESUME_STOP, metrics=m)
    t0 = time.perf_counter()
    ck.wait()
    drain = time.perf_counter() - t0
    ck.close()
    print_run(f"interrupted at step {RESUME_STOP}", part, ref)
    print(f"resume: interrupted run: save {saves}; commit {m.stage('ckpt.commit').seconds:.3f} s, "
          f"{m.counter('ckpt.bytes_written')} bytes; drained {drain:.3f} s after the loop")
    del model, opt, ck, part
    free_cuda()

    # resumed from another seed's weights
    model, opt = sparse_state(RESUME_SEED)
    ck = TrainCheckpointer(ckpt_dir, max_to_keep=1)
    t0 = time.perf_counter()
    step, tree, resume = ck.restore(train_state(model, opt))
    t1 = time.perf_counter()
    load_train_state(model, opt, tree)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ck.close()
    del tree
    live = tree_flatten_with_path(train_state(model, opt))[0]
    same = [p for p, t in live if torch.equal(bits(t), bits(snap[p].to(t.device)))]
    print(f"resume: restore of step {step} at {resume}: disk -> host {t1 - t0:.3f} s, host -> "
          f"device {t2 - t1:.3f} s (load_train_state, synchronized); {len(same)} of {len(live)} "
          f"tensors bit-equal to the step-{RESUME_SAVE_EVERY} snapshot")
    if step != RESUME_SAVE_EVERY or resume is None or len(same) != len(live) or len(live) != len(snap):
        raise SystemExit(f"resume: restored step {step}, position {resume}, "
                         f"{len(same)}/{len(live)} tensors equal to the snapshot")
    del snap, live
    rest = harness_run(model, opt, data_dir, resume)
    if rest["ds"].fingerprint() != resume.fingerprint or rest["steps"] != 16 - RESUME_SAVE_EVERY:
        raise SystemExit(f"resume: the resumed run took {rest['steps']} steps")
    if rest["digests"] != ref["digests"][RESUME_SAVE_EVERY:]:
        raise SystemExit("resume: the resumed batches differ from steps 9-16 of the uninterrupted run")
    print("resume: batch digests of the resumed steps 9-16 equal the uninterrupted run's")
    check_training("resume: resumed steps 9-16", rest["losses"], model,
                   ref["losses"][RESUME_SAVE_EVERY:], ref_model, torch.bfloat16, "uninterrupted",
                   "counted at the end of the phase")
    print_run("resumed, steps 9-16", rest)
    restore = dict(disk_to_host_s=t1 - t0, host_to_device_s=t2 - t1)
    interrupted = dict(saves=saves, commit_s=m.stage("ckpt.commit").seconds,
                       bytes_written=m.counter("ckpt.bytes_written"), drain_s=drain)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del model, opt, ref_model, rest
    free_cuda()

    twins = {mode: checkpoint_twin(data_dir, os.path.join(data_dir, f"ckpt_{mode}"),
                                   mode == "sync", ref) for mode in ("async", "sync")}
    launches = dict(dot_interaction.instance_launches)
    want = {"bf16_mma": 16 + RESUME_STOP + (16 - RESUME_SAVE_EVERY) + 16 + 16, "f32_tiled": 0}
    print(f"resume: kernel launches over phase 8 (uninterrupted 16 + interrupted {RESUME_STOP} + "
          f"resumed {16 - RESUME_SAVE_EVERY} + async twin 16 + sync twin 16): {launches}")
    if launches != want:
        raise SystemExit(f"resume: launches {launches}, want {want}")
    print("resume: " + json.dumps({
        "free_bytes": free, "checkpoint_bytes": need, "interrupted": interrupted,
        "restore": restore, "twins": twins,
        "rows_per_s": {"uninterrupted": [ref["whole"], ref["steady"]],
                       "phase5_train_files": [TRAIN_BF16.get("whole"), TRAIN_BF16.get("steady")]},
    }, default=float))
    return launches


# -- phase 9: the sequence models -------------------------------------------------------

SEQ_DEVICE = "cuda"
SEQ_PARITY_STEPS = 16
LM_LOGITS_ATOL = 1e-4      # f32, TF32 off: the card against the CPU
SEQ_LOSS_RTOL = 1e-4
LONGDOC_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LM_DRILL_STEPS = 64
LM_DRILL_SAVE_EVERY = 8
LM_DRILL_KILL_AT = 20
LM_DRILL_RESUMED_AT = 16
SEQ_TIMEOUT_S = 300
RATE_STEPS = 25
PROFILE_STEPS = 5
PACK_REPS = 40


def seq_sync() -> None:
    if torch.device(SEQ_DEVICE).type == "cuda":
        torch.cuda.synchronize()


def tree_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    from tpu_tfrecord_torch.checkpoint import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.detach().to(device).clone() for t in leaves])


def packed_batches(data_dir: str, packing: str, n: int) -> tuple:
    """The first ``n`` packed batches of the LM twin's read (its dataset,
    ``TokenPacker(32, 64, packing)``) as dicts, and the packer's density."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.device.ingest import TokenPacker
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(data_dir, batch_size=tw.READ_BATCH, schema=tw.make_schema(),
                         num_epochs=4, recordType="SequenceExample", shuffle=True, seed=0)
    pk = TokenPacker(tw.BATCH, tw.SEQ_LEN, packing=packing)
    out = []
    with ds.batches() as it:
        for cb in it:
            pk.feed_column(cb["tokens"])
            while len(out) < n and (b := pk.pop()) is not None:
                out.append(b if isinstance(b, dict) else {"tokens": b})
            if len(out) == n:
                break
    if len(out) < n:
        raise SystemExit(f"seq: {packing} packing gave {len(out)} batches, want {n}")
    return out, pk.density()


def lm_parity(data_dir: str, packing: str) -> dict:
    """Phase 9 (1): the twin's LM (f32, TF32 off) with one set of weights
    on the card and on the CPU: logits of the first packed batch within
    ``LM_LOGITS_ATOL``, then 16 Adam(3e-3) steps with losses within
    ``SEQ_LOSS_RTOL``."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.models import lm, optim

    cfg = tw.make_config()
    batches, density = packed_batches(data_dir, packing, SEQ_PARITY_STEPS)
    host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_to(host, SEQ_DEVICE)

    def args(b, device):
        segs = b.get("segment_ids")
        return (torch.from_numpy(b["tokens"]).to(device),
                None if segs is None else torch.from_numpy(segs).to(device))

    with torch.no_grad():
        tok, seg = args(batches[0], "cpu")
        want = lm.forward(host, tok, cfg, segments=seg)[0]
        tok, seg = args(batches[0], SEQ_DEVICE)
        got = lm.forward(card, tok, cfg, segments=seg)[0].cpu()
    err = float((got - want).abs().max())
    opts = {"cpu": optim.adam(host, tw.LR), SEQ_DEVICE: optim.adam(card, tw.LR)}
    losses = {d: [] for d in opts}
    for b in batches:
        for device, params in (("cpu", host), (SEQ_DEVICE, card)):
            tok, seg = args(b, device)
            losses[device].append(float(lm.train_step(params, opts[device], tok, cfg, segments=seg)))
    lc, lg = np.array(losses["cpu"]), np.array(losses[SEQ_DEVICE])
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    ok = err <= LM_LOGITS_ATOL and rel <= SEQ_LOSS_RTOL and np.isfinite(lg).all()
    print(f"seq: LM parity, {packing} batches ({SEQ_PARITY_STEPS} of [32, 65]"
          f"{', segment_ids' if packing != 'slice' else ''}; density {density:.4f}): logits max abs "
          f"err {err:.3e} (atol {LM_LOGITS_ATOL}); {SEQ_PARITY_STEPS} Adam steps, losses card "
          f"{lg[0]:.6f} -> {lg[-1]:.6f}, max rel diff to the CPU {rel:.3e} (rtol {SEQ_LOSS_RTOL}): {ok}")
    if not ok:
        raise SystemExit(f"seq: LM card/CPU parity failed on {packing} batches")
    return dict(logits_err=err, loss_rel=rel, density=density)


def longdoc_parity(data_dir: str) -> dict:
    """Phase 9 (2): the bf16 frames of the long_doc twin's feed (native pad
    and round, ``DeviceIterator``) bit-equal to the float32 pad cast on the
    card; the twin's classifier on the card and on the CPU, bf16 logits
    within 2e-2 and float32 within 1e-4."""
    from tpu_tfrecord_torch import train_longdoc as tw
    from tpu_tfrecord_torch.device.ingest import DeviceIterator, host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.models import long_doc

    ds = TFRecordDataset(data_dir, batch_size=tw.BATCH, schema=tw.make_schema(),
                         recordType="SequenceExample", shuffle=True, seed=0)
    with ds.batches() as it:
        cb = next(it)
    hb = tw.host_batch(cb, ds.schema)
    f32 = host_batch_from_columnar(cb, ds.schema, pad_to={"frames": (tw.MAX_LEN, tw.SEQ_DIM)})
    with DeviceIterator([hb], SEQ_DEVICE) as dit:
        fed = next(dit)
    cast = torch.from_numpy(f32["frames"]).to(SEQ_DEVICE).to(torch.bfloat16)
    same = (fed["frames"].dtype == torch.bfloat16
            and torch.equal(fed["frames"].view(torch.int16), cast.view(torch.int16))
            and all(torch.equal(fed[k].cpu(), torch.from_numpy(f32[k])) for k in ("frames_len", "label")))
    print(f"seq: long_doc feed: frames {tuple(fed['frames'].shape)} {fed['frames'].dtype} through "
          f"DeviceIterator bit-equal to the float32 pad cast on the card: {same}")
    if not same:
        raise SystemExit("seq: the bf16 frame feed disagrees with the cast on the card")
    out = {}
    for dtype, frames in ((torch.bfloat16, hb["frames"]), (torch.float32, torch.from_numpy(f32["frames"]))):
        cfg = dataclasses.replace(tw.make_config(), dtype=dtype)
        host = long_doc.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = tree_to(host, SEQ_DEVICE)
        batch = {"frames": frames, "frames_len": torch.from_numpy(f32["frames_len"]),
                 "label": torch.from_numpy(f32["label"])}
        with torch.no_grad():
            want = long_doc.forward(host, batch, cfg)
            got = long_doc.forward(card, {k: v.to(SEQ_DEVICE) for k, v in batch.items()}, cfg).cpu()
        err = float((got - want).abs().max())
        tol = LONGDOC_TOL[dtype]
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"seq: long_doc logits [64, 2] {dtype}, card against the CPU: max abs err {err:.3e} "
              f"(tol {tol}): {ok}")
        if not ok:
            raise SystemExit(f"seq: long_doc card/CPU parity failed in {dtype}")
        out[str(dtype).replace("torch.", "")] = err
    return out


def run_twin(module: str, args: list, work: str, log: str, kill_after_step=None, device=None,
             env=None):
    """``python -m <module> --device <device> *args`` in a subprocess
    (``SEQ_DEVICE`` unless ``device``; ``env`` added to this process's):
    (return code, [(host seconds since start, line)], stderr). With
    ``kill_after_step`` it is killed with SIGKILL after that step's
    ``lm_step`` line, once the save before it is committed: the save is
    asynchronous, and on a busy host its commit can land after later
    steps' lines (waited for up to SEQ_TIMEOUT_S)."""
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", module, "--device", device or SEQ_DEVICE, *args]
    env = dict(os.environ, PYTHONPATH=repo, **(env or {}))
    lines = []
    t0 = time.perf_counter()
    with open(os.path.join(work, log), "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE, stderr=err,
                                text=True)
        timer = threading.Timer(SEQ_TIMEOUT_S, proc.kill)  # a hung run ends the read
        timer.start()
        try:
            for line in proc.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip()))
                if (kill_after_step is not None and line.startswith("lm_step ")
                        and json.loads(line.split(" ", 1)[1])["step"] == kill_after_step):
                    every = int(args[args.index("--save-every") + 1])
                    manifest = os.path.join(args[args.index("--ckpt-dir") + 1],
                                            f"gen-{kill_after_step // every * every:08d}",
                                            "MANIFEST.json")
                    deadline = time.monotonic() + SEQ_TIMEOUT_S
                    while not os.path.exists(manifest) and time.monotonic() < deadline:
                        time.sleep(0.002)
                    proc.send_signal(signal.SIGKILL)
                    break
        finally:
            timer.cancel()
            if kill_after_step is None:
                with contextlib.suppress(subprocess.TimeoutExpired):
                    proc.wait(timeout=60)
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
    with open(os.path.join(work, log)) as fh:
        stderr = fh.read()
    return proc.returncode, lines, stderr


def lm_steps(lines) -> dict:
    out = {}
    for t, ln in lines:
        if ln.startswith("lm_step "):
            rec = json.loads(ln.split(" ", 1)[1])
            out[rec["step"]] = dict(rec, t=t)
    return out


def done_rate(lines) -> float:
    """examples/s of a twin's "done: N steps, X examples/s" line."""
    done = [m for _, ln in lines if (m := re.match(r"done: \d+ steps, ([\d,.]+) examples/s", ln))]
    if not done:
        raise SystemExit("seq: the twin printed no done line")
    return float(done[-1].group(1).replace(",", ""))


def lm_drill(work: str, data_dir: str) -> dict:
    """Phase 9 (3): the train_lm twin, uninterrupted for 64 steps saving
    every 8 and, at the same time, a run killed with SIGKILL after step 20,
    then run again: it must resume at step 16 and give the uninterrupted
    run's digests for steps 17-64 and its losses, bit-equal or within
    ``SEQ_LOSS_RTOL``."""
    import signal

    from tpu_tfrecord_torch import train_lm as tw

    common = ["--data-dir", data_dir, "--steps", str(LM_DRILL_STEPS),
              "--save-every", str(LM_DRILL_SAVE_EVERY)]

    def lm_run(name, ckpt, kill=None):
        return run_twin("tpu_tfrecord_torch.train_lm", common + [
            "--ckpt-dir", os.path.join(work, ckpt),
            "--digest-out", os.path.join(work, f"lm_{name}.jsonl")], work, f"lm_{name}.err", kill)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ref_f = pool.submit(lm_run, "uninterrupted", "lm_ckpt_ref")
        kill_f = pool.submit(lm_run, "killed", "lm_ckpt", LM_DRILL_KILL_AT)
        done = {"uninterrupted": ref_f.result(), "killed": kill_f.result()}
    done["resumed"] = lm_run("resumed", "lm_ckpt")
    runs = {}
    for name, (rc, lines, err) in done.items():
        want_rc = -signal.SIGKILL if name == "killed" else 0
        if rc != want_rc:
            raise SystemExit(f"seq: train_lm {name} run ended with {rc}: {err[-3000:]}")
        runs[name] = lines
        head = [ln for _, ln in lines if not ln.startswith("lm_step")]
        print(f"seq: train_lm {name}: " + " | ".join(head))
    ref, res = lm_steps(runs["uninterrupted"]), lm_steps(runs["resumed"])
    first = [ln for _, ln in runs["resumed"]][:3]
    resumed_at = f"resumed at step {LM_DRILL_RESUMED_AT}" in first
    later = range(LM_DRILL_RESUMED_AT + 1, LM_DRILL_STEPS + 1)
    digests = sorted(res) == list(later) and all(res[s]["digest"] == ref[s]["digest"] for s in later)
    bit_equal = all(res[s]["loss"] == ref[s]["loss"] for s in later)
    rel = max(abs(float(res[s]["loss"]) - float(ref[s]["loss"])) / abs(float(ref[s]["loss"]))
              for s in later) if digests else float("inf")
    determinism = "bit-equal" if bit_equal else f"within a relative {SEQ_LOSS_RTOL} (max {rel:.3e})"
    print(f"seq: train_lm drill: {first[:2]}; resumed at step {LM_DRILL_RESUMED_AT}: {resumed_at}; "
          f"digests of steps {later[0]}-{later[-1]} equal the uninterrupted run's: {digests}; "
          f"losses {determinism}")
    if not (resumed_at and digests and (bit_equal or rel <= SEQ_LOSS_RTOL)):
        raise SystemExit("seq: the train_lm kill drill did not continue the uninterrupted run")
    losses = [float(ref[s]["loss"]) for s in sorted(ref)]
    if not np.isfinite(losses).all():
        raise SystemExit("seq: train_lm losses are not finite")
    whole = done_rate(runs["uninterrupted"]) * tw.SEQ_LEN
    t2, tn = ref[2]["t"], ref[LM_DRILL_STEPS]["t"]
    steady = (LM_DRILL_STEPS - 2) * tw.BATCH * tw.SEQ_LEN / (tn - t2)
    print(f"seq: train_lm uninterrupted: losses {losses[0]:.4f} -> {losses[-1]:.4f}; {whole:.1f} "
          f"tokens/s whole (its done line), {steady:.1f} steady (steps 3-{LM_DRILL_STEPS}, lm_step "
          "lines' arrival, host clock), contended: beside the killed run and train_longdoc "
          "on the same card and host, so not comparable with the rate of a run alone")
    return dict(determinism=determinism, loss_rel=rel, tokens_per_s_whole=whole,
                tokens_per_s_steady=steady, first_loss=losses[0], last_loss=losses[-1])


def longdoc_twin(work: str, data_dir: str) -> dict:
    """Phase 9 (4): the train_longdoc twin whole (2 epochs, 32 steps, bf16
    frames): finite losses, the harness's phase shares and verdict. It
    runs beside phase 9 (3)'s train_lm runs: its rate is contended."""
    from tpu_tfrecord_torch import train_longdoc as tw

    rc, lines, err = run_twin("tpu_tfrecord_torch.train_longdoc",
                              ["--data-dir", data_dir, "--ckpt-dir", os.path.join(work, "ld_ckpt")],
                              work, "longdoc.err")
    text = [ln for _, ln in lines]
    print("seq: train_longdoc (contended: beside the train_lm drill): " + " | ".join(text))
    losses = [float(ln.split("~")[1]) for ln in text if ln.startswith("step ")]
    phases = [ln for ln in text if ln.startswith("train phases:")]
    if rc != 0 or not losses or not np.isfinite(losses).all() or not phases \
            or not any(ln.startswith("done: 32 steps") for ln in text):
        raise SystemExit(f"seq: train_longdoc failed ({rc}): {err[-3000:]}")
    return dict(losses=losses, phases=phases[0], steps_per_s_whole=done_rate(lines) / tw.BATCH)


def step_rate(label, step, tokens_per_step: int, steps: int = 0, profile_steps: int = 0) -> dict:
    """Steps/s of ``step`` run back to back (host clock, synchronized;
    ``steps``, default ``RATE_STEPS``), the device ms per step of its
    kernels (torch.profiler over ``profile_steps``, default
    ``PROFILE_STEPS``) and the card's idle share (1 - device ms / wall ms
    per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps, profile_steps = steps or RATE_STEPS, profile_steps or PROFILE_STEPS
    for _ in range(5):
        step()
    seq_sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    seq_sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profile_steps):
            step()
        seq_sync()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / profile_steps
    per_step = len(kernels) / profile_steps
    idle = 1 - dev_ms / wall_ms if dev_ms > 0 else float("nan")
    print(f"seq: {label}: {1e3 / wall_ms:.1f} steps/s eager ({wall_ms:.3f} ms a step, host clock, "
          f"{steps} steps back to back; {tokens_per_step * 1e3 / wall_ms:.1f} tokens/s); device "
          f"{dev_ms:.4f} ms a step in {per_step:.0f} kernels (torch.profiler, {profile_steps} steps"
          f"{'' if dev_ms > 0 else ': no device time recorded, not measured'}); idle share {idle:.4f}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    return dict(steps_per_s=1e3 / wall_ms, step_ms=wall_ms, device_ms=dev_ms,
                kernels_per_step=per_step, idle_share=idle)


def seq_rates(card: str) -> dict:
    """Phase 9 (5): LM train steps/s at the bench's shape on
    ``make_synthetic_tokens``, long_doc steps/s on a resident full-width
    batch, and ``TokenPacker`` docs/s and density at the bench's
    ``pack_shape``."""
    from tpu_tfrecord_torch import train_lm as lm_tw, train_longdoc as ld_tw
    from tpu_tfrecord_torch.device.ingest import TokenPacker
    from tpu_tfrecord_torch.models import lm, long_doc, optim

    print(f"seq: rates on {card}")
    cfg = lm_tw.make_config()
    params = lm.init_params(cfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0), SEQ_DEVICE)
    opt = optim.adam(params, lm_tw.LR)
    toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, 32, seed=0)).to(SEQ_DEVICE)
    out = {"lm": step_rate("LM train step, B=32 L=64 d=64 (make_synthetic_tokens)",
                           lambda: lm.train_step(params, opt, toks, cfg), 32 * 64)}
    lcfg = ld_tw.make_config()
    lparams = long_doc.init_params(lcfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0), SEQ_DEVICE)
    lopt = optim.adam(lparams, ld_tw.LR)
    hb = long_doc.make_synthetic_batch(lcfg, ld_tw.BATCH, seed=0)
    batch = {"frames": torch.from_numpy(hb["frames"]).to(SEQ_DEVICE).to(torch.bfloat16),
             "frames_len": torch.from_numpy(hb["frames_len"]).to(SEQ_DEVICE),
             "label": torch.from_numpy(hb["label"]).to(SEQ_DEVICE)}
    out["long_doc"] = step_rate("long_doc train step, B=64 L=64 d=32 bf16 (make_synthetic_batch)",
                                lambda: long_doc.train_step(lparams, lopt, batch, lcfg),
                                ld_tw.BATCH * ld_tw.MAX_LEN)
    sizes = np.random.default_rng(15).choice([2, 6, 10, 15, 16, 21, 25, 31], size=300)
    docs = [np.ones(int(n), np.int32) for n in sizes]
    t0 = time.perf_counter()
    for _ in range(PACK_REPS):
        pk = TokenPacker(4, 32, packing="best_fit")
        pk.feed_docs(docs)
        while pk.pop() is not None:
            pass
    secs = time.perf_counter() - t0
    out["packer"] = dict(docs_per_s=PACK_REPS * len(docs) / secs, density=pk.density())
    print(f"seq: TokenPacker at the bench's pack_shape (B=4 L=32 best_fit ragged[2..31]x300): "
          f"{out['packer']['docs_per_s']:.1f} docs/s (host clock, {PACK_REPS} repetitions), "
          f"density {out['packer']['density']:.4f}")
    return out


def seq_path(work: str, card: str) -> dict:
    """Phase 9: the sequence-model families at the twins' widths, on
    ``card`` (nvidia-smi's name and power limit). Returns the phase's
    numbers."""
    from tpu_tfrecord_torch import train_lm, train_longdoc

    lm_data, ld_data = os.path.join(work, "lm_data"), os.path.join(work, "ld_data")
    t0 = time.perf_counter()
    train_lm.generate(lm_data)
    train_longdoc.generate(ld_data)
    print(f"seq: wrote the twins' SequenceExamples (4 x 256 token documents, 4 x 256 frame "
          f"documents) in {time.perf_counter() - t0:.1f} s")
    out = {"lm_parity": {p: lm_parity(lm_data, p) for p in ("slice", "best_fit")},
           "long_doc_parity": longdoc_parity(ld_data)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ld_f = pool.submit(longdoc_twin, work, ld_data)
        out["train_lm"] = lm_drill(work, lm_data)
        out["train_longdoc"] = ld_f.result()
    out["rates"] = seq_rates(card)
    out["card"] = card
    print("seq: " + json.dumps(out, default=float))
    return out


# -- phase 10: LM serving ----------------------------------------------------------------

SERVE_DEVICE = "cuda"
SERVE_TRAIN_STEPS = 16
SERVE_MB = 8
SERVE_REQUESTS = 32
SERVE_LAYOUTS = ((1, 2), (2, 2))      # (stages of the one-device schedule, virtual chunks)
SERVE_LAYOUT_ATOL = 1e-5              # f32 logits, (1, 2) against (2, 2) on the card
SERVE_CPU_ATOL = 1e-4                 # f32 logits, TF32 off: the card against the CPU
REPLICA_CLIENTS = 8
REPLICA_REQUESTS = 4                  # a client
REPLICA_NEW = 16                      # new tokens a request
REPLICA_MAX_QUEUE = 16
REPLICA_BURST = 8                     # arrivals past max_queue in the shed check
TICK_RATE_SUBMITS = 50
TICK_PROFILE_SUBMITS = 5
SERVE_TIMEOUT_S = 120


def serve_sync() -> None:
    if torch.device(SERVE_DEVICE).type == "cuda":
        torch.cuda.synchronize()


PARK_WRITER = r"""
import sys
sys.path.insert(0, {repo!r})
from tpu_tfrecord_torch import serve_lm, train_lm
ck = train_lm.LMCheckpoint({ckpt!r})
ck.save({step}, serve_lm.checkpoint_template(serve_lm.make_config()), {{"input": None, "packer": None}})
ck.wait()
"""


def serve_checkpoint(work: str) -> tuple:
    """Phase 10 (a): the serve_lm-width LM (vocab 256, d_model 64, 4 heads,
    4 layers, L = 64) trained 16 Adam steps on ``make_synthetic_tokens``
    under deterministic algorithms, saved through ``train_lm.LMCheckpoint``
    at step 16; a second generation (step 24) parked after its shard,
    before its manifest, by a writer process killed there. Returns (step,
    the parameters ``serve_lm.load_checkpoint`` gave, on the CPU)."""
    import signal

    from tpu_tfrecord_torch import serve_lm, train_lm
    from tpu_tfrecord_torch.checkpoint import tree_flatten
    from tpu_tfrecord_torch.models import lm, optim

    cfg = serve_lm.make_config(2)
    params = tree_to(lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), SERVE_DEVICE)
    opt = optim.adam(params, train_lm.LR)
    losses = []
    for i in range(SERVE_TRAIN_STEPS):
        toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, train_lm.BATCH, seed=i)).to(SERVE_DEVICE)
        losses.append(float(lm.train_step(params, opt, toks, cfg)))
    if not np.isfinite(losses).all():
        raise SystemExit(f"serve: training losses not finite: {losses}")
    ckpt = os.path.join(work, "serve_ckpt")
    ck = train_lm.LMCheckpoint(ckpt, sync=True)
    try:
        ck.save(SERVE_TRAIN_STEPS, optim.train_state(params, opt), {"input": None, "packer": None})
    finally:
        ck.close()
    mark = os.path.join(work, "serve_parked")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TFR_CKPT_CHAOS_STAGE="pre_manifest", TFR_CKPT_CHAOS_MARK=mark)
    proc = subprocess.Popen([sys.executable, "-c", PARK_WRITER.format(
        repo=repo, ckpt=ckpt, step=SERVE_TRAIN_STEPS + 8)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while not os.path.exists(mark):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise SystemExit(f"serve: the parked writer never parked: {proc.communicate(timeout=30)}")
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)
    parked = os.path.join(ckpt, f"gen-{SERVE_TRAIN_STEPS + 8:08d}")
    torn = os.path.isdir(parked) and not os.path.exists(os.path.join(parked, "MANIFEST.json"))
    step, state = serve_lm.load_checkpoint(ckpt, serve_lm.checkpoint_template(cfg))
    same = step == SERVE_TRAIN_STEPS and all(
        torch.equal(a, b.detach().cpu()) for a, b in zip(tree_flatten(state[0])[0],
                                                         tree_flatten(params)[0]))
    print(f"serve: checkpoint: {SERVE_TRAIN_STEPS} Adam steps on the card under deterministic "
          f"algorithms, losses {losses[0]:.4f} -> {losses[-1]:.4f}; generation {SERVE_TRAIN_STEPS + 8} "
          f"parked before its manifest and killed: {torn}; load_checkpoint returned step {step}, "
          f"parameters bit-equal to the trained ones: {same}")
    if not (torn and same):
        raise SystemExit("serve: the manifest-last restore did not return the complete generation")
    return step, state[0]


def serve_one_shot(params, step, card: str) -> dict:
    """Phase 10 (b): serve_lm's timed pass at each layout on the card (32
    requests of mb 8 after the warm-up, streamed logits bitwise equal to
    ``batch_reference`` or it fails), the layouts' logits against each
    other and the card's against a CPU run of the same checkpoint."""
    from tpu_tfrecord_torch import serve_lm

    out, logits = {}, {}
    for stages, virtual in SERVE_LAYOUTS:
        cfg = serve_lm.make_config(virtual)
        line, outs = serve_lm.one_shot(params, cfg, stages, SERVE_MB, SERVE_REQUESTS, SERVE_DEVICE,
                                       step)
        print(f"serve: serve_lm OK: {json.dumps(line)}  ({card})")
        out[f"S{stages}V{virtual}"] = line
        logits[(stages, virtual)] = outs
    a, b = (logits[k] for k in SERVE_LAYOUTS)
    layout_err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    _, cpu = serve_lm.one_shot(params, serve_lm.make_config(SERVE_LAYOUTS[0][1]),
                               SERVE_LAYOUTS[0][0], SERVE_MB, SERVE_REQUESTS, "cpu", step)
    cpu_err = max(float(np.abs(x - y).max()) for x, y in zip(a, cpu))
    ok = layout_err <= SERVE_LAYOUT_ATOL and cpu_err <= SERVE_CPU_ATOL
    print(f"serve: logits of {SERVE_LAYOUTS[0]} against {SERVE_LAYOUTS[1]} on the card: max abs "
          f"diff {layout_err:.3e} (atol {SERVE_LAYOUT_ATOL}); card against the CPU at "
          f"{SERVE_LAYOUTS[0]}: {cpu_err:.3e} (atol {SERVE_CPU_ATOL}): {ok}")
    if not ok:
        raise SystemExit("serve: the one-shot logits disagree across layouts or with the CPU")
    out.update(layout_err=layout_err, cpu_err=cpu_err)
    return out


def replica_windows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=64).astype(np.int32) for _ in range(n)]


def shed_check(params, cfg) -> dict:
    """Phase 10 (c), over-admission: a replica whose engine has not started
    (the accept loop only) takes ``REPLICA_MAX_QUEUE`` arrivals plus a
    ``burst`` rule's ``REPLICA_BURST`` more; exactly the excess is shed
    with "overloaded" and a Retry-After hint, and the admitted ones are
    served with the sequential reference's tokens once the engine runs."""
    from tpu_tfrecord_torch import faults, serving
    from tpu_tfrecord_torch import service_protocol as sp
    from tpu_tfrecord_torch.metrics import Metrics

    plan = faults.FaultPlan([faults.FaultRule(op="serve", kind="burst", path="load",
                                              burst_n=REPLICA_MAX_QUEUE + REPLICA_BURST - 1)])
    metrics = Metrics()
    eng = serving.ServingEngine(params, cfg, 1, policy=serving.ServePolicy(
        mb=SERVE_MB, max_queue=REPLICA_MAX_QUEUE), metrics=metrics, device=SERVE_DEVICE)
    srv = serving.ServeServer(eng, port=0, fault_plan=plan)
    srv._accept_thread = threading.Thread(target=srv._accept_loop, name="shed-accept", daemon=True)
    srv._accept_thread.start()
    socks, shed = [], []
    ws = replica_windows(REPLICA_MAX_QUEUE, seed=77)
    try:
        arrivals = 1 + plan.apply_serve("load")
        for i in range(arrivals):
            s = sp.connect(srv.addr, timeout=30.0)
            socks.append(s)
            sp.send_msg(s, {"v": sp.PROTO_VERSION, "op": "generate", "req": i,
                            "tokens": ws[i % len(ws)].tolist(), "n_new": 1, "deadline_s": None})
            if i < REPLICA_MAX_QUEUE:
                deadline = time.monotonic() + 30
                while eng.report()["queue_depth"] < i + 1:
                    if time.monotonic() > deadline:
                        raise SystemExit("serve: an admitted arrival never queued")
                    time.sleep(0.005)
            else:
                shed.append(sp.recv_msg(s, srv.addr))
        eng.start()
        served = [sp.recv_msg(s, srv.addr) for s in socks[:REPLICA_MAX_QUEUE]]
    finally:
        for s in socks:
            s.close()
        srv.stop()
        srv._accept_thread.join(timeout=30)
    ref = serving.sequential_reference(params, cfg, 1, [(w, 1) for w in ws], SERVE_MB,
                                       device=SERVE_DEVICE)
    hints = [r.get("retry_after_s", 0) for r in shed]
    ok = (arrivals == REPLICA_MAX_QUEUE + REPLICA_BURST and len(shed) == REPLICA_BURST
          and all(r.get("error") == "overloaded" for r in shed) and min(hints) > 0
          and metrics.counter("serve.rejected") == REPLICA_BURST
          and [r.get("tokens") for r in served] == ref
          and not srv._accept_thread.is_alive())
    print(f"serve: over-admission: {arrivals} arrivals (burst rule) at max_queue "
          f"{REPLICA_MAX_QUEUE}: {len(shed)} shed 'overloaded' (serve.rejected "
          f"{metrics.counter('serve.rejected')}), Retry-After {min(hints):.4f}-{max(hints):.4f} s, "
          f"the {len(served)} admitted served with the reference's tokens: {ok}")
    if not ok:
        raise SystemExit("serve: the over-admission burst was not shed by exactly the excess")
    return dict(arrivals=arrivals, shed=len(shed), retry_after_s=[min(hints), max(hints)])


def replica_path(params, card: str) -> dict:
    """Phase 10 (c): a replica (``ServingEngine`` + ``ServeServer`` on
    127.0.0.1, S = 1, V = 2, mb 8, max_queue 16) driven by 8 concurrent
    ``ServeClient`` threads, 4 requests of 16 new tokens each from seeded
    64-token windows; every request's tokens equal ``sequential_reference``
    on the card. Meanwhile: a raw client hangs up mid-generation (its slot
    frees, counted once), the over-admission check (``shed_check``), and
    two deadlines (one expired at admission, one of 0.25 s on a request of
    100,000 tokens), dropped and counted, never served late."""
    from tpu_tfrecord_torch import serving
    from tpu_tfrecord_torch import service_protocol as sp
    from tpu_tfrecord_torch.metrics import Metrics
    from tpu_tfrecord_torch.serve_lm import make_config

    cfg = make_config(2)
    metrics = Metrics()
    eng = serving.ServingEngine(params, cfg, 1, policy=serving.ServePolicy(
        mb=SERVE_MB, max_queue=REPLICA_MAX_QUEUE), metrics=metrics, device=SERVE_DEVICE)
    srv = serving.ServeServer(eng, port=0).start()
    reqs = [replica_windows(REPLICA_REQUESTS, seed=100 + c) for c in range(REPLICA_CLIENTS)]
    results, errors, lat, done = {}, [], [], []
    lock = threading.Lock()

    def client(c):
        cl = serving.ServeClient([srv.addr], timeout_s=60.0)
        try:
            for r, w in enumerate(reqs[c]):
                t0 = time.perf_counter()
                toks = cl.generate(w, REPLICA_NEW)
                with lock:
                    lat.append(time.perf_counter() - t0)
                    results[(c, r)] = toks
        except Exception as e:  # noqa: BLE001 - the phase fails on any client error below
            errors.append(f"client {c}: {type(e).__name__}: {e}")
        finally:
            cl.close()
            with lock:
                done.append(time.perf_counter())

    doomed = sp.connect(srv.addr, timeout=30.0)
    sp.send_msg(doomed, {"v": sp.PROTO_VERSION, "op": "generate", "req": 1,
                         "tokens": replica_windows(1, seed=99)[0].tolist(), "n_new": 100000,
                         "deadline_s": None})
    deadline = time.monotonic() + 30
    while metrics.gauge_value("serve.in_flight", 0.0) < 1:
        if time.monotonic() > deadline:
            raise SystemExit("serve: the long request never started")
        time.sleep(0.005)
    threads = [threading.Thread(target=client, args=(c,), name=f"serve-client-{c}")
               for c in range(REPLICA_CLIENTS)]
    t0 = time.perf_counter()
    expired = {}
    try:
        for t in threads:
            t.start()
        doomed.close()  # hang up mid-generation while the clients run
        for key, kw in (("admission", dict(deadline_s=0.0)), ("mid_generation", dict(deadline_s=0.25))):
            cl = serving.ServeClient([srv.addr], timeout_s=60.0)
            try:
                got = cl.generate(replica_windows(1, seed=98)[0], 100000, **kw)
                expired[key] = f"served {len(got)} tokens"
            except serving.DeadlineExpired:
                expired[key] = "DeadlineExpired"
            finally:
                cl.close()
        shed = shed_check(params, cfg)
    finally:
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
    wall = max(done, default=time.perf_counter()) - t0  # the last client's last reply
    hung = [t.name for t in threads if t.is_alive()]
    deadline = time.monotonic() + 30
    while eng.report()["in_flight"] or eng.report()["queue_depth"]:
        if time.monotonic() > deadline:
            break
        time.sleep(0.01)
    rep = eng.report()
    ticks = metrics.counter("serve.ticks")
    drained = srv.drain(timeout=60)
    ref = serving.sequential_reference(
        params, cfg, 1, [(w, REPLICA_NEW) for c in range(REPLICA_CLIENTS) for w in reqs[c]],
        SERVE_MB, device=SERVE_DEVICE)
    got = [results.get((c, r)) for c in range(REPLICA_CLIENTS) for r in range(REPLICA_REQUESTS)]
    parted = [(i, next(j for j, (a, b) in enumerate(zip(g, w)) if a != b) if g else None)
              for i, (g, w) in enumerate(zip(got, ref)) if g != w]
    n = len(got)
    counters = rep["counters"]
    ok = (not errors and not hung and not parted and drained
          and counters["serve.requests"] == n
          and counters["serve.disconnects"] == 1
          and counters["serve.deadline_expired"] == 2
          and expired == {"admission": "DeadlineExpired", "mid_generation": "DeadlineExpired"}
          and rep["in_flight"] == 0 and rep["queue_depth"] == 0)
    tokens_per_s = n * REPLICA_NEW / wall
    out = dict(requests=n, tokens_per_s=tokens_per_s, requests_per_s=n / wall, wall_s=wall,
               latency_ms_p50=float(np.percentile(lat, 50)) * 1e3 if lat else None,
               latency_ms_p99=float(np.percentile(lat, 99)) * 1e3 if lat else None,
               engine_p50_ms=rep["p50_ms"], engine_p99_ms=rep["p99_ms"], ticks=ticks,
               counters=counters, verdict=rep["verdict"], expired=expired, shed=shed)
    print(f"serve: replica S=1 V=2 mb={SERVE_MB} max_queue={REPLICA_MAX_QUEUE}: "
          f"{REPLICA_CLIENTS} clients x {REPLICA_REQUESTS} requests x {REPLICA_NEW} tokens in "
          f"{wall:.3f} s: {tokens_per_s:.1f} tokens/s, {n / wall:.2f} requests/s (host clock, the "
          f"checks' requests sharing the card); client latency p50 {out['latency_ms_p50']:.2f} ms "
          f"p99 {out['latency_ms_p99']:.2f} ms; engine serve.latency p50 {rep['p50_ms']:.2f} ms p99 "
          f"{rep['p99_ms']:.2f} ms; {ticks} ticks; counters {counters}; verdict {rep['verdict']} "
          f"(slo {rep['slo_p99_ms']} ms) ({card})")
    print(f"serve: tokens equal sequential_reference on the card for {n - len(parted)}/{n} "
          f"requests{'' if not parted else f'; parted (request, position): {parted}'}; hung-up "
          f"client counted once: {counters['serve.disconnects'] == 1}; deadlines {expired}, "
          f"serve.deadline_expired {counters['serve.deadline_expired']}; drained: {drained}"
          f"{'; errors: ' + '; '.join(errors) if errors else ''}{'; hung: ' + str(hung) if hung else ''}")
    if not ok:
        raise SystemExit("serve: the replica check failed")
    return out


def tick_profile(params, card: str) -> dict:
    """Phase 10 (d): where one serving tick's time goes at (1, 2): an
    engine tick is one ``LMStream.submit`` of a full [8, 65] microbatch
    (two schedule ticks at S = 1, V = 2: the previous microbatch's second
    chunk, then this one's first; embed, head and the copy to the host).
    Its host ms (submits back to back; each ends in the host copy), device
    ms and kernels (torch.profiler over a few submits) and the idle share
    (1 - device / host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tfrecord_torch.models import lm
    from tpu_tfrecord_torch.serve_lm import make_config

    cfg = make_config(2)
    stream = lm.LMStream(params, cfg, 1, device=SERVE_DEVICE)
    toks = lm.make_synthetic_tokens(cfg, SERVE_MB, seed=5)
    for _ in range(10):
        stream.submit(toks)
    serve_sync()
    t0 = time.perf_counter()
    for _ in range(TICK_RATE_SUBMITS):
        stream.submit(toks)
    host_ms = (time.perf_counter() - t0) * 1e3 / TICK_RATE_SUBMITS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TICK_PROFILE_SUBMITS):
            stream.submit(toks)
        serve_sync()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / TICK_PROFILE_SUBMITS
    per_tick = len(kernels) / TICK_PROFILE_SUBMITS
    idle = 1 - dev_ms / host_ms if dev_ms > 0 else float("nan")
    print(f"serve: one engine tick at S=1 V=2 (one submit of [{SERVE_MB}, 65]: 2 schedule ticks, "
          f"embed, head, one host copy): {host_ms:.4f} ms host ({TICK_RATE_SUBMITS} back to back), "
          f"device {dev_ms:.4f} ms in {per_tick:.0f} kernels (torch.profiler, "
          f"{TICK_PROFILE_SUBMITS} submits{'' if dev_ms > 0 else ': no device time recorded, not measured'}); "
          f"idle share {idle:.4f} ({card})")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    return dict(host_ms=host_ms, device_ms=dev_ms, kernels=per_tick, idle_share=idle)


def replica_start() -> tuple:
    """Phase 10 (e)'s replica process, started (it imports and builds
    while (a) runs); ``replica_subprocess`` goes on with it."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    err = tempfile.TemporaryFile(mode="w+")  # a file, not a pipe: nothing reads it until the end
    proc = subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.serving", "--device",
                             SERVE_DEVICE], cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    proc.err_file = err
    ready: dict = {}
    reader = threading.Thread(target=lambda: ready.update(json.loads(proc.stdout.readline() or "{}")))
    reader.start()
    return proc, reader, ready, t0


def replica_subprocess(started: tuple, card: str) -> dict:
    """Phase 10 (e): ``python -m tpu_tfrecord_torch.serving --device
    <SERVE_DEVICE>`` (its synthetic seeded LM, started by
    ``replica_start``): the ready line, 4 requests answered with the tokens
    of the same seed's weights computed here, SIGTERM, exit 0 within 60 s."""
    import argparse
    import signal

    from tpu_tfrecord_torch import serving

    proc, reader, ready, t0 = started
    try:
        reader.join(timeout=SERVE_TIMEOUT_S)
        if "addr" not in ready:
            raise SystemExit(f"serve: the replica printed no ready line: {proc.poll()}")
        ready_s = time.perf_counter() - t0
        syn = argparse.Namespace(vocab=96, d_model=32, heads=2, layers=4, max_len=16, mb=4,
                                 virtual=1, seed=0)
        params, cfg = serving._build_synthetic(syn)
        rng = np.random.default_rng(3)
        ws = [rng.integers(0, 96, size=16).astype(np.int32) for _ in range(4)]
        cl = serving.ServeClient([ready["addr"]], timeout_s=60.0)
        try:
            got = [cl.generate(w, 4) for w in ws]
        finally:
            cl.close()
        want = serving.sequential_reference(params, cfg, 2, [(w, 4) for w in ws], 4,
                                            device=SERVE_DEVICE)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        exit_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.err_file.seek(0)
        err = proc.err_file.read()
        proc.err_file.close()
        proc.stdout.close()
    ok = rc == 0 and got == want
    print(f"serve: python -m tpu_tfrecord_torch.serving --device {SERVE_DEVICE}: ready in "
          f"{ready_s:.1f} s (started beside (a)); 4 requests equal to the reference: "
          f"{got == want}; SIGTERM -> exit {rc} in {exit_s:.2f} s (limit 60 s)")
    if not ok:
        raise SystemExit(f"serve: the replica subprocess failed: {err[-3000:]}")
    return dict(ready_s=ready_s, exit_s=exit_s, rc=rc)


def serve_path(work: str, card: str) -> dict:
    """Phase 10: LM serving on ``card`` (nvidia-smi's name and power limit),
    under deterministic algorithms (cuBLAS workspace ``:4096:8``)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    started = replica_start()  # (e)'s process imports and builds beside (a)
    try:
        try:
            step, params = serve_checkpoint(work)
            out = {"subprocess": replica_subprocess(started, card)}
        finally:
            if started[0].poll() is None:  # (a) failed: (e) never ran
                started[0].kill()
                started[0].wait(timeout=30)
        out["one_shot"] = serve_one_shot(params, step, card)
        out["replica"] = replica_path(params, card)
        out["tick"] = tick_profile(params, card)
    finally:
        torch.use_deterministic_algorithms(False)
    out["card"] = card
    print("serve: " + json.dumps(out, default=float))
    return out

# -- phase 11: Mixture-of-Experts on one card -----------------------------------------------

MOE_DEVICE = "cuda"
MOE_EXPERTS = 4
MOE_TOKENS = (32, 64)                 # the LM twin's B x L: T = 2048 tokens a layer
MOE_CASES = {                         # (top_k, capacity factor, share of tokens masked out)
    "top2": (2, 1.25, 0.0),
    "top1": (1, 1.25, 0.0),
    "top2_drop": (2, 0.25, 0.0),
    "top2_valid": (2, 1.25, 0.25),
}
MOE_ATOL = 1e-4                       # f32, TF32 off: the card against the CPU
MOE_PARITY_STEPS = 16
MOE_DRILL_STEPS = 32
MOE_DRILL_SAVE_EVERY = 8
MOE_DRILL_KILL_AT = 12
MOE_DRILL_RESUMED_AT = 8


def moe_layer_run(moe, cfg, params, x, cot, valid, device) -> dict:
    """One ``moe_apply`` forward and backward on ``device`` (float32): y,
    aux, the diagnostics, the gradients of x and the three weights, and
    the routing (each rank's expert and slot, kept or not) with the
    router probabilities."""
    p = {k: v.detach().to(device).clone().requires_grad_(True) for k, v in params.items()}
    xx = torch.tensor(x, device=device, requires_grad=True)
    v = None if valid is None else torch.from_numpy(valid).to(device)
    y, aux, diag = moe.moe_apply(p, xx, cfg, valid=v, diagnostics=True)
    (torch.sum(y * torch.from_numpy(cot).to(device)) + aux).backward()
    with torch.no_grad():
        xt = xx.detach().reshape(-1, cfg.d_model)
        probs = moe._router_probs(p, xt)
        r = moe._route(probs, cfg, moe._capacity(xt.shape[0], cfg),
                       None if v is None else v.reshape(-1))
    return dict(y=y.detach().cpu(), aux=float(aux), diag={k: t.cpu() for k, t in diag.items()},
                grads=[xx.grad.cpu()] + [p[k].grad.cpu() for k in ("router", "w_in", "w_out")],
                route=[t.cpu() for t in (r.expert, r.slot, r.kept)], probs=probs.cpu())


def moe_layer_parity() -> dict:
    """Phase 11 (a): ``moe_apply`` at T = 2048 (d_model 64, d_ff 256, 4
    experts) on the card against the CPU at top_k 2, top_k 1, a capacity
    factor of 0.25 and a quarter of the tokens masked out: y and aux within
    ``MOE_ATOL``, the routing and the diagnostics' counts equal, the
    gradients of x and the three weights within ``MOE_ATOL`` times their
    largest magnitude (at least 1). The smallest probability margin between
    a token's chosen expert and the next one says how close a tie came."""
    from tpu_tfrecord_torch.models import moe

    rng = np.random.default_rng(11)
    x = rng.normal(size=MOE_TOKENS + (64,)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    mask = rng.random(MOE_TOKENS) >= 0.25
    out = {}
    for name, (top_k, cf, pad) in MOE_CASES.items():
        cfg = moe.MoEConfig(d_model=64, d_ff=256, n_experts=MOE_EXPERTS, capacity_factor=cf,
                            top_k=top_k)
        params = moe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        valid = mask if pad else None
        cpu = moe_layer_run(moe, cfg, params, x, cot, valid, "cpu")
        card = moe_layer_run(moe, cfg, params, x, cot, valid, MOE_DEVICE)
        y_err = float((card["y"] - cpu["y"]).abs().max())
        aux_err = abs(card["aux"] - cpu["aux"])
        routing = all(torch.equal(a, b) for a, b in zip(card["route"], cpu["route"]))
        counts = all(torch.equal(card["diag"][k], cpu["diag"][k]) for k in ("expert_tokens", "expert_kept"))
        grad_errs = [float((g - h).abs().max()) for g, h in zip(card["grads"], cpu["grads"])]
        grad_scales = [max(1.0, float(h.abs().max())) for h in cpu["grads"]]
        grads_ok = all(e <= MOE_ATOL * s for e, s in zip(grad_errs, grad_scales))
        top = torch.sort(cpu["probs"], dim=-1, descending=True).values
        keep = torch.ones(top.shape[0], dtype=torch.bool) if valid is None else torch.from_numpy(valid.reshape(-1))
        margin = float(min((top[keep, r] - top[keep, r + 1]).min() for r in range(top_k)))
        ok = y_err <= MOE_ATOL and aux_err <= MOE_ATOL and routing and counts and grads_ok \
            and bool(torch.isfinite(card["y"]).all())
        kept = card["diag"]["expert_kept"].tolist()
        print(f"moe: moe_apply {name} (top_k {top_k}, capacity factor {cf}, "
              f"{'a quarter masked' if pad else 'no mask'}; T=2048, C={moe._capacity(2048, cfg)}): "
              f"y max abs err {y_err:.3e}, aux {aux_err:.3e} (atol {MOE_ATOL}); routing equal "
              f"{routing}, counts equal {counts} (kept {kept}, dropped fraction "
              f"{float(card['diag']['dropped_fraction']):.4f}); grad errs x/router/w_in/w_out "
              f"{['%.3e' % e for e in grad_errs]} (scales {['%.2f' % s for s in grad_scales]}); "
              f"smallest top-{top_k} probability margin {margin:.3e}: {ok}")
        if not ok:
            raise SystemExit(f"moe: moe_apply {name} disagrees between the card and the CPU")
        out[name] = dict(y_err=y_err, aux_err=aux_err, grad_errs=grad_errs, margin=margin,
                         kept=kept)
    return out


def moe_lm_parity(data_dir: str) -> dict:
    """Phase 11 (b): the MoE LM of ``train_lm --moe 4`` (vocab 256, d_model
    64, 4 heads, 2 layers, L = 64, 4 experts top-2, f32) with one set of
    weights on the card and on the CPU: the first packed batch's logits
    within ``MOE_ATOL``, then 16 Adam steps in lockstep (before each step the
    CPU takes the card's parameters and Adam moments) with losses within a
    relative ``SEQ_LOSS_RTOL`` and each step's ``expert_tokens`` and
    ``expert_kept`` equal. The same 16 steps run free on both sides are
    printed beside, not gated: a top-k router's choices are discontinuous,
    so the two trajectories part once rounding flips a near tie."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.models import lm, optim

    cfg = tw.make_config(2, MOE_EXPERTS)
    batches, _ = packed_batches(data_dir, "slice", MOE_PARITY_STEPS)
    toks = [torch.from_numpy(b["tokens"]) for b in batches]
    host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_to(host, MOE_DEVICE)
    with torch.no_grad():
        want, want_aux, want_diag = lm.forward(host, toks[0], cfg, diagnostics=True)
        got, got_aux, got_diag = lm.forward(card, toks[0].to(MOE_DEVICE), cfg, diagnostics=True)
    err = float((got.cpu() - want).abs().max())
    first_counts = all(torch.equal(got_diag[k].cpu(), want_diag[k]) for k in ("expert_tokens", "expert_kept"))
    runs = {}
    for mode in ("lockstep", "free"):
        h, c = tree_to(host, "cpu"), tree_to(host, MOE_DEVICE)
        ho, co = optim.adam(h, tw.LR), optim.adam(c, tw.LR)
        rels, equal = [], []
        for t in toks:
            if mode == "lockstep":
                optim.load_train_state(h, ho, optim.train_state(c, co))
            lh, dh = lm.train_step(h, ho, t, cfg, diagnostics=True)
            lc, dc = lm.train_step(c, co, t.to(MOE_DEVICE), cfg, diagnostics=True)
            rels.append(abs(float(lc) - float(lh)) / abs(float(lh)))
            equal.append(all(torch.equal(dc[k].cpu(), dh[k]) for k in ("expert_tokens", "expert_kept")))
        runs[mode] = dict(max_rel=max(rels), equal_steps=sum(equal), last_loss=float(lc),
                          last_drop=float(dc["dropped_fraction"]))
    lock = runs["lockstep"]
    ok = err <= MOE_ATOL and first_counts and lock["max_rel"] <= SEQ_LOSS_RTOL \
        and lock["equal_steps"] == len(toks) and np.isfinite(lock["last_loss"])
    print(f"moe: MoE LM parity (train_lm --moe {MOE_EXPERTS} width, [32, 65] slice batches): logits "
          f"max abs err {err:.3e} (atol {MOE_ATOL}), aux {float(got_aux):.6f} vs {float(want_aux):.6f}, "
          f"counts equal {first_counts}; {len(toks)} Adam steps in lockstep: max loss rel diff "
          f"{lock['max_rel']:.3e} (rtol {SEQ_LOSS_RTOL}), expert_tokens/expert_kept equal on "
          f"{lock['equal_steps']}/{len(toks)} steps, last loss {lock['last_loss']:.6f}, dropped "
          f"fraction {lock['last_drop']:.4f}: {ok}")
    print(f"moe: the same {len(toks)} steps run free on both sides (not gated): max loss rel diff "
          f"{runs['free']['max_rel']:.3e}, counts equal on {runs['free']['equal_steps']}/{len(toks)} "
          "steps")
    if not ok:
        raise SystemExit("moe: the MoE LM disagrees between the card and the CPU")
    return dict(logits_err=err, **{f"{m}_{k}": v for m, r in runs.items() for k, v in r.items()})


def moe_twins(work: str, lm_data: str, ld_data: str) -> dict:
    """Phase 11 (c) and (d): ``train_lm --moe 4 --diagnostics --trace-out``
    for 32 steps saving every 8, uninterrupted, and again killed with
    SIGKILL after step 12 and rerun: it must resume at step 8 with the
    uninterrupted run's digests for steps 9-32 and its losses (bit-equal,
    or within a relative ``SEQ_LOSS_RTOL``: the line says which), print
    finite ``moe.*`` gauges and write its trace. Beside them,
    ``LONGDOC_MOE_EXPERTS=4 train_longdoc`` whole: finite losses, the phase
    shares and the verdict. The uninterrupted run, the killed run and
    train_longdoc run at once (three processes on the card)."""
    import signal

    common = ["--data-dir", lm_data, "--steps", str(MOE_DRILL_STEPS), "--save-every",
              str(MOE_DRILL_SAVE_EVERY), "--moe", str(MOE_EXPERTS), "--diagnostics"]

    def lm_run(name, ckpt, kill=None):
        return run_twin("tpu_tfrecord_torch.train_lm", common + [
            "--ckpt-dir", os.path.join(work, ckpt),
            "--digest-out", os.path.join(work, f"moe_{name}.jsonl"),
            "--trace-out", os.path.join(work, f"moe_{name}_trace.json")],
            work, f"moe_{name}.err", kill, device=MOE_DEVICE)

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ref_f = pool.submit(lm_run, "uninterrupted", "moe_ckpt_ref")
        kill_f = pool.submit(lm_run, "killed", "moe_ckpt", MOE_DRILL_KILL_AT)
        ld_f = pool.submit(run_twin, "tpu_tfrecord_torch.train_longdoc",
                           ["--data-dir", ld_data, "--ckpt-dir", os.path.join(work, "moe_ld_ckpt")],
                           work, "moe_longdoc.err", None, MOE_DEVICE, {"LONGDOC_MOE_EXPERTS": "4"})
        runs = {"uninterrupted": ref_f.result(), "killed": kill_f.result()}
        ld = ld_f.result()
    runs["resumed"] = lm_run("resumed", "moe_ckpt")
    for name, (rc, lines, err) in runs.items():
        want_rc = -signal.SIGKILL if name == "killed" else 0
        if rc != want_rc:
            raise SystemExit(f"moe: train_lm --moe {name} run ended with {rc}: {err[-3000:]}")
        head = [ln for _, ln in lines if not ln.startswith("lm_step")]
        print(f"moe: train_lm --moe {MOE_EXPERTS} --diagnostics {name}: " + " | ".join(head))
    ref, res = lm_steps(runs["uninterrupted"][1]), lm_steps(runs["resumed"][1])
    first = [ln for _, ln in runs["resumed"][1]][:3]
    resumed_at = f"resumed at step {MOE_DRILL_RESUMED_AT}" in first
    later = range(MOE_DRILL_RESUMED_AT + 1, MOE_DRILL_STEPS + 1)
    digests = sorted(res) == list(later) and all(res[s]["digest"] == ref[s]["digest"] for s in later)
    bit_equal = digests and all(res[s]["loss"] == ref[s]["loss"] for s in later)
    rel = max(abs(float(res[s]["loss"]) - float(ref[s]["loss"])) / abs(float(ref[s]["loss"]))
              for s in later) if digests else float("inf")
    determinism = "bit-equal" if bit_equal else f"within a relative {SEQ_LOSS_RTOL} (max {rel:.3e})"
    gauges = {}
    traces = {}
    for name in ("uninterrupted", "resumed"):
        line = [ln for _, ln in runs[name][1] if ln.startswith("model diagnostics: ")]
        gauges[name] = json.loads(line[-1].split(": ", 1)[1]) if line else {}
        path = os.path.join(work, f"moe_{name}_trace.json")
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        traces[name] = sum(1 for e in events if e.get("name") == "train.step")
    losses = [float(ref[s]["loss"]) for s in sorted(ref)]
    gauges_ok = all(sorted(g) == ["moe.dropped_fraction", "moe.expert_imbalance", "moe.gate_entropy"]
                    and all(np.isfinite(v) for v in g.values()) for g in gauges.values())
    ok = resumed_at and digests and (bit_equal or rel <= SEQ_LOSS_RTOL) and gauges_ok \
        and np.isfinite(losses).all() and traces["uninterrupted"] == MOE_DRILL_STEPS \
        and traces["resumed"] == MOE_DRILL_STEPS - MOE_DRILL_RESUMED_AT
    print(f"moe: train_lm --moe drill: {first[:3]}; resumed at step {MOE_DRILL_RESUMED_AT}: "
          f"{resumed_at}; digests of steps {later[0]}-{later[-1]} equal the uninterrupted run's: "
          f"{digests}; losses {determinism}; losses {losses[0]:.4f} -> {losses[-1]:.4f}; moe gauges "
          f"{gauges}; train.step spans in the traces {traces}: {ok}")
    if not ok:
        raise SystemExit("moe: the train_lm --moe kill drill did not continue the uninterrupted run")
    rc, lines, err = ld
    text = [ln for _, ln in lines]
    print("moe: LONGDOC_MOE_EXPERTS=4 train_longdoc: " + " | ".join(text))
    ld_losses = [float(ln.split("~")[1]) for ln in text if ln.startswith("step ")]
    phases = [ln for ln in text if ln.startswith("train phases:")]
    if rc != 0 or not ld_losses or not np.isfinite(ld_losses).all() or not phases \
            or not any(ln.startswith("done: 32 steps") for ln in text):
        raise SystemExit(f"moe: train_longdoc with MoE failed ({rc}): {err[-3000:]}")
    return dict(determinism=determinism, loss_rel=rel, first_loss=losses[0], last_loss=losses[-1],
                gauges=gauges, longdoc_losses=ld_losses, longdoc_phases=phases[0])


def moe_longdoc_parity(data_dir: str) -> dict:
    """Phase 11 (d): the MoE long_doc (4 experts, top 1, routed over the
    valid prefix) on the twin's first batch, card against CPU: bf16 logits
    within 2e-2, float32 within 1e-4."""
    from tpu_tfrecord_torch import train_longdoc as tw
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.models import long_doc

    ds = TFRecordDataset(data_dir, batch_size=tw.BATCH, schema=tw.make_schema(),
                         recordType="SequenceExample", shuffle=True, seed=0)
    with ds.batches() as it:
        cb = next(it)
    hb = tw.host_batch(cb, ds.schema)
    f32 = host_batch_from_columnar(cb, ds.schema, pad_to={"frames": (tw.MAX_LEN, tw.SEQ_DIM)})
    out = {}
    for dtype, frames in ((torch.bfloat16, hb["frames"]), (torch.float32, torch.from_numpy(f32["frames"]))):
        cfg = dataclasses.replace(tw.make_config(), moe_experts=MOE_EXPERTS, dtype=dtype)
        host = long_doc.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = tree_to(host, MOE_DEVICE)
        batch = {"frames": frames, "frames_len": torch.from_numpy(f32["frames_len"]),
                 "label": torch.from_numpy(f32["label"])}
        with torch.no_grad():
            want, want_aux = long_doc.forward(host, batch, cfg, with_aux=True)
            got, got_aux = long_doc.forward(card, {k: v.to(MOE_DEVICE) for k, v in batch.items()},
                                            cfg, with_aux=True)
        err = float((got.cpu() - want).abs().max())
        tol = LONGDOC_TOL[dtype]
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"moe: MoE long_doc logits [64, 2] {dtype} (T=4096, C=1280, top 1), card against the "
              f"CPU: max abs err {err:.3e} (tol {tol}); aux {float(got_aux):.6f} vs "
              f"{float(want_aux):.6f}: {ok}")
        if not ok:
            raise SystemExit(f"moe: MoE long_doc card/CPU parity failed in {dtype}")
        out[str(dtype).replace("torch.", "")] = err
    return out


def moe_rates(card: str) -> dict:
    """Phase 11 (e), beside ``card`` (nvidia-smi's name and power limit):
    the MoE LM train step and phase 9's dense step on a resident batch
    (host ms, device ms and kernels a step, idle share), and ``moe_apply``'s
    forward at T = 2048, under the default algorithms as in phase 9."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.models import lm, moe, optim

    print(f"moe: rates on {card}")
    out = {}
    for name, experts in (("moe", MOE_EXPERTS), ("dense", 0)):
        cfg = tw.make_config(2, experts)
        params = lm.init_params(cfg, torch.Generator(device=MOE_DEVICE).manual_seed(0), MOE_DEVICE)
        opt = optim.adam(params, tw.LR)
        toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, 32, seed=0)).to(MOE_DEVICE)
        label = (f"MoE LM train step ({experts} experts, top 2)" if experts else "dense LM train step")
        out[name] = step_rate(f"{label}, B=32 L=64 d=64 (make_synthetic_tokens)",
                              lambda: lm.train_step(params, opt, toks, cfg), 32 * 64)
    cfg = moe.MoEConfig(d_model=64, d_ff=256, n_experts=MOE_EXPERTS, top_k=2)
    params = moe.init_params(cfg, torch.Generator(device=MOE_DEVICE).manual_seed(0), MOE_DEVICE)
    x = torch.randn(MOE_TOKENS + (64,), generator=torch.Generator(device=MOE_DEVICE).manual_seed(1),
                    device=MOE_DEVICE)
    with torch.no_grad():
        out["moe_apply_forward"] = step_rate("moe_apply forward, T=2048 d=64 d_ff=256 4 experts top 2",
                                             lambda: moe.moe_apply(params, x, cfg), 2048)
    return out


def moe_path(work: str, card: str) -> dict:
    """Phase 11: the Mixture-of-Experts models on ``card`` (nvidia-smi's
    name and power limit), the parities and twins under deterministic
    algorithms (cuBLAS workspace ``:4096:8``), the rates under the default
    ones. Uses phase 9's SequenceExamples under ``work`` (written again
    when absent)."""
    from tpu_tfrecord_torch import train_lm, train_longdoc

    lm_data, ld_data = os.path.join(work, "lm_data"), os.path.join(work, "ld_data")
    train_lm.generate(lm_data)
    train_longdoc.generate(ld_data)
    t0 = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        out = {"moe_apply": moe_layer_parity(), "lm_parity": moe_lm_parity(lm_data),
               "long_doc_parity": moe_longdoc_parity(ld_data)}
        out["twins"] = moe_twins(work, lm_data, ld_data)
    finally:
        torch.use_deterministic_algorithms(False)
    out["rates"] = moe_rates(card)  # default algorithms, as phase 9 times its steps
    out["card"] = card
    out["seconds"] = time.perf_counter() - t0
    print(f"moe: phase 11 took {out['seconds']:.1f} s")
    print("moe: " + json.dumps(out, default=float))
    return out


# -- phase 12: the rest of the decode pool ---------------------------------------------

READPOOL_SHARDS = 4
READPOOL_ROWS = 262_144        # a shard: 16 batches, well past the readahead window
READPOOL_COLD_WORKERS = 2
READPOOL_READAHEAD = 64 << 20  # the JAX default window
READPOOL_GUARD_MS = 60_000     # deadlines and watchdog that never fire
READPOOL_PULSE_S = 0.25
READPOOL_DEVICE = "cuda"
READPOOL_WRITE_WORKERS = 4
DRILL_STALL_MS = 3_000
# filesystems that keep a file's pages in memory whatever fadvise says
MEMORY_FS = ("tmpfs", "ramfs", "overlay", "devtmpfs", "squashfs")
BLOCK_FS = ("ext2", "ext3", "ext4", "xfs", "btrfs", "f2fs", "zfs")


def mount_of(path: str) -> tuple:
    """(mount point, filesystem type) of the mount that holds ``path``."""
    path = os.path.realpath(path)
    best, best_len = ("/", "unknown"), -1
    with open("/proc/mounts") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            inside = path == mnt or path.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) > best_len:
                best, best_len = (mnt, parts[2]), len(mnt)
    return best


def readpool_dir(work: str) -> tuple:
    """Where phase 12's shards go: the temp dir ``work`` unless its
    filesystem keeps files in memory (tmpfs, overlay), else the
    checkout's ``_scratch/`` (ignored by git). Whether a dropped shard is
    read cold there is measured after the drop (``resident_fraction``).
    Returns (dir, mount point, fstype)."""
    with open("/proc/mounts") as fh:
        block = sorted({f"{p[1]} ({p[2]})" for p in (line.split() for line in fh)
                        if len(p) > 2 and p[2] in BLOCK_FS})
    print(f"readpool: block-device filesystems mounted on this machine: {block or 'none'}")
    repo = os.path.dirname(os.path.abspath(__file__))
    candidates = [os.path.join(work, "readpool"), os.path.join(repo, "_scratch", "readpool")]
    for d in candidates:
        mnt, fstype = mount_of(d)
        print(f"readpool: {d} lies on {mnt}, filesystem {fstype}")
        if fstype not in MEMORY_FS:
            break
    os.makedirs(d, exist_ok=True)
    return d, mnt, fstype


def resident_fraction(files) -> float:
    """The share of the shards' pages in this kernel's page cache
    (``mincore`` over a read-only map of each file)."""
    import ctypes
    import mmap

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    page = os.sysconf("SC_PAGE_SIZE")
    resident = total = 0
    for path in files:
        size = os.path.getsize(path)
        fd = os.open(path, os.O_RDONLY)
        try:
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
            if addr is None or addr == ctypes.c_void_p(-1).value:
                raise OSError(ctypes.get_errno(), f"mmap of {path}")
            try:
                vec = np.zeros((size + page - 1) // page, np.uint8)
                if libc.mincore(addr, size, vec.ctypes.data) != 0:
                    raise OSError(ctypes.get_errno(), f"mincore of {path}")
            finally:
                libc.munmap(addr, size)
        finally:
            os.close(fd)
        resident += int((vec & 1).sum())
        total += len(vec)
    return resident / max(total, 1)


def readpool_batches(shard: int):
    """One shard's rows as ColumnarBatches of BATCH rows: phase 4's rows
    (``criteo_shard_rows``: int64 label 0/1, 13 ints below 2^31, 26 strings
    of 8 letters a-p), drawn as arrays of the same shapes from a seed."""
    from tpu_tfrecord_torch.columnar import Column, ColumnarBatch

    schema = criteo_write_schema()
    rng = np.random.default_rng((12, shard))
    n = READPOOL_ROWS
    ints = rng.integers(0, 1 << 31, size=(n, 13))
    labels = rng.integers(0, 2, size=n)
    cats = rng.integers(0, 16, size=(n, 26, 8), dtype=np.uint8) + 97
    offsets = np.arange(BATCH + 1, dtype=np.int64) * 8
    for lo in range(0, n, BATCH):
        hi = min(n, lo + BATCH)
        cols = {"label": Column("label", schema["label"].data_type,
                                values=labels[lo:hi].astype(np.int64))}
        for i in range(1, 14):
            cols[f"I{i}"] = Column(f"I{i}", schema[f"I{i}"].data_type,
                                   values=np.ascontiguousarray(ints[lo:hi, i - 1], np.int64))
        for i in range(1, 27):
            cols[f"C{i}"] = Column(f"C{i}", schema[f"C{i}"].data_type,
                                   blob=cats[lo:hi, i - 1, :].tobytes(),
                                   blob_offsets=offsets[:hi - lo + 1])
        yield ColumnarBatch(cols, hi - lo)


def write_readpool(root: str) -> tuple:
    """Phase 12 (a): READPOOL_SHARDS shards of READPOOL_ROWS rows, one dir
    each, through ``DatasetWriter.write_batches``. Returns (dirs, files)."""
    from tpu_tfrecord_torch.io.writer import DatasetWriter
    from tpu_tfrecord_torch.options import TFRecordOptions

    dirs, files = [], []
    t0 = time.perf_counter()
    for s in range(READPOOL_SHARDS):
        d = os.path.join(root, f"shard{s:02d}")
        opts = TFRecordOptions.from_map(write_workers=READPOOL_WRITE_WORKERS)
        DatasetWriter(d, criteo_write_schema(), opts, mode="overwrite").write_batches(
            readpool_batches(s))
        names = [n for n in os.listdir(d) if n.startswith("part-")]
        if len(names) != 1:
            raise SystemExit(f"readpool: {d} holds {names}, want one shard file")
        dirs.append(d)
        files.append(os.path.join(d, names[0]))
    secs = time.perf_counter() - t0
    sizes = [os.path.getsize(f) for f in files]
    rows = READPOOL_SHARDS * READPOOL_ROWS
    print(f"readpool: wrote {READPOOL_SHARDS} x {READPOOL_ROWS} Example rows = {sum(sizes)} bytes "
          f"({min(sizes)}-{max(sizes)} a shard, {sum(sizes) / rows:.1f} bytes a row) in "
          f"{secs:.2f} s (write_batches, {READPOOL_WRITE_WORKERS} workers, host)")
    if min(sizes) <= READPOOL_READAHEAD and READPOOL_ROWS >= 262_144:
        raise SystemExit("readpool: a shard is smaller than the readahead window")
    return dirs, files


def drop_page_cache(files) -> None:
    """Evict the shards from the page cache as bench.py does: fsync (dirty
    pages are skipped by DONTNEED), then POSIX_FADV_DONTNEED."""
    for path in files:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def raw_disk_mbps(files) -> float:
    """Serial cold read of the shards in 8 MB blocks with no hints, as
    bench.py measures the store: the bound the cold passes read against."""
    drop_page_cache(files)
    buf = bytearray(8 << 20)
    nb = 0
    t0 = time.perf_counter()
    for path in files:
        with open(path, "rb", buffering=0) as fh:
            while True:
                k = fh.readinto(buf)
                if not k:
                    break
                nb += k
    return nb / (time.perf_counter() - t0) / 1e6


def readpool_pass(dirs, **kw) -> tuple:
    """One decode-only pass (no scoring) over the shards: (the batches'
    digests, rows, wall s, CPU s, major faults). Each batch is digested
    as it arrives, while the pool decodes ahead, and dropped."""
    import resource

    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    kw.setdefault("num_workers", READPOOL_COLD_WORKERS)
    ds = TFRecordDataset(dirs, BATCH, **criteo_read_kw(), **kw)
    digests, rows = [], 0
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    with ds.batches() as it:
        for cb in it:
            digests.append(batch_digest(cb))
            rows += cb.num_rows
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
    return digests, rows, wall, cpu, r1.ru_majflt - r0.ru_majflt


def cold_passes(dirs, files) -> tuple:
    """Phase 12 (b): the serial disk rate, a warm pass (the reference
    digests), then four passes at READPOOL_COLD_WORKERS workers, {mmap,
    stream} x readahead {0, 64 MiB}, each after dropping the shards from
    the page cache, with the share of their pages still resident after
    the drop; every pass's digests must equal the warm one's."""
    nbytes = sum(os.path.getsize(f) for f in files)
    rows_total = READPOOL_SHARDS * READPOOL_ROWS
    disk = raw_disk_mbps(files)
    disk_rows = disk * 1e6 / (nbytes / rows_total)
    print(f"readpool: serial read (8 MB blocks, no hints, after DONTNEED): {disk:.1f} MB/s "
          f"= {disk_rows:.1f} rows/s at {nbytes / rows_total:.1f} bytes a row")
    warm, rows, wall, cpu, majflt = readpool_pass(dirs)
    if rows != rows_total:
        raise SystemExit(f"readpool: the warm pass read {rows} rows, want {rows_total}")
    print(f"readpool: warm pass (mmap, readahead 64 MiB, {READPOOL_COLD_WORKERS} workers): "
          f"{rows / wall:.1f} rows/s, {nbytes / wall / 1e6:.1f} MB/s, CPU {cpu:.3f} s over wall "
          f"{wall:.3f} s, majflt {majflt}")
    out = {"disk_mbps": disk, "disk_rows_per_s": disk_rows, "warm_rows_per_s": rows / wall,
           "bytes": nbytes}
    for route, use_mmap in (("mmap", True), ("stream", False)):
        for ra in (0, READPOOL_READAHEAD):
            before = resident_fraction(files)
            drop_page_cache(files)
            left = resident_fraction(files)
            digests, rows, wall, cpu, majflt = readpool_pass(dirs, use_mmap=use_mmap,
                                                             readahead_bytes=ra)
            label = f"{route}, readahead {ra >> 20} MiB"
            rate = rows / wall
            print(f"readpool: pass after the drop ({label}, {READPOOL_COLD_WORKERS} workers): "
                  f"{rate:.1f} rows/s, {nbytes / wall / 1e6:.1f} MB/s, majflt {majflt}, CPU "
                  f"{cpu:.3f} s over wall {wall:.3f} s, {rate / disk_rows:.3f} of the serial read's "
                  f"rate; pages resident {before:.4f} before the drop, {left:.4f} after it"
                  f"{'' if left < 0.01 else ' (not a cold read)'}; digests equal the warm "
                  f"pass's: {digests == warm}")
            if digests != warm:
                raise SystemExit(f"readpool: the pass ({label}) read other batches")
            out[f"{route}_ra{ra >> 20}"] = dict(rows_per_s=rate, mb_per_s=nbytes / wall / 1e6,
                                               majflt=majflt, cpu_s=cpu, wall_s=wall,
                                               of_serial_read=rate / disk_rows,
                                               resident_after_drop=left)
    return warm, out


def pool_depth_probe(dirs, warm) -> dict:
    """Warm decode-only rows/s at 1, 2 and 4 workers with each shard's
    queue at the JAX depth of 2 chunks and at 16: the pool emits shards in
    order, so at depth 2 a worker can run only 2 chunks ahead of the
    shard being drained, and a shard of 16 chunks keeps the others idle."""
    from tpu_tfrecord_torch.io import dataset as dataset_mod

    default = dataset_mod.SHARD_QUEUE_CHUNKS
    out = {}
    try:
        for depth in (default, 16):
            dataset_mod.SHARD_QUEUE_CHUNKS = depth
            for workers in (1, 2, 4):
                digests, rows, wall, cpu, _ = readpool_pass(dirs, num_workers=workers)
                if digests != warm:
                    raise SystemExit(f"readpool: depth {depth}, {workers} workers: other batches")
                out[f"depth{depth}_w{workers}"] = rows / wall
                print(f"readpool: pool depth probe: {depth} chunks a shard queue, {workers} "
                      f"workers: {rows / wall:.1f} rows/s, CPU {cpu:.3f} s over wall {wall:.3f} s")
    finally:
        dataset_mod.SHARD_QUEUE_CHUNKS = default
    return out


def host_loop_rate(dirs, **kw) -> float:
    """Rows/s of the warm host loop: the dataset at 2 workers and the
    densify of every batch (``host_batch_from_columnar``), no device."""
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(dirs, BATCH, num_workers=2, **criteo_read_kw(), **kw)
    n = 0
    t0 = time.perf_counter()
    with ds.batches() as it:
        for cb in it:
            host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
            n += cb.num_rows
    return n / (time.perf_counter() - t0)


def guard_overhead(dirs) -> dict:
    """Phase 12 (c): the warm host loop with read and open deadlines and
    the watchdog at READPOOL_GUARD_MS (they never fire) against the same
    loop without them, A/B/B/A, best of each (bench.py's probe), with each
    A/B pair's ratio."""
    guarded = dict(read_deadline_ms=READPOOL_GUARD_MS, open_deadline_ms=READPOOL_GUARD_MS,
                   watchdog_timeout_ms=READPOOL_GUARD_MS)
    base, guard = [], []
    for kw in ({}, guarded, guarded, {}):
        (guard if kw else base).append(host_loop_rate(dirs, **kw))
    pct = (1.0 - max(guard) / max(base)) * 100.0
    pairs = [round((1.0 - g / b) * 100.0, 2) for b, g in zip(base, guard)]
    print(f"readpool: stall guard's cost with no fault (warm host loop, 2 workers, A/B/B/A): "
          f"without {[round(r, 1) for r in base]} rows/s, with {[round(r, 1) for r in guard]}; "
          f"best {max(base):.1f} vs {max(guard):.1f}: overhead {pct:.2f} % (pairs {pairs} %)")
    return dict(base=base, guarded=guard, overhead_pct=pct, pair_pct=pairs)


def drill(label, dirs, rule: dict, **kw) -> tuple:
    """One read under a one-rule FaultPlan on the real shards: (digests,
    wall s, counters, error). The plan is released at the end."""
    from tpu_tfrecord_torch import faults
    from tpu_tfrecord_torch.metrics import METRICS

    METRICS.reset()
    plan = faults.FaultPlan([faults.FaultRule(**rule)])
    digests, wall, error = [], None, None
    t0 = time.perf_counter()
    try:
        with faults.install_chaos(plan):
            digests, _, wall, _, _ = readpool_pass(dirs, **kw)
    except Exception as e:  # the raise drill's expected error, checked by the caller
        error = e
        wall = time.perf_counter() - t0
    finally:
        plan.release()
    names = ("read.retries", "read.stalls", "read.deadline_misses", "read.hedges",
             "read.hedge_wins", "read.watchdog_restarts", "read.skipped_shards")
    counters = {n: METRICS.counter(n) for n in names}
    print(f"readpool: drill {label}: {len(digests)} batches in {wall:.3f} s, counters {counters}, "
          f"ledger {plan.ledger}, error {type(error).__name__ if error else None}")
    return digests, wall, counters, error


def stall_drills(dirs, warm) -> dict:
    """Phase 12 (d): a stalled read beaten by a hedge, a stalled open
    retried past its deadline, and a wedged worker failed by the watchdog
    (skipped, then raised)."""
    from tpu_tfrecord_torch.stall import WatchdogError

    victim = os.path.join(dirs[1], "")  # substring of shard 1's file path only
    per = READPOOL_ROWS // BATCH
    out = {}
    d, _, c, e = drill("1 (hedge)", dirs, dict(op="read", kind="stall", path=victim, ordinal=0,
                                               times=1, stall_ms=DRILL_STALL_MS),
                       use_mmap=False, hedge_after_ms=50, read_deadline_ms=1000)
    if e is not None or d != warm or c["read.hedge_wins"] < 1 or c["read.stalls"]:
        raise SystemExit(f"readpool: the hedge drill failed: equal {d == warm}, {c}, {e!r}")
    out["hedge"] = c
    d, _, c, e = drill("2 (open deadline)", dirs, dict(op="open", kind="stall", path=victim,
                                                       ordinal=0, times=1,
                                                       stall_ms=DRILL_STALL_MS),
                       open_deadline_ms=200, read_retries=2)
    if e is not None or d != warm or c["read.retries"] < 1:
        raise SystemExit(f"readpool: the open-deadline drill failed: equal {d == warm}, {c}, {e!r}")
    out["open_deadline"] = c
    base = readpool_pass(dirs, use_mmap=False, num_workers=4)
    base_d, base_wall = base[0], base[2]
    if base_d != warm:
        raise SystemExit("readpool: the stream route at 4 workers read other batches")
    rule = dict(op="read", kind="stall", path=victim, ordinal=0, times=1, stall_ms=DRILL_STALL_MS)
    wd = dict(use_mmap=False, num_workers=4, watchdog_timeout_ms=500)
    d, wall, c, e = drill("3 (watchdog, skip_shard)", dirs, rule, on_stall="skip_shard", **wd)
    want = warm[:per] + warm[2 * per:]
    print(f"readpool: watchdog drill lost {wall - base_wall:.3f} s against the fault-free read "
          f"at 4 workers ({base_wall:.3f} s); the other shards' batches equal: {d == want}")
    if (e is not None or d != want or c["read.watchdog_restarts"] != 1
            or c["read.skipped_shards"] != 1):
        raise SystemExit(f"readpool: the watchdog drill failed: {c}, {e!r}")
    out["watchdog"] = dict(c, lost_s=wall - base_wall)
    _, _, c, e = drill("3 (watchdog, raise)", dirs, rule, on_stall="raise", **wd)
    if not isinstance(e, WatchdogError):
        raise SystemExit(f"readpool: on_stall='raise' under the watchdog gave {e!r}")
    out["watchdog_raise"] = type(e).__name__
    return out


class PulseLines(logging.Handler):
    """The pulse lines the package logger emits (``telemetry._log_pulse``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("tfrecord.pulse "):
            self.lines.append(json.loads(msg.split(" ", 1)[1]))


def readpool_serving(dirs, warm, card: str) -> dict:
    """Phase 12 (e): the bf16 Criteo DLRM scores the shards through
    dataset -> HostPrefetcher -> DeviceIterator (``score_files``'s feed)
    three times: autotuned from one worker with a pulse every
    READPOOL_PULSE_S, at a fixed 1 worker and at a fixed 4. Logits
    bit-equal, one ``bf16_mma`` launch a batch; then a state taken under
    autotune after a resize resumes on a fixed pool to the same batches."""
    from tpu_tfrecord_torch.entry import _read_plan, _score_dataset
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.metrics import METRICS
    from tpu_tfrecord_torch.models.dlrm import init_params
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                        READPOOL_DEVICE)
    read = criteo_read_kw()
    paths, hash_buckets, pack, pad_to = _read_plan(dirs, cfg, read["pack"]["dense"],
                                                   read["pack"]["cat"])
    n_batches = READPOOL_SHARDS * READPOOL_ROWS // BATCH
    # warm-up forwards (cuBLAS handles, allocator) outside the three runs
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import make_synthetic_batch

    model(make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), READPOOL_DEVICE))
    runs = {"autotune": dict(num_workers=1, autotune="on", pulse_interval_s=READPOOL_PULSE_S),
            "fixed 1": dict(num_workers=1), "fixed 4": dict(num_workers=4)}
    logger = logging.getLogger("tpu_tfrecord_torch")
    out, logits = {}, {}
    for name, kw in runs.items():
        METRICS.reset()
        pulses = PulseLines()
        level = logger.level
        logger.addHandler(pulses)
        logger.setLevel(logging.INFO)
        try:
            ds = TFRecordDataset(paths, BATCH, schema=read["schema"], recordType="Example",
                                 hash_buckets=hash_buckets, pack=pack, **kw)
            reset_launch_counts()
            res = _score_dataset(ds, model, READPOOL_DEVICE, pad_to, log1p_dense=True)
            launches = dict(dot_interaction.instance_launches)
        finally:
            logger.removeHandler(pulses)
            logger.setLevel(level)
        logits[name] = res.logits
        whole = res.batches * BATCH / res.wall_s
        idle = 1.0 - sum(res.forward_s) / res.wall_s
        stats = dict(whole=whole, steady=steady_rate(res), idle_share=idle,
                     duty_cycle=res.duty_cycle, launches=launches, pulses=len(pulses.lines))
        print(f"readpool: serving bf16, {name}: {res.batches} batches, {whole:.1f} rows/s whole, "
              f"{stats['steady']:.1f} steady (batches 2-{res.batches}); device idle share at least "
              f"{idle:.4f} (1 - synchronized forward time / wall); duty cycle {res.duty_cycle}; "
              f"kernel launches {launches}; {len(pulses.lines)} pulse lines ({card})")
        if name == "autotune":
            t_first = pulses.lines[0]["ts"] if pulses.lines else 0.0
            pool = [(round(p["ts"] - t_first, 3), p["autotune"]["workers"], p["verdict"])
                    for p in pulses.lines if "autotune" in p]
            decisions = [a for p in pulses.lines for a in p.get("autotune", {}).get("adjusted", [])]
            print(f"readpool: autotune pool over time (s from the first pulse, workers, verdict): "
                  f"{pool}")
            print(f"readpool: autotune decisions: {decisions}")
            stats.update(pool=pool, decisions=decisions)
        want = {"bf16_mma": n_batches, "f32_tiled": 0}
        if launches != want or res.batches != n_batches or not torch.isfinite(res.logits).all():
            raise SystemExit(f"readpool: serving {name}: {res.batches} batches, launches {launches}")
        out[name] = stats
    same = all(torch.equal(logits[n], logits["autotune"]) for n in runs)
    print(f"readpool: logits of the three runs bit-equal: {same}")
    if not same:
        raise SystemExit("readpool: the autotuned run's logits differ from a fixed pool's")
    local_logits = logits["fixed 4"].float().cpu()  # phase 15's reference
    del model, logits
    # a state taken under autotune, after a resize, resumes on a fixed pool
    ds = TFRecordDataset(dirs, BATCH, num_workers=1, autotune="on",
                         pulse_interval_s=READPOOL_PULSE_S, **read)
    cut = n_batches * 3 // 8
    head = []
    with ds.batches() as it:
        for i, cb in enumerate(it):
            head.append(batch_digest(cb))
            if i == cut // 3:
                it._control.set_workers(4)
            if i == cut - 1:
                state = it.state()
                break
    fixed = TFRecordDataset(dirs, BATCH, num_workers=2, **read)
    with fixed.batches(state) as it:
        tail = [batch_digest(cb) for cb in it]
    ok = head + tail == warm
    print(f"readpool: state {state.to_json()} taken under autotune after a resize to 4 workers "
          f"resumes at 2 fixed workers to the uninterrupted batches: {ok}")
    if not ok:
        raise SystemExit("readpool: the resumed batches differ")
    out["launches"] = out["autotune"]["launches"]
    return out, local_logits


def readpool_path(work: str, card: str, pipe_s: float = 0.0) -> tuple:
    """Phase 12: the decode pool's read knobs, stall defence and autotune on
    this machine's host, beside ``card`` (nvidia-smi's name and power
    limit): (a) the shards, (b) cold decode rates, (c) the guard's cost,
    (d) the stall drills, (e) autotuned serving at full width. Then phase
    13 (``cache_path``) on the same shards, with its cache beside them,
    phase 14 (``multiproc_path``), phase 15 (``remote_path``) and phase 16
    (``fleet_path``), phase 17's data service (``service_path``) and phase
    18's standby and scalers (``elastic_path``). Returns the kernel launches
    of phase 12's autotuned serving run, of phase 13's warm cached epoch,
    of phase 14's ranks (summed), of phase 15's scoring over HTTP, of phase
    16's spooling scorer, of phase 17's scoring through the service, of
    phase 18's scoring through the failover and through the resize, and of
    phase 14 (c)'s sharded steps, (d)'s sequence axis and (e)'s FSDP steps
    (each summed over the ranks). ``pipe_s`` is phase 17 (a)'s time, for the phase's total."""
    from tpu_tfrecord_torch.cache import release_registry

    t0 = time.perf_counter()
    host_facts()
    root, mnt, fstype = readpool_dir(work)
    cache_dir = os.path.join(root, "cache")
    try:
        dirs, files = write_readpool(root)
        warm, rates = cold_passes(dirs, files)
        rates["pool_depth"] = pool_depth_probe(dirs, warm)
        overhead = guard_overhead(dirs)
        drills = stall_drills(dirs, warm)
        serving, local_logits = readpool_serving(dirs, warm, card)
        out = dict(card=card, dir=root, mount=mnt, fstype=fstype, cold=rates, guard=overhead,
                   drills=drills, serving=serving, seconds=time.perf_counter() - t0)
        print(f"readpool: phase 12 took {out['seconds']:.1f} s")
        print("readpool: " + json.dumps(out, default=str))
        cached = cache_path(dirs, files, warm, cache_dir, card)
        multi = multiproc_path(dirs, root, card, work)
        remote = remote_path(dirs, files, root, warm, local_logits, card)
        fleet_out = fleet_path(dirs, work, root, local_logits, serving["fixed 4"]["whole"], card)
        served = service_path(dirs, root, local_logits, serving["fixed 4"]["whole"], card)
        print(f"phase 17 took {pipe_s + served['seconds']:.1f} s: (a) {pipe_s:.1f} s, "
              f"(b) {served['seconds']:.1f} s")
        scaled = elastic_path(dirs, root, local_logits, served["whole"], card)
    finally:
        # the entries' maps are unpinned before the directory goes, or its
        # blocks stay allocated for the rest of the run
        release_registry(cache_dir)
        shutil.rmtree(root, ignore_errors=True)
    return (serving["launches"], cached["launches"], multi["launches"], remote["launches"],
            fleet_out["launches"], served["launches"], scaled["launches"],
            scaled["resize_launches"], multi["mesh_launches"], multi["sp_launches"],
            multi["fsdp_launches"], multi["ep_launches"])


# -- phase 13: the columnar epoch cache ----------------------------------------------

CACHE_WORKERS = 4      # the serving runs' pool: phase 12's fastest fixed one
CACHE_CUT = 24         # batches read before the state is taken: inside shard 1


def cache_serve(dirs, model, label: str, card: str, **kw) -> tuple:
    """One traced bf16 serving run of phase 12's shards through the feed
    (dataset -> HostPrefetcher -> DeviceIterator -> the DLRM) at
    CACHE_WORKERS workers; (ScoreResult, rates)."""
    from tpu_tfrecord_torch.entry import _read_plan, _score_dataset
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    read = criteo_read_kw()
    paths, hash_buckets, pack, pad_to = _read_plan(dirs, model.cfg, read["pack"]["dense"],
                                                   read["pack"]["cat"])
    ds = TFRecordDataset(paths, BATCH, schema=read["schema"], recordType="Example",
                         hash_buckets=hash_buckets, pack=pack, num_workers=CACHE_WORKERS,
                         trace="on", **kw)
    res = _score_dataset(ds, model, READPOOL_DEVICE, pad_to, log1p_dense=True)
    whole = res.batches * BATCH / res.wall_s
    idle = 1.0 - sum(res.forward_s) / res.wall_s
    stats = dict(whole=whole, steady=steady_rate(res), idle_share=idle,
                 duty_cycle=res.duty_cycle, wall_s=res.wall_s)
    print(f"cache: serving bf16, {label}, {CACHE_WORKERS} workers: {res.batches} batches, "
          f"{whole:.1f} rows/s whole, {stats['steady']:.1f} steady (batches 2-{res.batches}); "
          f"device idle share at least {idle:.4f} (1 - synchronized forward time / wall); "
          f"duty cycle {res.duty_cycle} ({card})")
    return res, stats


def scrape_metrics() -> str:
    """One GET of the process's Prometheus page (``telemetry_port=0``)."""
    import urllib.request

    from tpu_tfrecord_torch import telemetry

    host, port = telemetry.exporter_address(0)
    with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
        return resp.read().decode()


def cache_path(dirs, files, warm, cache_dir: str, card: str) -> dict:
    """Phase 13: the columnar epoch cache on phase 12's shards, beside
    ``card``: (a) a decode-only populate pass, (b) a warm epoch scored by
    the bf16 DLRM from a new dataset on the same cache, traced and
    exported, against an uncached serving run of the same rows, (c) a
    state taken on a cached read resumed on an uncached one, (d) one byte
    of one entry flipped and read through. Returns the warm epoch's kernel
    launches."""
    from tpu_tfrecord_torch import cache as cache_mod
    from tpu_tfrecord_torch import telemetry
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.metrics import METRICS
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    t0 = time.perf_counter()
    free_cuda()
    n_batches = READPOOL_SHARDS * READPOOL_ROWS // BATCH
    mnt, fstype = mount_of(os.path.dirname(cache_dir))
    shard_bytes = sum(os.path.getsize(f) for f in files)
    names = ("hits", "misses", "bytes_written", "corrupt_fallbacks", "populate_errors")

    def counts() -> dict:
        return {n: METRICS.counter(f"cache.{n}") for n in names}

    # (a) the populate pass: decode, and append each chunk to its entry
    METRICS.reset()
    digests, rows, wall, cpu, _ = readpool_pass(dirs, cache="auto", cache_dir=cache_dir)
    c = counts()
    entries = sorted(os.path.join(cache_dir, n) for n in os.listdir(cache_dir)
                     if n.endswith(cache_mod.ENTRY_SUFFIX))
    entry_bytes = sum(os.path.getsize(e) for e in entries)
    commit = METRICS.stage("cache.commit")
    populate = dict(rows_per_s=rows / wall, wall_s=wall, cpu_s=cpu, counters=c,
                    entry_bytes=entry_bytes, shard_bytes=shard_bytes,
                    commit_s=commit.seconds)
    print(f"cache: populate pass ({READPOOL_COLD_WORKERS} workers, decode + append, "
          f"{cache_dir} on {mnt}, {fstype}): {rows / wall:.1f} rows/s, CPU {cpu:.3f} s over "
          f"wall {wall:.3f} s, commits {commit.seconds:.3f} s; counters {c}; "
          f"{len(entries)} entries = {entry_bytes} bytes against {shard_bytes} bytes of shards "
          f"({entry_bytes / shard_bytes:.3f}); digests equal phase 12's warm pass: "
          f"{digests == warm} ({card})")
    if (digests != warm or c["misses"] != READPOOL_SHARDS or c["hits"] or c["populate_errors"]
            or len(entries) != READPOOL_SHARDS or c["bytes_written"] != entry_bytes):
        raise SystemExit(f"cache: the populate pass failed: {c}, {len(entries)} entries")
    chunks = sum(len(cache_mod.load_footer(e)["chunks"]) for e in entries)

    # (b) an uncached serving run, then the warm epoch from a new dataset
    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                        READPOOL_DEVICE)
    model(make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), READPOOL_DEVICE))
    traces = [os.path.join(os.path.dirname(cache_dir), f"trace_{n}.json")
              for n in ("uncached", "warm")]
    telemetry.RECORDER.clear()
    ref, ref_stats = cache_serve(dirs, model, "uncached", card)
    telemetry.RECORDER.save_chrome_trace(traces[0])
    telemetry.RECORDER.clear()
    METRICS.reset()
    try:
        reset_launch_counts()
        res, stats = cache_serve(dirs, model, "warm epoch from the cache", card, cache="auto",
                                 cache_dir=cache_dir, telemetry_port=0)
        launches = dict(dot_interaction.instance_launches)
        page = scrape_metrics()
    finally:
        telemetry.shutdown_exporter(0)
    c = counts()
    serve_spans = sum(1 for sp in telemetry.RECORDER.spans() if sp[0] == "cache.serve")
    telemetry.RECORDER.save_chrome_trace(traces[1])
    telemetry.disable()
    telemetry.RECORDER.clear()
    merged = telemetry.merge_chrome_traces(os.path.join(os.path.dirname(cache_dir),
                                                        "trace_merged.json"), traces)
    n_events = len(merged["traceEvents"])
    exported = 'tfrecord_stage_records_total{stage="cache.hits"} ' in page
    equal = torch.equal(res.logits, ref.logits)
    want = {"bf16_mma": n_batches, "f32_tiled": 0}
    print(f"cache: warm epoch counters {c}; logits bit-equal to the uncached run's: {equal}; "
          f"kernel launches {launches}; cache.serve spans {serve_spans}, chunks in the entries "
          f"{chunks}; the two traces merged into {n_events} events; the scrape of /metrics "
          f"holds the cache.hits family: {exported}; warm whole rate "
          f"{stats['whole'] / ref_stats['whole']:.3f} x the uncached run's ({card})")
    if (c["hits"] != READPOOL_SHARDS or c["misses"] or not equal or launches != want
            or res.batches != n_batches or not torch.isfinite(res.logits).all()
            or serve_spans != chunks or not exported):
        raise SystemExit(f"cache: the warm epoch failed: {c}, equal {equal}, launches "
                         f"{launches}, spans {serve_spans} of {chunks}, exported {exported}")
    del model, ref, res
    free_cuda()

    # (c) a state taken on a cached read resumes on an uncached one
    read = criteo_read_kw()
    head = []
    ds = TFRecordDataset(dirs, BATCH, num_workers=2, cache="auto", cache_dir=cache_dir, **read)
    with ds.batches() as it:
        for i, cb in enumerate(it):
            head.append(batch_digest(cb))
            if i == CACHE_CUT - 1:
                state = it.state()
                break
    with TFRecordDataset(dirs, BATCH, num_workers=2, **read).batches(state) as it:
        tail = [batch_digest(cb) for cb in it]
    resumed = head + tail == warm
    print(f"cache: state {state.to_json()} taken on the cached read resumes on an uncached "
          f"read to the uninterrupted batches: {resumed}")
    if not resumed:
        raise SystemExit("cache: the resumed batches differ")

    # (d) one byte of one section of one entry flipped: the read falls
    # back to the shard, gives the same batches and rewrites the entry
    victim = entries[1]
    sec = cache_mod.load_footer(victim)["chunks"][3]["columns"][0]["sections"][0][1]
    ino = os.stat(victim).st_ino
    with open(victim, "r+b") as fh:
        fh.seek(sec["off"])
        byte = fh.read(1)
        fh.seek(sec["off"])
        fh.write(bytes([byte[0] ^ 0xFF]))
    METRICS.reset()
    digests = readpool_pass(dirs, cache="auto", cache_dir=cache_dir)[0]
    c = counts()
    report = cache_mod.inspect_entry(victim)
    rewritten = report["status"] == "ok" and os.stat(victim).st_ino != ino
    print(f"cache: one byte flipped at offset {sec['off']} of {os.path.basename(victim)}: "
          f"counters {c}; batches equal: {digests == warm}; entry rewritten: {rewritten} "
          f"({report['status']})")
    if (c["corrupt_fallbacks"] != 1 or c["hits"] != READPOOL_SHARDS - 1 or digests != warm
            or not rewritten):
        raise SystemExit(f"cache: the corrupt-entry read failed: {c}, {report}")
    out = dict(card=card, populate=populate, uncached=ref_stats, warm=stats, chunks=chunks,
               serve_spans=serve_spans, merged_events=n_events, resumed=resumed,
               corrupt=dict(counters=c, rewritten=rewritten), launches=launches,
               seconds=time.perf_counter() - t0)
    print(f"cache: phase 13 took {out['seconds']:.1f} s")
    print("cache: " + json.dumps(out, default=str))
    return out


# -- phase 14: multi-process ingest over torch.distributed ----------------------------

MULTI_RANKS = 2
MULTI_WORKERS = 2          # decode workers a rank: phase 12's fixed 4 split between the ranks
MULTI_CUT = 5              # batches a rank reads before it saves its position
MULTI_TIMEOUT_S = 300      # for the ranks to finish, from their start
# the module's sizes a rank takes from the parent (a spawned rank imports
# this file afresh)
MULTI_SIZES = ("BATCH", "VOCAB", "READPOOL_ROWS", "READPOOL_DEVICE")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multiproc_rank(rank: int, port: int, dirs: list, work: str, sizes: dict) -> None:
    """One rank of phase 14, in a spawned process: its result (or the
    traceback that ended it) goes to ``work/rank<r>.json``."""
    import faulthandler
    import traceback

    globals().update(sizes)
    torch.set_num_threads(1)
    # phase 14 (d)'s LM steps run under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    path = os.path.join(work, f"rank{rank}.json")
    with open(os.path.join(work, f"rank{rank}.fault"), "w") as fault:
        faulthandler.enable(fault)  # a crash in native code leaves the stacks here
        try:
            out = _multiproc_rank(rank, port, dirs, work)
        except BaseException:
            with open(path, "w") as fh:
                json.dump({"rank": rank, "error": traceback.format_exc()}, fh)
            raise
        finally:
            faulthandler.disable()
    with open(path, "w") as fh:
        json.dump(out, fh)


def _multiproc_rank(rank: int, port: int, dirs: list, work: str) -> dict:
    """Phase 14 on one rank: join the group, infer the schema across it,
    score this rank's slot of the shards through dataset -> HostPrefetcher
    -> DeviceIterator(mesh) with the bf16 DLRM, resume the slot from a saved
    position, and write (shard, row, logit) rows under the job commit."""
    from tpu_tfrecord_torch import checkpoint
    from tpu_tfrecord_torch import io as tio
    from tpu_tfrecord_torch.columnar import Column, ColumnarBatch
    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.device.ingest import DeviceIterator, HostPrefetcher, make_global_batch
    from tpu_tfrecord_torch.entry import _drive, _host_batch, _read_plan
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.io.writer import DatasetWriter
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts
    from tpu_tfrecord_torch.schema import FloatType, LongType, StructField, StructType
    from torch.distributed.tensor import DTensor, Shard

    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", MULTI_RANKS, rank)
    ctx = distributed.adopt_shared_trace_context("chip_rank")
    t_infer = time.perf_counter()
    schema = tio.reader(dirs).infer_schema_multihost(num_workers=2)
    distributed.assert_same_across_hosts(schema.json().encode(), "schema")
    t_infer = time.perf_counter() - t_infer
    mesh = meshes.create_mesh(device_type=torch.device(READPOOL_DEVICE).type)
    device = meshes.mesh_device(mesh)
    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(TRAIN_SEED), device)
    # warm-up outside the timed run: the forward, and the process's first
    # DTensor, which pays torch's one-time set-up (timed apart)
    t_first = time.perf_counter()
    warm = make_global_batch(make_synthetic_batch(cfg, BATCH, seed=1), mesh)
    t_first = time.perf_counter() - t_first
    model({k: v.to_local() for k, v in warm.items()})
    read = criteo_read_kw()
    paths, hash_buckets, pack, pad_to = _read_plan(dirs, cfg, read["pack"]["dense"],
                                                   read["pack"]["cat"])

    def dataset():
        return TFRecordDataset(paths, BATCH, schema=read["schema"], recordType="Example",
                               hash_buckets=hash_buckets, pack=pack, num_workers=MULTI_WORKERS,
                               process_index=rank, process_count=MULTI_RANKS)

    ds = dataset()
    everyone = [sh.path for sh in tio.reader(paths).shards]
    mine = [everyone.index(sh.path) for sh in ds.shards]
    seen, first_labels = {}, []

    def step(batch):
        if not seen:
            first_labels.append(batch["label"].to_local().cpu())
            seen.update({k: dict(type=type(v).__name__, shape=list(v.shape),
                                 local=list(v.to_local().shape),
                                 placements=[str(p) for p in v.placements],
                                 batch_dim_sharded=tuple(v.placements) == (Shard(0),))
                         for k, v in batch.items()})
        return model({k: v.to_local() for k, v in batch.items()})

    times = ([], [], [], [])
    # train_dlrm's two ranks (phase 14 (c)) start beside this process; the
    # card is left to the scoring only after they exited
    t_twin = time.perf_counter()
    wait_for_file(os.path.join(work, TWIN_DONE), MESH_TWIN_TIMEOUT_S)
    t_twin = time.perf_counter() - t_twin
    distributed.barrier("score")  # both ranks start scoring together
    reset_launch_counts()
    t_start = time.perf_counter()  # the host's monotonic clock, one for both ranks
    with ds.batches() as it, HostPrefetcher(map(lambda cb: _host_batch(cb, ds, pad_to, True),
                                                it)) as pf, \
            DeviceIterator(pf, mesh=mesh) as dev:
        outs, wall, duty = _drive(dev, device, step, times)
    launches = dict(dot_interaction.instance_launches)
    # each synchronized forward as (start, end) on that clock
    forwards = [(t_start + done - fwd, t_start + done) for fwd, done in zip(times[2], times[3])]
    logits = torch.cat(outs).float().cpu().reshape(-1)
    forward_s = sum(times[2])
    # the first global batch gathered: gloo's all-gather of a DTensor on
    # the card kills the process (a probe of earlier runs), so the check
    # gathers a CPU copy of its labels over a CPU mesh of the same group
    cpu_mesh = meshes.create_mesh(device_type="cpu")
    gathered = DTensor.from_local(first_labels[0], cpu_mesh, meshes.data_sharding(cpu_mesh),
                                  run_check=False).full_tensor()
    gather = dict(rows=int(gathered.numel()),
                  own_rows_in_place=bool(torch.equal(
                      gathered[rank * BATCH:(rank + 1) * BATCH], first_labels[0])))

    # the slot's position after MULTI_CUT batches, saved and resumed
    with dataset().batches() as it:
        whole = [batch_digest(cb) for cb in it]
    with dataset().batches() as it:
        head = [batch_digest(cb) for _, cb in zip(range(MULTI_CUT), it)]
        checkpoint.save_state(work, it)
    distributed.barrier("states")
    state = checkpoint.load_state(work)
    with dataset().batches(state) as it:
        tail = [batch_digest(cb) for cb in it]
    other = checkpoint.load_state(work, 1 - rank)
    try:
        with dataset().batches(other) as it:
            next(it)
        other_refused = False
    except ValueError as e:
        other_refused = "fingerprint" in str(e)

    # (shard, row, logit) rows of this rank, then the job commit
    out_dir = os.path.join(work, "multiproc_out")
    wschema = StructType([StructField("shard", LongType()), StructField("row", LongType()),
                          StructField("logit", FloatType())])
    t_write = time.perf_counter()
    batches = []
    for k, g in enumerate(mine):
        lo = k * READPOOL_ROWS
        cols = {"shard": np.full(READPOOL_ROWS, g, np.int64),
                "row": np.arange(READPOOL_ROWS, dtype=np.int64),
                "logit": logits[lo:lo + READPOOL_ROWS].numpy()}
        batches.append(ColumnarBatch({n: Column(n, wschema[n].data_type, values=v)
                                      for n, v in cols.items()}, READPOOL_ROWS))
    DatasetWriter(out_dir, wschema, mode="append", write_success=False).write_batches(
        batches, task_id=rank)
    distributed.finalize_distributed_write(out_dir)
    success_seen = os.path.exists(os.path.join(out_dir, "_SUCCESS"))
    t_write = time.perf_counter() - t_write
    del model, warm
    free_cuda()
    mesh_out = mesh_rank(rank, dirs, work)
    sp_out = seq_mesh_rank()
    fsdp_out = fsdp_mesh_rank()
    moe_out = moe_mesh_rank()
    return dict(rank=rank, mesh=mesh_out, sp=sp_out, fsdp=fsdp_out, moe=moe_out,
                trace=ctx.to_json(),
                schema=schema.json(), shards=mine,
                launches=launches, batches=len(times[2]), rows=int(logits.numel()),
                wall_s=wall, forward_s=forward_s, idle_share=1.0 - forward_s / wall,
                duty_cycle=duty, rows_per_s=len(times[2]) * BATCH / wall,
                steady=(len(times[3]) - 1) * BATCH / (times[3][-1] - times[3][0]),
                first_dtensor_s=t_first, batch=seen, forwards=forwards,
                span=(t_start, t_start + wall),
                gather=gather, infer_s=t_infer, write_s=t_write,
                resume=dict(state=state.to_json(), batches=len(whole),
                            exact=head + tail == whole and len(head) == MULTI_CUT,
                            other_refused=other_refused),
                success_seen=success_seen, twin_wait_s=t_twin, seconds=time.perf_counter() - t0)


MESH_RUNS = (  # (label, mesh axes, sparse step?, steps) of phase 14 (c)
    ("model_sparse", {"model": 2}, True, 4),
    ("data_sparse", {"data": 2}, True, 4),
    ("model_dense", {"model": 2}, False, 1),
)
MESH_TWIN_STEPS = 8
MESH_TWIN_TIMEOUT_S = 180  # for the two train_dlrm ranks, from their start
TWIN_DONE = "twin.done"    # marks, in phase 14's work dir, that the twin's ranks exited


def wait_for_file(path: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear within {timeout_s} s")
        time.sleep(0.05)


def mesh_batches(dirs, slot: int, slots: int, n: int) -> list:
    """The first ``n`` host batches of slot ``slot`` of ``slots`` over
    phase 12's shards, as the training feed makes them (dense log1p'd,
    float labels)."""
    from tpu_tfrecord_torch.entry import _host_batch, _read_plan
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    read = criteo_read_kw()
    paths, hash_buckets, pack, pad_to = _read_plan(dirs, criteo_cfg(), read["pack"]["dense"],
                                                   read["pack"]["cat"])
    ds = TFRecordDataset(paths, BATCH, schema=read["schema"], recordType="Example",
                         hash_buckets=hash_buckets, pack=pack, num_workers=MULTI_WORKERS,
                         process_index=slot, process_count=slots)
    with ds.batches() as it:
        return [_host_batch(cb, ds, pad_to, True, float_label=True) for _, cb in zip(range(n), it)]


def table_digest(table: torch.Tensor) -> int:
    """An order-sensitive checksum of a float32 tensor's bits, computed on
    its device one slice of dim 0 at a time: sum over i of bits[i] * (i+1),
    mod 2^64 (int64 arithmetic wraps)."""
    total = 0
    weights = None
    for f in range(table.shape[0]):
        bits = table[f].detach().reshape(-1).view(torch.int32).long()
        if weights is None:
            weights = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        total = (total * 1_000_003 + int((bits * weights).sum().item())) % (1 << 64)
    return total


def pieces_digest(model) -> str:
    """sha256 over the bytes of every parameter but the table, by name."""
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        if name != "embeddings":
            h.update(name.encode())
            h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def timed_collectives():
    """CUDA events around every ``all_reduce`` and ``all_gather`` on a CUDA
    tensor issued inside the block (``torch.distributed``'s two functions
    wrapped for its length, so the port carries no timing code); yields
    the list of (start, end) event pairs."""
    import torch.distributed as dist

    events: list = []
    originals = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def wrap(name, fn):
        def timed(*args, **kw):
            tensor = args[1] if name == "all_gather" else args[0]
            if not tensor.is_cuda:
                return fn(*args, **kw)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            events.append((start, end))
            return out
        return timed

    for name, fn in originals.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield events
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def profiled_kernel_ms(prof) -> float:
    """Device ms of every kernel in a torch.profiler trace."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def mesh_rank(rank: int, dirs: list, work: str) -> dict:
    """Phase 14 (c) on one rank, the group up and the scoring model freed:
    each of MESH_RUNS from a full-width bf16 DLRM built from TRAIN_SEED and
    sharded on its mesh, with the counts set to 0 just before its steps
    and read just after. Each step is synchronized and timed (host clock,
    and CUDA events around the step and around each collective); the last
    step of each run is profiled. The table rows the run moved, and on a
    sparse run their accumulators, go to ``work/mesh_<label>_rank<r>.pt``
    (on {'data': 2} rank 0's only: the replicas' digests must be equal)."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.device.ingest import make_device_batch, make_global_batch
    from tpu_tfrecord_torch.entry import _adam
    from tpu_tfrecord_torch.models import dlrm
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    cfg = criteo_cfg()
    out = {}
    for label, axes, sparse, steps in MESH_RUNS:
        t0 = time.perf_counter()
        mesh = meshes.create_mesh(axes)
        device = meshes.mesh_device(mesh)
        on_data = "data" in axes
        hosts = mesh_batches(dirs, rank if on_data else 0, MULTI_RANKS if on_data else 1, steps)
        full = dlrm.init_params(cfg, torch.Generator(device=device).manual_seed(TRAIN_SEED), device)
        model = dlrm.shard_model(full, mesh)
        del full
        free_cuda()
        table0 = model.embeddings.detach().clone()
        if sparse:
            opt = dlrm.sparse_opt_init(model, cfg, _adam)
            step = lambda b: dlrm.sharded_sparse_train_step(model, opt, b, cfg)  # noqa: E731
        else:
            opt = _adam(list(model.parameters()))
            step = lambda b: dlrm.sharded_train_step(model, opt, b)  # noqa: E731
        batches = [make_global_batch(h, mesh) if on_data else make_device_batch(h, device)
                   for h in hosts]
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t_steps = time.perf_counter()
        distributed.barrier(f"mesh {label}")
        run = dict(local_table=list(model.embeddings.shape), v_range=[model.v_lo, model.v_hi],
                   losses=[], digests=[], host_ms=[], step_ms=[], collective_ms=[],
                   collectives=[], setup_s=setup_s)
        reset_launch_counts()
        for i, batch in enumerate(batches):
            last = i == len(batches) - 1
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as prof, timed_collectives() as events:
                t = time.perf_counter()
                start.record()
                loss = step(batch)
                end.record()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t) * 1e3
            run["host_ms"].append(host_ms)
            run["step_ms"].append(start.elapsed_time(end))
            run["collective_ms"].append(sum(a.elapsed_time(b) for a, b in events))
            run["collectives"].append(len(events))
            run["losses"].append(loss.item())
            if last:
                kernel_ms = profiled_kernel_ms(prof)
                run["kernel_ms"] = kernel_ms
                run["idle_share"] = 1.0 - kernel_ms / host_ms if kernel_ms > 0 else None
            run["digests"].append(dict(table=table_digest(model.embeddings),
                                       pieces=pieces_digest(model)))
        run["launches"] = dict(dot_interaction.instance_launches)
        run["steps_s"] = time.perf_counter() - t_steps
        with torch.no_grad():
            moved = (model.embeddings != table0).any(-1)                      # [F, V/m]
            f_ix, v_ix = moved.nonzero(as_tuple=True)
            run["moved"] = int(f_ix.numel())
            if not (on_data and rank != 0):
                path = os.path.join(work, f"mesh_{label}_rank{rank}.pt")
                t = time.perf_counter()
                torch.save(dict(f=f_ix.int().cpu(), v=(v_ix + model.v_lo).int().cpu(),
                                rows=model.embeddings[f_ix, v_ix].float().cpu(),
                                accum=opt.accum[f_ix, v_ix].cpu() if sparse else None), path)
                run["ship_s"] = time.perf_counter() - t
        run["seconds"] = time.perf_counter() - t0
        out[label] = run
        del model, opt, table0, batches, moved, f_ix, v_ix, step
        free_cuda()
    return out


def mesh_twin_start(data_dir: str, ckpt_dir: str, work: str) -> list:
    """Start two ranks of ``python -m tpu_tfrecord_torch.train_dlrm
    --max-steps MESH_TWIN_STEPS`` under torchrun's environment on a free
    port, their output to ``work/twin<r>.log``. Returns [(process, log)]."""
    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = []
    for r in range(MULTI_RANKS):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(MULTI_RANKS), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=repo)
        log = open(os.path.join(work, f"twin{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tpu_tfrecord_torch.train_dlrm", "--max-steps",
             str(MESH_TWIN_STEPS), "--data-dir", data_dir, "--ckpt-dir", ckpt_dir],
            cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def mesh_twin_finish(procs, t0: float, work: str) -> tuple:
    """Wait for the twin's ranks (killed after MESH_TWIN_TIMEOUT_S from
    ``t0``, the host's monotonic clock); (gates, each rank's done line)."""
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, t0 + MESH_TWIN_TIMEOUT_S - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    done = []
    for r in range(MULTI_RANKS):
        with open(os.path.join(work, f"twin{r}.log")) as fh:
            text = fh.read()
        lines = [line for line in text.splitlines() if line.startswith("done:")]
        done.append(lines[0] if lines else text[-2000:])
        print(f"mesh: train_dlrm rank {r}: " + " | ".join(
            line for line in text.splitlines()[-8:] if not line.startswith("[W")))
    want = f"done: {MESH_TWIN_STEPS} steps,"
    gates = {"twin_exit": codes == [0] * MULTI_RANKS,
             "twin_steps": all(d.startswith(want) for d in done)}
    return gates, done


def mesh_check(dirs, work: str, results: list, card: str) -> tuple:
    """Phase 14 (c) in this process: each of MESH_RUNS again in one process
    from the same weights on the same (concatenated) batches, held against
    the ranks' results. Returns (gates, numbers)."""
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.entry import _adam
    from tpu_tfrecord_torch.models import dlrm

    gates, out = {}, {}
    for label, axes, sparse, steps in MESH_RUNS:
        t0 = time.perf_counter()
        runs = [res["mesh"][label] for res in results]
        on_data = "data" in axes
        if on_data:
            per = [mesh_batches(dirs, r, MULTI_RANKS, steps) for r in range(MULTI_RANKS)]
            hosts = [{k: np.concatenate([p[i][k] for p in per]) for k in per[0][i]}
                     for i in range(steps)]
        else:
            hosts = mesh_batches(dirs, 0, 1, steps)
        model = new_criteo_model()
        cfg = model.cfg
        table0 = model.embeddings.detach().clone()
        opt = dlrm.sparse_opt_init(model, cfg, _adam) if sparse else _adam(list(model.parameters()))
        ref = []
        for h in hosts:
            b = make_device_batch(h, "cuda")
            ref.append((dlrm.sparse_train_step(model, opt, b, cfg) if sparse
                        else dlrm.train_step(model, opt, b)).item())
        shippers = range(1) if on_data else range(MULTI_RANKS)
        with torch.no_grad():
            ref_moved = (model.embeddings != table0).any(-1)                   # [F, V]
            del table0
            shipped = torch.zeros_like(ref_moved)
            row_err, accum_diff, accum_max, accum_rel = 0.0, 0.0, 0.0, []
            for r in shippers:
                d = torch.load(os.path.join(work, f"mesh_{label}_rank{r}.pt"))
                f, v, rows = d["f"].cuda().long(), d["v"].cuda().long(), d["rows"].cuda()
                shipped[f, v] = True
                if f.numel():
                    row_err = max(row_err, (model.embeddings[f, v] - rows).abs().max().item())
                if sparse and f.numel():
                    want = opt.accum[f, v]
                    diff = (d["accum"].cuda() - want).abs()
                    accum_diff = max(accum_diff, diff.max().item())
                    accum_max = max(accum_max, want.abs().max().item())
                    accum_rel.append((diff / want.abs().clamp_min(1e-30)).cpu())
            same_rows = bool(torch.equal(shipped, ref_moved))
            n_ref, n_shipped = int(ref_moved.sum()), int(shipped.sum())
            # each entry's own relative difference, printed only: a
            # near-zero gradient's one-ulp change moves it far
            accum_rel = torch.cat(accum_rel) if accum_rel else torch.zeros(1)
            accum = dict(rel_of_largest=accum_diff / accum_max if accum_max else None,
                         largest=accum_max, median=opt.accum[ref_moved].median().item(),
                         entry_rel_median=accum_rel.median().item(),
                         entry_rel_max=accum_rel.max().item()) if sparse else None
        loss_err = max(abs(a - b) for run in runs for a, b in zip(run["losses"], ref))
        half = VOCAB // MULTI_RANKS
        gates[f"{label}_losses"] = all(
            len(run["losses"]) == steps
            and np.allclose(run["losses"], ref, rtol=TRAIN_LOSS_TOL, atol=TRAIN_LOSS_TOL)
            for run in runs)
        gates[f"{label}_rows"] = row_err <= TRAIN_TABLE_ATOL and same_rows and n_ref > 0
        if sparse:
            gates[f"{label}_accum"] = (accum["rel_of_largest"] is not None
                                       and accum["rel_of_largest"] <= MESH_ACCUM_RTOL)
        gates[f"{label}_launches"] = all(run["launches"] == {"bf16_mma": steps, "f32_tiled": 0}
                                         for run in runs)
        if on_data:
            gates[f"{label}_replicas"] = (runs[0]["digests"] == runs[1]["digests"]
                                          and runs[0]["losses"] == runs[1]["losses"])
            gates[f"{label}_layout"] = all(run["local_table"] == [26, VOCAB, 32] for run in runs)
        else:
            gates[f"{label}_ranks_agree"] = runs[0]["losses"] == runs[1]["losses"]
            gates[f"{label}_layout"] = (
                [run["v_range"] for run in runs] == [[r * half, (r + 1) * half]
                                                    for r in range(MULTI_RANKS)]
                and all(run["local_table"] == [26, half, 32] for run in runs))
        out[label] = dict(ref_losses=ref, loss_err=loss_err, row_err=row_err, moved_rows=n_ref,
                          shipped_rows=n_shipped, same_rows=same_rows, accum=accum,
                          seconds=time.perf_counter() - t0)
        for r, run in enumerate(runs):
            for i in range(steps):
                print(f"mesh: {label} {axes} rank {r} step {i + 1}: loss {run['losses'][i]:.6f} "
                      f"(one process {ref[i]:.6f}); host {run['host_ms'][i]:.3f} ms, step "
                      f"{run['step_ms'][i]:.3f} ms (CUDA events), collectives "
                      f"{run['collectives'][i]} in {run['collective_ms'][i]:.3f} ms (CUDA events); "
                      f"table digest {run['digests'][i]['table']} ({card})")
            idle = run["idle_share"]
            print(f"mesh: {label} rank {r}: {run['seconds']:.2f} s in the rank (set-up "
                  f"{run['setup_s']:.2f} s, steps with digests and profile {run['steps_s']:.2f} s); "
                  f"last step profiled: "
                  f"kernels {run['kernel_ms']:.4f} ms of {run['host_ms'][-1]:.3f} ms, the card idle "
                  f"for this rank's kernels "
                  f"{'not measured' if idle is None else f'{idle:.4f}'} (torch.profiler; the "
                  f"other rank shares the card); launches {run['launches']}; {run['moved']} rows "
                  f"moved, shipped in {run.get('ship_s', 0.0):.2f} s ({card})")
        print(f"mesh: {label}: max |loss - one process| {loss_err} (tol {TRAIN_LOSS_TOL}); "
              f"{n_ref} rows moved by the one process, {n_shipped} by the ranks, the same rows: "
              f"{same_rows}; max |row - one process row| {row_err} (atol {TRAIN_TABLE_ATOL}); "
              + (f"the moved rows' accumulators: max |accum - one process| over the largest "
                 f"{accum['rel_of_largest']} (tol {MESH_ACCUM_RTOL}), largest {accum['largest']}, "
                 f"median {accum['median']}, each entry's relative difference median "
                 f"{accum['entry_rel_median']} max {accum['entry_rel_max']}; " if sparse else "")
              + f"the one-process run and check {out[label]['seconds']:.1f} s")
        del model, opt, ref_moved, shipped
        free_cuda()
    return gates, out


# -- phase 14 (d): the sequence axis over the same two ranks --------------------------

SP_ATTN_SHAPE = (32, 64, 4, 16)     # the LM twin's batch, length, heads and head dim
SP_PROBE_SHAPE = (1, 8192, 8, 64)   # the long probe: bf16, forward only
SP_ATTN_CASES = (  # (label, flavour, zigzag, Hkv, lengths?, segments?); every case causal
    ("ring contiguous", "ring_attention", False, 4, False, False),
    ("ring zigzag segments GQA", "ring_attention", True, 2, False, True),
    ("ulysses lengths", "ulysses_attention", False, 4, True, False),
)
SP_PROBE_CASES = (("ring zigzag", "ring_attention", True), ("ulysses", "ulysses_attention", False))
SP_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SP_GRAD_RTOL = 1e-4        # f32 gradients: of each tensor's largest |gradient|
SP_STEPS = 4
SP_LONGDOC_TOL = 2e-2      # bf16 losses against one process
SP_LM_TOL = 1e-4           # f32 losses against one process, deterministic algorithms
SP_REPS = 5                # timed calls of each attention case
SP_TWIN_STEPS = 8
SP_TWIN_TIMEOUT_S = 180    # for each trainer's two ranks, from their start


def sp_inputs(shape, hkv: int, dtype, seed: int, lengths: bool, segments: bool) -> dict:
    """Global q, k, v (and a cotangent) on the card from ``seed``, the same
    on every rank, with ``lengths`` and packed-document ``segments``."""
    b, l, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {"q": torch.randn(b, l, h, d, generator=g, device="cuda").to(dtype),
           "k": torch.randn(b, l, hkv, d, generator=g, device="cuda").to(dtype),
           "v": torch.randn(b, l, hkv, d, generator=g, device="cuda").to(dtype),
           "cot": torch.randn(b, l, h, d, generator=g, device="cuda").to(dtype)}
    if lengths:
        out["lengths"] = torch.randint(1, l + 1, (b,), generator=g, device="cuda")
    if segments:
        out["segments"] = torch.sort(torch.randint(1, 5, (b, l), generator=g, device="cuda"),
                                     dim=1).values
    return out


def sp_attention_case(mesh, flavour: str, zigzag: bool, inp: dict, grads: bool) -> dict:
    """One attention case on this rank: its chunk against the dense
    attention over the whole sequence (the output and, with ``grads``, the
    gradients of q, k and v), then the ms of a call and of its collectives
    (CUDA events), and of the dense attention over the whole sequence on
    this rank alone."""
    from tpu_tfrecord_torch.models import attention, sharded

    p, idx = sharded.axis_size(mesh, "seq"), sharded.axis_index(mesh, "seq")
    lc = inp["q"].shape[1] // p
    local = lambda t: t[:, idx * lc:(idx + 1) * lc].contiguous()  # noqa: E731
    kw = dict(causal=True)
    if flavour == "ring_attention":
        kw["zigzag"] = zigzag
    ref_kw = dict(causal=True, lengths=inp.get("lengths"), segments=inp.get("segments"))
    fn = getattr(attention, flavour)

    def call(q, k, v):
        return fn(q, k, v, mesh, seq_axis="seq", lengths=inp.get("lengths"),
                  segments=local(inp["segments"]) if "segments" in inp else None, **kw)

    full = [inp[n].detach().clone().requires_grad_(grads) for n in ("q", "k", "v")]
    mine = [local(inp[n]).requires_grad_(grads) for n in ("q", "k", "v")]
    with torch.set_grad_enabled(grads):
        got = call(*mine)
        want = attention.attention_reference(*full, **ref_kw)
        out = dict(err=(got.float() - local(want).float()).abs().max().item())
        if grads:
            (got * local(inp["cot"])).sum().backward()
            (want * inp["cot"]).sum().backward()
            out["grad_rel"] = max(
                ((m.grad - local(f.grad)).abs().max() / f.grad.abs().max()).item()
                for m, f in zip(mine, full))
    del got, want, full
    with torch.no_grad():
        q, k, v = (local(inp[n]) for n in ("q", "k", "v"))
        call(q, k, v)  # warm
        ms, coll = [], []
        for _ in range(SP_REPS):
            with timed_collectives() as events:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                call(q, k, v)
                end.record()
                torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            coll.append(sum(a.elapsed_time(b) for a, b in events))
        n_coll = len(events)
        dense = [inp[n] for n in ("q", "k", "v")]
        attention.attention_reference(*dense, **ref_kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(SP_REPS):
            attention.attention_reference(*dense, **ref_kw)
        end.record()
        torch.cuda.synchronize()
    out.update(ms=float(np.median(ms)), collective_ms=float(np.median(coll)), collectives=n_coll,
               dense_ms=start.elapsed_time(end) / SP_REPS)
    return out


def sp_step_pair(mesh, label: str, steps, card_step, ref_step) -> dict:
    """``steps`` sharded steps (``card_step(i)``) beside the one-process
    steps (``ref_step(i)``) on this rank: both losses, and the sharded
    step's host ms (synchronized) and its collectives' ms (CUDA events)."""
    out = dict(label=label, losses=[], ref_losses=[], host_ms=[], collective_ms=[],
               collectives=[])
    for i in range(steps):
        with timed_collectives() as events:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = card_step(i)
            torch.cuda.synchronize()
            out["host_ms"].append((time.perf_counter() - t) * 1e3)
        out["collective_ms"].append(sum(a.elapsed_time(b) for a, b in events))
        out["collectives"].append(len(events))
        out["losses"].append(loss.item())
        out["ref_losses"].append(ref_step(i).item())
    return out


def seq_mesh_rank() -> dict:
    """Phase 14 (d) on one rank of phase 14's group, after (c): (a) ring
    and Ulysses attention on {'seq': 2} at the LM twin's widths (float32,
    with gradients) and the long probe (bf16, forward only), each rank's
    chunk held against the dense attention over the whole sequence; (b) 4
    bf16 ``long_doc`` train steps at the JAX trainer's widths with ring and
    with Ulysses attention beside the one-process steps; (c) 4 float32 LM
    train steps with the zigzag ring and packed-document segments beside
    the one-process steps, under deterministic algorithms. The counts of
    ``dot_interaction`` are set to 0 before and read after."""
    from tpu_tfrecord_torch import train_lm, train_longdoc
    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.device.ingest import TokenPacker
    from tpu_tfrecord_torch.models import long_doc, lm, optim, sharded
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    t0 = time.perf_counter()
    mesh = meshes.create_mesh({"seq": 2})
    distributed.barrier("sp")
    reset_launch_counts()
    out = {"attention": {}, "probe": {}}
    for i, (label, flavour, zigzag, hkv, lengths, segments) in enumerate(SP_ATTN_CASES):
        inp = sp_inputs(SP_ATTN_SHAPE, hkv, torch.float32, 100 + i, lengths, segments)
        out["attention"][label] = sp_attention_case(mesh, flavour, zigzag, inp, grads=True)
    for i, (label, flavour, zigzag) in enumerate(SP_PROBE_CASES):
        inp = sp_inputs(SP_PROBE_SHAPE, SP_PROBE_SHAPE[2], torch.bfloat16, 200 + i, False, False)
        out["probe"][label] = sp_attention_case(mesh, flavour, zigzag, inp, grads=False)
        del inp
        free_cuda()
    lc = train_longdoc.MAX_LEN // 2
    me = sharded.axis_index(mesh, "seq")
    cols = slice(me * lc, (me + 1) * lc)
    for flavour in ("ring", "ulysses"):
        cfg = long_doc.LongDocConfig(seq_dim=train_longdoc.SEQ_DIM, d_model=32, n_heads=4,
                                     n_layers=2, max_len=train_longdoc.MAX_LEN,
                                     sp_attention=flavour)
        pair = [long_doc.init_params(cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                                     "cuda") for _ in range(2)]
        opts = [optim.adam(p, train_longdoc.LR) for p in pair]
        batches = [{k: torch.from_numpy(v).cuda() for k, v in
                    long_doc.make_synthetic_batch(cfg, train_longdoc.BATCH, seed=s).items()}
                   for s in range(SP_STEPS)]
        local = [dict(b, frames=b["frames"][:, cols].contiguous()) for b in batches]
        out[f"long_doc {flavour}"] = sp_step_pair(
            mesh, f"long_doc {flavour}", SP_STEPS,
            lambda i: long_doc.train_step(pair[0], opts[0], local[i], cfg, mesh=mesh),
            lambda i: long_doc.train_step(pair[1], opts[1], batches[i], cfg))
    cfg = train_lm.make_config(2)
    packer = TokenPacker(train_lm.BATCH, train_lm.SEQ_LEN, packing="best_fit")
    rng, toks = np.random.default_rng(5), []
    while len(toks) < SP_STEPS:
        packer.feed_docs(rng.integers(1, train_lm.VOCAB, size=int(n))
                         for n in rng.integers(8, 97, size=64))
        b = packer.pop()
        if b is not None:
            toks.append((torch.from_numpy(b["tokens"]).cuda(),
                         torch.from_numpy(b["segment_ids"]).cuda()))
    pair = [lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED), "cuda")
            for _ in range(2)]
    opts = [optim.adam(p, train_lm.LR) for p in pair]
    torch.use_deterministic_algorithms(True)
    try:
        out["lm zigzag segments"] = sp_step_pair(
            mesh, "lm zigzag segments", SP_STEPS,
            lambda i: lm.train_step(pair[0], opts[0], toks[i][0], cfg, mesh=mesh, seq_axis="seq",
                                    segments=toks[i][1]),
            lambda i: lm.train_step(pair[1], opts[1], toks[i][0], cfg, segments=toks[i][1]))
        out["lm zigzag segments"]["param_err"] = max(
            (a - b).abs().max().item() for a, b in zip(optim.param_leaves(pair[0]),
                                                       optim.param_leaves(pair[1])))
    finally:
        torch.use_deterministic_algorithms(False)
    out["launches"] = dict(dot_interaction.instance_launches)
    out["seconds"] = time.perf_counter() - t0
    return out


def sp_twins_start(data_dir: str, work: str) -> list:
    """Start two ranks each of ``train_lm --mesh dp_sp --steps SP_TWIN_STEPS``
    and ``train_longdoc --max-steps SP_TWIN_STEPS``, and FSDP_TWIN_RANKS
    ranks of ``train_lm --mesh dp_fsdp --steps SP_TWIN_STEPS`` (phase 14
    (e)), under torchrun's environment on free ports (phase 9's documents
    under ``data_dir``), their output to ``work/sp_<name><r>.log``.
    Returns [(name, rank, process, log)]."""
    repo = os.path.dirname(os.path.abspath(__file__))

    def lm_twin(name: str, mesh: str) -> list:
        return ["tpu_tfrecord_torch.train_lm", "--mesh", mesh, "--steps", str(SP_TWIN_STEPS),
                "--save-every", "4", "--digest-out", os.path.join(work, f"sp_{name}.jsonl"),
                "--data-dir", os.path.join(data_dir, "lm_data"), "--ckpt-dir",
                os.path.join(work, f"sp_{name}_ck")]

    runs = {"lm": (lm_twin("lm", "dp_sp"), MULTI_RANKS),
            "longdoc": (["tpu_tfrecord_torch.train_longdoc", "--max-steps", str(SP_TWIN_STEPS),
                         "--data-dir", os.path.join(data_dir, "ld_data"), "--ckpt-dir",
                         os.path.join(work, "sp_ld_ck")], MULTI_RANKS),
            "fsdp": (lm_twin("fsdp", "dp_fsdp"), FSDP_TWIN_RANKS),
            "moe": (lm_twin("moe", "dp") + ["--moe", "4", "--diagnostics"], EP_TWIN_RANKS)}
    procs = []
    for name, (args, ranks) in runs.items():
        port = free_port()
        for r in range(ranks):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=repo)
            env.pop("LM_MESH", None)
            log = open(os.path.join(work, f"sp_{name}{r}.log"), "w")
            procs.append((name, r, subprocess.Popen([sys.executable, "-m", *args], cwd=repo,
                                                    env=env, stdout=log,
                                                    stderr=subprocess.STDOUT), log))
    return procs


def sp_twins_finish(procs, t0: float, work: str, card: str) -> dict:
    """Wait for the trainers' ranks (killed after SP_TWIN_TIMEOUT_S from
    ``t0``, the host's monotonic clock); their gates."""
    codes = {}
    for name, r, p, log in procs:
        try:
            codes[(name, r)] = p.wait(timeout=max(1.0, t0 + SP_TWIN_TIMEOUT_S - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes[(name, r)] = None
        log.close()
    gates, losses, gauges = {}, {}, {}
    for name, r, _, _ in procs:
        with open(os.path.join(work, f"sp_{name}{r}.log")) as fh:
            lines = fh.read().splitlines()
        done = [ln for ln in lines if ln.startswith("done:")]
        mesh = [ln for ln in lines if ln.startswith("mesh:")]
        if name == "longdoc":
            got = [float(ln.split("~")[1]) for ln in lines if ln.startswith("step ")]
        else:
            got = [float(json.loads(ln.split(" ", 1)[1])["loss"]) for ln in lines
                   if ln.startswith("lm_step ")]
        shape = {"lm": "{'data': 1, 'seq': 2} mode=dp_sp (2 ranks",
                 "longdoc": "{'data': 1, 'seq': 2} sp_attention=ring",
                 "fsdp": "{'data': 2, 'fsdp': 2} mode=dp_fsdp (4 ranks",
                 "moe": "{'data': 2} mode=dp (2 ranks"}[name]
        losses[(name, r)] = got
        gates[f"{name}_rank{r}"] = (codes[(name, r)] == 0 and bool(done)
                                    and done[0].startswith(f"done: {SP_TWIN_STEPS} steps")
                                    and bool(mesh) and mesh[0].startswith("mesh: " + shape)
                                    and bool(got) and bool(np.isfinite(got).all()))
        if name == "fsdp":
            gates[f"{name}_rank{r}"] &= any(ln.startswith("fsdp param bytes/device: ")
                                            for ln in lines)
        if name == "moe":
            diag = [json.loads(ln.split(": ", 1)[1]) for ln in lines
                    if ln.startswith("model diagnostics: ")]
            gauges[r] = diag[0] if len(diag) == 1 else None
            gates[f"{name}_rank{r}"] &= (gauges[r] is not None and sorted(gauges[r]) == [
                "moe.dropped_fraction", "moe.expert_imbalance", "moe.gate_entropy"]
                and bool(np.isfinite(list(gauges[r].values())).all()))
        tag = {"fsdp": "fsdp", "moe": "ep"}.get(name, "sp")
        print(f"{tag}: {name} rank {r} (exit "
              f"{codes[(name, r)]}): " + " | ".join(
                  ln for ln in lines[:2] + lines[-6:] if not ln.startswith("[W")) + f" ({card})")
    for name in ("lm", "longdoc", "fsdp", "moe"):
        ranks = [v for (n, _), v in losses.items() if n == name]
        gates[f"{name}_ranks_agree"] = all(v == ranks[0] for v in ranks)
    gates["moe_gauges_agree"] = len(gauges) == EP_TWIN_RANKS and all(
        g == gauges[0] for g in gauges.values())
    return gates


def seq_mesh_check(results: list, card: str) -> tuple:
    """Phase 14 (d)'s gates on the ranks' results, and its printed numbers
    beside ``card``. The hops pass through host memory (gloo on CUDA
    tensors, two ranks sharing the card): not NVLink or NCCL figures."""
    gates = {}
    runs = [res["sp"] for res in results]
    for label, *_ in SP_ATTN_CASES:
        cases = [run["attention"][label] for run in runs]
        gates[f"attention {label}"] = all(c["err"] <= SP_ATOL[torch.float32]
                                          and c["grad_rel"] <= SP_GRAD_RTOL for c in cases)
        for r, c in enumerate(cases):
            print(f"sp: {label} {SP_ATTN_SHAPE} f32 rank {r}: max |out - dense| {c['err']:.3g} "
                  f"(atol {SP_ATOL[torch.float32]}), gradients {c['grad_rel']:.3g} of the "
                  f"largest (tol {SP_GRAD_RTOL}); {c['ms']:.3f} ms a call, {c['collectives']} "
                  f"collectives in {c['collective_ms']:.3f} ms (CUDA events, median of "
                  f"{SP_REPS}); the dense attention over the whole sequence alone "
                  f"{c['dense_ms']:.3f} ms ({card}; gloo through host memory)")
    for label, *_ in SP_PROBE_CASES:
        cases = [run["probe"][label] for run in runs]
        gates[f"probe {label}"] = all(c["err"] <= SP_ATOL[torch.bfloat16] for c in cases)
        for r, c in enumerate(cases):
            print(f"sp: probe {label} {SP_PROBE_SHAPE} bf16 causal rank {r}: max |out - dense| "
                  f"{c['err']:.3g} (atol {SP_ATOL[torch.bfloat16]}); {c['ms']:.3f} ms a call, "
                  f"{c['collectives']} collectives in {c['collective_ms']:.3f} ms (CUDA events, "
                  f"median of {SP_REPS}); the dense attention over the whole sequence alone "
                  f"{c['dense_ms']:.3f} ms ({card}; gloo through host memory)")
    for label, tol in (("long_doc ring", SP_LONGDOC_TOL), ("long_doc ulysses", SP_LONGDOC_TOL),
                       ("lm zigzag segments", SP_LM_TOL)):
        steps = [run[label] for run in runs]
        gates[label] = all(len(s["losses"]) == SP_STEPS and np.isfinite(s["losses"]).all()
                           and np.allclose(s["losses"], s["ref_losses"], rtol=tol, atol=tol)
                           for s in steps) and steps[0]["losses"] == steps[1]["losses"]
        for r, s in enumerate(steps):
            print(f"sp: {label} rank {r}: losses {[round(x, 6) for x in s['losses']]} (one "
                  f"process {[round(x, 6) for x in s['ref_losses']]}, tol {tol}); host ms a step "
                  f"{[round(x, 2) for x in s['host_ms']]}, collectives "
                  f"{s['collectives']} in {[round(x, 2) for x in s['collective_ms']]} ms (CUDA "
                  f"events)" + (f"; max |param - one process| {s['param_err']:.3g}"
                                if "param_err" in s else "") + f" ({card})")
    gates["no_dot_interaction"] = all(not any(run["launches"].values()) for run in runs)
    launches = {k: sum(run["launches"][k] for run in runs) for k in INSTANCE_DTYPE}
    return gates, launches


# -- phase 14 (e): FSDP for the LM over the same two ranks -----------------------------

FSDP_STEPS = 4
FSDP_TOL = 1e-4            # f32 losses and parameters against one process, deterministic algorithms
FSDP_BYTES_RATIO = 0.65    # JAX's bar for a doubling of the fsdp axis (tests/test_lm_fsdp.py)
FSDP_TWIN_RANKS = 4        # train_lm --mesh dp_fsdp: {'data': 2, 'fsdp': 2}


def fsdp_mesh_rank() -> dict:
    """Phase 14 (e) on one rank of phase 14's group, after (d): on
    {'fsdp': 2}, FSDP_STEPS float32 LM train steps at the ``train_lm``
    twin's widths on this rank's ``lm.shard_params`` slices, beside the
    one-process steps on the same batches, under deterministic algorithms:
    both losses, both steps' host ms (synchronized) and the ms of the
    step's gathers (CUDA events); then ``lm.unshard_params`` against the
    one-process parameters, and the at-rest bytes of the slices and their
    Adam state against one process's (``harness.report_fsdp_param_bytes``).
    The counts of ``dot_interaction`` are set to 0 before and read after."""
    from tpu_tfrecord_torch import harness, train_lm
    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.models import lm, optim
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    t0 = time.perf_counter()
    mesh = meshes.create_mesh({"fsdp": 2})
    distributed.barrier("fsdp")
    reset_launch_counts()
    cfg = train_lm.make_config(2)
    ref, full = (lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                                "cuda") for _ in range(2))
    shard = lm.shard_params(full, mesh)
    del full
    opt, ref_opt = optim.adam(shard, train_lm.LR), optim.adam(ref, train_lm.LR)
    out = dict(bytes=harness.report_fsdp_param_bytes(optim.train_state(shard, opt)),
               one_bytes=harness.report_fsdp_param_bytes(optim.train_state(ref, ref_opt)),
               losses=[], ref_losses=[], host_ms=[], ref_ms=[], gather_ms=[], gathers=[])
    toks = [torch.from_numpy(lm.make_synthetic_tokens(cfg, train_lm.BATCH, seed=60 + i)).cuda()
            for i in range(FSDP_STEPS)]

    def timed(step) -> tuple:
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        return loss.item(), (time.perf_counter() - t) * 1e3

    torch.use_deterministic_algorithms(True)
    try:
        for i in range(FSDP_STEPS):
            with timed_collectives() as events:
                loss, ms = timed(lambda: lm.train_step(shard, opt, toks[i], cfg, mesh=mesh,
                                                       fsdp_axis="fsdp"))
            out["gather_ms"].append(sum(a.elapsed_time(b) for a, b in events))
            out["gathers"].append(len(events))
            ref_loss, ref_ms = timed(lambda: lm.train_step(ref, ref_opt, toks[i], cfg))
            for k, v in (("losses", loss), ("host_ms", ms), ("ref_losses", ref_loss),
                         ("ref_ms", ref_ms)):
                out[k].append(v)
        whole = lm.unshard_params(shard, mesh)
        out["param_err"] = max((a - b).abs().max().item() for a, b in
                               zip(optim.param_leaves(whole), optim.param_leaves(ref)))
    finally:
        torch.use_deterministic_algorithms(False)
    out["launches"] = dict(dot_interaction.instance_launches)
    out["seconds"] = time.perf_counter() - t0
    return out


def fsdp_mesh_check(results: list, twin_gates: dict, card: str) -> tuple:
    """Phase 14 (e)'s gates on the ranks' results and on its trainers'
    (``twin_gates``), and its printed numbers beside ``card``. The gathers
    pass through host memory (gloo on CUDA tensors, two ranks sharing the
    card): not NVLink or NCCL figures."""
    runs = [res["fsdp"] for res in results]
    gates = dict(twin_gates)
    gates["steps"] = all(len(r["losses"]) == FSDP_STEPS and np.isfinite(r["losses"]).all()
                         and np.allclose(r["losses"], r["ref_losses"], rtol=FSDP_TOL,
                                         atol=FSDP_TOL) and r["param_err"] <= FSDP_TOL
                         for r in runs)
    gates["ranks_agree"] = runs[0]["losses"] == runs[1]["losses"]
    gates["bytes"] = all(r["bytes"] < FSDP_BYTES_RATIO * r["one_bytes"] for r in runs)
    gates["no_dot_interaction"] = all(not any(r["launches"].values()) for r in runs)
    for k, r in enumerate(runs):
        print(f"fsdp: rank {k} on {{'fsdp': 2}}: losses {[round(x, 6) for x in r['losses']]} "
              f"(one process {[round(x, 6) for x in r['ref_losses']]}, tol {FSDP_TOL}); max "
              f"|unshard_params - one process| {r['param_err']:.3g}; at-rest bytes (parameters "
              f"+ Adam) {r['bytes']} against one process's {r['one_bytes']} (ratio "
              f"{r['bytes'] / r['one_bytes']:.4f}, bar {FSDP_BYTES_RATIO}); host ms a step "
              f"{[round(x, 2) for x in r['host_ms']]} ({r['gathers']} gathers in "
              f"{[round(x, 2) for x in r['gather_ms']]} ms, CUDA events), one process "
              f"{[round(x, 2) for x in r['ref_ms']]} ms; {r['seconds']:.1f} s ({card}; gloo "
              f"through host memory, not NVLink or NCCL)")
    launches = {k: sum(r["launches"][k] for r in runs) for k in INSTANCE_DTYPE}
    return gates, launches


# -- phase 14 (f): the MoE over the same two ranks ---------------------------------------

EP_TOL = 1e-4              # f32: the EP layer against moe_reference(shards=2); steps and parameters
EP_LAYER_CFS = (1.25, 0.75)
EP_NO_DROP_CF = 4.0        # no assignment drops: EP equals one process's moe_apply
EP_STEPS = 4
EP_NEAR_ZERO = 1e-6        # |one-process gradient| under which Adam turns rounding into a step
EP_TWIN_RANKS = 2          # train_lm --mesh dp --moe 4: {'data': 2}


@contextlib.contextmanager
def timed_all_to_all():
    """CUDA events around every tiled all_to_all of ``models.sharded``
    issued inside the block (forward and backward); yields the list of
    (start, end) event pairs."""
    from tpu_tfrecord_torch.models import sharded

    events: list = []
    original = sharded._tiled_all_to_all

    def timed(t, *args, **kw):
        if not t.is_cuda:
            return original(t, *args, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = original(t, *args, **kw)
        end.record()
        events.append((start, end))
        return out

    sharded._tiled_all_to_all = timed
    try:
        yield events
    finally:
        sharded._tiled_all_to_all = original


def ep_layer_case(mesh, mcfg, seed: int, grads: bool) -> dict:
    """``moe_apply_ep`` on {'expert': 2} over the ``train_lm`` twin's
    32 x 64 tokens as one stream (each rank's shard one contiguous block, as
    ``moe_reference(shards=2)`` cuts it), f32: the max |y - oracle| and the
    second call's ms; with ``grads`` (no drops) y and the gradients of
    ``(y**2).sum() + 0.01 * aux`` against one process's ``moe_apply``."""
    from tpu_tfrecord_torch import train_lm
    from tpu_tfrecord_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(seed)
    params = moe.init_params(mcfg, g, "cuda")
    x = torch.randn(train_lm.BATCH * train_lm.SEQ_LEN, mcfg.d_model, generator=g, device="cuda")
    out = {}
    if not grads:
        with torch.no_grad():  # a warm-up call: the axis's first exchange sets gloo up
            moe.moe_apply_ep(params, x, mcfg, mesh, expert_axis="expert")
        with torch.no_grad(), timed_all_to_all() as events:
            torch.cuda.synchronize()
            t = time.perf_counter()
            y, aux = moe.moe_apply_ep(params, x, mcfg, mesh, expert_axis="expert")
            torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - t) * 1e3
        out["all_to_all_ms"] = sum(a.elapsed_time(b) for a, b in events)
        out["all_to_alls"] = len(events)
        want = moe.moe_reference(params, x, mcfg, shards=2)
        out["err"] = float(np.abs(y.double().cpu().numpy() - want).max())
        out["aux"] = float(aux)
        return out
    runs = []
    for ep in (True, False):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xi = x.clone().requires_grad_(True)
        y, aux = (moe.moe_apply_ep(p, xi, mcfg, mesh, expert_axis="expert") if ep
                  else moe.moe_apply(p, xi, mcfg))
        ((y ** 2).sum() + 0.01 * aux).backward()
        runs.append([y.detach()] + [p[k].grad for k in sorted(p)] + [xi.grad])
    out["err"] = (runs[0][0] - runs[1][0]).abs().max().item()
    out["grad_rel"] = max(((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(runs[0][1:], runs[1][1:]))
    out["router_grad_max"] = runs[0][1 + sorted(params).index("router")].abs().max().item()
    return out


def ep_step_pair(label: str, card_step, ref_step) -> dict:
    """EP_STEPS steps on the mesh (``card_step(i)``) beside one process's
    (``ref_step(i)``) on this rank: both losses and host ms (synchronized),
    and the mesh step's collectives' ms and count and, of those, its
    all_to_alls' (CUDA events)."""
    out = dict(label=label, losses=[], ref_losses=[], host_ms=[], ref_ms=[], all_to_all_ms=[],
               all_to_alls=[], collective_ms=[], collectives=[])
    for i in range(EP_STEPS):
        with timed_collectives() as events, timed_all_to_all() as exchanges:
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = card_step(i)
            torch.cuda.synchronize()
            out["host_ms"].append((time.perf_counter() - t) * 1e3)
        out["collective_ms"].append(sum(a.elapsed_time(b) for a, b in events))
        out["collectives"].append(len(events))
        out["all_to_all_ms"].append(sum(a.elapsed_time(b) for a, b in exchanges))
        out["all_to_alls"].append(len(exchanges))
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = ref_step(i)
        torch.cuda.synchronize()
        out["ref_ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(loss.item())
        out["ref_losses"].append(ref.item())
    return out


def moe_mesh_rank() -> dict:
    """Phase 14 (f) on one rank of phase 14's group, after (e). (a) The EP
    layer on {'expert': 2} at the ``train_lm`` twin's MoE widths (4 experts
    of d_ff 256 over d_model 64, top-2), f32, against ``moe_reference(
    shards=2)`` at capacity factors 1.25 and 0.75, and at 4.0 (no drops) its
    gradients against one process's ``moe_apply``. (b) EP_STEPS float32 LM
    train steps of the twin's model with ``--moe 4`` under deterministic
    algorithms: on {'data': 2} (the global route, each rank its half of the
    rows) and on {'expert': 2} at factor 4.0 (each rank 2 of the 4 experts
    and their Adam state), each beside the one-process steps on the same
    batches; then the parameters gathered against one process's. (c) The
    steps' host ms and their all_to_alls' ms. The counts of
    ``dot_interaction`` are set to 0 before and read after. An entry whose
    one-process gradient came within EP_NEAR_ZERO of zero at some step
    (the key bias's, zero but for rounding) is held to Adam's bound of
    EP_STEPS steps of lr instead: Adam turns that rounding into a step of
    up to lr."""
    from tpu_tfrecord_torch import train_lm
    from tpu_tfrecord_torch.device import distributed, mesh as meshes
    from tpu_tfrecord_torch.models import lm, optim, sharded
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    t0 = time.perf_counter()
    emesh = meshes.create_mesh({"expert": 2})
    dmesh = meshes.create_mesh({"data": 2})
    distributed.barrier("ep")
    reset_launch_counts()
    cfg = train_lm.make_config(2, moe_experts=4)
    out = {"layer": {}}
    for i, cf in enumerate(EP_LAYER_CFS + (EP_NO_DROP_CF,)):
        mcfg = dataclasses.replace(lm._moe_cfg(cfg), capacity_factor=cf)
        out["layer"][str(cf)] = ep_layer_case(emesh, mcfg, 300 + i, grads=cf == EP_NO_DROP_CF)
    toks = [torch.from_numpy(lm.make_synthetic_tokens(cfg, train_lm.BATCH, seed=80 + i)).cuda()
            for i in range(EP_STEPS)]
    per = train_lm.BATCH // 2
    lo = sharded.axis_index(dmesh, "data") * per
    torch.use_deterministic_algorithms(True)
    try:
        for label, mesh, step_cfg, kw in (
                ("data", dmesh, cfg, dict(data_axis="data")),
                ("expert", emesh, dataclasses.replace(cfg, moe_capacity_factor=EP_NO_DROP_CF),
                 dict(expert_axis="expert"))):
            full, ref = (lm.init_params(step_cfg, torch.Generator(device="cuda").manual_seed(
                TRAIN_SEED), "cuda") for _ in range(2))
            mine = lm.shard_params(full, mesh, fsdp_axis=None,
                                   expert_axis=kw.get("expert_axis"))
            del full
            opt, ref_opt = optim.adam(mine, train_lm.LR), optim.adam(ref, train_lm.LR)
            rows = (lambda t: t[lo:lo + per]) if label == "data" else (lambda t: t)
            near = [torch.zeros_like(t, dtype=torch.bool) for t in optim.param_leaves(ref)]

            def ref_step(i):
                loss = lm.train_step(ref, ref_opt, toks[i], step_cfg)
                for m, t in zip(near, optim.param_leaves(ref)):
                    m |= t.grad.abs() < EP_NEAR_ZERO
                return loss

            res = ep_step_pair(
                label,
                lambda i: lm.train_step(mine, opt, rows(toks[i]), step_cfg, mesh=mesh, **kw),
                ref_step)
            whole = lm.unshard_params(mine, mesh, fsdp_axis=None,
                                      expert_axis=kw.get("expert_axis"))
            diffs = [(a - b).abs() for a, b in zip(optim.param_leaves(whole),
                                                     optim.param_leaves(ref))]
            res["param_err"] = max(d[~m].max().item() if (~m).any() else 0.0
                                   for d, m in zip(diffs, near))
            res["near_zero_err"] = max(d[m].max().item() if m.any() else 0.0
                                       for d, m in zip(diffs, near))
            res["near_zero_share"] = (sum(int(m.sum()) for m in near)
                                      / sum(m.numel() for m in near))
            adam = optim.adam_state(mine, opt)[0]
            res["expert_shapes"] = [list(t["blocks"]["moe"]["w_in"].shape)
                                    for t in (mine, adam.mu, adam.nu)]
            out[label] = res
            del mine, ref, opt, ref_opt, whole, adam
            free_cuda()
    finally:
        torch.use_deterministic_algorithms(False)
    out["launches"] = dict(dot_interaction.instance_launches)
    out["seconds"] = time.perf_counter() - t0
    return out


def moe_mesh_check(results: list, twin_gates: dict, card: str) -> tuple:
    """Phase 14 (f)'s gates on the ranks' results and on its trainers'
    (``twin_gates``), and its printed numbers beside ``card``. The
    all_to_alls pass through host memory (gloo on CUDA tensors, two ranks
    sharing the card): not NVLink or NCCL figures."""
    from tpu_tfrecord_torch import train_lm

    runs = [res["moe"] for res in results]
    gates = dict(twin_gates)
    for cf in EP_LAYER_CFS:
        cases = [r["layer"][str(cf)] for r in runs]
        gates[f"layer cf {cf}"] = all(c["err"] <= EP_TOL for c in cases)
        for k, c in enumerate(cases):
            print(f"ep: moe_apply_ep on {{'expert': 2}} rank {k}, 2048 tokens x d_model 64, 4 "
                  f"experts of d_ff 256, top-2, capacity factor {cf}, f32: max |y - "
                  f"moe_reference(shards=2)| {c['err']:.3g} (tol {EP_TOL}); {c['ms']:.3f} ms "
                  f"a call (host, synchronized), {c['all_to_alls']} all_to_alls in "
                  f"{c['all_to_all_ms']:.3f} ms (CUDA events) ({card}; gloo through host "
                  f"memory, not NVLink or NCCL)")
    cases = [r["layer"][str(EP_NO_DROP_CF)] for r in runs]
    gates["layer gradients"] = all(c["err"] <= EP_TOL and c["grad_rel"] <= EP_TOL
                                   and c["router_grad_max"] > 0 for c in cases)
    for k, c in enumerate(cases):
        print(f"ep: capacity factor {EP_NO_DROP_CF} rank {k}: max |y - one process's moe_apply| "
              f"{c['err']:.3g}, gradients of router, w_in, w_out and x within {c['grad_rel']:.3g} "
              f"of each one's largest (tol {EP_TOL}), router's largest {c['router_grad_max']:.3g}")
    for label, mesh in (("data", "{'data': 2}"), ("expert", "{'expert': 2}")):
        steps = [r[label] for r in runs]
        gates[f"steps {label}"] = all(
            len(s["losses"]) == EP_STEPS and np.isfinite(s["losses"]).all()
            and np.allclose(s["losses"], s["ref_losses"], rtol=EP_TOL, atol=EP_TOL)
            and s["param_err"] <= EP_TOL
            and s["near_zero_err"] <= EP_STEPS * train_lm.LR * (1 + 1e-3) for s in steps) and steps[0]["losses"] == steps[1]["losses"]
        if label == "expert":
            gates["expert shards"] = all(s["expert_shapes"] == [[2, 2, 64, 256]] * 3 for s in steps)
        for k, s in enumerate(steps):
            print(f"ep: lm --moe 4 on {mesh} rank {k}: losses {[round(x, 6) for x in s['losses']]}"
                  f" (one process {[round(x, 6) for x in s['ref_losses']]}, tol {EP_TOL}); max "
                  f"|gathered parameters - one process| {s['param_err']:.3g} ({s['near_zero_err']:.3g}"
                  f" over the {100 * s['near_zero_share']:.3f} % of entries with a gradient under "
                  f"{EP_NEAR_ZERO}, bound {EP_STEPS} x lr); host ms a step "
                  f"{[round(x, 2) for x in s['host_ms']]}, collectives "
                  f"{[round(x, 2) for x in s['collective_ms']]} ms in {s['collectives']} (CUDA "
                  f"events; the list all_gathers of the all_to_alls included), all_to_alls "
                  f"{[round(x, 2) for x in s['all_to_all_ms']]} ms in {s['all_to_alls']}; one "
                  f"process {[round(x, 2) for x in s['ref_ms']]} ms "
                  f"({card}; gloo through host memory, not NVLink or NCCL)")
    gates["no_dot_interaction"] = all(not any(r["launches"].values()) for r in runs)
    launches = {k: sum(r["launches"][k] for r in runs) for k in INSTANCE_DTYPE}
    return gates, launches


def multiproc_path(dirs, work: str, card: str, seq_data: str) -> dict:
    """Phase 14: phase 12's shards scored by MULTI_RANKS spawned ranks over
    a gloo group on this one card, held against this process's own
    single-process scoring of every shard, beside ``card``; then (c) the
    DLRM, (d) the sequence axis and (e) FSDP for the LM over the same
    ranks, (d)'s and (e)'s trainers on phase 9's documents under
    ``seq_data``. Returns the launches summed over the ranks."""
    import multiprocessing

    from tpu_tfrecord_torch import io as tio
    from tpu_tfrecord_torch.entry import _read_plan, _score_dataset
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.models.dlrm import init_params

    t0 = time.perf_counter()
    free_cuda()
    work = os.path.join(work, "multiproc")
    os.makedirs(work)
    # (1) the reference: every shard, one process, phase 12's fixed-4 feed
    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                        READPOOL_DEVICE)
    read = criteo_read_kw()
    paths, hash_buckets, pack, pad_to = _read_plan(dirs, cfg, read["pack"]["dense"],
                                                   read["pack"]["cat"])
    ds = TFRecordDataset(paths, BATCH, schema=read["schema"], recordType="Example",
                         hash_buckets=hash_buckets, pack=pack, num_workers=4)
    ref = _score_dataset(ds, model, READPOOL_DEVICE, pad_to, log1p_dense=True)
    ref_logits = ref.logits.float().cpu().reshape(-1).numpy()
    ref_rate = ref.batches * BATCH / ref.wall_s
    ref_idle = 1.0 - sum(ref.forward_s) / ref.wall_s
    want_schema = tio.reader(dirs).infer_schema_all_files(num_workers=2).json()
    del model, ref
    free_cuda()
    print(f"multiproc: single-process reference: {READPOOL_SHARDS} shards, "
          f"{ref_logits.size} rows at {ref_rate:.1f} rows/s whole, idle share {ref_idle:.4f} "
          f"({card})")

    # (2) the ranks, spawned (this process has CUDA up: no fork)
    spawn = multiprocessing.get_context("spawn")
    port = free_port()
    sizes = {k: globals()[k] for k in MULTI_SIZES}
    procs = [spawn.Process(target=multiproc_rank, args=(r, port, list(dirs), work, sizes),
                           name=f"chip-rank-{r}") for r in range(MULTI_RANKS)]
    t_ranks = time.perf_counter()
    for p in procs:
        p.start()

    # (c)'s train_dlrm ranks start right after them and run while they
    # import (its rank 0 writes its data); a thread here runs the twin and
    # marks its end, which the ranks wait for before they score
    twin_result: dict = {"gates": {"twin_exit": False, "twin_steps": False}, "done": [],
                         "seconds": 0.0}

    sp_result: dict = {"gates": {"sp_trainers": False}, "seconds": 0.0}

    def drive_twin():
        # (d)'s trainers start with (c)'s: all of them run while the ranks
        # import, and the ranks score after every one has exited
        t = time.monotonic()
        sp_procs = []
        try:
            sp_procs = sp_twins_start(seq_data, work)
            twin = mesh_twin_start(os.path.join(work, "twin_data"),
                                   os.path.join(work, "twin_ckpt"), work)
            twin_result["gates"], twin_result["done"] = mesh_twin_finish(twin, t, work)
            twin_result["seconds"] = time.monotonic() - t
            sp_result["gates"] = sp_twins_finish(sp_procs, t, work, card)
        finally:
            twin_result["seconds"] = twin_result["seconds"] or time.monotonic() - t
            sp_result["seconds"] = time.monotonic() - t
            for _, _, p, log in sp_procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
            open(os.path.join(work, TWIN_DONE), "w").close()

    twin_waiter = threading.Thread(target=drive_twin, name="twin")
    twin_waiter.start()
    deadline = time.monotonic() + MULTI_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    t_ranks = time.perf_counter() - t_ranks
    codes = [p.exitcode for p in procs]
    results = []
    for r in range(MULTI_RANKS):
        path = os.path.join(work, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path) else {"rank": r})

    if hung or any(codes) or any("error" in res or "trace" not in res for res in results):
        twin_waiter.join()  # the twin's processes end (or are killed) first
        detail = []
        for r, res in enumerate(results):
            with open(os.path.join(work, f"rank{r}.fault")) as fh:
                fault = fh.read()
            detail.append(f"rank {r}: {res.get('error', 'no result')[-2000:]}\n{fault[-3000:]}")
        raise SystemExit(f"multiproc: ranks hung {hung}, exit codes {codes}:\n"
                         + "\n".join(detail))

    # (3) the gates
    out_dir = os.path.join(work, "multiproc_out")
    successes = [os.path.join(d, f) for d, _, fs in os.walk(out_dir) for f in fs
                 if f == "_SUCCESS"]
    parts = sorted(f for f in os.listdir(out_dir) if f.startswith("part-"))
    tasks = sorted({int(f.split("-")[1]) for f in parts})
    back = TFRecordDataset(out_dir, 1 << 16, drop_remainder=False, num_workers=4)
    cols = {"shard": [], "row": [], "logit": []}
    with back.batches() as it:
        for cb in it:
            for n in cols:
                cols[n].append(np.asarray(cb[n].values))
    shard, row, logit = (np.concatenate(cols[n]) for n in ("shard", "row", "logit"))
    key = shard * READPOOL_ROWS + row
    order = np.argsort(key, kind="stable")
    complete = key.size == ref_logits.size and np.array_equal(key[order],
                                                               np.arange(ref_logits.size))
    equal = complete and np.array_equal(logit[order].view(np.uint32),
                                        ref_logits.astype(np.float32).view(np.uint32))
    r0, r1 = results[0], results[1]
    per_rank = READPOOL_SHARDS * READPOOL_ROWS // BATCH // MULTI_RANKS
    want_launches = {"bf16_mma": per_rank, "f32_tiled": 0}
    trace_ok = (r0["trace"]["trace_id"] == r1["trace"]["trace_id"]
                and r0["trace"]["parent_span_id"] is None
                and r1["trace"]["parent_span_id"] == r0["trace"]["span_id"])
    global_rows = MULTI_RANKS * BATCH
    batch_ok = all(
        res["batch"] and all(v["type"] == "DTensor" and v["shape"][0] == global_rows
                             and v["local"][0] == BATCH and v["batch_dim_sharded"]
                             for v in res["batch"].values())
        for res in results)
    gates = {
        "schema": all(res["schema"] == want_schema for res in results),
        "slots": [res["shards"] for res in results] == [list(range(r, READPOOL_SHARDS, MULTI_RANKS))
                                                         for r in range(MULTI_RANKS)],
        "logits_bit_equal": bool(equal),
        "one_success": len(successes) == 1 and all(res["success_seen"] for res in results),
        "task_ids": tasks == list(range(MULTI_RANKS)),
        "rows_read_back": int(key.size) == READPOOL_SHARDS * READPOOL_ROWS,
        "trace": trace_ok,
        "resume": all(res["resume"]["exact"] and res["resume"]["other_refused"]
                      for res in results),
        "launches": all(res["launches"] == want_launches for res in results),
        "global_batch": batch_ok and all(
            res["gather"] == dict(rows=global_rows, own_rows_in_place=True) for res in results),
    }
    for res in results:
        print(f"multiproc: rank {res['rank']}: shards {res['shards']}, {res['batches']} batches, "
              f"{res['rows_per_s']:.1f} rows/s whole over {res['wall_s']:.3f} s of scoring, "
              f"{res['steady']:.1f} steady (batches 2-{res['batches']}); the process's first "
              f"DTensor took {res['first_dtensor_s']:.3f} s (before the run); device idle "
              f"share at least {res['idle_share']:.4f} (1 - its synchronized forward time / "
              f"wall); launches {res['launches']}; batch {res['batch']}; inference "
              f"{res['infer_s']:.3f} s, write + commit {res['write_s']:.3f} s; resume "
              f"{res['resume']}; first global batch's labels gathered (CPU copy): "
              f"{res['gather']}; "
              f"{res['seconds']:.1f} s in the rank ({card})")
    out = dict(card=card, reference=dict(rows_per_s=ref_rate, idle_share=ref_idle),
               ranks=[{k: res[k] for k in ("rank", "shards", "batches", "rows_per_s", "steady",
                                            "first_dtensor_s", "wall_s",
                                            "idle_share", "duty_cycle", "launches", "gather",
                                            "infer_s", "write_s", "seconds")}
                      for res in results],
               ranks_s=t_ranks, parts=len(parts), gates=gates,
               launches={k: sum(res["launches"][k] for res in results) for k in want_launches})
    # the card's idle share while the ranks scored: 1 - the union of both
    # ranks' synchronized forwards over the span from the first start to
    # the last end
    lo = min(res["span"][0] for res in results)
    hi = max(res["span"][1] for res in results)
    busy, reach = 0.0, lo
    for a, b in sorted(tuple(f) for res in results for f in res["forwards"]):
        busy += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    out["card_idle_share"] = 1.0 - busy / (hi - lo)
    out["together_rows_per_s"] = sum(res["batches"] for res in results) * BATCH / (hi - lo)
    out["seconds"] = time.perf_counter() - t0
    print(f"multiproc: gates {gates}; {len(parts)} part files from tasks {tasks}, "
          f"{len(successes)} _SUCCESS, {key.size} rows read back; ranks took {t_ranks:.1f} s "
          f"from spawn to exit")
    walls = ", ".join(f"rank {res['rank']} {res['wall_s']:.3f} s at "
                      f"{res['rows_per_s'] / 1e6:.3f} M rows/s" for res in results)
    print(f"multiproc: phase 14 (a) and (b) took {out['seconds']:.1f} s; scoring {walls}; both ranks "
          f"{out['together_rows_per_s'] / 1e6:.3f} M rows/s over {hi - lo:.3f} s, the card idle "
          f"{out['card_idle_share']:.4f} of it (one process: "
          f"{ref_rate / 1e6:.3f} M rows/s, idle {ref_idle:.4f}) ({card})")
    print("multiproc: " + json.dumps(out, default=str))
    if not all(gates.values()):
        raise SystemExit(f"multiproc: gates failed: {gates}")

    # (c) the mesh: the one-process reference here, after the ranks
    t_mesh = time.perf_counter()
    mesh_gates, mesh = mesh_check(dirs, work, results, card)
    twin_waiter.join()
    mesh_gates.update(twin_result["gates"])
    out["mesh"] = mesh
    out["mesh_launches"] = {k: sum(res["mesh"][label]["launches"][k] for res in results
                                   for label, *_ in MESH_RUNS) for k in INSTANCE_DTYPE}
    print(f"mesh: train_dlrm --max-steps {MESH_TWIN_STEPS} on {MULTI_RANKS} ranks: "
          f"{twin_result['done']}; {twin_result['seconds']:.1f} s from start to exit, beside "
          f"the ranks' start and (d)'s trainers; the ranks waited "
          f"{[round(r['twin_wait_s'], 2) for r in results]} s for them before scoring ({card})")
    print(f"mesh: gates {mesh_gates}; launches {out['mesh_launches']}; (c) took "
          f"{time.perf_counter() - t_mesh:.1f} s after the ranks ({card})")
    if not all(mesh_gates.values()):
        raise SystemExit(f"mesh: gates failed: {mesh_gates}")
    # (d) the sequence axis
    sp_gates, out["sp_launches"] = seq_mesh_check(results, card)
    sp_gates.update({k: v for k, v in sp_result["gates"].items()
                     if not k.startswith(("fsdp", "moe"))})
    out["sp_seconds"] = [res["sp"]["seconds"] for res in results]
    print(f"sp: gates {sp_gates}; launches {out['sp_launches']}; (d) took "
          f"{[round(x, 1) for x in out['sp_seconds']]} s in the ranks, its and (e)'s trainers "
          f"{sp_result['seconds']:.1f} s from start to exit (beside the ranks' start) ({card})")
    if not all(sp_gates.values()):
        raise SystemExit(f"sp: gates failed: {sp_gates}")
    # (e) FSDP for the LM
    fsdp_gates, out["fsdp_launches"] = fsdp_mesh_check(
        results, {k: v for k, v in sp_result["gates"].items() if k.startswith("fsdp")}, card)
    out["fsdp_seconds"] = [res["fsdp"]["seconds"] for res in results]
    out["seconds"] = time.perf_counter() - t0
    print(f"fsdp: gates {fsdp_gates}; launches {out['fsdp_launches']}; (e) took "
          f"{[round(x, 1) for x in out['fsdp_seconds']]} s in the ranks; phase 14 took "
          f"{out['seconds']:.1f} s ({card})")
    if not all(fsdp_gates.values()):
        raise SystemExit(f"fsdp: gates failed: {fsdp_gates}")
    # (f) the MoE over ranks
    ep_gates, out["ep_launches"] = moe_mesh_check(
        results, {k: v for k, v in sp_result["gates"].items() if k.startswith("moe")}, card)
    out["ep_seconds"] = [res["moe"]["seconds"] for res in results]
    out["seconds"] = time.perf_counter() - t0
    print(f"ep: gates {ep_gates}; launches {out['ep_launches']}; (f) took "
          f"{[round(x, 1) for x in out['ep_seconds']]} s in the ranks; phase 14 took "
          f"{out['seconds']:.1f} s ({card})")
    if not all(ep_gates.values()):
        raise SystemExit(f"ep: gates failed: {ep_gates}")
    return out



# -- phase 15: remote filesystems --------------------------------------------------------

REMOTE_LATENCY_S = 0.020   # the server's delay of each request in the bare-read probe
REMOTE_DEPTHS = (1, 4)     # PrefetchReader fetches in flight in the bare-read probe
REMOTE_WORKERS = 4         # the scoring runs' pool: phase 12's fixed 4
REMOTE_RETRIES = 4         # read_retries of the faulted read
REMOTE_TIMEOUT_S = 120     # for the server process to start or answer
REMOTE_BLOCK = 8 << 20     # the JAX default TFR_REMOTE_BLOCK_BYTES, which the rules key on


def range_server_main(root: str, conn) -> None:
    """Phase 15's Range server (``httpfs.serve_directory`` over ``root``),
    in a spawned process so that its sends do not take the GIL from the
    decode pool: it sends its URL, then answers (op, arg) requests from
    ``conn`` until "stop"."""
    from tpu_tfrecord_torch import httpfs
    from tpu_tfrecord_torch.faults import FaultPlan

    torch.set_num_threads(1)
    srv = httpfs.serve_directory(root)
    plan = None
    conn.send(srv.url)
    try:
        while True:
            op, arg = conn.recv()
            if op == "stop":
                break
            if op == "plan":
                if plan is not None:
                    plan.release()
                plan = FaultPlan.from_json(arg) if arg is not None else None
                srv.set_plan(plan)
                conn.send(None)
            elif op == "latency":
                srv.set_latency(arg)
                conn.send(None)
            elif op == "ledger":
                conn.send(plan.ledger_json() if plan is not None else "")
            elif op == "counts":
                conn.send(dict(requests=srv.request_count, gets=srv.get_count,
                               file_gets=srv.file_get_count))
    finally:
        if plan is not None:
            plan.release()
        srv.close()


class RangeServerProcess:
    """The parent's handle on ``range_server_main``: ``url_for``,
    ``set_plan`` (a ``FaultPlan``, run in the server), ``set_latency``,
    ``ledger``, ``counts``; ``close`` stops the process (killed after
    10 s)."""

    def __init__(self, root: str):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=range_server_main, args=(root, child),
                                 name="chip-range-server", daemon=True)
        self._proc.start()
        child.close()
        self.url = self._answer("start")

    def _answer(self, what: str):
        if not self._conn.poll(REMOTE_TIMEOUT_S):
            raise SystemExit(f"remote: the server process did not answer ({what}) within "
                             f"{REMOTE_TIMEOUT_S} s; alive: {self._proc.is_alive()}")
        return self._conn.recv()

    def _call(self, op: str, arg=None):
        self._conn.send((op, arg))
        return self._answer(op)

    def url_for(self, rel: str) -> str:
        return f"{self.url}/{rel}"

    def set_plan(self, plan) -> None:
        self._call("plan", None if plan is None else plan.to_json())

    def set_latency(self, seconds: float) -> None:
        self._call("latency", seconds)

    def ledger(self) -> str:
        return self._call("ledger")

    def counts(self) -> dict:
        return self._call("counts")

    def close(self) -> None:
        if self._proc.is_alive():
            try:
                self._conn.send(("stop", None))
            except OSError:
                pass
            self._proc.join(10)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()
        self._conn.close()


def bare_read_mbps(url: str, depth: int) -> tuple:
    """(MB/s, bytes) of one sequential read of ``url`` through a
    ``fs.PrefetchReader`` of REMOTE_BLOCK blocks at ``depth`` fetches in
    flight, 8 MB at a time, with no decode."""
    from tpu_tfrecord_torch import fs

    fsys = fs.filesystem_for(url)
    buf = bytearray(8 << 20)
    nb = 0
    t0 = time.perf_counter()
    with fs.PrefetchReader(fsys, url, fsys.size(url), REMOTE_BLOCK, depth) as fh:
        while True:
            k = fh.readinto(buf)
            if not k:
                break
            nb += k
    return nb / (time.perf_counter() - t0) / 1e6, nb


REMOTE_COUNTERS = ("remote.fetch_retries", "remote.bad_range", "read.retries")


def remote_counters() -> dict:
    from tpu_tfrecord_torch.metrics import METRICS

    return {n: METRICS.counter(n) for n in REMOTE_COUNTERS}


def remote_serve(urls, model, label: str, nbytes: int, card: str, tag: str = "remote",
                 **kw) -> tuple:
    """One bf16 serving run of the shards at ``urls`` through phase 12's
    fixed-4 feed (dataset -> HostPrefetcher -> DeviceIterator -> the DLRM),
    its line printed under ``tag``: (ScoreResult, rates)."""
    from tpu_tfrecord_torch.entry import _read_plan, _score_dataset
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.metrics import METRICS
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    read = criteo_read_kw()
    paths, hash_buckets, pack, pad_to = _read_plan(urls, model.cfg, read["pack"]["dense"],
                                                   read["pack"]["cat"])
    METRICS.reset()
    ds = TFRecordDataset(paths, BATCH, schema=read["schema"], recordType="Example",
                         hash_buckets=hash_buckets, pack=pack, num_workers=REMOTE_WORKERS, **kw)
    reset_launch_counts()
    res = _score_dataset(ds, model, READPOOL_DEVICE, pad_to, log1p_dense=True)
    launches = dict(dot_interaction.instance_launches)
    whole = res.batches * BATCH / res.wall_s
    idle = 1.0 - sum(res.forward_s) / res.wall_s
    stats = dict(whole=whole, steady=steady_rate(res), mbps=nbytes / res.wall_s / 1e6,
                 idle_share=idle, duty_cycle=res.duty_cycle, wall_s=res.wall_s,
                 counters=remote_counters(), launches=launches)
    pool = "the service's workers" if kw.get("service") else f"{REMOTE_WORKERS} workers"
    print(f"{tag}: serving bf16, {label}, {pool}: {res.batches} batches, "
          f"{whole:.1f} rows/s whole, {stats['steady']:.1f} steady (batches 2-{res.batches}), "
          f"{stats['mbps']:.1f} MB/s of shards; device idle share at least {idle:.4f} "
          f"(1 - synchronized forward time / wall); counters {stats['counters']}; kernel "
          f"launches {launches} ({card})")
    return res, stats


def remote_fault_plan(names: list):
    """The faulted read's plan: one reset and one truncation mid-body (an
    eighth and three eighths into the block), one 503 with Retry-After
    0.05 s and one trickle, each on one block request (``<url path>@<block
    start>``) of its own shard. Block starts of 3 x REMOTE_BLOCK and up: a
    key must not be a prefix of a later block's."""
    from tpu_tfrecord_torch.faults import FaultPlan, FaultRule

    key = [f"/shard{s:02d}/{n}" for s, n in enumerate(names)]
    return FaultPlan([
        FaultRule(op="http", kind="reset", path=f"{key[0]}@{3 * REMOTE_BLOCK}",
                  cap_bytes=REMOTE_BLOCK // 8, times=1),
        FaultRule(op="http", kind="truncated_body", path=f"{key[1]}@{4 * REMOTE_BLOCK}",
                  cap_bytes=REMOTE_BLOCK * 3 // 8, times=1),
        FaultRule(op="http", kind="http_error", path=f"{key[2]}@0", status=503,
                  retry_after_s=0.05, times=1),
        FaultRule(op="http", kind="trickle", path=f"{key[3]}@{5 * REMOTE_BLOCK}",
                  cap_bytes=64 << 10, stall_ms=2, times=1),
    ], seed=15)


def remote_path(dirs, files, root: str, warm, local_logits, card: str) -> dict:
    """Phase 15: phase 12's shards read over HTTP from the port's Range
    server in a spawned process, beside ``card``: (1) bare read rates, (2)
    discovery, inference and the bf16 DLRM scoring the shards over the
    link, its logits bit-equal to phase 12's local run (``local_logits``),
    (3) a faulted decode-only read, replayed, and a shifted Content-Range
    that must raise, (4) the shards through the epoch cache. Returns the
    kernel launches of (2)'s scoring run."""
    from tpu_tfrecord_torch import cache as cache_mod
    from tpu_tfrecord_torch import fs
    from tpu_tfrecord_torch import io as tio
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.faults import FaultPlan, FaultRule
    from tpu_tfrecord_torch.httpfs import BadContentRangeError
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.metrics import METRICS
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch

    t0 = time.perf_counter()
    free_cuda()
    names = [os.path.basename(f) for f in files]
    nbytes = sum(os.path.getsize(f) for f in files)
    n_batches = READPOOL_SHARDS * READPOOL_ROWS // BATCH
    want_launches = {"bf16_mma": n_batches, "f32_tiled": 0}
    cache_dir = os.path.join(root, "remote_cache")
    t_start = time.perf_counter()
    srv = RangeServerProcess(root)
    out = dict(card=card, server_start_s=time.perf_counter() - t_start)
    gates = {}
    try:
        urls = [srv.url_for(f"shard{s:02d}") for s in range(READPOOL_SHARDS)]
        print(f"remote: Range server (httpfs.serve_directory) in a spawned process at {srv.url}, "
              f"up in {out['server_start_s']:.2f} s; loopback TCP, so the rates below are what "
              f"the client and the decoder cost, not a remote store's")

        # (1) bare sequential reads of one shard, no decode
        bare = {}
        for latency in (0.0, REMOTE_LATENCY_S):
            srv.set_latency(latency)
            for depth in REMOTE_DEPTHS:
                mbps, got = bare_read_mbps(srv.url_for(f"shard00/{names[0]}"), depth)
                if got != os.path.getsize(files[0]):
                    raise SystemExit(f"remote: the bare read got {got} bytes of {files[0]}")
                bare[f"latency {latency * 1e3:.0f} ms, depth {depth}"] = mbps
        srv.set_latency(0.0)
        print(f"remote: bare sequential read of one {os.path.getsize(files[0])}-byte shard "
              f"({REMOTE_BLOCK >> 20} MiB blocks), MB/s by server delay a request and fetches "
              f"in flight: { {k: round(v, 1) for k, v in bare.items()} }")
        out["bare_mbps"] = bare

        # (2) discovery, inference, and the bf16 DLRM over the link
        t_disc = time.perf_counter()
        remote_shards = tio.discover_shards(urls)
        local_shards = tio.discover_shards(dirs)
        gates["discovery"] = (
            [(s.path.rsplit("/", 1)[-1], s.size) for s in remote_shards]
            == [(os.path.basename(s.path), s.size) for s in local_shards])
        t_disc = time.perf_counter() - t_disc
        t_inf = time.perf_counter()
        remote_schema = tio.reader(urls).infer_schema_all_files(num_workers=2).json()
        t_inf = time.perf_counter() - t_inf
        gates["schema"] = remote_schema == tio.reader(dirs).infer_schema_all_files(
            num_workers=2).json()
        print(f"remote: discovery over http:// {t_disc:.3f} s, sizes equal the local shards': "
              f"{gates['discovery']}; infer_schema_all_files over http:// {t_inf:.3f} s "
              f"({nbytes / t_inf / 1e6:.1f} MB/s), equal to the local inference: "
              f"{gates['schema']}")
        cfg = criteo_cfg()
        model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                            READPOOL_DEVICE)
        model(make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), READPOOL_DEVICE))
        gets0 = srv.counts()
        res, clean = remote_serve(urls, model, "clean read over http://", nbytes, card)
        gets1 = srv.counts()
        launches = clean["launches"]
        logits = res.logits.float().cpu()
        gates["logits_bit_equal"] = (logits.shape == local_logits.shape
                                     and torch.equal(logits, local_logits))
        gates["launches"] = launches == want_launches and res.batches == n_batches
        clean["server"] = {k: gets1[k] - gets0[k] for k in gets1}
        print(f"remote: the clean read's logits bit-equal to phase 12's local run, every one of "
              f"{logits.numel()} rows: {gates['logits_bit_equal']}; requests the server saw "
              f"{clean['server']}")
        out["clean"] = clean
        del res

        # (3) the faulted decode-only read, twice, then a lying server
        if fs._remote_prefetch_params() != (REMOTE_BLOCK, 4):
            raise SystemExit(f"remote: the faulted read needs the default blocks, got "
                             f"{fs._remote_prefetch_params()}")
        plan = remote_fault_plan(names)
        faulted = []
        for run in range(2):
            srv.set_plan(plan)
            METRICS.reset()
            digests, rows, wall, cpu, _ = readpool_pass(urls, read_retries=REMOTE_RETRIES)
            ledger = sorted(srv.ledger().splitlines())
            srv.set_plan(None)
            c = remote_counters()
            kinds = sorted(json.loads(line)["kind"] for line in ledger)
            failing = sum(k != "trickle" for k in kinds)
            faulted.append(dict(equal=digests == warm, rows_per_s=rows / wall, wall_s=wall,
                                cpu_s=cpu, counters=c, ledger=ledger, kinds=kinds))
            print(f"remote: faulted decode-only read {run + 1} (read_retries={REMOTE_RETRIES}, "
                  f"{READPOOL_COLD_WORKERS} workers): {rows / wall:.1f} rows/s, {wall:.3f} s; "
                  f"batches equal the clean read's: {digests == warm}; fired {kinds}; counters "
                  f"{c}")
            gates[f"faulted_{run + 1}"] = (digests == warm and kinds == sorted(
                ["reset", "truncated_body", "http_error", "trickle"])
                and c["remote.fetch_retries"] >= failing)
        gates["ledger_replays"] = faulted[0]["ledger"] == faulted[1]["ledger"]
        print(f"remote: the replayed plan's ledger equals the first run's: "
              f"{gates['ledger_replays']}")
        out["faulted"] = [{k: v for k, v in f.items() if k != "ledger"} for f in faulted]
        srv.set_plan(FaultPlan([FaultRule(op="http", kind="bad_content_range",
                                          path=f"/shard00/{names[0]}@0", shift_bytes=32,
                                          times=None)]))
        METRICS.reset()
        seen, raised = 0, None
        try:
            ds = TFRecordDataset(urls, BATCH, num_workers=READPOOL_COLD_WORKERS,
                                 **criteo_read_kw())
            with ds.batches() as it:
                for cb in it:
                    seen += cb.num_rows
        except OSError as e:
            raised = e
        srv.set_plan(None)
        gates["bad_content_range"] = isinstance(raised, BadContentRangeError) and seen == 0
        print(f"remote: a shifted Content-Range with no retries raised "
              f"{type(raised).__name__}: {raised}; rows yielded before it: {seen}; "
              f"remote.bad_range {METRICS.counter('remote.bad_range')}")

        # (4) the shards over the link into the epoch cache, then a warm epoch
        METRICS.reset()
        digests, rows, wall, cpu, _ = readpool_pass(urls, cache="auto", cache_dir=cache_dir)
        populate = dict(equal=digests == warm, rows_per_s=rows / wall, wall_s=wall,
                        misses=METRICS.counter("cache.misses"),
                        entries=len([n for n in os.listdir(cache_dir)
                                     if n.endswith(cache_mod.ENTRY_SUFFIX)]))
        gets0 = srv.counts()
        res, warm_stats = remote_serve(urls, model, "warm epoch from the cache", nbytes, card,
                                       cache="auto", cache_dir=cache_dir)
        gets1 = srv.counts()
        hits = METRICS.counter("cache.hits")
        warm_stats["server"] = {k: gets1[k] - gets0[k] for k in gets1}
        gates["cache"] = (populate["equal"] and populate["misses"] == READPOOL_SHARDS
                          and populate["entries"] == READPOOL_SHARDS and hits == READPOOL_SHARDS
                          and warm_stats["server"]["file_gets"] == 0
                          and torch.equal(res.logits.float().cpu(), local_logits)
                          and warm_stats["launches"] == want_launches)
        print(f"remote: populate over http:// ({READPOOL_COLD_WORKERS} workers): "
              f"{populate['rows_per_s']:.1f} rows/s, {populate['misses']} misses, "
              f"{populate['entries']} entries, batches equal: {populate['equal']}; the warm "
              f"epoch: {hits} hits, requests the server saw {warm_stats['server']} (no file GET "
              f"is the gate), logits bit-equal: "
              f"{torch.equal(res.logits.float().cpu(), local_logits)}")
        out.update(populate=populate, warm=warm_stats)
        del model, res
    finally:
        srv.close()
        cache_mod.release_registry(cache_dir)
        shutil.rmtree(cache_dir, ignore_errors=True)
    free_cuda()
    out.update(gates=gates, launches=launches, seconds=time.perf_counter() - t0)
    print(f"remote: gates {gates}; phase 15 took {out['seconds']:.1f} s ({card})")
    print("remote: " + json.dumps(out, default=str))
    if not all(gates.values()):
        raise SystemExit(f"remote: gates failed: {gates}")
    return out

# -- phase 16: the fleet flight recorder and the SLO engine ---------------------------------

FLEET_INTERVAL_S = 0.2     # every spool's cadence: the trainer's staleness bar is 0.4 s
FLEET_REQUESTS = 4         # requests sent to the spooling replica
FLEET_TRAIN_STEPS = 32
FLEET_KILL_AT = 12         # the trainer's last step before SIGKILL
FLEET_TIMEOUT_S = 120      # for a spawned process to start, answer or reach a step


def fleet_trainer(spool_dir: str, work: str, killed: dict) -> None:
    """Phase 16 (3), on a thread: ``train_lm`` at phase 9's width for
    FLEET_TRAIN_STEPS steps, spooling into ``spool_dir``; after its
    FLEET_KILL_AT ``lm_step`` line, once its spool's newest line counts a
    step, SIGKILL. A synchronous save after every step (≈ 1.2 step times
    each) spreads steps 2-15 over more than one spool interval, so a
    counted step lands before step 16, where the harness's first window
    would publish its rounded share gauges. Fills ``killed`` (rc, kill
    time, pid, the steps the spool counted, the seconds from spawn to the
    kill)."""
    import signal

    from tpu_tfrecord_torch import fleet

    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.train_lm", "--device", READPOOL_DEVICE,
           "--spool", spool_dir, "--spool-interval", str(FLEET_INTERVAL_S),
           "--steps", str(FLEET_TRAIN_STEPS), "--save-every", "1", "--ckpt-mode", "sync",
           "--data-dir", os.path.join(work, "lm_data"),
           "--ckpt-dir", os.path.join(work, "fleet_lm_ckpt"),
           "--digest-out", os.path.join(work, "fleet_lm.jsonl")]
    t0 = time.perf_counter()
    with open(os.path.join(work, "fleet_trainer.err"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                                stdout=subprocess.PIPE, stderr=err, text=True)
        timer = threading.Timer(FLEET_TIMEOUT_S, proc.kill)  # a hung run ends the read
        timer.start()
        try:
            for line in proc.stdout:
                if (line.startswith("lm_step ")
                        and json.loads(line.split(" ", 1)[1])["step"] == FLEET_KILL_AT):
                    counted = 0
                    while proc.poll() is None and time.perf_counter() - t0 < FLEET_TIMEOUT_S:
                        names = [n for n in os.listdir(spool_dir)
                                 if n.endswith(f"-{proc.pid}{fleet.SPOOL_SUFFIX}")]
                        snap = (fleet.read_spool(os.path.join(spool_dir, names[0]))
                                if names else None)
                        counted = snap.counters.get("train.steps", 0) if snap else 0
                        if counted:
                            break
                        time.sleep(0.002)
                    proc.send_signal(signal.SIGKILL)
                    killed.update(at=time.time(), counted=counted,
                                  kill_s=time.perf_counter() - t0)
                    break
        finally:
            timer.cancel()
            if proc.poll() is None and "at" not in killed:
                proc.kill()
            killed.update(rc=proc.wait(timeout=60), pid=proc.pid)
            proc.stdout.close()


def fleet_replica(spool_dir: str) -> tuple:
    """Phase 16 (2): ``python -m tpu_tfrecord_torch.serving --device
    <SERVE_DEVICE> --spool-dir spool_dir`` (phase 10 (e)'s synthetic LM),
    started: (process, the ready JSON that a reader thread fills, that
    thread, [seconds to ready] once read). The caller scores meanwhile and
    joins the thread when it needs the replica."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.serving", "--device",
                             SERVE_DEVICE, "--spool-dir", spool_dir], cwd=repo,
                            env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ready, ready_s = {}, []

    def read():
        ready.update(json.loads(proc.stdout.readline() or "{}"))
        ready_s.append(time.perf_counter() - t0)

    reader = threading.Thread(target=read, name="fleet-replica-ready")
    reader.start()
    return proc, ready, reader, ready_s


def fleet_reference(windows_, n_new: int = 4, mb: int = 4) -> list:
    """Phase 10 (e)'s reference tokens of ``windows_`` (``n_new`` new tokens
    each, microbatches of ``mb``) on the card, under deterministic
    algorithms as the replica runs."""
    import argparse

    from tpu_tfrecord_torch import serving

    syn = argparse.Namespace(vocab=96, d_model=32, heads=2, layers=4, max_len=16, mb=4,
                             virtual=1, seed=0)
    params, cfg = serving._build_synthetic(syn)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        return serving.sequential_reference(params, cfg, 2, [(w, n_new) for w in windows_], mb,
                                            device=SERVE_DEVICE)
    finally:
        torch.use_deterministic_algorithms(False)


def fleet_path(dirs, work: str, root: str, local_logits, fixed4_whole: float, card: str) -> dict:
    """Phase 16: the fleet flight recorder and the SLO engine, beside
    ``card``: a scorer (this process), a serving replica and a trainer
    spool into one dir under ``root`` at once; the aggregate and the SLO
    evaluation of that dir are held to the files. ``local_logits`` and
    ``fixed4_whole`` are phase 12's fixed-4 logits and rows/s. Returns the
    numbers, the kernel launches of (1)'s scoring window among them."""
    import signal
    import urllib.request

    from tpu_tfrecord_torch import fleet, serving, slo, telemetry, train_lm
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.metrics import METRICS, Histogram
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch

    t0 = time.perf_counter()
    free_cuda()
    spool_dir = os.path.join(root, "spool")
    n_batches = READPOOL_SHARDS * READPOOL_ROWS // BATCH
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for d in dirs for n in os.listdir(d)
                 if n.endswith(".tfrecord"))
    gates, out = {}, dict(card=card, spool_dir=spool_dir)
    train_lm.generate(os.path.join(work, "lm_data"))  # phase 9's documents, when absent
    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                        READPOOL_DEVICE)
    model(make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), READPOOL_DEVICE))
    os.makedirs(spool_dir)
    killed: dict = {}
    trainer = threading.Thread(target=fleet_trainer, args=(spool_dir, work, killed),
                               name="fleet-trainer")
    trainer.start()
    # the replica starts while (1) scores: its start no longer adds to the phase
    replica, ready, reader, ready_after = fleet_replica(spool_dir)
    rc = None
    try:
        # (1) this process scores the shards while the other two spool
        spool_kw = dict(telemetry_spool_dir=spool_dir, spool_interval_s=FLEET_INTERVAL_S,
                        telemetry_role="scorer")
        res, scored = remote_serve(dirs, model, "spooling as the scorer", nbytes, card,
                                   tag="fleet", **spool_kw)
        launches = scored["launches"]
        scorer_ctx = telemetry.current_context()
        logits = res.logits.float().cpu()
        gates["logits_bit_equal"] = logits.shape == local_logits.shape and torch.equal(
            logits, local_logits)
        gates["launches"] = (launches == {"bf16_mma": n_batches, "f32_tiled": 0}
                             and res.batches == n_batches)
        print(f"fleet: the scorer's logits bit-equal to phase 12's local run, every one of "
              f"{logits.numel()} rows: {gates['logits_bit_equal']}; {scored['whole']:.1f} rows/s "
              f"whole spooling beside {fixed4_whole:.1f} in phase 12's fixed-4 run of this "
              f"process (the other two processes starting meanwhile)")
        del res

        # (2) the replica answers, then drains on SIGTERM
        reader.join(timeout=FLEET_TIMEOUT_S)
        ready_s = ready_after[0] if ready_after else float("nan")
        if "addr" not in ready:
            raise SystemExit(f"fleet: the replica printed no ready line: {replica.poll()}")
        rng = np.random.default_rng(3)
        ws = [rng.integers(0, 96, size=16).astype(np.int32) for _ in range(FLEET_REQUESTS)]
        cl = serving.ServeClient([ready["addr"]], timeout_s=60.0)
        try:
            got = [cl.generate(w, 4) for w in ws]
        finally:
            cl.close()
        trainer.join(timeout=FLEET_TIMEOUT_S)
        t1 = time.perf_counter()
        replica.send_signal(signal.SIGTERM)
        rc = replica.wait(timeout=60)
        exit_s = time.perf_counter() - t1
    finally:
        if replica.poll() is None:
            replica.kill()
            replica.wait(timeout=30)
        err = replica.stderr.read()
        replica.stdout.close()
        replica.stderr.close()
        trainer.join(timeout=FLEET_TIMEOUT_S)
    want = fleet_reference(ws)
    (replica_file,) = [n for n in os.listdir(spool_dir)
                       if n.endswith(f"-{ready['pid']}{fleet.SPOOL_SUFFIX}")]
    last = fleet.read_spool(os.path.join(spool_dir, replica_file))
    gates["replica"] = got == want and rc == 0 and exit_s <= 60 and bool(last and last.final)
    print(f"fleet: python -m tpu_tfrecord_torch.serving --device {SERVE_DEVICE} --spool-dir: "
          f"ready in {ready_s:.1f} s; {FLEET_REQUESTS} requests equal to the reference: "
          f"{got == want}; SIGTERM -> exit {rc} in {exit_s:.2f} s (limit 60 s); its spool's last "
          f"line final: {bool(last and last.final)}")
    if rc != 0:
        print(f"fleet: replica stderr: {err[-3000:]}")
    gates["trainer_killed"] = killed.get("rc") == -signal.SIGKILL and "at" in killed
    print(f"fleet: python -m tpu_tfrecord_torch.train_lm --device {READPOOL_DEVICE} --spool: "
          f"SIGKILLed after its step-{FLEET_KILL_AT} line, {killed.get('kill_s', float('nan')):.1f}"
          f" s after its spawn, its spool then counting {killed.get('counted')} steps; rc "
          f"{killed.get('rc')}")

    # (4) the aggregate, past the trainer's staleness bar
    time.sleep(max(0.0, killed.get("at", time.time()) + 2.5 * FLEET_INTERVAL_S - time.time()))
    agg = fleet.TelemetryAggregator(spool_dir)
    snap = agg.aggregate()
    files = sorted(os.path.join(spool_dir, n) for n in os.listdir(spool_dir)
                   if n.endswith(fleet.SPOOL_SUFFIX))
    newest = [fleet.read_spool(f) for f in files]
    by_role = {p.role: p for p in snap.processes}
    gates["processes"] = len(snap.processes) == 3 and set(by_role) == {"scorer", "serving",
                                                                       "trainer"}
    gates["liveness"] = (sorted(p.role for p in snap.alive) == ["scorer", "serving"]
                         and all(p.final for p in snap.alive)
                         and [p.role for p in snap.dead] == ["trainer"])
    names = {n for s_ in newest for n in s_.counters}
    gates["counters"] = snap.counters == {n: sum(s_.counters.get(n, 0) for s_ in newest)
                                          for n in names}
    gates["hists"] = all(
        h.counts == Histogram.from_states([s_.hists[n] for s_ in newest if n in s_.hists]).counts
        for n, h in snap.hists.items()) and set(snap.hists) == {n for s_ in newest
                                                                for n in s_.hists}
    gates["serve_requests"] = snap.counters.get("serve.requests") == FLEET_REQUESTS
    shares = fleet.train_phase_shares(by_role["trainer"]) if "trainer" in by_role else None
    gates["train_shares"] = shares is not None and abs(sum(shares.values()) - 1.0) <= 1e-6
    scoped = fleet.TelemetryAggregator(spool_dir, trace_id=scorer_ctx.trace_id).processes()
    gates["trace_filter"] = [p.role for p in scoped] == ["scorer"]
    lat = snap.quantiles().get("serve.latency", {})
    trace_ids = sorted({p.trace_id for p in snap.processes if p.trace_id})
    print(f"fleet: aggregate of {len(snap.processes)} processes, roles "
          f"{sorted(by_role)}; alive {sorted(p.role for p in snap.alive)} (final: "
          f"{[p.final for p in snap.alive]}), dead {[p.role for p in snap.dead]}; verdict "
          f"{snap.verdict}, occupancy {snap.occupancy}; serve.latency merged p50 "
          f"{lat.get('p50_s', float('nan')) * 1e3:.3f} ms, p99 "
          f"{lat.get('p99_s', float('nan')) * 1e3:.3f} ms over {lat.get('count')} requests; "
          f"serve.requests {snap.counters.get('serve.requests')}; the trainer's phase shares "
          f"{shares}; trace ids {trace_ids} (one a process: no CLI adopts an env context); "
          f"the scorer's trace id selects {[p.role for p in scoped]}")
    server = agg.serve(0)
    try:
        host, port = telemetry.exporter_address(0)
        with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10) as resp:
            page = resp.read().decode()
    finally:
        telemetry.shutdown_exporter(0)
    gates["federated_page"] = server is not None and all(
        f'role="{r}"' in page for r in ("scorer", "serving", "trainer"))
    print(f"fleet: the federated page on port {port}: {len(page)} bytes, "
          f"{page.count(chr(10))} lines, every role labeled: {gates['federated_page']}")

    # (5) the SLO engine over the spool, its windows scaled to the run
    span_s = time.time() - min(p.created or p.heartbeat for p in snap.processes)
    windows = [w.scaled(span_s / slo.DEFAULT_WINDOWS[0].long_s) for w in slo.DEFAULT_WINDOWS]
    objectives = [slo.Objective.parse("availability:0.999"),
                  slo.Objective.parse("latency:0.95:250")]
    report = slo.engine_from_spool(spool_dir, objectives, windows).evaluate()
    avail = report["objectives"][0]
    bad = snap.counters.get("serve.rejected", 0) + snap.counters.get("serve.deadline_expired", 0)
    gates["slo_availability"] = (avail["bad"], avail["total"]) == (
        bad, bad + snap.counters.get("serve.requests", 0))
    for entry in report["objectives"]:
        burns = {w["name"]: (round(w["long_burn"], 4), round(w["short_burn"], 4), w["alerting"])
                 for w in entry["windows"]}
        print(f"fleet: SLO {entry['objective']}: bad {entry['bad']} of {entry['total']}, budget "
              f"remaining {entry['budget_remaining']:.4f}, burns (long, short, alerting) by "
              f"window {burns}, verdict {entry['verdict']}")
    print(f"fleet: SLO verdict {report['verdict']} over windows scaled to the run's {span_s:.2f}"
          f" s ({[(w.name, round(w.long_s, 3), round(w.short_s, 3)) for w in windows]})")

    # the spool's cost on a quiet host: the scoring without it and with it
    quiet = {}
    for name, kw in (("no spool", {}), ("spool", dict(
            spool_kw, telemetry_spool_dir=os.path.join(root, "spool_quiet")))):
        res, stats = remote_serve(dirs, model, f"quiet, {name}", nbytes, card, tag="fleet", **kw)
        quiet[name] = stats["whole"]
        gates[f"quiet_{name}"] = torch.equal(res.logits.float().cpu(), local_logits)
        del res
    cost = 1.0 - quiet["spool"] / quiet["no spool"]
    print(f"fleet: the spool's cost at {FLEET_INTERVAL_S} s on a quiet host: "
          f"{quiet['spool']:.1f} rows/s spooling against {quiet['no spool']:.1f} without "
          f"({cost:+.4f} of the rate; one run each, back to back)")
    del model
    free_cuda()
    METRICS.reset()
    out.update(gates=gates, launches=launches, scored_whole=scored["whole"],
               fixed4_whole=fixed4_whole, idle_share=scored["idle_share"], ready_s=ready_s,
               exit_s=exit_s, kill_s=killed.get("kill_s"), verdict=snap.verdict,
               occupancy=snap.occupancy, serve_latency=lat, train_shares=shares,
               trace_ids=trace_ids, slo=report["verdict"], quiet=quiet, spool_cost=cost,
               seconds=time.perf_counter() - t0)
    print(f"fleet: gates {gates}; phase 16 took {out['seconds']:.1f} s ({card})")
    print("fleet: " + json.dumps(out, default=str))
    if not all(gates.values()):
        raise SystemExit(f"fleet: gates failed: {gates}")
    return out


# -- phase 17: pipelined LM training, and the data service ---------------------------

PIPE_VIRTUAL = (1, 2)      # chunks a stage of the 2-stage schedule, 8 microbatches
PIPE_TOL = 1e-4            # phase 9's LM tolerance: losses and every gradient
PIPE_TWIN_STEPS = 16
PIPE_RATE_STEPS = 5        # a pipelined step is ≈ 0.1 s of host time
PIPE_PROFILE_STEPS = 1     # ≈ 4,000 kernels a step
SERVICE_WORKERS = 2
SERVICE_DEADLINE_MS = 5_000
SERVICE_TIMEOUT_S = 120    # for a service process to print its ready line


def pipe_step_grads(params, cfg, toks, **axes):
    """One ``lm.train_step`` (Adam) of a copy of ``params``: (loss, the
    gradients it stepped with, the step's diagnostics or {})."""
    from tpu_tfrecord_torch import train_lm
    from tpu_tfrecord_torch.checkpoint import tree_flatten
    from tpu_tfrecord_torch.models import lm, optim

    p = tree_to(params, SEQ_DEVICE)
    opt = optim.adam(p, train_lm.LR)
    if axes:
        loss, diag = lm.train_step(p, opt, toks, cfg, diagnostics=True, **axes)
    else:
        loss, diag = lm.train_step(p, opt, toks, cfg), {}
    return float(loss), [t.grad.detach().clone() for t in tree_flatten(p)[0]], diag


def pipe_path(work: str, card: str, lm9: dict) -> dict:
    """Phase 17 (a): the LM trained through the one-card pipeline schedule
    (``train_lm --mesh dp_pp``: 4 layers in 2 stages, 8 microbatches), on
    ``card``. ``lm9`` is phase 9's LM step (``step_rate``). Returns the
    numbers."""
    from tpu_tfrecord_torch import train_lm
    from tpu_tfrecord_torch.device.ingest import TokenPacker
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.models import lm, optim

    t0 = time.perf_counter()
    gates, out = {}, dict(card=card)
    shape, axes, n_layers = train_lm.pick_mesh("dp_pp")
    pipe_kw = dict(axes, mesh=shape)
    n_stages = shape["pipe"]
    # (2)'s twin runs in a subprocess beside (1)'s checks, which time
    # nothing; (1)'s rates are taken after the twin exited
    lm_data = os.path.join(work, "lm_data")
    train_lm.generate(lm_data)  # phase 9's documents, when absent
    ck = os.path.join(work, "pipe_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        twin_f = pool.submit(run_twin, "tpu_tfrecord_torch.train_lm", [
            "--mesh", "dp_pp", "--virtual", "2", "--diagnostics", "--steps",
            str(PIPE_TWIN_STEPS), "--save-every", "8", "--data-dir", lm_data, "--ckpt-dir", ck,
            "--digest-out", os.path.join(work, "pipe_digests.jsonl")], work, "pipe_twin.log")
        # (1) one step through the schedule against the same step without it
        for v in PIPE_VIRTUAL:
            cfg = train_lm.make_config(n_layers, 0, axes, v)
            params = lm.init_params(cfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0),
                                    SEQ_DEVICE)
            toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, train_lm.BATCH, seed=0)).to(
                SEQ_DEVICE)
            lp, gp, diag = pipe_step_grads(params, cfg, toks, **pipe_kw)
            ld, gd, _ = pipe_step_grads(params, cfg, toks)
            grad_err = max(float((a - b).abs().max()) for a, b in zip(gp, gd))
            want = (n_stages - 1) / (v * cfg.n_micro + n_stages - 1)
            gates[f"v{v}_loss"] = abs(lp - ld) <= PIPE_TOL * max(1.0, abs(ld))
            gates[f"v{v}_grads"] = all(torch.allclose(a, b, rtol=PIPE_TOL, atol=PIPE_TOL)
                                       for a, b in zip(gp, gd))
            gates[f"v{v}_bubble"] = diag["bubble_fraction"] == want
            out[f"v{v}"] = dict(loss=lp, dense_loss=ld, loss_err=abs(lp - ld), grad_err=grad_err,
                                diag=diag)
            print(f"pipe: one train step, {n_layers} layers in {n_stages} stages, V={v}, "
                  f"M={cfg.n_micro}, B={train_lm.BATCH} L={train_lm.SEQ_LEN} d=64 f32: loss "
                  f"{lp!r} against {ld!r} without the schedule (|diff| {abs(lp - ld):.3e}), "
                  f"every gradient within {grad_err:.3e}; bubble {diag['bubble_fraction']!r} "
                  f"(analytic (S-1)/(V*M+S-1) = {want!r}), ticks {diag['useful_ticks']:.0f} "
                  f"useful of {diag['total_ticks']:.0f}")
        rc, lines, err = twin_f.result()
    rates = {}
    for v in PIPE_VIRTUAL:
        cfg = train_lm.make_config(n_layers, 0, axes, v)
        params = lm.init_params(cfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0), SEQ_DEVICE)
        toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, train_lm.BATCH, seed=0)).to(SEQ_DEVICE)
        opt = optim.adam(params, train_lm.LR)
        rates[f"pipe_v{v}"] = step_rate(
            f"pipelined LM train step, {n_layers} layers in {n_stages} stages, V={v}, "
            f"M={cfg.n_micro}", lambda: lm.train_step(params, opt, toks, cfg, **pipe_kw),
            train_lm.BATCH * train_lm.SEQ_LEN, PIPE_RATE_STEPS, PIPE_PROFILE_STEPS)
    rates["dense_4"] = step_rate(
        f"the same {n_layers}-layer LM train step without the schedule",
        lambda: lm.train_step(params, opt, toks, cfg), train_lm.BATCH * train_lm.SEQ_LEN)
    rates["phase9_lm"] = lm9
    print("pipe: step host ms / device ms / kernels / idle share: " + "; ".join(
        f"{k} {r['step_ms']:.3f} / {r['device_ms']:.4f} / {r['kernels_per_step']:.0f} / "
        f"{r['idle_share']:.4f}" for k, r in rates.items()) + f" ({card})")
    del params, opt
    free_cuda()

    # (2) the train_lm twin through the schedule, against this process
    # without it over the same batches
    if rc != 0:
        raise SystemExit(f"pipe: the dp_pp twin exited {rc}: {err[-2000:]}")
    twin = lm_steps(lines)
    diag_line = [ln for _, ln in lines if ln.startswith("model diagnostics:")]
    gauges = json.loads(diag_line[-1].split(":", 1)[1]) if diag_line else {}
    ds = TFRecordDataset(lm_data, batch_size=train_lm.READ_BATCH, schema=train_lm.make_schema(),
                         num_epochs=4, recordType="SequenceExample", shuffle=True, seed=0)
    snaps: dict = {}
    batches, digests = [], []
    with ds.batches(None) as it:
        for n, b in enumerate(train_lm.packed_stream(
                it, TokenPacker(train_lm.BATCH, train_lm.SEQ_LEN), snaps)):
            if n == PIPE_TWIN_STEPS:
                break
            batches.append(b["tokens"])
            digests.append(snaps[n]["digest"])
    cfg = train_lm.make_config(n_layers, 0, axes, 2)
    params = lm.init_params(cfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0), SEQ_DEVICE)
    opt = optim.adam(params, train_lm.LR)
    dense = [float(lm.train_step(params, opt, torch.as_tensor(b).to(SEQ_DEVICE), cfg))
             for b in batches]
    steps = list(range(1, PIPE_TWIN_STEPS + 1))
    gates["twin_steps"] = sorted(twin) == steps
    gates["twin_batches"] = gates["twin_steps"] and all(
        twin[s]["digest"] == digests[s - 1] for s in steps)
    errs = [abs(float(twin[s]["loss"]) - dense[s - 1]) / max(1.0, abs(dense[s - 1]))
            for s in steps if s in twin]
    gates["twin_losses"] = gates["twin_steps"] and max(errs) <= PIPE_TOL
    gates["twin_gauges"] = gauges == {"pipeline.bubble_fraction": 1 / 17,
                                      "pipeline.bubble_fraction_v": 1 / 17}
    print(f"pipe: train_lm --mesh dp_pp --virtual 2 --diagnostics, {PIPE_TWIN_STEPS} steps in a "
          f"subprocess: batches equal this process's stream {gates['twin_batches']}, losses "
          f"within {max(errs):.3e} (relative) of the same steps without the schedule here "
          f"(first {dense[0]!r}, last {dense[-1]!r}); gauges {gauges}")
    del params, opt
    free_cuda()
    out.update(gates=gates, rates=rates, twin_loss_err=max(errs), twin_gauges=gauges,
               seconds=time.perf_counter() - t0)
    print(f"pipe: gates {gates}; phase 17 (a) took {out['seconds']:.1f} s ({card})")
    print("pipe: " + json.dumps(out, default=str))
    if not all(gates.values()):
        raise SystemExit(f"pipe: gates failed: {gates}")
    return out


def wait_status(addr: str, ok, what: str, timeout: float = SERVICE_TIMEOUT_S) -> dict:
    """Poll ``fetch_status(addr)`` until ``ok(status)``; fail after
    ``timeout`` seconds."""
    from tpu_tfrecord_torch import service

    deadline = time.monotonic() + timeout
    while True:
        st = service.fetch_status(addr)
        if ok(st):
            return st
        if time.monotonic() > deadline:
            raise SystemExit(f"service: {what} never happened: {st}")
        time.sleep(0.01)


def reap(procs) -> None:
    """Terminate the processes ``service_spawn`` started, kill any still
    alive after 30 s, and close their pipes."""
    procs = list(procs)
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.stdout is not None:
            proc.stdout.close()


def service_spawn(args: list, env: dict, log: str):
    """``python -m tpu_tfrecord_torch.service *args`` in a subprocess, its
    stderr in ``log``."""
    with open(log, "w") as fh:
        return subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.service", *args],
                                cwd=env["PYTHONPATH"], env=env, stdout=subprocess.PIPE,
                                stderr=fh, text=True)


def service_ready(proc, args: list, log: str) -> dict:
    """The ready line of a process ``service_spawn`` started."""
    timer = threading.Timer(SERVICE_TIMEOUT_S, proc.kill)  # a silent start ends the read
    timer.start()
    try:
        line = proc.stdout.readline()
    finally:
        timer.cancel()
    if not line:
        with open(log) as err:
            raise SystemExit(f"service: {args[0]} printed no ready line "
                             f"(rc {proc.poll()}): {err.read()[-2000:]}")
    return json.loads(line)


def service_path(dirs, root: str, local_logits, fixed4_whole: float, card: str) -> dict:
    """Phase 17 (b): the data service feeding the bf16 DLRM on phase 12's
    shards, beside ``card``: a dispatcher with its journal and two decode
    workers, each a subprocess that never opens the card, serve phase 12's
    fixed-4 feed; then the chaos drill (a worker SIGKILLed after the
    consumer's first chunk from it, the dispatcher SIGKILLed and restarted
    on its port from its journal). ``local_logits`` and ``fixed4_whole``
    are phase 12's fixed-4 logits and rows/s. Returns the numbers, the
    kernel launches of the first scoring among them."""
    import signal

    from tpu_tfrecord_torch import service, telemetry
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.metrics import METRICS
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch

    t0 = time.perf_counter()
    free_cuda()
    n_batches = READPOOL_SHARDS * READPOOL_ROWS // BATCH
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for d in dirs for n in os.listdir(d)
                 if n.endswith(".tfrecord"))
    journal = os.path.join(root, "service.journal")
    ctx = telemetry.TraceContext.new(role="smoke")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               CUDA_VISIBLE_DEVICES="", **ctx.to_env())
    gates, out = {}, dict(card=card, workers=SERVICE_WORKERS)
    procs = {}
    port = str(free_port())
    addr = f"127.0.0.1:{port}"
    disp_args = ["dispatcher", "--journal", journal, "--port", port]
    try:
        # all three start at once: the workers' beat loops retry until the
        # dispatcher listens
        logs = {"dispatcher": os.path.join(root, "dispatcher.log")}
        procs["dispatcher"] = service_spawn(disp_args, env, logs["dispatcher"])
        for i in range(SERVICE_WORKERS):
            logs[f"worker{i}"] = os.path.join(root, f"worker{i}.log")
            procs[f"worker{i}"] = service_spawn(["worker", "--dispatcher", addr], env,
                                                logs[f"worker{i}"])
        ready = {name: service_ready(proc, [name], logs[name]) for name, proc in procs.items()}
        if ready["dispatcher"]["addr"] != addr:
            raise SystemExit(f"service: the dispatcher listens on {ready['dispatcher']['addr']}")
        pid_of = {ready[n]["worker_id"]: procs[n] for n in procs if n != "dispatcher"}
        wait_status(addr, lambda st: st["alive"] >= SERVICE_WORKERS, "the workers' registration")
        out["start_s"] = time.perf_counter() - t0
        cfg = criteo_cfg()
        model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                            READPOOL_DEVICE)
        model(make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), READPOOL_DEVICE))
        svc = dict(service=addr, service_deadline_ms=SERVICE_DEADLINE_MS)

        # (1) the 64 batches through the service
        res, stats = remote_serve(dirs, model, f"through the data service, {SERVICE_WORKERS} "
                                  "worker processes", nbytes, card, tag="service", **svc)
        launches = stats["launches"]
        logits = res.logits.float().cpu()
        gates["logits_bit_equal"] = logits.shape == local_logits.shape and torch.equal(
            logits, local_logits)
        gates["rows"] = res.batches * BATCH == READPOOL_SHARDS * READPOOL_ROWS
        gates["launches"] = launches == {"bf16_mma": n_batches, "f32_tiled": 0}
        gates["no_fallback"] = METRICS.counter("service.fallbacks") == 0
        out.update(whole=stats["whole"], steady=stats["steady"], idle_share=stats["idle_share"],
                   fixed4_whole=fixed4_whole, chunks=METRICS.counter("service.chunks_recv"),
                   launches=launches)
        print(f"service: logits bit-equal to phase 12's local fixed-4 run, every one of "
              f"{logits.numel()} rows: {gates['logits_bit_equal']}; {stats['whole']:.1f} rows/s "
              f"whole through the service beside {fixed4_whole:.1f} in phase 12's fixed-4 run "
              f"({stats['whole'] / fixed4_whole:.4f} of it); device idle share at least "
              f"{stats['idle_share']:.4f}; {out['chunks']} chunks, "
              f"{METRICS.counter('service.fallbacks')} fallbacks")
        del res, logits

        # (2) the chaos drill: kill the worker the first chunk came from,
        # then the dispatcher, and restart it on its port from its journal
        drill: dict = {}
        METRICS.reset()

        def chaos():
            try:
                while METRICS.counter("service.chunks_recv") < 1:
                    time.sleep(0.002)
                held = [w["worker_id"] for w in service.fetch_status(addr)["workers"]
                        if w["leases"]]
                victim = held[0] if held else next(iter(pid_of))
                drill["victim"] = victim
                drill["chunks_before_kill"] = METRICS.counter("service.chunks_recv")
                pid_of[victim].send_signal(signal.SIGKILL)
                pid_of[victim].wait()
                procs["dispatcher"].send_signal(signal.SIGKILL)
                procs["dispatcher"].wait()
                t_kill = time.perf_counter()
                log2 = os.path.join(root, "dispatcher2.log")
                procs["dispatcher"] = service_spawn(disp_args, env, log2)
                again = service_ready(procs["dispatcher"], disp_args, log2)
                drill["restart_s"] = time.perf_counter() - t_kill
                drill["addr"] = again["addr"]
            except (Exception, SystemExit) as e:  # reported by the gates below
                drill["error"] = repr(e)

        chaos_thread = threading.Thread(target=chaos, name="service-chaos")
        chaos_thread.start()
        try:
            res, dstats = remote_serve(dirs, model, "chaos drill: a worker and the dispatcher "
                                       "killed mid-epoch", nbytes, card, tag="service", **svc)
        finally:
            chaos_thread.join(timeout=SERVICE_TIMEOUT_S)
        st = service.fetch_status(addr)
        survivors = [w for w in st["workers"] if w["worker_id"] != drill.get("victim")]
        gates["drill_ran"] = "error" not in drill and drill.get("addr") == addr
        gates["drill_logits"] = torch.equal(res.logits.float().cpu(), local_logits)
        gates["drill_rows"] = res.batches * BATCH == READPOOL_SHARDS * READPOOL_ROWS
        gates["drill_no_fallback"] = METRICS.counter("service.fallbacks") == 0
        gates["drill_reassigned"] = st["lease_reassignments"] >= 1
        gates["survivor_alive"] = len(survivors) == SERVICE_WORKERS - 1 and all(
            w["alive"] for w in survivors)
        gates["one_trace"] = st["trace_id"] == ctx.trace_id
        drill.update(whole=dstats["whole"], reconnects=METRICS.counter("service.reconnects"),
                     dropped=METRICS.counter("service.redelivered_dropped"),
                     reassignments=st["lease_reassignments"], trace_id=st["trace_id"],
                     workers=[(w["worker_id"], w["alive"], w["shards_done"])
                              for w in st["workers"]])
        print(f"service: chaos drill: {drill}; the epoch bit-equal {gates['drill_logits']}, "
              f"{res.batches * BATCH} rows, {METRICS.counter('service.fallbacks')} fallbacks")
        del res, model
        free_cuda()
    finally:
        reap(procs.values())
    METRICS.reset()
    out.update(gates=gates, drill=drill, trace_id=ctx.trace_id,
               seconds=time.perf_counter() - t0)
    print(f"service: gates {gates}; phase 17 (b) took {out['seconds']:.1f} s ({card})")
    print("service: " + json.dumps(out, default=str))
    if not all(gates.values()):
        raise SystemExit(f"service: gates failed: {gates}")
    return out


# -- phase 18: the data service's warm standby and elastic scaling ------------------

HA_PING_S = 0.25           # the standby's ping and journal-tail cadence
HA_MISSES = 3              # failed pings before the standby promotes
ELASTIC_TTL_S = 2.0        # (b)'s lease TTL: a SIGKILLed worker goes stale within it
ELASTIC_MOVES = {4: "grow", 20: "drain", 36: "kill"}  # batch index -> the scaler's move
ELASTIC_SPOOL_S = 0.2
SCALE_CLIENTS = 8
SCALE_WINDOWS = 16         # distinct windows the clients cycle through
SCALE_NEW = 16             # new tokens a request, as phase 10's replica runs
# the replicas' microbatch, admission bound and SLO (phase 10's model
# otherwise): 2 stages x 2 rows keep 4 requests in flight, so 8 clients
# leave 4 waiting, past half of a queue of 4, and a 16-token request at
# phase 10's 6-9 ms ticks misses 50 ms: the load reads queue_bound
SCALE_MB = 2
SCALE_REPLICA_ARGS = ("--mb", str(SCALE_MB), "--max-queue", "4", "--slo-p99-ms", "50")
SCALE_TICK_S = 0.25
SCALE_TIMEOUT_S = 120


class ScriptedVerdict:
    """(b)'s verdict source for the fleet scaler (its ``aggregator=``
    seam): one running consumer whose cluster verdict the script sets."""

    def __init__(self, verdict: str):
        self.verdict = verdict

    def aggregate(self, roles=None):
        from tpu_tfrecord_torch import fleet, telemetry

        proc = fleet.ProcessSnapshot(path="scripted", host="smoke", pid=os.getpid(),
                                     role="trainer", trace_id=None, heartbeat=time.time(),
                                     interval_s=1.0, seq=1,
                                     gauges={telemetry.OCCUPANCY_GAUGE: 0.5})
        return fleet.FleetSnapshot(processes=[proc], alive=[proc], dead=[], counters={},
                                   stages={}, hists={}, verdict=self.verdict, occupancy=0.5)


class HookedModel:
    """The DLRM with ``hook(i)`` called before it scores batch ``i``: the
    scaler's moves land at fixed points of the epoch, and the seconds spent
    in the hook are kept apart from the scoring."""

    def __init__(self, model, hook):
        self.model, self.hook, self.cfg = model, hook, model.cfg
        self.calls, self.hook_s = 0, 0.0

    def __call__(self, batch):
        t = time.perf_counter()
        self.hook(self.calls)
        self.hook_s += time.perf_counter() - t
        self.calls += 1
        return self.model(batch)


def ha_failover(dirs, root: str, model, local_logits, nbytes: int, env: dict,
                card: str) -> tuple:
    """Phase 18 (a): a primary dispatcher with its journal, its warm standby
    on the same journal and two workers registered with both
    (``primary|standby``), all subprocesses off the card; the bf16 DLRM
    scores phase 12's shards through ``service=primary|standby`` and the
    primary is SIGKILLed after the consumer's first chunk. Returns (gates,
    numbers)."""
    import signal

    from tpu_tfrecord_torch import service
    from tpu_tfrecord_torch.metrics import METRICS

    journal = os.path.join(root, "ha.journal")
    logs = {n: os.path.join(root, f"ha_{n}.log") for n in ("primary", "standby", "w0", "w1")}
    procs: dict = {}
    gates, out, drill = {}, {}, {}
    routes = []
    rpc = service.ServiceClient._dispatcher_rpc

    def timed_rpc(client, msg):
        reply = rpc(client, msg)
        if msg.get("op") == "route" and reply.get("ok"):
            routes.append(time.perf_counter())
        return reply

    try:
        t0 = time.perf_counter()
        args = ["dispatcher", "--journal", journal]
        procs["primary"] = service_spawn(args, env, logs["primary"])
        primary = service_ready(procs["primary"], args, logs["primary"])["addr"]
        args = ["dispatcher", "--journal", journal, "--standby-of", primary,
                "--ping-interval", str(HA_PING_S), "--takeover-misses", str(HA_MISSES)]
        procs["standby"] = service_spawn(args, env, logs["standby"])
        ready = service_ready(procs["standby"], args, logs["standby"])
        standby = ready["addr"]
        gates["standby_ready"] = ready["role"] == "standby" and ready["standby_of"] == primary
        spec = f"{primary}|{standby}"
        for name in ("w0", "w1"):
            procs[name] = service_spawn(["worker", "--dispatcher", spec], env, logs[name])
        for name in ("w0", "w1"):
            service_ready(procs[name], [name], logs[name])
        wait_status(primary, lambda st: st["alive"] == SERVICE_WORKERS, "registration")
        wait_status(standby, lambda st: len(st["workers"]) == SERVICE_WORKERS, "the journal tail")
        out["start_s"] = time.perf_counter() - t0

        def chaos():
            try:
                while METRICS.counter("service.chunks_recv") < 1:
                    time.sleep(0.002)
                procs["primary"].send_signal(signal.SIGKILL)
                drill["t_kill"] = time.perf_counter()
                drill["rc"] = procs["primary"].wait()
                drill["chunks_before_kill"] = METRICS.counter("service.chunks_recv")
                wait_status(standby, lambda st: st["accepting"], "promotion", timeout=30)
                drill["promote_s"] = time.perf_counter() - drill["t_kill"]
            except (Exception, SystemExit) as e:  # reported by the gates below
                drill["error"] = repr(e)

        chaos_thread = threading.Thread(target=chaos, name="ha-chaos")
        service.ServiceClient._dispatcher_rpc = timed_rpc
        METRICS.reset()
        chaos_thread.start()
        try:
            res, stats = remote_serve(dirs, model, "the primary SIGKILLed after the first chunk",
                                      nbytes, card, tag="elastic",
                                      service=spec, service_deadline_ms=SERVICE_DEADLINE_MS)
        finally:
            service.ServiceClient._dispatcher_rpc = rpc
            chaos_thread.join(timeout=SERVICE_TIMEOUT_S)
        t_kill = drill.get("t_kill")
        after = [t for t in routes if t_kill is not None and t > t_kill]
        st = service.fetch_status(standby)
        tenants = list(st["tenants"].values())
        gates["ha_killed"] = "error" not in drill and drill.get("rc") == -signal.SIGKILL
        gates["ha_logits"] = torch.equal(res.logits.float().cpu(), local_logits)
        gates["ha_rows"] = res.batches * BATCH == READPOOL_SHARDS * READPOOL_ROWS
        gates["ha_launches"] = stats["launches"] == {"bf16_mma": res.batches, "f32_tiled": 0}
        gates["ha_no_fallback"] = METRICS.counter("service.fallbacks") == 0
        gates["ha_promoted"] = (st["failed_over"] is True and st["generation"] == 1
                                and st["role"] == "dispatcher")
        gates["ha_shards_once"] = st["shards_done"] == READPOOL_SHARDS
        gates["ha_routed_after"] = bool(after)
        out.update(whole=stats["whole"], steady=stats["steady"], idle_share=stats["idle_share"],
                   launches=stats["launches"], promote_s=drill.get("promote_s"),
                   takeover_s=after[0] - t_kill if after else None,
                   chunks_before_kill=drill.get("chunks_before_kill"),
                   reconnects=METRICS.counter("service.reconnects"),
                   redelivered_dropped=METRICS.counter("service.redelivered_dropped"),
                   completions=[t["completions"] for t in tenants],
                   lease_reassignments=st["lease_reassignments"], generation=st["generation"])
        print(f"elastic: (a) failover: logits bit-equal {gates['ha_logits']}, {res.batches} "
              f"batches, {stats['whole']:.1f} rows/s whole; the primary SIGKILLed after "
              f"{out['chunks_before_kill']} chunks; the standby promoted "
              f"{out['promote_s']} s after the kill (ping {HA_PING_S} s x {HA_MISSES} misses), "
              f"its first granted route {out['takeover_s']} s after it; standby status: role "
              f"{st['role']}, generation {st['generation']}, failed_over {st['failed_over']}, "
              f"{st['shards_done']} shards done, {out['completions']} completions; "
              f"{out['reconnects']} reconnects, {METRICS.counter('service.fallbacks')} "
              f"fallbacks ({card})")
        del res
    finally:
        reap(procs.values())
    return gates, out


def elastic_resize(dirs, root: str, model, local_logits, nbytes: int, env: dict,
                   card: str) -> tuple:
    """Phase 18 (b): a dispatcher subprocess and a ``FleetScaler`` here over
    it (a ``DispatcherHandle``), spawning workers with
    ``elastic.subprocess_spawner``; its verdicts are scripted through the
    ``aggregator=`` seam. One worker serves from the start; at batch 4 the
    fleet grows to 3, at 20 one worker drains, at 36 a second drains and is
    SIGKILLed. The consumer spools as a trainer, and what a real
    ``TelemetryAggregator`` reads of that spool is printed. Returns (gates,
    numbers)."""
    import signal

    from tpu_tfrecord_torch import elastic, fleet, service, telemetry
    from tpu_tfrecord_torch.metrics import METRICS

    spool = os.path.join(root, "elastic_spool")
    log = os.path.join(root, "elastic_dispatcher.log")
    args = ["dispatcher", "--lease-ttl-s", str(ELASTIC_TTL_S)]
    disp = service_spawn(args, env, log)
    spawner = None
    verdict = ScriptedVerdict("balanced")
    gates, out, moves = {}, {}, {}

    def alive(n):
        return lambda st: st["alive"] >= n

    def hook(i):
        move = ELASTIC_MOVES.get(i)
        if move == "grow":
            verdict.verdict = "producer_bound"
            for n in (2, 3):
                moves.setdefault("grow", []).append(scaler.step())
                wait_status(addr, alive(n), f"registration of worker {n}")
        elif move in ("drain", "kill"):
            verdict.verdict = "consumer_bound"
            decision = scaler.step()
            moves[move] = decision
            if move == "kill" and decision:
                pid = next(w["pid"] for w in service.fetch_status(addr)["workers"]
                           if w["worker_id"] == decision["victim"])
                os.kill(pid, signal.SIGKILL)

    try:
        t0 = time.perf_counter()
        addr = service_ready(disp, args, log)["addr"]
        spawner = elastic.subprocess_spawner(addr, ("--drain-grace", "0.2"), env=env)
        scaler = elastic.FleetScaler(
            elastic.DispatcherHandle(addr), spawner, aggregator=verdict,
            policy=elastic.ScalerPolicy(min_workers=1, max_workers=3, hysteresis=1,
                                        cooldown_s=0.0))
        moves["floor"] = scaler.step()
        wait_status(addr, alive(1), "registration of worker 1")
        out["start_s"] = time.perf_counter() - t0
        hooked = HookedModel(model, hook)
        METRICS.reset()
        res, stats = remote_serve(dirs, hooked, "the fleet grown 1 -> 3, one worker drained, "
                                  "a draining one SIGKILLed", nbytes, card, tag="elastic",
                                  service=addr, service_deadline_ms=SERVICE_DEADLINE_MS,
                                  telemetry_spool_dir=spool, spool_interval_s=ELASTIC_SPOOL_S,
                                  telemetry_role="trainer")
        fallbacks = METRICS.counter("service.fallbacks")
        drained = (moves.get("drain") or {}).get("victim")
        killed = (moves.get("kill") or {}).get("victim")
        st = wait_status(addr, lambda st: drained not in [w["worker_id"] for w in st["workers"]],
                         "the drained worker's goodbye", timeout=30)
        st = wait_status(addr, lambda st: st["lease_reassignments"] >= 1 or any(
            w["worker_id"] == killed and not w["alive"] for w in st["workers"]),
            "the killed worker's expiry", timeout=30)
        snap = fleet.TelemetryAggregator(spool).aggregate(roles=["trainer"])
        grow = moves.get("grow") or []
        gates["el_logits"] = torch.equal(res.logits.float().cpu(), local_logits)
        gates["el_rows"] = res.batches * BATCH == READPOOL_SHARDS * READPOOL_ROWS
        gates["el_launches"] = stats["launches"] == {"bf16_mma": res.batches, "f32_tiled": 0}
        gates["el_no_fallback"] = fallbacks == 0
        ups = [d for d in scaler.log if d["action"] == "scale_up"]
        gates["el_grown"] = len(grow) == 2 and all(
            d and d["action"] == "scale_up" and d["reason"] == "producer_bound" for d in grow)
        gates["el_drained"] = bool(drained) and drained != killed and drained not in st["draining"]
        gates["el_killed"] = bool(killed) and killed in st["draining"]
        # the holds ran inside the scored step: they are the card's idle
        # time, not its forward time
        scoring_s = stats["wall_s"] - hooked.hook_s
        idle = 1.0 - (sum(res.forward_s) - hooked.hook_s) / stats["wall_s"]
        out.update(whole=stats["whole"], idle_share=idle,
                   launches=stats["launches"], hook_s=hooked.hook_s,
                   whole_without_moves=res.batches * BATCH / scoring_s,
                   scale_ups=len(ups),
                   scale_downs=len([d for d in scaler.log if d["action"] == "scale_down"]),
                   drained=drained, killed=killed,
                   lease_reassignments=st["lease_reassignments"],
                   reconnects=METRICS.counter("service.reconnects"),
                   aggregator=dict(verdict=snap.verdict, occupancy=snap.occupancy,
                                   processes=len(snap.processes), alive=len(snap.alive),
                                   final=[p.final for p in snap.processes]))
        print(f"elastic: (b) resize: logits bit-equal {gates['el_logits']}, {res.batches} "
              f"batches, {stats['whole']:.1f} rows/s whole ({out['whole_without_moves']:.1f} "
              f"without the {hooked.hook_s:.2f} s the scaler's moves held the loop); the card "
              f"idle {idle:.4f} of the wall (the holds counted idle, not forward); scale-ups "
              f"{out['scale_ups']}, scale-downs {out['scale_downs']}; {drained} drained and "
              f"said goodbye, {killed} SIGKILLed while draining; {st['lease_reassignments']} "
              f"lease reassignments, {fallbacks} fallbacks; the real aggregator over the "
              f"consumer's spool: {out['aggregator']} ({card})")
        del res
    finally:
        if spawner is not None:
            spawner.reap()
        reap([disp])
        telemetry.RECORDER.context = None  # the trainer role stays with the spool it named
    return gates, out


def serving_scale_floor() -> dict:
    """Phase 18 (c), its first tick: a ``ServingScaler`` here over
    ``elastic.ServingReplicaSpawner`` replicas on the card (phase 10's
    synthetic LM, ``SCALE_REPLICA_ARGS``), policy 1..2, hysteresis 2,
    ticked once on a thread, which spawns the floor while (a) and (b) run.
    The replica the scaler grows to later is started beside it, on a
    second thread, and handed over when the scaler asks for it, so no
    replica start lies inside (c). Returns what ``serving_scale`` goes on
    with."""
    from tpu_tfrecord_torch import elastic

    repo = os.path.dirname(os.path.abspath(__file__))
    spawner = elastic.ServingReplicaSpawner(("--device", SERVE_DEVICE, *SCALE_REPLICA_ARGS),
                                            env=dict(os.environ, PYTHONPATH=repo))
    run = dict(spawner=spawner, spawned=[], ready_s=[], t0=time.perf_counter())
    started = threading.Event()

    def start():
        t = time.perf_counter()
        started.set()
        addr = spawner()
        return addr, time.perf_counter() - t

    warm: dict = {}

    def start_second():
        started.wait(SCALE_TIMEOUT_S)
        while len(spawner.procs) < 1 and time.perf_counter() - run["t0"] < SCALE_TIMEOUT_S:
            time.sleep(0.01)  # the floor's process first: procs keep the spawn order
        try:
            warm["started"] = start()
        except Exception as e:  # noqa: BLE001 - the scale-up below raises it
            warm["error"] = e

    def spawn():
        if not run["spawned"]:
            addr, ready = start()
        else:
            run["warm_thread"].join(timeout=SCALE_TIMEOUT_S)
            if "started" not in warm:
                raise OSError(f"the second replica did not start: {warm.get('error')}")
            addr, ready = warm.pop("started")
        run["ready_s"].append(ready)
        run["spawned"].append(addr)
        return addr

    run["scaler"] = elastic.ServingScaler(spawn, policy=elastic.ScalerPolicy(
        min_workers=1, max_workers=2, hysteresis=2, cooldown_s=0.0))
    run["floor_thread"] = threading.Thread(
        target=lambda: run.setdefault("floor", run["scaler"].step()), name="scale-floor")
    run["warm_thread"] = threading.Thread(target=start_second, name="scale-second")
    run["floor_thread"].start()
    run["warm_thread"].start()
    return run


def serving_scale(run: dict, card: str) -> tuple:
    """Phase 18 (c) after its first tick (``serving_scale_floor``): 8
    clients at once make the verdict queue_bound until the scaler spawns a
    second replica; without them the idle ticks drain one, which exits 0.
    Returns (gates, numbers)."""
    from tpu_tfrecord_torch import serving
    from tpu_tfrecord_torch.metrics import METRICS

    spawner, scaler, spawned, ready_s = (run[k] for k in ("spawner", "scaler", "spawned",
                                                           "ready_s"))
    gates, out = {}, {}
    rng = np.random.default_rng(18)
    ws = [rng.integers(0, 96, size=16).astype(np.int32) for _ in range(SCALE_WINDOWS)]
    answers: list = []
    stop = threading.Event()

    def client(i, addr):
        cl = serving.ServeClient([addr], timeout_s=60.0)
        try:
            k = i
            while not stop.is_set():
                answers.append((k % SCALE_WINDOWS, cl.generate(ws[k % SCALE_WINDOWS], SCALE_NEW)))
                k += SCALE_CLIENTS
        except Exception as e:  # noqa: BLE001 - reported by the gates below
            answers.append((None, repr(e)))
        finally:
            cl.close()

    def tick_until(action: str, what: str) -> tuple:
        deadline = time.monotonic() + SCALE_TIMEOUT_S
        ticks = []
        while time.monotonic() < deadline:
            decision = scaler.step()
            ticks.append(scaler.status()["verdict"])
            if decision and decision["action"] == action:
                return decision, ticks
            time.sleep(SCALE_TICK_S)
        raise SystemExit(f"elastic: (c) {what} never happened; verdicts {ticks}")

    try:
        t0 = time.perf_counter()
        run["floor_thread"].join(timeout=SCALE_TIMEOUT_S)
        floor = run.get("floor")
        if not floor or floor["reason"] != "below_min":
            raise SystemExit(f"elastic: (c) the first tick did not spawn the floor: {floor}")
        want = fleet_reference(ws, SCALE_NEW, SCALE_MB)
        METRICS.reset()  # (a) and (b) reset it too: count (c)'s drains from here
        threads = [threading.Thread(target=client, args=(i, spawned[0]), name=f"scale-client{i}")
                   for i in range(SCALE_CLIENTS)]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        try:
            grew, load_ticks = tick_until("scale_up", "the queue_bound scale-up")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=SCALE_TIMEOUT_S)
        load_s = time.perf_counter() - t_load
        shrank, idle_ticks = tick_until("scale_down", "the idle drain")
        victim = spawner.procs[spawned.index(shrank["victim"])]
        rc = victim.wait(timeout=60)
        scaler.step()  # the drained replica's goodbye: its status no longer answers
        bad = [a for a in answers if a[0] is None or a[1] != want[a[0]]]
        gates["sc_answers"] = bool(answers) and not bad
        gates["sc_grew"] = grew["reason"] == "queue_bound" and len(spawned) == 2
        gates["sc_drained"] = (shrank["reason"] == "idle" and rc == 0
                               and METRICS.counter("elastic.drains") == 1
                               and METRICS.counter("elastic.replicas_lost") == 0
                               and scaler.replicas == [a for a in spawned if a != shrank["victim"]])
        out.update(ready_s=ready_s, requests=len(answers), load_s=load_s,
                   requests_per_s=len(answers) / load_s, load_verdicts=load_ticks,
                   idle_verdicts=idle_ticks, victim_rc=rc, wrong=bad[:3],
                   drains=METRICS.counter("elastic.drains"),
                   replicas_lost=METRICS.counter("elastic.replicas_lost"),
                   seconds=time.perf_counter() - t0,
                   floor_s=t0 - run["t0"])
        print(f"elastic: (c) replicas: ready in {', '.join(f'{s:.1f}' for s in ready_s)} s "
              f"(both started beside (a) and (b)); "
              f"{len(answers)} requests of {SCALE_NEW} tokens from {SCALE_CLIENTS} clients in "
              f"{load_s:.1f} s ({out['requests_per_s']:.1f} requests/s, until the scaler took "
              f"the second replica), every one equal to the reference: {gates['sc_answers']}; "
              f"verdicts under load {load_ticks}, then {idle_ticks}; the drained replica exited "
              f"{rc}; drains {out['drains']}, replicas lost {out['replicas_lost']} ({card})")
    finally:
        stop.set()
        run["floor_thread"].join(timeout=SCALE_TIMEOUT_S)
        run["warm_thread"].join(timeout=SCALE_TIMEOUT_S)
        spawner.reap()
    return gates, out


def elastic_path(dirs, root: str, local_logits, service_whole: float, card: str) -> dict:
    """Phase 18: the data service's warm standby and elastic scaling, and
    the serving tier's replica scaler, beside ``card``. ``local_logits``
    are phase 12's fixed-4 logits; ``service_whole`` is phase 17's rows/s
    through the service. Returns the numbers, the kernel launches of (a)'s
    and (b)'s scoring windows among them."""
    from tpu_tfrecord_torch import telemetry
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch

    t0 = time.perf_counter()
    free_cuda()
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for d in dirs for n in os.listdir(d)
                 if n.endswith(".tfrecord"))
    ctx = telemetry.TraceContext.new(role="smoke")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               CUDA_VISIBLE_DEVICES="", **ctx.to_env())
    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device=READPOOL_DEVICE).manual_seed(TRAIN_SEED),
                        READPOOL_DEVICE)
    model(make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), READPOOL_DEVICE))
    replicas = serving_scale_floor()  # both replicas start (14-24 s each) beside (a) and (b)
    try:
        gates_a, ha = ha_failover(dirs, root, model, local_logits, nbytes, env, card)
        gates_b, resize = elastic_resize(dirs, root, model, local_logits, nbytes, env, card)
    except BaseException:
        replicas["floor_thread"].join(timeout=SCALE_TIMEOUT_S)
        replicas["spawner"].reap()
        raise
    del model
    free_cuda()
    gates_c, scale = serving_scale(replicas, card)
    gates = {**gates_a, **gates_b, **gates_c}
    out = dict(card=card, failover=ha, resize=resize, serving=scale, gates=gates,
               service_whole=service_whole, seconds=time.perf_counter() - t0,
               launches=ha["launches"], resize_launches=resize["launches"])
    print(f"elastic: through the failover {ha['whole']:.1f} rows/s, through the resize "
          f"{resize['whole']:.1f}, beside phase 17's {service_whole:.1f} through the service; "
          f"the card idle {ha['idle_share']:.4f} / {resize['idle_share']:.4f} of the wall")
    print(f"elastic: gates {gates}; phase 18 took {out['seconds']:.1f} s ({card})")
    print("elastic: " + json.dumps(out, default=str))
    if not all(gates.values()):
        raise SystemExit(f"elastic: gates failed: {gates}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_tfrecord_torch import _cuda

    t_start = time.perf_counter()
    smi = device_facts()
    host_facts()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)  # g++ beside nvcc
        _cuda.build(["interaction"])
        print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s")
        native.result()
    for name, log in _cuda.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}")
    if "interaction" in _cuda.BUILD_LOGS:
        check_build_log(_cuda.BUILD_LOGS["interaction"])
    else:
        print("interaction kernels were built before this run: no ptxas report to check")
    phase_s = {}
    mark = [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = round(now - mark[0], 1)
        mark[0] = now

    lap("1 facts, build")
    errs = check_interaction()
    check_small_forward()
    timing = {k: time_interaction(dtype) for k, dtype in INSTANCE_DTYPE.items()}
    lap("2-3 kernels")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        launches = main_path(data_dir)
        free_cuda()
        lap("4 main path")
        train = train_path(data_dir)
        free_cuda()
        lap("5 training")
        feed = feed_path(data_dir)
        free_cuda()
        lap("6 feed")
        datasource = datasource_path(data_dir)
        free_cuda()
        lap("7 writes")
        resume = resume_path(data_dir)
        free_cuda()
        lap("8 resume")
        from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

        # phase 8's kill drill (two train_dlrm processes, checked for
        # correctness only) runs beside phase 9, whose rates are contended
        # already
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            drill = pool.submit(kill_drill, data_dir)
            reset_launch_counts()
            seq = seq_path(data_dir, smi)
            seq_launches = dict(dot_interaction.instance_launches)
            print("resume: drill " + json.dumps(drill.result(), default=float))
        free_cuda()
        lap("9 sequence models, 8's kill drill beside it")
        reset_launch_counts()
        serve_path(data_dir, smi)
        serve_launches = dict(dot_interaction.instance_launches)
        free_cuda()
        lap("10 serving")
        reset_launch_counts()
        moe_path(data_dir, smi)
        moe_launches = dict(dot_interaction.instance_launches)
        free_cuda()
        lap("11 moe")
        reset_launch_counts()
        pipe = pipe_path(data_dir, smi, seq["rates"]["lm"])
        pipe_launches = dict(dot_interaction.instance_launches)
        free_cuda()
        lap("17 (a) pipe")
        (readpool_launches, cache_launches, multiproc_launches, remote_launches,
         fleet_launches, service_launches, ha_launches,
         elastic_launches, mesh_launches, sp_launches,
         fsdp_launches, ep_launches) = readpool_path(data_dir, smi, pipe["seconds"])
        lap("12-18 on phase 12's shards")
    phase_launches = {"seq": seq_launches, "serve": serve_launches, "moe": moe_launches,
                      "pipe": pipe_launches, "sequence axis": sp_launches,
                      "fsdp": fsdp_launches, "moe over ranks": ep_launches}
    for phase, counts in phase_launches.items():
        if any(counts.values()):
            raise SystemExit(f"dot_interaction launched in the {phase} phase: {counts}")
    design = {
        "bf16_mma": "mma.sync m16n8k16 bf16 Gram, cp.async 16-byte double-buffered "
                    "staging, persistent grid, 16-byte stores through shared memory",
        "f32_tiled": "f32 FMAs in 4x4 register blocks of row pairs, cp.async 16-byte "
                     "double-buffered staging at an odd-chunk sample stride, persistent grid, "
                     "16-byte stores through shared memory",
    }
    kernels = [dict(
        name=f"dot_interaction_{k}",
        route="cuda",
        source="tpu_tfrecord_torch/csrc/interaction.cu",
        replaces="tpu_tfrecord/models/interaction.py:78",
        design=design[k],
        launches=launches[k],
        max_abs_err=errs[k],
        **timing[k],
        **train[k],
        feed_launches=feed[k],
        datasource_launches=datasource[k],
        resume_launches=resume[k],
        seq_launches=seq_launches[k],
        serve_launches=serve_launches[k],
        moe_launches=moe_launches[k],
        readpool_launches=readpool_launches[k],
        cache_launches=cache_launches[k],
        multiproc_launches=multiproc_launches[k],
        remote_launches=remote_launches[k],
        fleet_launches=fleet_launches[k],
        service_launches=service_launches[k],
        pipe_launches=pipe_launches[k],
        ha_launches=ha_launches[k],
        elastic_launches=elastic_launches[k],
        mesh_launches=mesh_launches[k],
        sp_launches=sp_launches[k],
        fsdp_launches=fsdp_launches[k],
        ep_launches=ep_launches[k],
    ) for k in INSTANCE_DTYPE]
    print(f"phase seconds: {phase_s} (phases 12-18 print their own)")
    print(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
