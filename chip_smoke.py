#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the similarity-search serving
path (sparse and dense input), the paper's Fig. 7 experiment, corpus dedup,
the hashed-feature trainer, the LM serving path, LM training on one NVIDIA
card and the mesh paths over two ranks sharing it, with its hand-written
kernels (eight CUDA sources).

    python3 chip_smoke.py              # from the root of a checkout

Phases; any failure raises and exits non-zero, and no result line is
printed then:

1. Build the eight CUDA sources in ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print nvcc's register report.
2. Main path at full size, through the service a user calls: SearchConfig
   defaults (D = 2^16, K = 256, 32 bands x 8 rows, b = 32, n_slots 2048
   growing by rebuild, bucket width 8, one in-process shard) on
   ``device="cuda"``.  Ingest 262,144 synthetic documents in 4096-document
   batches through ``IngestPipeline(depth=2)``, then answer one batch of
   1024 indexed + 64 fresh documents (top_k = 5).  Every kernel's launch
   count is set to 0 just before this phase and read just after it; each
   must be > 0, and the collision kernel and the top-k select must each
   have launched once per brute-force fallback call (one launch over the
   whole index, one call over its real rows).  Top-1
   self-hit on the indexed rows must be 100%, and some rows must take the
   brute-force fallback.  Then the same batch through the shard's own
   ``SketchStore.query_packed`` (the library's single-store query), its
   counts set to 0 just before and read just after (``store_path``): it
   must answer as the service did, with one launch of the fold and one of
   the probe a batch, the leg the service's shard runs.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gave it: outputs must be equal (tolerance 0, all
   integers).  Times are medians of CUDA-event timings after warm-up.
   ``ms`` (as ``plain_ms`` and ``library_ms``) times the call as a caller
   makes it, the wrapper's host work included; ``device_ms`` has the card
   spin ~0.25 ms before each start event, so the host's work overlaps the
   spin and the events time the device's work alone (a run whose enqueue
   outlasts the spin is dropped; a kernel with no device-only time this
   way fails the run).
   ``bound_ms`` is the larger of bytes / 3.35 TB/s and operations / the
   int32 rate (132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7e12 op/s, half
   the lanes behind the published 67 TFLOP/s float32 figure of the H100
   SXM), counted from this run's inputs.  ``library_ms`` is the collision
   count as one PyTorch call, ``K - torch.cdist(a.double(), b.double(),
   p=0)`` (float64 holds the int32 codes exactly; checked equal), timed
   here only; no single PyTorch call computes the others, so theirs is
   null.  The probe runs from the fold's hashes on the card
   (``lsh_probe``); its bound counts the function's own bytes (8 a hash,
   8 a probe step this run's walks take, W * 4 a hit, the output), and
   the dependent reads of the earlier and the current probe over this
   run's walks are printed beside it; then the fold -> candidates leg as
   every query leg runs it (the service's shard and the single store) is
   timed.  The collision kernel is timed
   at the fallback's real call, the pow2-padded fallback rows against all
   262,144 indexed rows in one launch on the stored words, and on one
   16,384-row block of unpacked codes (the shape the earlier blocked
   fallback launched 16 times); its bound counts one integer compare a
   pair of codes (a pair of words at b < 32), the compare being the only
   part of the count that needs the integer pipe.  The top-k select
   (``topk_select``) runs on that call's counts of the real fallback
   rows, as the planner selects them, at top_k = 5 (``ops.topk_select``
   must take the kernel) and at 40 (two passes of the kernel), values and
   columns against the plain version's stable sort; its bound counts the
   counts read once and each row's values and int64 columns written.
4. One more query batch under ``torch.profiler``: the device-busy share
   of its wall time and device time by kernel (the timeline goes to
   ``chiprun_out/query_trace.json``).
5. The card against the port's own CPU path on the first 4096 documents:
   ids and scores must be identical.
5b. Raw-signature serving and snapshots, three legs.  (1) ``raw_path``:
   ``SearchConfig(device="cuda", b=2)``, otherwise the defaults; 8 rows a
   band are not word-aligned at b = 2, so ingest and query run on raw
   signatures (the sparse kernel's unpacked output, band keys folded on
   the host, the probe from the coordinator's uploaded keys, the collision
   count on 2-bit words).  The same 262,144 documents through
   ``IngestPipeline(depth=2)``, the same 1088-row batch five times; counts
   set to 0 just before and read just after: the sparse kernel and the
   probe must have launched, the fold kernel not at all,
   the collision kernel once per fallback call per shard.  Every indexed
   row must find its own id in its top 5 at score 1.0, and some rows must
   take the fallback.  The query side's registry histograms over batches
   2-5 (``QUERY_SPANS``: the sign leg, the coordinator's fold, the shards'
   submit and gather, the merge) are printed a batch beside phase 2's.
   Then the three kernels at this leg's own shapes against their plain
   versions, timed and bounded as in phase 3 (in ``chip_smoke.json`` under
   ``raw_path``), the query batch's words packed on the host and on the
   card, timed, and one more query batch under the profiler, as in phase 4
   (``chiprun_out/query_trace_raw.json``).
   (2) Phase 5 at b = 2.
   (3) ``snapshot_path``: phase 2's b = 32 plane and leg 1's b = 2 plane
   each saved with ``ShardedSketchStore.save`` to a temporary directory,
   loaded onto the card with ``ShardedSketchStore.load`` and served by a
   service with the same permutations: the same batch must get the live
   plane's ids and scores, and every shard the live shard's ``digest()``;
   the save and load seconds and the snapshot's bytes are printed.
5c. The tcp shard plane (``tcp_path``): ``SearchConfig(device="cuda",
   transport="tcp", n_shards=4)``, otherwise the defaults: four shard
   worker processes on the one card, each with its own CUDA context.  The
   coordinator signs and folds (kernels 1, 2), and each worker probes from
   the wire's hashes, uploaded once, and scores its fallback rows (kernels
   3, 4).  The same 262,144 documents through ``IngestPipeline(depth=2)``,
   then the 1088-row batch five times: ids and scores must equal phase 2's,
   fallback rows included.  Counted: the coordinator's counts set to 0
   just before the service is built, the workers' read from their STATS
   (fresh processes): the coordinator folds once a batch and launches no
   probe, collision or select kernel, each worker probes once a batch,
   scores and selects once a batch and launches no fold; each worker's
   labelled registry shows ``kernel.query_fused.cuda`` and no plain
   kernel, every worker
   reports a ``cuda`` device and holds memory on the card by its own
   STATS, and every worker pid appears in ``nvidia-smi
   --query-compute-apps`` (where nvidia-smi sees this namespace's pids;
   where it does not, the pid check is not possible and is said so, and
   nvidia-smi need only list as many contexts).  Printed: the spawn
   and ingest time, the query latencies, the coordinator's spans a batch
   over batches 2-5 (``TCP_SPANS``: the fold, the legs' submit and gather,
   the merge, each shard's reply latency) and the wire bytes a batch.
   Then the plane saved, and the workers' kernels held against their
   plain versions at the tcp path's shapes, timed and bounded as in phase
   3 (in ``chip_smoke.json`` under ``tcp_path.kernels``): shard 0 loaded
   onto the card from the snapshot, the probe from the batch's band
   hashes folded, copied to the host and uploaded as a worker gets them,
   the collision count of the padded fallback rows against the shard's
   words.  Then a hedged plane: four workers booted from the
   snapshot with worker 1 sleeping 20 ms on half its reads, and
   ``connect_sharded(hedge=True)``; 12 batches on each plane, answers
   equal, both medians and the hedges fired and won printed.  Every
   worker is shut down in a ``finally``.
5d. The replicated plane, two legs.  (1) ``replica_path``:
   ``SearchConfig(device="cuda", transport="tcp", n_shards=2,
   n_replicas=2, journal_dir=<tmp>)`` through the service with phase 2's
   permutations: four workers on the card, the write-ahead journal and the
   supervisor.  The same 262,144 documents through
   ``IngestPipeline(depth=2)``, every write to both lanes of its shard,
   then the 1088-row batch five times: ids and scores must equal phase
   2's, fallback rows included.  Counted: the coordinator's counts set to 0 just
   before the service is built; the lanes' from their STATS (fresh
   processes).  The coordinator folds once a batch and launches no probe
   or collision kernel; across the lanes of each shard, probe and
   collision launches must equal the QUERY and BRUTE frames those lanes
   handled (their ``worker.handle.*`` counts: a hedge makes a twin handle
   one), and no lane folds; every lane reports a ``cuda`` device, and each
   lane that answered a QUERY holds bytes there (a twin's store uploads its
   index on its first read).  Printed: spawn, ingest and documents/s, the
   query latencies, the wire bytes, and the journal's bytes on disk beside
   its reckoning (64 ADD records of 4096 x 256 uint32 words).  Then the
   plane is saved and, as in 5c, kernels 3 and 4 are held against their
   plain versions at the lanes' shapes: shard 0 (131,072 rows) loaded onto
   the card (``replica_path.kernels``).
   (2) ``chaos_path``: a second plane from ``spawn_replicated(
   device="cuda", faults=...)``, ``connect_replicated(journal=...)`` and
   ``Supervisor(device="cuda")``, served by a service over it.  Lane (0, 1)
   dies on its 20th ADD, mid-ingest: the writes go on at reduced
   redundancy and the plane stays consistent.  Lane (1, 0), shard 1's
   primary, dies on its 2nd QUERY: two batches answer through the
   failover.  The supervisor then heals both on the card (respawn,
   journal replay of each shard's 131,072 rows, digest against a live
   peer, rejoin): R = 2 with no failed recovery, two batches; then it is
   stopped, the two original survivors are stopped, and two batches are
   answered by the resynced lanes alone.  Every answer equals phase 2's.
   Printed: each resync's seconds (the ``replica.resync`` histogram) split
   into its respawn and replay parts (``replica.respawn``,
   ``replica.replay``), rows replayed a replay second and a resync second,
   the replica counters, and each respawned worker's device and device
   bytes.  The launches of the two survivors, read just before they stop,
   and of the resynced lanes, read at the end, are checked as in leg 1 (the
   killed lanes' launches die with them).  Every worker is shut down in a
   ``finally``; the journals' directory is deleted after phase 5e.
5e. The streaming front end (``stream_path``): over phase 2's in-process
   service, then over 5d's healthy plane, ``svc.stream(max_batch=256,
   max_delay_ms=2.0, depth=2)`` gets the 1088 query rows one at a time
   with Poisson gaps at 2,000 queries/s (seeded from ``--seed``).  Every
   ticket's ids and scores must equal phase 2's row.  The coordinator's
   counts are set to 0 just before each stream and read just after: one
   sparse-kernel launch and one fold a batch; in process, one probe a
   batch and a collision launch for each batch with fallback rows; over
   the plane, the lanes' launches checked as in 5d.  Printed: ticket
   latency p50 and p99, the batches and their mean size, the documents
   signed (pow2 padding included).  Then kernels 1-4 at one stream-sized
   batch against their plain versions, timed and bounded as in phase 3
   (``stream_path.kernels``): seven queries padded to eight as the
   coalescer pads them, signed and folded, probed over phase 2's shard, the
   rows without candidates scored as its fallback.
6. Dense serving path: a fresh service with the same defaults ingests the
   first 65,536 documents as dense 0/1 int8 rows (16 batches of 4096 x
   2^16, built on the host) through ``pipeline(layout="dense", depth=2)``
   (auto: the bit-packed kernel), then answers the 1088-row query batch as
   dense rows five times.  Counts are set to 0 just before and read just
   after; the bit-packed kernel must have launched once per ingest and
   query batch, and the collision kernel once per fallback call.
   Every ingested word must equal the sparse signing of the same
   documents, ``query_dense`` must answer as ``query_sparse`` of the same
   documents, and top-1 self-hit must be 100%.  One more dense query batch
   runs under the profiler, as in phase 4
   (``chiprun_out/query_trace_dense.json``).
7. Paper path, Fig. 7 (``benchmarks/bench_mae.py``'s four corpora at D =
   2048, 4096 documents each, K in {64, 256, 512}): C-MinHash-(0,pi) and
   -(sigma,pi) through ``ops.cminhash_signatures`` (auto: the int8
   kernel), classical MinHash through ``core.minhash.minhash_dense``,
   estimates from the collision kernel, exact Jaccard over all pairs as an
   exact float32 product (TF32 off).  Prints each method's MAE per
   (corpus, K); nothing statistical gates the run.  Counted as phase 6.
8. The two dense kernels against their plain versions: the int8 kernel
   at the paper's shape and, forced, at the service's shape with pack_b =
   32; the bit-packed kernel at the service's shape and at D = 2048.
   Tolerance 0; timed and bounded as in phase 3.  Both are bounded by the
   function's work on this run's rows: each input byte (or word) read
   once, and one min per set bit per hash.  The int8 kernel's B*K*D
   masked mins are its algorithm's cost, not the function's, and are
   recorded beside as ``dense_algorithm_ops``.  No single PyTorch call
   computes the dense min-reduce, so ``library_ms`` is null.  The int8
   kernel is also timed on the imageA corpus at each of Fig. 7's K, and
   the sum over phase 7's 24 launches (8 at each K) is printed; so is the
   collision kernel at Fig. 7's 4096 x 4096 x K on those signatures
   (checked against its plain version and ``K - cdist(p=0)``, timed with
   both, summed over phase 7's 36 launches).
9. The card against the CPU on a 512-document dense subset.
10. Dedup (``dedup_path``): ``data.dedup.dedup_corpus(device="cuda")``
    over phase 2's 262,144 documents at ``DedupConfig()``'s defaults (D =
    2^16, K = 256, 64 x 4 bands, threshold 0.5), its counts set to 0 just
    before and read just after: the sparse signing kernel must have
    launched exactly once (the whole corpus, unpacked) and no other kernel.
    Pair precision > 0.95 and recall > 0.9 against the planted clusters
    (``dedup_metrics``); the card's result equal to the CPU's on the first
    16,384 documents in every field; the kernel's output at that launch
    equal to the result's signatures and to its plain version (in
    8,192-row calls), timed and bounded as in phase 3.  Prints each stage's
    seconds (the registry's ``dedup.<stage>`` histograms), documents/s,
    candidate and verified pairs, kept/total.
11. The hashed-feature trainer (``linear_path``): the classifier example's
    data at D = 2^14 (templates at 5% density, 2% flips), 32,768 training
    and 8,192 test rows made on the card in 4096-row batches and signed at
    K = 512 through ``SketchEngine.signatures_dense`` (the bit-packed
    kernel, once a batch and no other kernel), then ``fit_logistic`` (300
    steps) for b in {1, 2, 4, 8}: test accuracy > 0.95 at each b, the
    card's peak memory over the signatures under 1/8 of the one-hot
    matrix's bytes at b = 8 (it is never built); the card's fit on the
    first 1,024 training rows within the CPU tests' tolerances of the
    CPU's (w and probabilities within 1e-3, equal accuracy); the
    bit-packed kernel against its plain version at one batch.  Prints
    seconds per step and the peak memory.
12. The LM serving path (``lm_path``, ``[lm]`` lines), its counts set to 0
    just before and read just after: it reaches no kernel of the port but
    the selective scan (``ssm_scan``, no TPU kernel's port: the JAX
    package computes these models in plain ``jnp``), which must launch
    once a Mamba layer of each prompt or forward of (b)'s two Mamba
    families, so every other count must stay 0.  (a) ``llama3_2_1b`` at
    its full published config (16 layers, d_model 2048, 32 heads / 8 KV
    heads, d_ff 8192, vocab 128,256, tied embeddings, bf16 compute,
    float32 parameters), weights drawn on
    the card from ``--seed``: 8 requests of 32-token prompts from
    ``data.synthetic.token_batches``, 32 greedy tokens each through
    ``serve.decode.generate``, twice (equal tokens, each in [0, vocab));
    then the same loop with a CUDA event after the prefill and after each
    decode step.  Prints the prefill ms, the median decode ms a token,
    tokens/s, the parameter bytes, the peak ``max_memory_allocated`` and
    the step's bound (every float32 parameter read and its bf16 copy
    written, at 3.35 TB/s); then the card's busy time in an 8-token
    ``generate`` under ``torch.profiler`` (as in phase 4; the timeline to
    ``chiprun_out/lm_trace.json``) against the same call's untraced wall.  Then the same weights in float32 with TF32
    off: teacher-forced ``decode_step`` over the generated tokens within
    1e-3 of ``forward``'s logits, and the card's prefill logits for 2
    requests within 1e-3 of the port's CPU path on the same weights.  (b)
    falcon_mamba_7b, hymba_1_5b, qwen3_moe_30b_a3b, pixtral_12b and
    seamless_m4t_medium at full width, depth cut to 2 layers (encdec: 2 +
    2): float32 prefill + 8 teacher-forced decode steps within 1e-3 of
    ``forward`` (MoE at capacity_factor 64, so neither drops a token), then
    a bf16 prefill (finite logits) and ``generate`` (tokens in range).
    (c) The scan kernel alone at the LM cell's Mamba layer (16 x 1,024
    positions, d_inner 8,192, N 16, x, B and C bf16, h0 0) against its
    plain version and the chunked scan ``models.ssm._ssm_inner``, within
    1e-5 of the largest |value| (float32 in both, summed in other
    orders), timed as in phase 3 beside the chunked scan and the plain
    version; its bound is the larger of its bytes (each operand read and
    each output written once) at 3.35 TB/s and its exps at one MUFU.EX2
    each (16 a clock an SM: 4.18e12 a second).

13. LM training on one card (``train_path``, ``[train]`` lines), its counts
    set to 0 just before and read just after: kernel 1 launches once (the
    launcher's dedup) and no other kernel.  (a) ``llama3_2_1b`` at its full
    published config (1,235,814,400 float32 parameters, bf16 compute,
    ``remat="block"``, ``fused_qkv``), weights drawn on the card from
    ``--seed``, through ``train.train_loop.make_train_step`` at the
    launcher's defaults (batch 8 x 128 from ``data.synthetic.token_batches``,
    AdamW at lr 3e-4, warmup 5 of 50 steps): 3 warm-up steps, 10 timed
    with CUDA events (median step ms, tokens/s, the host's wall a step),
    the peak ``max_memory_allocated``, every step's loss, lr and grad norm;
    the losses finite and the last timed below the first timed; the step's
    bound, max(FLOPs / 989 TFLOP/s bf16, bytes / 3.35 TB/s), with the work
    it counts (``train_step_work``); one step under the profiler, as in
    phase 4 (``chiprun_out/train_trace.json``); then 2 steps with
    ``microbatches=2, grad_compression="bf16"``.  (b) Full width cut to 1
    layer, float32, TF32 off: one step's loss and global grad norm on the
    card within 1e-3 (relative) of the port's CPU path on the same weights
    and a 2 x 128 batch; the parameters after one ``adamw_update`` on the
    same gradients within 1e-5; after each side's whole step within 2 x
    lr (AdamW's first step moves a parameter by up to lr whatever its
    gradient's size, so a gradient near 0 that rounds differently moves
    it differently).  (c)
    ``TrainLoop`` at full width, 1 layer (a checkpoint is 14.8 GB at
    16 layers), 4 steps, a checkpoint every 2, ``keep_checkpoints=1``,
    in a temporary workdir deleted afterwards: SIGTERM raised while batch 2
    is fetched stops the loop at the next step boundary with a save; a new
    loop restores that step and runs on; the losses and the final
    parameters equal an uninterrupted run's exactly.  Prints the save's
    seconds, the load's and the bytes on disk.  (d)
    ``launch/train.py --arch llama3_2_1b --reduced --dedup --steps 8`` in
    process on the card (its default device): the ``[launch]`` lines, kernel
    1 once in the dedup and no kernel in the training, then kernel 1 at that
    launch (400 documents, D = 2^14, K = 256) against its plain version,
    tolerance 0, timed and bounded as in phase 3.

14. The mesh paths over two ranks sharing the card (``mesh_path``,
    ``[mesh]`` lines), its counts set to 0 just before and read just
    after: (a)-(g) launch no kernel (the LM stack reaches none but the
    selective scan, whose launches are printed); (h)
    launches the signing and query kernels on each rank.  Two processes
    (``launch.ranks.RankPool``, the spawn context) join one gloo process
    group on ``cuda:0`` (NCCL takes one rank a card); the script is their
    subreaper and closes the pool in a ``finally``.  TF32 off throughout.
    (a) ``llama3_2_1b`` at its full published config in float32, batch 8
    x 128 from ``--seed``: one ``make_train_step`` step on one device in
    this process (its parameters to a temporary file, then a second step
    timed with CUDA events), the card freed; then the same first step on
    a ``(1, 2)`` mesh, ``sharding_mode="tp"`` (``jit_train_step``, each
    rank its slices of the same seeded weights): loss and grad norm
    within 1e-4 (relative), every parameter within 2 x lr of one device's,
    each rank's peak memory below the one device's, no weight all-gather;
    a second step timed.  Prints the collectives by kind (calls, bytes;
    gloo carries every kind on CUDA tensors, through the host inside the
    backend).  (b)
    ``qwen3_moe_30b_a3b`` at its published widths, 2 layers, float32, at
    its own capacity factor (1.25): the forward of 8 x 32 tokens on ``(1,
    2)``, expert parallel (``tp``) and ``fsdp`` (each rank its 4 rows, the
    token group the whole batch: its places offset by the other rank's
    assignment counts), each within 1e-4 of one device's; assignments
    are dropped (> 0), and the ranks drop as many as one device.  (c) llama3_2_1b's widths at 1
    layer on ``(2, 1)``: ZeRO-1 off and on, and ``sharding_mode="fsdp"``,
    each against one device's step as in (a).  (d) A ZeRO-1 state (llama
    reduced to d_model 512, vocab 8192, 2 layers) saved on ``(2, 1)``,
    restored on ``(1, 2)`` and saved again: both directories byte-equal
    to one device's save of the restored state.  (e) ``compressed_psum``
    bf16 and int8 with error feedback on CUDA tensors of the two ranks:
    within 0.05 of the exact sum, the 20-step int8 mean within 0.02.  (f)
    ``hymba_1_5b`` at its full published config (1,662,209,600 parameters,
    float32), batch 8 x 128: one step on one device, then on ``(1, 2)`` as
    in (a) (its 25 query heads and 5 KV heads do not split: attention runs
    replicated, the SSM and MLP split), each leaf's gradients within the
    larger of 1e-5 and twice that leaf's own float32 spread on the one
    device, of its largest (the spread measured in the same run: the
    whole batch's gradients against the mean of two halves', over two
    splits of the rows; it must stay below 1e-4), the grad norm the same
    on both ranks, a second step timed; then prefill of 8 x 32 prompts
    and 8 teacher-forced decode
    steps on ``(1, 2)`` with the replicated attention cache, each rank's
    logits and cache blocks (``k``, ``v``, ``h``, ``conv``) within 1e-4 of
    one device's.  (g) ``falcon_mamba_7b`` (a ``tp`` and an ``fsdp``
    step), ``pixtral_12b`` (the forward with a 16-patch prefix) and
    ``seamless_m4t_medium`` (a ``tp`` step; 64 encoder frames a row) at
    their published widths, 1 layer (seamless: 1 a side; cut from 2 to
    keep the phase in its time), each with prefill and 4 decode steps on
    ``(1, 2)``, held as in (f) (gradients to 1e-5).  (h) The entry
    points over a mesh, each call collective (both ranks pass the same
    host batch and get the whole answer back), against one device of the
    card: on ``(2, 1)``, ``SketchEngine(cfg, mesh)`` signs the main sparse
    batch (4096 x 254 at ``SearchConfig``'s D and K, b = 32 words), 4096 x
    2^16 int8 dense rows (b = 32, the bit-packed kernel) and 4096 x 2048
    int8 rows (raw, the int8 kernel), each rank its half of the rows and
    one all-gather of the words a call: every rank's words equal one
    device's, and each rank's ``kernel.sparse.cuda`` and
    ``kernel.dense.*.cuda`` counters are above 0;
    ``SimilaritySearchService(cfg, mesh)`` ingests the first 65,536
    documents of the main corpus and answers the 1,088-row query batch
    with one device's ids and scores (each rank launches kernels 2-4);
    ``dedup_corpus(docs, cfg, mesh)`` of its first 32,768 documents keeps
    one device's ``keep``.  On ``(1, 2)``, ``generate(..., mesh=)`` of
    llama3_2_1b at full width, float32, 8 x 32 prompts from ``--seed``, 8
    greedy tokens: every row whose one-device top-2 logit gap exceeds
    1e-3 at every step has one device's tokens on each rank (the rows
    under the gap are counted and printed).  Prints the part's seconds.

``launches`` in the kernels line is the sum over the fifteen counted paths
(phase 2's service and store paths, phase 5b's raw and snapshot paths,
phase 5c's tcp path, coordinator and workers, phase 5d's two planes,
coordinator and lanes, phase 5e's two streams, phases 6, 7, 10, 11, 12,
13 and 14).

The script makes itself the subreaper of what it starts
(``PR_SET_CHILD_SUBREAPER``).  Before its result it stops and reaps every
process still running that it started, workers, multiprocessing's
resource tracker and any descendant whose parent died first, and names
them in an ``[exit]`` line; it does the same when a phase fails.

The second-to-last line is nvidia-smi's name and power limit of the card;
the last is ``{"ok": true, "device": {...}}``.  Details, nvcc's full
output included, go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --compare [--baseline DIR]

runs only a comparison of the signing and collision kernels, through their
wrappers: the sparse, dense int8 and bit-packed signing kernels at the
serving batch, at Fig. 7's shapes and at the dense service's, with the
per-call table placement of ``csrc/window_fold.cuh`` and each placement
forced through the kernels' test entry point; the collision kernel at the
serving fallback (b = 32 and 8), one 16,384-row block and Fig. 7's 4096 x
4096 x K; with ``--baseline``, each of them also on a build of
``DIR/src/repro_torch/csrc``'s source of it (an earlier checkout) behind
the same wrapper.  Each variant is checked against the plain version and
timed both ways; the collision kernel's count loop is profiled in SASS
(instructions a compare, by opcode).  Then the query side at the main
path's full-size shapes (a 2^19-slot, 32-band table of 262,144 documents,
1088 x 32 x 8 query codes): the fold, the probe from the fold's hashes,
and the fold -> candidates leg as every query leg runs it, the service's
shard and the single store alike (fold, probe; DIR's sources on the
earlier operand-row interface: fold, hashes to the host,
``probe_operands``, upload, probe); each also timed with L2 flushed before
every run.  Output:
``chiprun_out/compare.json`` and ``chiprun_out/collision.sass``.
Last, the trainer's gather form (``core.linear_model.fit_logistic``)
against its first, index form at phase 11's shape, in turns
(``[trainer]`` lines).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.analysis import roofline  # noqa: E402  (the card's constants)

HBM_BYTES_PER_S = roofline.HBM_BW
SPIN_CYCLES = 500_000         # ~0.25 ms at the H100's 1.98 GHz boost clock
INT32_OPS_PER_S = roofline.INT32_OPS
BATCH = 4096
N_QUERY_INDEXED = 1024
N_QUERY_FRESH = 64
TOP_K = 5
N_DENSE = 65_536              # documents ingested as dense rows
PAPER_D = 2048
PAPER_DOCS = 4096
PAPER_KS = (64, 256, 512)


PR_SET_CHILD_SUBREAPER = 36


def adopt_descendants() -> None:
    """Make this process the subreaper of everything it starts, so that a
    process whose parent dies first (a killed worker's child, a helper
    that detaches) is reparented here, not to init, and ``stop_children``
    finds it."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def child_processes() -> dict[int, tuple[str, str]]:
    """This process's children, ``{pid: (state, command line)}``, from
    /proc (state ``Z``: exited, not yet reaped)."""
    me, out = os.getpid(), {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # the command name may hold spaces and ')': fields follow the last
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if int(ppid) == me:
            out[int(entry)] = (state, cmd.strip() or stat.split(" ", 2)[1])
    return out


def stop_children() -> list[str]:
    """Stop and reap every process this script started that still runs:
    multiprocessing's children (terminated, then killed after 10 s),
    multiprocessing's resource tracker, then any other child or adopted
    descendant (SIGTERM, then SIGKILL after 10 s).  Returns a line for each
    process that was still running; an exited one is only reaped."""
    import multiprocessing
    from multiprocessing import resource_tracker
    stopped = []
    procs = multiprocessing.active_children()
    for p in procs:
        stopped.append(f"{p.pid} multiprocessing {p.name}")
        p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()
    tracker = resource_tracker._resource_tracker
    if tracker._pid is not None:
        stopped.append(f"{tracker._pid} multiprocessing resource tracker")
    tracker._stop()
    left = child_processes()
    for pid, (state, cmd) in left.items():
        if state != "Z":
            stopped.append(f"{pid} {cmd[:160]}")
            os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 10
    for pid in left:
        try:
            while os.waitpid(pid, os.WNOHANG) == (0, 0):
                if time.monotonic() > deadline:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
                    break
                time.sleep(0.05)
        except ChildProcessError:
            pass                    # reaped by its own Popen meanwhile
    return stopped


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2, spin: bool = False,
            flush: torch.Tensor | None = None) -> float | None:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up,
    the host's work to launch it included.

    With ``spin`` the card spins for ~0.25 ms (``torch.cuda._sleep``)
    before the start event of each run, so the host's work to launch
    ``fn`` (the wrapper's checks, the allocation, the ctypes call) overlaps
    the spin and the events time the device's work alone, as long as that
    enqueue takes less than the spin.  A run whose enqueue outlasts it (the
    card has passed the start event when ``fn`` returns: a long enqueue,
    or an ``fn`` that waits for the card) holds host work, and is dropped;
    if half the runs or more are, ``fn`` has no device-only time this way
    and the result is None.  With ``flush`` (a tensor larger than the 50 MB
    L2) the card rewrites it before each run, so ``fn`` finds its inputs in
    device memory, not in L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.add_(1)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        overran = spin and start.query()
        end.record()
        end.synchronize()
        if not overran:
            times.append(start.elapsed_time(end))
    return statistics.median(times) if 2 * len(times) > reps else None


def both_ms(fn, reps: int, host_bound_ok: bool = False
            ) -> tuple[float, float | None]:
    """(``ms``, ``device_ms``) of ``fn``: with the host's launch work, and
    without it.  A device time that cannot be separated from the host's
    work (``time_ms`` gives None) fails the run unless ``host_bound_ok``."""
    ms, device_ms = time_ms(fn, reps), time_ms(fn, reps, spin=True)
    require(device_ms is not None or host_bound_ok,
            "device time: the enqueue outlasted the card's spin")
    return ms, device_ms


def fmt_ms(ms: float | None) -> str:
    return "host-bound" if ms is None else f"{ms:.4f}"


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    seconds, by = roofline.kernel_bound(n_bytes, n_ops)
    return seconds * 1e3, by


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    require(a.shape == b.shape and a.dtype == b.dtype,
            f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
            f"{b.dtype}")
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def documents(n_docs: int):
    """The synthetic corpus: (token arrays, planted cluster label per
    document, -1 for unique ones)."""
    from repro_torch.data.synthetic import corpus_with_duplicates
    return corpus_with_duplicates(n_docs, vocab=30_000, doc_len=256,
                                  dup_fraction=0.4, seed=0)


def corpus(n_docs: int, docs=None):
    """``documents(n_docs)`` (or ``docs``) as padded 3-shingle index lists,
    and the fresh query documents'."""
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    if docs is None:
        docs, _ = documents(n_docs)
    idx = batch_shingles(docs, n=3, d=1 << 16)
    fresh, _ = corpus_with_duplicates(N_QUERY_FRESH, vocab=30_000,
                                      doc_len=256, dup_fraction=0.4, seed=1)
    fresh_idx = batch_shingles(fresh, n=3, d=1 << 16, max_nnz=idx.shape[1])
    return idx, fresh_idx


def kernels():
    from repro_torch.kernels import all_kernels
    return all_kernels()


def zero_counts(ks) -> None:
    for k in ks.values():
        k.launches = 0


def read_counts(ks) -> dict:
    return {n: k.launches for n, k in ks.items()}


def dense_rows(idx: np.ndarray, d: int = 1 << 16) -> np.ndarray:
    """Padded index lists -> (B, d) int8 0/1 rows, as a user holds them."""
    v = np.zeros((len(idx), d), np.int8)
    rows = np.repeat(np.arange(len(idx)), idx.shape[1])
    flat = idx.reshape(-1)
    ok = flat >= 0
    v[rows[ok], flat[ok]] = 1
    return v


# The query side's registry histograms: the service's sign leg (the span
# query.sign), the coordinator's fold (host keys and words for raw
# signatures), the shards' submit and gather (probe, scoring, the partials'
# host copies), the host merge, and the service's whole batch.
QUERY_SPANS = ("service.sign", "query.fold", "query.broadcast",
               "query.partial", "query.merge", "service.query")


def span_sums() -> dict:
    """Seconds summed so far in each of ``QUERY_SPANS``' histograms."""
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.default()
    return {n: reg.histogram(n).sum for n in QUERY_SPANS}


def span_ms(before: dict, n_batches: int) -> dict:
    """Each of ``QUERY_SPANS`` in ms a query batch since ``before``."""
    now = span_sums()
    return {n: (now[n] - before[n]) * 1e3 / n_batches for n in QUERY_SPANS}


def ingest(svc, idx, batch: int) -> float:
    t0 = time.perf_counter()
    with svc.pipeline(depth=2) as pipe:
        for lo in range(0, len(idx), batch):
            pipe.submit(idx[lo: lo + batch])
    return time.perf_counter() - t0


def main_path(idx, fresh_idx, report: dict):
    """Phase 2: the serving path at full size, counted and checked."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ks = kernels()
    svc = SimilaritySearchService(SearchConfig(device="cuda"))
    qidx = np.concatenate([idx[:N_QUERY_INDEXED], fresh_idx])
    zero_counts(ks)
    # --- the main path: ingest + query batches -----------------------------
    t_ingest = ingest(svc, idx, BATCH)
    after_ingest = {n: k.launches for n, k in ks.items()}
    lat = []
    for i in range(5):
        before = {n: k.launches for n, k in ks.items()}
        if i == 1:                  # the spans of batches 2-5
            spans0 = span_sums()
        t0 = time.perf_counter()
        ids, scores = svc.query_sparse(qidx, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    spans = span_ms(spans0, len(lat) - 1)
    # -----------------------------------------------------------------------
    per_query = {n: launches[n] - before[n] for n in ks}
    n_batches = -(-len(idx) // BATCH)
    store = svc.store.shards[0].store
    n_fallback = svc.store.last_timings["n_fallback"]
    self_hit = float((ids[:N_QUERY_INDEXED, 0]
                      == np.arange(N_QUERY_INDEXED)).mean())
    report["main_path"] = {
        "docs": len(idx), "ingest_s": t_ingest,
        "ingest_docs_per_s": len(idx) / t_ingest,
        "query_rows": len(qidx),
        "query_latency_s_first": lat[0],
        "query_latency_s_median_next4": statistics.median(lat[1:]),
        "query_latency_s_all": lat, "top1_self_hit": self_hit,
        "fallback_rows": n_fallback, "n_slots": store.table.n_slots,
        "bucket_width": store.table.bucket_width,
        "n_spilled": store.n_spilled, "n_rebuilds": store.n_rebuilds,
        "records_bytes": store.table.records.nbytes,
        "words_bytes": store.buffer.size * store.buffer.cfg.n_words * 4,
        "launches": launches,
        "launches_per_ingest_batch": {n: after_ingest[n] / n_batches
                                      for n in ks},
        "launches_per_query_batch": per_query,
        "query_spans_ms_next4": spans,
        "registry": obs_metrics.default().snapshot(),
    }
    print(f"[main] ingest {len(idx)} docs in {t_ingest:.3f} s "
          f"({len(idx) / t_ingest:.0f} docs/s, {n_batches} batches of "
          f"{BATCH}); n_slots={store.table.n_slots} "
          f"bucket_width={store.table.bucket_width} "
          f"spilled={store.n_spilled} rebuilds={store.n_rebuilds}")
    print(f"[main] query batch of {len(qidx)} rows: first "
          f"{lat[0] * 1e3:.3f} ms, median of next 4 "
          f"{statistics.median(lat[1:]) * 1e3:.3f} ms; top-1 self-hit "
          f"{self_hit * 100:.2f}%; fallback rows {n_fallback}")
    print(f"[main] launches {launches}; per query batch {per_query}")
    require(ids.shape == (len(qidx), TOP_K) and scores.dtype == np.float32,
            "answer shape")
    require(bool(np.isfinite(scores).all()), "finite scores")
    require(self_hit == 1.0, f"top-1 self-hit {self_hit}")
    require(n_fallback > 0, "some rows take the brute-force fallback")
    for n in ("cminhash_sparse", "fold", "lsh_probe", "collision",
              "topk_select"):
        require(launches[n] > 0,
                f"kernel {n} launched on the main path ({launches[n]})")
    store_path(svc, qidx, ids, scores, report)
    n_shards = len(svc.store.shards)
    for n in ("collision", "topk_select"):
        require(per_query[n] == n_shards
                and launches[n] == len(lat) * n_shards,
                f"{n} kernel launched once per brute-force fallback call "
                f"({launches[n]} launches for {len(lat)} query batches "
                f"x {n_shards} shard)")
    return svc, qidx


def store_path(svc, qidx, ids, scores, report: dict) -> None:
    """Phase 2, second leg: the same query batch through the main path's
    shard store, ``SketchStore.query_packed``, the library's single-store
    query (the shard's leg: the fold, then the probe from its hashes),
    counted apart from the service.  It must answer as the service did."""
    ks = kernels()
    store = svc.store.shards[0].store
    qwords = svc.engine.sign(qidx, layout="sparse", pack_b=svc.cfg.b)
    torch.cuda.synchronize()
    zero_counts(ks)
    # --- the store path: query batches --------------------------------------
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        s_ids, s_scores = store.query_packed(qwords, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    report["store_path"] = {"query_rows": len(qidx),
                            "query_latency_s_all": lat,
                            "n_spilled": store.n_spilled,
                            "launches": launches}
    print(f"[store] SketchStore.query_packed, {len(qidx)} rows: "
          + ", ".join(f"{t * 1e3:.3f}" for t in lat)
          + f" ms; launches {launches}")
    require(np.array_equal(s_ids, ids) and np.array_equal(s_scores, scores),
            "the store's own query answers as the service")
    require(launches["fold"] == len(lat) and launches["lsh_probe"] == len(lat),
            f"the store's query folds and probes once a batch, as the "
            f"service's shard ({launches['fold']} fold and "
            f"{launches['lsh_probe']} probe launches for {len(lat)} batches)")


def kernel_checks(svc, idx, qidx, report: dict) -> list[dict]:
    """Phase 3: every kernel vs its plain version at the main path's
    shapes, timed."""
    from repro_torch.core.lsh import band_hashes_packed
    from repro_torch.core.permutations import apply_permutation_sparse
    from repro_torch.device import u32_to_host
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.kernels import collision_kernel as kc
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import lsh_probe as kp
    from repro_torch.kernels import query_fused as kq
    from repro_torch.kernels.packfmt import pack_codes, unpack_codes
    dev = svc.engine.device
    cfg = svc.cfg
    store = svc.store.shards[0].store
    out = []

    def entry(*args, **kw):
        out.append(kernel_entry(*args, **kw))

    # 1. sparse window-min signing, one 4096-document ingest batch
    sidx = apply_permutation_sparse(torch.tensor(idx[:BATCH], device=dev),
                                    svc.engine.sigma).to(torch.int32)
    sidx = sidx.contiguous()
    pi, k = svc.engine.pi, cfg.k
    got = ks.cminhash_sparse_kernel(sidx, pi, k, pack_b=cfg.b)
    want = ks.cminhash_sparse_plain(sidx, pi, k, pack_b=cfg.b)
    for pack_b in (None, 1, 2, 4, 8, 16):      # the other epilogues
        a = ks.cminhash_sparse_kernel(sidx, pi, k, pack_b=pack_b)
        require(torch.equal(a, ks.cminhash_sparse_plain(sidx, pi, k,
                                                        pack_b=pack_b)),
                f"cminhash_sparse pack_b={pack_b}")
    wrap = sidx + pi.numel() * torch.randint_like(sidx, 0, 3) * (sidx >= 0)
    require(torch.equal(ks.cminhash_sparse_kernel(wrap, pi, k, pack_b=cfg.b),
                        want), "cminhash_sparse indices >= D wrap mod D")
    require(torch.equal(
        ks.cminhash_sparse_kernel(sidx, pi, k, shift_offset=0),
        ks.cminhash_sparse_plain(sidx, pi, k, shift_offset=0)),
        "cminhash_sparse shift_offset=0")
    big_d = (1 << 16) + 3                       # past the uint16 range
    gen = torch.Generator().manual_seed(1)
    pi_big = torch.randperm(big_d, generator=gen).to(torch.int32).to(dev)
    idx_big = torch.randint(-1, big_d, (257, 77), generator=gen,
                            dtype=torch.int32).to(dev)
    require(torch.equal(ks.cminhash_sparse_kernel(idx_big, pi_big, 200),
                        ks.cminhash_sparse_plain(idx_big, pi_big, 200)),
            "cminhash_sparse D > 2^16")
    ms, dev_ms = both_ms(lambda: ks.cminhash_sparse_kernel(
        sidx, pi, k, pack_b=cfg.b), 20)
    plain_ms = time_ms(lambda: ks.cminhash_sparse_plain(sidx, pi, k,
                                                        pack_b=cfg.b), 5)
    n_valid = int((sidx >= 0).sum().item())
    entry("cminhash_sparse", "src/repro_torch/csrc/cminhash_sparse.cu",
          "src/repro/kernels/cminhash_sparse.py:186", got, want, ms,
          plain_ms, sidx.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
          n_valid * k, dev_ms,
          {"shape": list(sidx.shape)})

    # 2. band-hash fold, the coordinator's query batch
    qwords = svc.engine.sign(qidx, layout="sparse", pack_b=cfg.b)
    rows = kq.words_to_rows(qwords, cfg.n_bands).contiguous()
    folded = got = kq.fold_rows_kernel(rows)
    want = kq.fold_rows_plain(rows)
    require(np.array_equal(kq.hashes_to_host(got), band_hashes_packed(
        u32_to_host(qwords), cfg.n_bands)), "fold vs host uint64 fold")
    sig = torch.randint(-2**31, 2**31 - 1, rows.shape, dtype=torch.int32,
                        device=dev)
    require(torch.equal(kq.fold_rows_kernel(sig, sign_extend=True),
                        kq.fold_rows_plain(sig, sign_extend=True)),
            "fold sign_extend")
    moved = torch.cat([rows.new_zeros(1), rows.reshape(-1)])[1:]
    require(torch.equal(kq.fold_rows_kernel(moved.view(rows.shape)), want),
            "fold, rows off the 16-byte boundary (scalar loads)")
    ms, dev_ms = both_ms(lambda: kq.fold_rows_kernel(rows), 50)
    plain_ms = time_ms(lambda: kq.fold_rows_plain(rows), 10)
    entry("fold", "src/repro_torch/csrc/fold.cu",
          "src/repro/kernels/query_fused.py:164", got, want, ms, plain_ms,
          rows.numel() * 4 + got.numel() * 8, rows.numel() * 5, dev_ms,
          {"shape": list(rows.shape)})

    # 3. probe over the full-size resident records, from the fold's hashes
    # where the fold left them
    records = store.table.device_records()
    ns, mp = store.table.n_slots, store.table.max_probes
    row, got = probe_entry(records, folded, ns, mp)
    out.append(row)
    e = folded.numel()
    print(f"[kernel] lsh_probe walk: {row['probe_steps']} steps for {e} "
          f"entries (most {row['steps_max']}), {row['hits']} hits; "
          f"dependent round trips, mean / most: thread an entry "
          f"{row['round_trips_thread_an_entry']['mean']:.3f} / "
          f"{row['round_trips_thread_an_entry']['max']}, group walk "
          f"{row['round_trips_group_walk']['mean']:.3f} / "
          f"{row['round_trips_group_walk']['max']}")

    # the fold -> candidates leg as every query leg runs it (the main
    # path's shard, the single store): words on the card to candidate ids
    # on the card
    leg_ms, leg_dev_ms = both_ms(lambda: kp.lsh_probe_hashes_kernel(
        records, dispatch.fold_hashes(qwords, n_bands=cfg.n_bands),
        n_slots=ns, max_probes=mp), 50)
    report["query_leg"] = {"service_ms": leg_ms,
                           "service_device_ms": leg_dev_ms}
    print(f"[kernel] fold -> candidates leg as every query leg runs it: "
          f"{leg_ms:.4f} ms, device {leg_dev_ms:.4f} ms")

    # 4. collision counts: the brute-force fallback's call, the
    # pow2-padded fallback rows against the whole index in one launch, on
    # the words as the index stores them; and one 16,384-row block of
    # unpacked codes, the shape the earlier blocked fallback launched
    n_fb = report["main_path"]["fallback_rows"]
    row, wq = collision_entry(qwords[N_QUERY_INDEXED:], n_fb,
                              store.buffer.device_words(), k, cfg.b)
    out.append(row)
    qfb = unpack_codes(wq, k, cfg.b).contiguous()
    block = unpack_codes(store.buffer.device_words()[:16384], k,
                         cfg.b).contiguous()
    require(torch.equal(kc.collision_counts_kernel(qfb, block),
                        kc.collision_counts_plain(qfb, block)),
            "collision one 16,384-row block")
    ragged = kc.collision_counts_kernel(qfb[:37, :130].contiguous(),
                                        block[:1001, :130].contiguous())
    require(torch.equal(ragged, kc.collision_counts_plain(
        qfb[:37, :130], block[:1001, :130])), "collision ragged edges")
    for pb in (1, 2, 4, 8, 16):                 # the other pack widths
        pq, pn = pack_codes(qfb, pb), pack_codes(block[:4099], pb)
        require(torch.equal(kc.packed_collision_counts_kernel(pq, pn, k, pb),
                            kc.packed_collision_counts_plain(pq, pn, k, pb)),
                f"collision b={pb}")
    blk_ms, blk_dev_ms = both_ms(lambda: kc.collision_counts_kernel(
        qfb, block), 20)
    qn = wq.shape[0]
    row.update({"launches_per_brute_call": 1,
                "block_16384_ms": blk_ms, "block_16384_device_ms": blk_dev_ms,
                "block_16384_bound_ms": bound_ms(
                    (qn + 16384) * k * 4 + qn * 16384 * 4,
                    collision_ops(qn, 16384, k, 32))[0]})
    print(f"[kernel] collision one 16,384-row block of int32 codes: "
          f"{blk_ms:.4f} ms, device {blk_dev_ms:.4f} ms")

    # 5. top-k select: the fallback's real rows of kernel 4's counts
    # against the whole index, as the planner selects them
    out.append(select_entry(kc.packed_collision_counts_kernel(
        wq, store.buffer.device_words(), k, cfg.b)[:n_fb]))
    return out


def select_entry(counts: torch.Tensor) -> dict:
    """Phase 3's top-k select row: ``ops.topk_select`` over the fallback's
    ``counts`` at ``TOP_K`` (the kernel's path) against the plain version,
    values and columns bit for bit (one tensor of both in the row's
    check), timed and bounded by its bytes (the counts read once, each
    row's values and int64 columns written); at 40, two passes of the
    kernel, checked too."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk_select as kt
    v, c, path = ops.topk_select(counts, TOP_K)
    require(path == "kernel", f"the select on the card takes the kernel "
            f"({path})")
    wv, wc = kt.topk_select_plain(counts, TOP_K)
    require(torch.equal(v, wv), "topk_select values == the plain version's")
    v40, c40, _ = ops.topk_select(counts, 40)
    require(all(torch.equal(a, b) for a, b in zip(
        (v40, c40), kt.topk_select_plain(counts, 40))),
        "topk_select at kk 40 (two passes) == the plain version")
    ms, dev_ms = both_ms(lambda: kt.topk_select_kernel(counts, TOP_K), 20)
    plain_ms = time_ms(lambda: kt.topk_select_plain(counts, TOP_K), 5)
    q, u = counts.shape
    return kernel_entry(
        "topk_select", "src/repro_torch/csrc/topk_select.cu",
        "src/repro/store/planner.py:187 (np.argsort on the host)",
        torch.cat([v.long(), c], 1), torch.cat([wv.long(), wc], 1), ms,
        plain_ms, q * u * 4 + q * TOP_K * (4 + 8), q * u, dev_ms,
        {"shape": [q, u], "kk": TOP_K})


def collision_ops(q: int, n: int, k: int, b: int) -> int:
    """The collision count's operations: one integer compare a pair of
    codes at b = 32, one a pair of words (32/b codes) below."""
    return q * n * (k if b == 32 else -(-k // (32 // b)))


def probe_entry(records, hashes, ns: int, mp: int,
                extra: dict | None = None) -> tuple[dict, torch.Tensor]:
    """The probe from band hashes on the card against its plain version,
    timed and bounded (phase 3, and phase 5b from the host's uploaded
    keys).  The bound counts the function's bytes: 8 a hash, 8 key bytes
    per probe step this run's walks take, the W posting ids of each hit,
    the output.  Returns the row and the kernel's candidates."""
    from repro_torch.kernels import lsh_probe as kp
    got = kp.lsh_probe_hashes_kernel(records, hashes, n_slots=ns,
                                     max_probes=mp)
    want = kp.lsh_probe_hashes_plain(records, hashes, n_slots=ns,
                                     max_probes=mp)
    ms, dev_ms = both_ms(lambda: kp.lsh_probe_hashes_kernel(
        records, hashes, n_slots=ns, max_probes=mp), 50)
    plain_ms = time_ms(lambda: kp.lsh_probe_hashes_plain(
        records, hashes, n_slots=ns, max_probes=mp), 5)
    w, e = records.shape[1] - 2, hashes.numel()
    walk = probe_walk(records, kp.hash_operands(hashes, ns), ns, mp)
    walk_bytes = walk["probe_steps"] * 8 + walk["hits"] * w * 4
    row = kernel_entry(
        "lsh_probe", "src/repro_torch/csrc/lsh_probe.cu",
        "src/repro/kernels/lsh_probe.py:137", got, want, ms, plain_ms,
        e * 8 + walk_bytes + got.numel() * 4, walk["probe_steps"] * 3,
        dev_ms, {"shape": [e, w], "records_shape": list(records.shape),
                 **walk, **(extra or {})})
    return row, got


def collision_entry(qwords, n_fb: int, words, k: int, b: int,
                    extra: dict | None = None) -> tuple[dict, torch.Tensor]:
    """The brute-force fallback's collision call on the card against its
    plain version (in 16,384-row blocks) and ``K - cdist(p=0)``, timed and
    bounded (phase 3, and phase 5b at b = 2): the fresh query rows'
    ``qwords`` padded to the next power of two of the ``n_fb`` fallback
    rows, as the planner pads them, against all stored ``words`` in one
    launch.  Returns the row and the padded query words."""
    from repro_torch.kernels import collision_kernel as kc
    from repro_torch.kernels.packfmt import unpack_codes
    q_pad = 1 << (n_fb - 1).bit_length()
    wq = torch.cat([qwords, qwords[:1].expand(max(q_pad - len(qwords), 0),
                                              -1)])
    wq = wq[:q_pad].contiguous()
    got = kc.packed_collision_counts_kernel(wq, words, k, b)
    want = torch.cat([kc.packed_collision_counts_plain(
        wq, words[lo: lo + 16384], k, b)
        for lo in range(0, len(words), 16384)], dim=1)
    qd = unpack_codes(wq, k, b).double()
    nd = unpack_codes(words, k, b).double()

    def library():
        return k - torch.cdist(qd, nd, p=0)
    require(torch.equal(library().to(torch.int32), want),
            f"collision b = {b}: K - cdist(p=0) == the plain version")
    ms, dev_ms = both_ms(lambda: kc.packed_collision_counts_kernel(
        wq, words, k, b), 20)
    plain_ms = time_ms(lambda: kc.packed_collision_counts_plain(
        wq, words, k, b), 3, warmup=1)
    library_ms = time_ms(library, 3, warmup=1)
    qn, nn, nw = wq.shape[0], words.shape[0], words.shape[1]
    row = kernel_entry(
        "collision", "src/repro_torch/csrc/collision.cu",
        "src/repro/kernels/collision_kernel.py:37", got, want, ms, plain_ms,
        (qn + nn) * nw * 4 + qn * nn * 4, collision_ops(qn, nn, k, b),
        dev_ms, {"shape": [qn, nn, k], "b": b, "words": nw,
                 **(extra or {})}, library_ms=library_ms)
    return row, wq


def kernel_entry(name, source, replaces, got, want, ms, plain_ms, nbytes,
                 ops, device_ms, extra=None, library_ms=None) -> dict:
    """One kernel's checked, timed and bounded row (launches are filled in
    from the counted paths at the end)."""
    err = max_abs_err(got, want)
    require(err == 0.0 and torch.equal(got, want),
            f"{name}: kernel != plain version (max abs err {err})")
    b_ms, b_by = bound_ms(nbytes, ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": None,
           "max_abs_err": err, "equal": True, "ms": ms, "kernel_ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms, "bytes": nbytes, "operations": ops}
    row.update(extra or {})
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    shape = f" {row['shape']}" if "shape" in row else ""
    print(f"[kernel] {name}{shape}: equal, {ms:.4f} ms, device "
          f"{device_ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}{lib})")
    return row


def profile_busy(fn, name: str) -> dict:
    """``fn`` once under torch.profiler, the timeline to
    ``chiprun_out/<name>.json``: its wall time and the device's busy time,
    the union of the trace's kernel, memcpy and memset intervals, so no
    operator is counted twice with the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(ROOT, "chiprun_out", f"{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, float("-inf")
    by_name: dict[str, float] = {}
    for start, stop, kname in device:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[kname] = by_name.get(kname, 0.0) + stop - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    require(busy_us > 0, "the profiler recorded device activity")
    return {"wall_us": wall_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / wall_us,
            "device_events": len(device),
            "top_device_time_us": [{"name": n, "us": t} for n, t in top]}


def trace_query(svc, qdata, report: dict, layout: str = "sparse",
                tag: str = "") -> None:
    """Phase 4 (and the raw and dense paths' traces): one query batch under
    torch.profiler."""
    query = svc.query_sparse if layout == "sparse" else svc.query_dense
    tag = tag or ("" if layout == "sparse" else f"_{layout}")
    rec = profile_busy(lambda: query(qdata, top_k=TOP_K),
                       f"query_trace{tag}")
    report[f"query_trace{tag}"] = rec
    wall_us, busy_us = rec["wall_us"], rec["device_busy_us"]
    top = [(r["name"], r["us"]) for r in rec["top_device_time_us"]]
    print(f"[trace] {tag.lstrip('_') or layout} query batch: wall "
          f"{wall_us / 1e3:.3f} ms, "
          f"device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us * 100:.1f}%) over "
          f"{rec['device_events']} device events; top: "
          + ", ".join(f"{n[:48]} {t / 1e3:.3f} ms" for n, t in top[:4]))


def probe_walk(records, meta, n_slots, max_probes) -> dict:
    """The early-exit walk over these operands: probe steps read and hits,
    and the dependent memory reads each design of the probe needs for it:
    a thread an entry (the earlier kernel: the operand row, one key read a
    step, the hit's ids) and the group walk (``csrc/lsh_probe.cu``: the
    hash, one read of four steps' keys, the hit's ids)."""
    lin, base = meta[:, 0].long(), meta[:, 1].long()
    active = meta[:, 4] != 0
    steps = torch.zeros(meta.shape[0], dtype=torch.long, device=meta.device)
    hit_any = torch.zeros_like(active)
    for t in range(max_probes):
        if not bool(active.any()):
            break
        steps += active.long()
        rec = records[lin + (base + t * (t + 1) // 2) % n_slots]
        hit = active & (rec[:, 0] == meta[:, 2]) & (rec[:, 1] == meta[:, 3])
        unused = (rec[:, 0] == -1) & (rec[:, 1] == -1)
        hit_any |= hit
        active = active & ~hit & ~unused
    old = 1 + steps + hit_any.long()
    new = 1 + (steps + 3) // 4 + hit_any.long()

    def stats(trips):
        return {"mean": float(trips.double().mean()),
                "max": int(trips.max()) if trips.numel() else 0}
    return {"probe_steps": int(steps.sum()), "hits": int(hit_any.sum()),
            "steps_max": int(steps.max()) if steps.numel() else 0,
            "steps_hist": torch.bincount(steps).tolist(),
            "round_trips_thread_an_entry": stats(old),
            "round_trips_group_walk": stats(new)}


def card_vs_cpu(idx, fresh_idx, report: dict, b: int = 32) -> None:
    """Phase 5 (b = 32) and phase 5b's second leg (b = 2, raw
    signatures): the same service on the card and on the CPU."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    sub = idx[:4096]
    q = np.concatenate([sub[:256], fresh_idx])
    answers = []
    for device in ("cuda", "cpu"):
        svc = SimilaritySearchService(SearchConfig(device=device, b=b))
        ingest(svc, sub, 1024)
        answers.append(svc.query_sparse(q, top_k=TOP_K))
        fb = svc.store.last_timings["n_fallback"]
    (ci, cs), (pi_, ps) = answers
    require(np.array_equal(ci, pi_) and np.array_equal(cs, ps),
            f"card and CPU answers differ on the 4096-document subset at "
            f"b = {b}")
    key = "card_vs_cpu" if b == 32 else f"card_vs_cpu_b{b}"
    report[key] = {"docs": len(sub), "query_rows": len(q), "b": b,
                   "packed_ingest": svc.packed_ingest,
                   "fallback_rows": fb, "identical": True}
    print(f"[card-vs-cpu] b = {b}, {len(sub)} docs, {len(q)} queries "
          f"({fb} fallback rows): ids and scores identical")


def raw_path(idx, fresh_idx, report: dict):
    """Phase 5b, first leg: the service at b = 2, where 8 rows a band are
    not word-aligned, so ingest and query run on raw signatures: the sparse
    kernel's unpacked output, band keys folded on the host, the probe from
    the coordinator's uploaded keys, the collision count on 2-bit words.
    Counted and checked like phase 2."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ks = kernels()
    svc = SimilaritySearchService(SearchConfig(device="cuda", b=2))
    require(not svc.packed_ingest, "b = 2 at 32 x 8 bands ingests raw")
    qidx = np.concatenate([idx[:N_QUERY_INDEXED], fresh_idx])
    zero_counts(ks)
    # --- the raw path: ingest + query batches -------------------------------
    t_ingest = ingest(svc, idx, BATCH)
    after_ingest = read_counts(ks)
    lat = []
    for i in range(5):
        if i == 1:                  # the spans of batches 2-5
            spans0 = span_sums()
        t0 = time.perf_counter()
        ids, scores = svc.query_sparse(qidx, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    spans = span_ms(spans0, len(lat) - 1)
    store = svc.store.shards[0].store
    n_shards = len(svc.store.shards)
    n_fallback = svc.store.last_timings["n_fallback"]
    own = ids[:N_QUERY_INDEXED] == np.arange(N_QUERY_INDEXED)[:, None]
    own_at_one = (own & (scores[:N_QUERY_INDEXED] == 1.0)).any(axis=1)
    report["raw_path"] = {
        "docs": len(idx), "b": svc.cfg.b, "ingest_s": t_ingest,
        "ingest_docs_per_s": len(idx) / t_ingest,
        "query_rows": len(qidx), "query_latency_s_first": lat[0],
        "query_latency_s_median_next4": statistics.median(lat[1:]),
        "query_latency_s_all": lat,
        "own_id_in_top5_at_1": float(own_at_one.mean()),
        "top1_self_hit": float(own[:, 0].mean()),
        "fallback_rows": n_fallback, "n_slots": store.table.n_slots,
        "bucket_width": store.table.bucket_width,
        "n_spilled": store.n_spilled, "n_rebuilds": store.n_rebuilds,
        "records_bytes": store.table.records.nbytes,
        "words_bytes": store.buffer.nbytes,
        "launches": launches, "launches_ingest": after_ingest,
        "query_spans_ms_next4": spans}
    print(f"[raw] b = 2: ingest {len(idx)} docs in {t_ingest:.3f} s "
          f"({len(idx) / t_ingest:.0f} docs/s); words "
          f"{store.buffer.nbytes} B, records {store.table.records.nbytes} B; "
          f"n_slots={store.table.n_slots} spilled={store.n_spilled} "
          f"rebuilds={store.n_rebuilds}")
    print(f"[raw] query batch of {len(qidx)} rows: first "
          f"{lat[0] * 1e3:.3f} ms, median of next 4 "
          f"{statistics.median(lat[1:]) * 1e3:.3f} ms; own id at 1.0 in "
          f"the top {TOP_K}: {own_at_one.mean() * 100:.2f}%; fallback rows "
          f"{n_fallback}")
    packed = report["main_path"]["query_spans_ms_next4"]
    print("[raw] query spans, ms a batch over batches 2-5, raw (b = 2) / "
          "packed (b = 32, phase 2): " + ", ".join(
              f"{n} {spans[n]:.3f} / {packed[n]:.3f}" for n in QUERY_SPANS))
    print(f"[raw] launches {launches}")
    require(ids.shape == (len(qidx), TOP_K) and scores.dtype == np.float32,
            "raw answer shape")
    require(bool(np.isfinite(scores).all()), "finite raw scores")
    require(bool(own_at_one.all()),
            "every indexed row finds its own id in its top 5 at score 1.0")
    require(n_fallback > 0, "some raw rows take the brute-force fallback")
    for n in ("cminhash_sparse", "lsh_probe"):
        require(launches[n] > 0, f"kernel {n} launched on the raw path")
    require(launches["fold"] == 0,
            f"raw keys are folded on the host: no fold launch "
            f"({launches['fold']})")
    require(launches["collision"] == len(lat) * n_shards,
            f"collision kernel launched once per brute-force fallback call "
            f"({launches['collision']} for {len(lat)} query batches x "
            f"{n_shards} shard)")
    report["raw_path"]["kernels"] = raw_kernel_checks(
        svc, idx, qidx, n_fallback, report["raw_path"])
    trace_query(svc, qidx, report, tag="_raw")
    return svc


def raw_kernel_checks(svc, idx, qidx, n_fallback: int,
                      report: dict) -> list[dict]:
    """Phase 5b: the kernels at the raw path's own shapes against their
    plain versions, timed and bounded as in phase 3: the sparse kernel's
    unpacked (4096, 256) output, the probe from the host's band keys
    uploaded, the collision count of the fallback rows on 2-bit words.
    Then the query batch's words packed both ways, timed as called."""
    from repro_torch.core.lsh import band_hashes
    from repro_torch.core.permutations import apply_permutation_sparse
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.kernels.packfmt import pack_codes
    from repro_torch.kernels.query_fused import hashes_to_device
    from repro_torch.store.packed import pack_host
    dev, cfg = svc.engine.device, svc.cfg
    store = svc.store.shards[0].store
    pi, k, b = svc.engine.pi, cfg.k, cfg.b
    out = []
    sidx = apply_permutation_sparse(torch.tensor(idx[:BATCH], device=dev),
                                    svc.engine.sigma).to(torch.int32)
    sidx = sidx.contiguous()
    got = ks.cminhash_sparse_kernel(sidx, pi, k)
    want = ks.cminhash_sparse_plain(sidx, pi, k)
    ms, dev_ms = both_ms(lambda: ks.cminhash_sparse_kernel(sidx, pi, k), 20)
    plain_ms = time_ms(lambda: ks.cminhash_sparse_plain(sidx, pi, k), 5)
    out.append(kernel_entry(
        "cminhash_sparse", "src/repro_torch/csrc/cminhash_sparse.cu",
        "src/repro/kernels/cminhash_sparse.py:186", got, want, ms, plain_ms,
        sidx.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
        int((sidx >= 0).sum().item()) * k, dev_ms,
        {"shape": list(sidx.shape), "output": "unpacked"}))

    qsigs = svc.engine.sign(qidx, layout="sparse").cpu().numpy()
    hashes = hashes_to_device(band_hashes(qsigs, cfg.n_bands,
                                          cfg.rows_per_band), dev)
    table = store.table
    out.append(probe_entry(table.device_records(), hashes, table.n_slots,
                           table.max_probes,
                           {"keys": "host band_hashes, uploaded"})[0])
    out.append(collision_entry(
        pack_codes(torch.tensor(qsigs[N_QUERY_INDEXED:], device=dev), b),
        n_fallback, store.buffer.device_words(), k, b)[0])
    # the coordinator's query words: packed on the host (as with
    # query_impl="host") or uploaded and packed on the card (the default)
    host_ms = time_ms(lambda: pack_host(qsigs, b), 10)
    card_ms = time_ms(lambda: pack_codes(torch.from_numpy(qsigs).to(dev), b),
                      10)
    report["query_words_pack_ms"] = {"host": host_ms, "card": card_ms}
    print(f"[raw] the query batch's words: packed on the host "
          f"{host_ms:.3f} ms, uploaded and packed on the card "
          f"{card_ms:.3f} ms")
    return out


def snapshot_path(services: dict, qidx, report: dict) -> None:
    """Phase 5b, third leg: each service's plane saved with
    ``ShardedSketchStore.save`` to a temporary directory (deleted after),
    loaded onto the card with ``ShardedSketchStore.load``, and served by a
    service with the same permutations: the same batch must get the live
    plane's ids and scores, and every shard the live shard's digest.
    Counted: the loaded planes' query batches."""
    from repro_torch.serve.search import SimilaritySearchService
    from repro_torch.store import ShardedSketchStore
    ks = kernels()
    live = {name: svc.query_sparse(qidx, top_k=TOP_K)
            for name, svc in services.items()}
    torch.cuda.synchronize()
    rows = {}
    zero_counts(ks)
    # --- the snapshot path: save, load, query batches -----------------------
    for name, svc in services.items():
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            svc.store.save(d)
            save_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            t0 = time.perf_counter()
            plane = ShardedSketchStore.load(d, device="cuda")
            load_s = time.perf_counter() - t0
        loaded = SimilaritySearchService(
            svc.cfg, params=(svc.engine.sigma, svc.engine.pi), store=plane)
        ids, scores = loaded.query_sparse(qidx, top_k=TOP_K)
        require(np.array_equal(ids, live[name][0])
                and np.array_equal(scores, live[name][1]),
                f"the {name} snapshot answers as its live plane")
        digests = [sh.store.digest() for sh in plane.shards]
        require(digests == [sh.store.digest() for sh in svc.store.shards],
                f"the {name} snapshot's shard digests equal the live ones")
        rows[name] = {"b": svc.cfg.b, "docs": plane.size,
                      "save_s": save_s, "load_s": load_s,
                      "snapshot_bytes": nbytes, "digests": digests}
        print(f"[snapshot] {name} (b = {svc.cfg.b}, {plane.size} docs): "
              f"saved {nbytes} B in {save_s:.3f} s, loaded onto the card in "
              f"{load_s:.3f} s; answers and digests equal the live plane's")
        del loaded, plane
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    report["snapshot_path"] = {"planes": rows, "launches": launches}
    print(f"[snapshot] launches {launches}")
    for n in ("lsh_probe", "collision"):
        require(launches[n] > 0, f"kernel {n} launched by a loaded plane")


# The coordinator's registry histograms a tcp query batch: the fold once,
# the legs' submit (the hashes' and words' host copies, the frames'
# encoding and the first sends), the gather (the wait for the workers'
# replies), the host merge; then each shard's reply latency.
TCP_SHARDS = 4
TCP_SPANS = ("service.sign", "query.fold", "query.broadcast",
             "query.partial", "query.merge", "service.query") + tuple(
                 f"query.shard{i}.partial" for i in range(TCP_SHARDS))
WIRE_COUNTERS = ("transport.client.bytes_out", "transport.client.bytes_in")


def hist_sums(names) -> dict:
    """Seconds summed so far in each named registry histogram."""
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.default()
    return {n: reg.histogram(n).sum for n in names}


def wire_bytes() -> dict:
    """The coordinator's tcp bytes so far, out and in."""
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.default()
    return {n.rsplit(".", 1)[1]: reg.counter(n).value for n in WIRE_COUNTERS}


def compute_apps() -> list[str]:
    """nvidia-smi's compute contexts on the card, one ``pid, used memory``
    line each."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def check_contexts(pids: list[int], apps: list[str], devices: list[str],
                   device_bytes: list[int]) -> str:
    """Every worker holds a CUDA context on the card.  By their own STATS,
    each worker's store lives on ``cuda`` and holds memory there.  Where
    nvidia-smi lists this namespace's pids (it lists this process), each
    worker pid must be among them.  Where it cannot (a container whose pids
    it does not see, so it does not list this process either), the pid
    check is not possible: nvidia-smi's rows are only required to number at
    least this process and each worker, which another process's context
    could satisfy, so the STATS checks carry the evidence.  Returns how it
    checked."""
    listed = {int(a.split(",")[0]) for a in apps
              if a.split(",")[0].strip().isdigit()}
    require(all(d.startswith("cuda") for d in devices),
            f"every worker's store lives on the card ({devices})")
    require(all(b > 0 for b in device_bytes),
            f"every worker holds memory on the card ({device_bytes} B)")
    if os.getpid() in listed:
        require(set(pids) <= listed,
                f"every worker pid holds a CUDA context (workers {pids}, "
                f"nvidia-smi {sorted(listed)})")
        return "pids: every worker pid listed by nvidia-smi"
    require(len(apps) >= 1 + len(pids),
            f"nvidia-smi lists at least a CUDA context for this process and "
            f"each of the {len(pids)} workers ({apps})")
    return ("pid check not possible: nvidia-smi does not list this "
            "namespace's pids; workers on the card by their STATS device "
            "and device bytes")


def tcp_query_batches(svc, qidx, n: int, want) -> list[float]:
    """``n`` query batches through ``svc``, each held equal to ``want``;
    their host-clock seconds."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        ids, scores = svc.query_sparse(qidx, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
        require(np.array_equal(ids, want[0])
                and np.array_equal(scores, want[1]),
                "the tcp plane answers as phase 2's in-process shard")
    return lat


def tcp_kernel_checks(d: str, main_svc, qidx, n_fallback: int,
                      report: dict, tag: str = "tcp") -> list[dict]:
    """Phases 5c and 5d: the workers' kernels at the shapes the tcp path
    (or the replicated plane's lanes) gives them, against their plain
    versions, timed and bounded as in phase 3.
    Shard 0 of the plane's snapshot in ``d`` is loaded onto the card as a
    worker loads it; the probe reads the batch's band hashes as a worker
    gets them (folded on the card, copied to the host, uploaded), and the
    collision count scores the fresh rows, padded as the planner pads the
    fallback rows, against the shard's words."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.query_fused import (hashes_to_device,
                                                 hashes_to_host)
    from repro_torch.store import SketchStore
    from repro_torch.store.sharded import shard_snapshot_path
    cfg = main_svc.cfg
    st = SketchStore.load(shard_snapshot_path(d, 0), device="cuda")
    qwords = main_svc.engine.sign(qidx, layout="sparse", pack_b=cfg.b)
    wire = hashes_to_host(dispatch.fold_hashes(qwords, n_bands=cfg.n_bands))
    hashes = hashes_to_device(wire, st.device)
    extra = {"shard": 0, "shard_docs": st.size}
    print(f"[{tag}] the workers' kernels at shard 0's shapes ({st.size} "
          f"docs, {n_fallback} fallback rows), against their plain "
          f"versions:")
    rows = [probe_entry(st.table.device_records(), hashes, st.table.n_slots,
                        st.table.max_probes,
                        {"keys": "wire band hashes, uploaded", **extra})[0],
            collision_entry(qwords[N_QUERY_INDEXED:], n_fallback,
                            st.buffer.device_words(), cfg.k, cfg.b,
                            extra)[0]]
    report["kernels"] = rows
    return rows


def tcp_path(main_svc, idx, qidx, report: dict) -> None:
    """Phase 5c: the tcp shard plane through the service a user calls,
    ``SearchConfig(transport="tcp", n_shards=4)`` on the card: four shard
    worker processes, each with its own CUDA context on this one card.
    The coordinator signs and folds (kernels 1, 2); each worker probes from
    the uploaded wire hashes and scores its fallback rows (kernels 3, 4).
    Counted: the coordinator's counts set to 0 just before, the workers'
    from their STATS (fresh processes, so they start at 0).  Then a hedged
    plane booted from the plane's snapshot, one worker slowed."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    from repro_torch.transport import (connect_sharded, shutdown_plane,
                                       spawn_workers)
    ks = kernels()
    want = main_svc.query_sparse(qidx, top_k=TOP_K)
    want_fb = main_svc.store.last_timings["n_fallback"]
    params = (main_svc.engine.sigma, main_svc.engine.pi)
    cfg = SearchConfig(device="cuda", transport="tcp", n_shards=TCP_SHARDS)
    svc = hsvc = hplane = None
    handles: list = []
    try:
        torch.cuda.synchronize()
        zero_counts(ks)
        # --- the tcp path: spawn, ingest + query batches ------------------
        t0 = time.perf_counter()
        svc = SimilaritySearchService(cfg, params=params)
        spawn_s = time.perf_counter() - t0
        w0 = wire_bytes()
        t_ingest = ingest(svc, idx, BATCH)
        w1 = wire_bytes()
        lat = tcp_query_batches(svc, qidx, 1, want)
        stats0 = [sh.stats() for sh in svc.store.shards]
        spans0, w2 = hist_sums(TCP_SPANS), wire_bytes()
        lat += tcp_query_batches(svc, qidx, 4, want)
        spans1, w3 = hist_sums(TCP_SPANS), wire_bytes()
        coordinator = read_counts(ks)
        stats = [sh.stats() for sh in svc.store.shards]
        # -------------------------------------------------------------------
        # each worker's own handling time a batch over batches 2-5 (its
        # registry's worker.handle.* histograms), beside the coordinator's
        # wait for its reply (query.shard{i}.partial)
        handle = [{leg: (json.loads(b["obs"])["hists"]
                         [f"worker.handle.{leg}"]["sum_ns"]
                         - json.loads(a["obs"])["hists"]
                         [f"worker.handle.{leg}"]["sum_ns"]) / 4 / 1e6
                   for leg in ("query", "brute")}
                  for a, b in zip(stats0, stats)]
        n_fallback = svc.store.last_timings["n_fallback"]
        workers = [json.loads(st["launches"]) for st in stats]
        launches = {n: coordinator[n] + sum(w[n] for w in workers)
                    for n in ks}
        spans = {n: (spans1[n] - spans0[n]) * 1e3 / 4 for n in TCP_SPANS}
        wire_q = {k: (w3[k] - w2[k]) / 4 for k in w3}
        wire_ingest = {k: w1[k] - w0[k] for k in w1}
        plane = svc.store.obs_snapshot()
        pids = [int(st["pid"]) for st in stats]
        apps = compute_apps()
        rows = {
            "shards": TCP_SHARDS, "docs": len(idx), "spawn_s": spawn_s,
            "ingest_s": t_ingest, "ingest_docs_per_s": len(idx) / t_ingest,
            "query_rows": len(qidx), "query_latency_s_first": lat[0],
            "query_latency_s_median_next4": statistics.median(lat[1:]),
            "query_latency_s_all": lat, "fallback_rows": n_fallback,
            "shard_sizes": [int(st["size"]) for st in stats],
            "n_spilled": [int(st["n_spilled"]) for st in stats],
            "worker_pids": pids, "compute_apps": apps,
            "worker_devices": [str(st["device"]) for st in stats],
            "worker_device_bytes": [int(st["device_bytes"]) for st in stats],
            "launches": launches, "launches_coordinator": coordinator,
            "launches_workers": workers,
            "query_spans_ms_next4": spans,
            "worker_handle_ms_next4": handle,
            "wire_bytes_per_query_batch": wire_q,
            "wire_bytes_ingest": wire_ingest,
            "worker_registries": {
                f"shard{i}": json.loads(st["obs"])["counters"]
                for i, st in enumerate(stats)}}
        report["tcp_path"] = rows
        print(f"[tcp] {TCP_SHARDS} shard workers on the card up in "
              f"{spawn_s:.3f} s; ingest {len(idx)} docs in {t_ingest:.3f} s "
              f"({len(idx) / t_ingest:.0f} docs/s), shard sizes "
              f"{rows['shard_sizes']}, wire {wire_ingest['bytes_out']} B "
              f"out")
        print(f"[tcp] query batch of {len(qidx)} rows: first "
              f"{lat[0] * 1e3:.3f} ms, median of next 4 "
              f"{statistics.median(lat[1:]) * 1e3:.3f} ms (phase 2's "
              f"in-process shard: "
              f"{report['main_path']['query_latency_s_median_next4'] * 1e3:.3f}"
              f" ms); fallback rows {n_fallback}; answers equal phase 2's")
        print("[tcp] spans, ms a batch over batches 2-5: " + ", ".join(
            f"{n} {spans[n]:.3f}" for n in TCP_SPANS))
        print("[tcp] each worker's own handling, ms a batch over batches "
              "2-5 (QUERY / BRUTE): " + ", ".join(
                  f"shard{i} {h['query']:.3f} / {h['brute']:.3f}"
                  for i, h in enumerate(handle)))
        print(f"[tcp] wire a query batch: {wire_q['bytes_out']:.0f} B out, "
              f"{wire_q['bytes_in']:.0f} B in")
        print(f"[tcp] launches {launches}; coordinator {coordinator}; "
              f"workers {workers}")
        require(n_fallback == want_fb and n_fallback > 0,
                f"the tcp plane takes phase 2's fallback rows ({n_fallback} "
                f"against {want_fb})")
        require(coordinator["fold"] == len(lat)
                and coordinator["lsh_probe"] == 0
                and coordinator["collision"] == 0
                and coordinator["topk_select"] == 0,
                f"the coordinator folds once a batch and probes and scores "
                f"nothing ({coordinator})")
        for i, w in enumerate(workers):
            require(w["fold"] == 0,
                    f"worker {i} launches no fold ({w})")
            require(w["lsh_probe"] == len(lat)
                    and w["collision"] == len(lat)
                    and w["topk_select"] == len(lat),
                    f"worker {i} probes once a batch from the wire's hashes "
                    f"and scores its fallback rows once a batch ({w})")
            prefix = f"shard{i}.replica0.kernel."
            mine = {n[len(prefix):]: v for n, v in plane["counters"].items()
                    if n.startswith(prefix)}
            require(mine.get("query_fused.cuda", 0) > 0
                    and not any(n.endswith(".plain") for n in mine),
                    f"worker {i}'s registry: the fused query on the card "
                    f"and no plain kernel ({mine})")
        rows["contexts_checked_by"] = check_contexts(
            pids, apps, rows["worker_devices"], rows["worker_device_bytes"])
        print(f"[tcp] worker pids {pids} on {rows['worker_devices']}, "
              f"holding {rows['worker_device_bytes']} B on the card; "
              f"nvidia-smi "
              f"compute contexts: {apps} ({rows['contexts_checked_by']})")

        # the hedged plane: the same shards booted from the plane's
        # snapshot, worker 1 sleeping 20 ms on half its reads
        with tempfile.TemporaryDirectory() as d:
            svc.store.save(d)
            tcp_kernel_checks(d, main_svc, qidx, n_fallback, rows)
            t0 = time.perf_counter()
            handles = spawn_workers(None, TCP_SHARDS, device="cuda",
                                    snapshot_dir=d,
                                    slow_shards={1: (0.5, 0.02)})
            hplane = connect_sharded(
                [h.address for h in handles], snapshot_dir=d,
                timeout=cfg.query_timeout_s, hedge=True, device="cuda")
            boot_s = time.perf_counter() - t0
        hsvc = SimilaritySearchService(cfg, params=params, store=hplane,
                                       workers=handles)
        n_more = 12
        lat_u = tcp_query_batches(svc, qidx, n_more, want)
        lat_h = tcp_query_batches(hsvc, qidx, n_more, want)
        group = hplane.shards[0].group
        rows["hedged"] = {
            "boot_s": boot_s, "batches": n_more,
            "slow_shards": {"1": [0.5, 0.02]},
            "query_latency_s_unhedged": lat_u,
            "query_latency_s_hedged": lat_h,
            "median_unhedged_s": statistics.median(lat_u[1:]),
            "median_hedged_s": statistics.median(lat_h[1:]),
            "n_hedges": group.n_hedges, "n_hedge_wins": group.n_hedge_wins}
        print(f"[tcp] hedged plane (worker 1 sleeps 20 ms on half its "
              f"reads), booted from the snapshot in {boot_s:.3f} s: "
              f"{n_more} batches, answers equal; median of batches 2-"
              f"{n_more}: unhedged {rows['hedged']['median_unhedged_s'] * 1e3:.3f}"
              f" ms, hedged {rows['hedged']['median_hedged_s'] * 1e3:.3f} ms;"
              f" hedges {group.n_hedges}, won {group.n_hedge_wins}")
    finally:
        # clean-up only (a failure above still raises): every worker is
        # shut down through shutdown_plane (the services' close)
        if hsvc is not None:
            hsvc.close()
        elif hplane is not None:
            shutdown_plane(hplane, handles)
        for h in handles:
            h.terminate()
        if svc is not None:
            svc.close()


# -- phases 5d and 5e: the replicated plane and the streaming front end ------

REPLICA_SHARDS = 2
REPLICAS = 2
STREAM_QPS = 2000.0


def lane_stats(store) -> list[dict]:
    """STATS of every up lane of a replicated plane whose worker is alive,
    with its (shard, replica): counters and launches parsed, and its
    longest ADD (``add_max_s``).  (A lane
    whose worker was stopped stays up until a round or the supervisor
    notices; it is left out.)"""
    from repro_torch.transport.wire import Message, MsgType
    out = []
    for rs in store.shards:
        for lane in rs.up_lanes():
            if lane.handle is not None and not lane.handle.alive:
                continue
            st = dict(lane.conn.request(Message(MsgType.STATS, {})).fields)
            obs = json.loads(st["obs"])
            out.append({"shard": lane.shard, "replica": lane.replica,
                        "pid": int(st["pid"]), "size": int(st["size"]),
                        "device": str(st["device"]),
                        "device_bytes": int(st["device_bytes"]),
                        "launches": json.loads(st["launches"]),
                        "handled": {leg: obs["hists"].get(
                            f"worker.handle.{leg}", {"count": 0})["count"]
                            for leg in ("add", "query", "brute")},
                        "add_max_s": obs["hists"].get(
                            "worker.handle.add", {}).get("max")})
    return out


def check_lane_launches(lanes: list[dict], tag: str) -> None:
    """Across the lanes of each shard, probe and collision launches equal
    the QUERY and BRUTE frames those lanes handled (a hedge or failover
    makes a twin handle one), and no lane folds."""
    for s in sorted({ln["shard"] for ln in lanes}):
        mine = [ln for ln in lanes if ln["shard"] == s]
        probes = sum(ln["launches"]["lsh_probe"] for ln in mine)
        scores = sum(ln["launches"]["collision"] for ln in mine)
        queries = sum(ln["handled"]["query"] for ln in mine)
        brutes = sum(ln["handled"]["brute"] for ln in mine)
        require(probes == queries and scores == brutes and probes > 0
                and scores > 0,
                f"{tag}: shard {s}'s lanes launch the probe once a QUERY "
                f"and the collision kernel once a BRUTE ({probes} probe "
                f"launches for {queries} QUERY frames, {scores} collision "
                f"launches for {brutes} BRUTE frames)")
        require(all(ln["launches"]["fold"] == 0 for ln in mine),
                f"{tag}: shard {s}'s lanes launch no fold")
    # a lane's store uploads its index to the card on its first read, so
    # only a lane that answered a QUERY must hold bytes there
    require(all(ln["device"].startswith("cuda") for ln in lanes)
            and all(ln["device_bytes"] > 0 for ln in lanes
                    if ln["handled"]["query"] > 0),
            f"{tag}: every lane's store on the card, each lane that answered "
            f"a read holding bytes there ("
            f"{[(ln['device'], ln['device_bytes'], ln['handled']['query']) for ln in lanes]})")


def plane_launches(coordinator: dict, lanes: list[dict]) -> dict:
    return {n: coordinator[n] + sum(ln["launches"][n] for ln in lanes)
            for n in coordinator}


def replica_path(main_svc, idx, qidx, jdir: str, report: dict):
    """Phase 5d, the healthy plane: ``SearchConfig(transport="tcp",
    n_shards=2, n_replicas=2, journal_dir=jdir)`` on the card through the
    service, phase 2's permutations; the 262,144 documents, the batch five
    times, answers equal phase 2's.  Returns the service (kept open for
    phase 5e)."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ks = kernels()
    reg = obs_metrics.default()
    want = main_svc.query_sparse(qidx, top_k=TOP_K)
    want_fb = main_svc.store.last_timings["n_fallback"]
    cfg = SearchConfig(device="cuda", transport="tcp",
                       n_shards=REPLICA_SHARDS, n_replicas=REPLICAS,
                       journal_dir=jdir)
    torch.cuda.synchronize()
    zero_counts(ks)
    # --- the replicated path: spawn, ingest + query batches --------------
    t0 = time.perf_counter()
    svc = SimilaritySearchService(
        cfg, params=(main_svc.engine.sigma, main_svc.engine.pi))
    try:
        spawn_s = time.perf_counter() - t0
        w0, j0 = wire_bytes(), reg.counter("journal.bytes").value
        t_ingest = ingest(svc, idx, BATCH)
        w1, j1 = wire_bytes(), reg.counter("journal.bytes").value
        lat = tcp_query_batches(svc, qidx, 5, want)
        w2 = wire_bytes()
        coordinator = read_counts(ks)
        lanes = lane_stats(svc.store)
        # -------------------------------------------------------------------
        # the supervisor's probes: this plane's is the run's first
        # supervisor, so the histogram is this phase's alone
        hb = reg.histogram("replica.heartbeat")
        heartbeats = {"count": hb.count, "max_s": hb.vmax,
                      "longest_add_s": max((ln["add_max_s"] or 0.0
                                            for ln in lanes), default=0.0)}
        n_fallback = svc.store.last_timings["n_fallback"]
        journal = svc.store.journal
        n_records = journal.last_seq + 1
        reckoned = n_records * BATCH * svc.cfg.k * 4
        rows = {
            "shards": REPLICA_SHARDS, "replicas": REPLICAS, "docs": len(idx),
            "spawn_s": spawn_s, "ingest_s": t_ingest,
            "ingest_docs_per_s": len(idx) / t_ingest,
            "query_rows": len(qidx), "query_latency_s_first": lat[0],
            "query_latency_s_median_next4": statistics.median(lat[1:]),
            "query_latency_s_all": lat, "fallback_rows": n_fallback,
            "wire_bytes_ingest": {k: w1[k] - w0[k] for k in w1},
            "wire_bytes_per_query_batch": {k: (w2[k] - w1[k]) / len(lat)
                                           for k in w2},
            "journal_records": n_records,
            "journal_bytes": os.path.getsize(journal.path),
            "journal_bytes_counted": j1 - j0,
            "journal_payload_bytes_reckoned": reckoned,
            "heartbeats": heartbeats,
            "lanes": lanes, "launches": plane_launches(coordinator, lanes),
            "launches_coordinator": coordinator}
        report["replica_path"] = rows
        print(f"[replica] {REPLICA_SHARDS} shards x {REPLICAS} replicas on "
              f"the card up in {spawn_s:.3f} s; ingest {len(idx)} docs in "
              f"{t_ingest:.3f} s ({len(idx) / t_ingest:.0f} docs/s), every "
              f"write to both lanes of its shard; wire "
              f"{rows['wire_bytes_ingest']['bytes_out']} B out")
        print(f"[replica] journal: {n_records} ADD records, "
              f"{rows['journal_bytes']} B on disk (counted "
              f"{rows['journal_bytes_counted']} B; reckoned {n_records} x "
              f"{BATCH} x {svc.cfg.k} uint32 words = {reckoned} B of "
              f"payload)")
        print(f"[replica] query batch of {len(qidx)} rows: first "
              f"{lat[0] * 1e3:.3f} ms, median of next 4 "
              f"{statistics.median(lat[1:]) * 1e3:.3f} ms; fallback rows "
              f"{n_fallback}; answers equal phase 2's; wire a batch "
              f"{rows['wire_bytes_per_query_batch']['bytes_out']:.0f} B out")
        print(f"[replica] supervisor heartbeats: {heartbeats['count']}, "
              f"longest {(heartbeats['max_s'] or 0.0) * 1e3:.3f} ms; a "
              f"worker's longest ADD {heartbeats['longest_add_s']:.3f} s "
              f"(the probe answers beside it)")
        print(f"[replica] launches: coordinator {coordinator}; lanes "
              + "; ".join(f"({ln['shard']},{ln['replica']}) "
                          f"{ln['launches']} for {ln['handled']}"
                          for ln in lanes))
        require(n_fallback == want_fb and n_fallback > 0,
                f"the replicated plane takes phase 2's fallback rows "
                f"({n_fallback} against {want_fb})")
        require(coordinator["fold"] == len(lat)
                and coordinator["lsh_probe"] == 0
                and coordinator["collision"] == 0
                and coordinator["topk_select"] == 0,
                f"the coordinator folds once a batch and launches no probe "
                f"or collision kernel ({coordinator})")
        down = [(ln.shard, ln.replica, ln.why_down)
                for rs in svc.store.shards for ln in rs.lanes if not ln.up]
        require(len(lanes) == REPLICA_SHARDS * REPLICAS,
                f"every lane up ({len(lanes)}; down: {down})")
        check_lane_launches(lanes, "replica")
        require(journal.last_seq + 1 == -(-len(idx) // BATCH),
                f"one journal record a batch ({n_records})")
        # the lanes' kernels at the shapes this plane gives them: shard 0 of
        # the plane's snapshot (131,072 rows) on the card
        d = tempfile.mkdtemp(prefix="chip_smoke_replica_")
        try:
            svc.store.save(d)
            tcp_kernel_checks(d, main_svc, qidx, n_fallback, rows,
                              tag="replica")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        return svc
    except BaseException:
        svc.close()
        raise


def chaos_path(main_svc, idx, qidx, jdir: str, report: dict) -> None:
    """Phase 5d, the chaos plane: ``spawn_replicated(device="cuda",
    faults=...)``, ``connect_replicated(journal=...)`` and
    ``Supervisor(device="cuda")``.  Lane (0, 1) dies on its 20th ADD, lane
    (1, 0) (shard 1's primary) on its 2nd QUERY; the supervisor heals both
    on the card; then the two original survivors are stopped and the
    resynced lanes answer alone.  Every answer equals phase 2's."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.replica import (IngestJournal, Supervisor,
                                     connect_replicated, spawn_replicated)
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    from repro_torch.store import StoreConfig
    from repro_torch.transport import FaultEvent, FaultPlan
    ks = kernels()
    reg = obs_metrics.default()
    want = main_svc.query_sparse(qidx, top_k=TOP_K)
    c = main_svc.cfg
    store_cfg = StoreConfig(k=c.k, n_bands=c.n_bands,
                            rows_per_band=c.rows_per_band, b=c.b,
                            n_slots=c.n_slots, bucket_width=c.bucket_width)
    cfg = SearchConfig(device="cuda", transport="tcp",
                       n_shards=REPLICA_SHARDS, n_replicas=REPLICAS)
    faults = {(0, 1): FaultPlan([FaultEvent("kill", 19, "add")]),
              (1, 0): FaultPlan([FaultEvent("kill", 1, "query")])}
    journal = IngestJournal(os.path.join(jdir, "ingest.journal"))
    grid: list = []
    svc = sup = None
    counters = ("replica.failovers", "replica.recover_failures",
                "replica.read_failovers", "replica.write_leg_failures",
                "replica.lanes_down")
    c0 = {n: reg.counter(n).value for n in counters}
    h = reg.histogram("replica.resync")
    h0 = (h.count, h.sum)
    hs = {n: reg.histogram(n) for n in ("replica.respawn", "replica.replay")}
    hs0 = {n: hs[n].sum for n in hs}
    try:
        torch.cuda.synchronize()
        zero_counts(ks)
        # --- the chaos path: kills, heal, the resynced lanes alone -------
        t0 = time.perf_counter()
        grid = spawn_replicated(store_cfg, REPLICA_SHARDS, REPLICAS,
                                device="cuda", faults=faults)
        store = connect_replicated(grid, store_cfg, journal=journal,
                                   timeout=cfg.query_timeout_s,
                                   device="cuda")
        sup = Supervisor(store, device="cuda")
        svc = SimilaritySearchService(
            cfg, params=(main_svc.engine.sigma, main_svc.engine.pi),
            store=store, workers=[w for row in grid for w in row])
        spawn_s = time.perf_counter() - t0
        t_ingest = ingest(svc, idx, BATCH)
        lane01 = store.shards[0].lanes[1]
        require(not lane01.up and store._failed is None,
                f"lane (0, 1) died on its 20th ADD and the writes went on "
                f"at reduced redundancy (up {lane01.up}, "
                f"failed {store._failed})")
        lat_kill = tcp_query_batches(svc, qidx, 2, want)
        grid[1][0].join(10)
        require(not grid[1][0].alive,
                "lane (1, 0) died on its 2nd QUERY")
        t0 = time.perf_counter()
        sup.start()
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and not all(
                l.up for rs in store.shards for l in rs.lanes):
            time.sleep(0.2)
        heal_s = time.perf_counter() - t0
        require(all(l.up for rs in store.shards for l in rs.lanes),
                "the supervisor restored R = 2 on the card: "
                + str([(l.shard, l.replica, l.why_down)
                       for rs in store.shards for l in rs.lanes
                       if not l.up]))
        lat_healed = tcp_query_batches(svc, qidx, 2, want)
        sup.stop()
        respawned = [(l.shard, l.replica) for rs in store.shards
                     for l in rs.lanes if l.handle is not grid[l.shard]
                     [l.replica]]
        # the two original survivors' launches, read before they stop (the
        # killed lanes' launches died with them)
        survivors = [ln for ln in lane_stats(store)
                     if (ln["shard"], ln["replica"]) not in respawned]
        for s, r in ((0, 0), (1, 1)):       # the two original survivors
            grid[s][r].terminate()
        lat_alone = tcp_query_batches(svc, qidx, 2, want)
        coordinator = read_counts(ks)
        alone = lane_stats(store)
        # -------------------------------------------------------------------
        d = {n: reg.counter(n).value - c0[n] for n in counters}
        n_resync = h.count - h0[0]
        resync_sum = h.sum - h0[1]
        each = [h.vmin, h.vmax] if h0[0] == 0 and n_resync == 2 else None
        split = {n: hs[n].sum - hs0[n] for n in hs}
        replayed = sum(store._gid_len[s] for s, _ in respawned)
        counted = survivors + alone
        mine = [ln for ln in alone
                if (ln["shard"], ln["replica"]) in respawned]
        rows = {
            "faults": {"(0, 1)": "kill on its 20th ADD",
                       "(1, 0)": "kill on its 2nd QUERY"},
            "spawn_s": spawn_s, "ingest_s": t_ingest,
            "ingest_docs_per_s": len(idx) / t_ingest,
            "query_latency_s_during_kill": lat_kill, "heal_s": heal_s,
            "query_latency_s_healed": lat_healed,
            "query_latency_s_resynced_alone": lat_alone,
            "respawned": [list(x) for x in respawned],
            "resync_count": n_resync, "resync_s_sum": resync_sum,
            "resync_s_each": each, "rows_replayed": replayed,
            "respawn_s_sum": split["replica.respawn"],
            "replay_s_sum": split["replica.replay"],
            "replayed_rows_per_s": replayed / split["replica.replay"],
            "rows_per_resync_s": replayed / resync_sum,
            "counters": d, "respawned_lanes": mine,
            "lanes_survivors": survivors, "lanes_alone": alone,
            "launches": plane_launches(coordinator, counted),
            "launches_coordinator": coordinator}
        report["chaos_path"] = rows
        print(f"[chaos] plane up in {spawn_s:.3f} s; ingest {len(idx)} docs "
              f"in {t_ingest:.3f} s with lane (0, 1) killed on its 20th ADD "
              f"(writes went on at reduced redundancy); 2 batches with lane "
              f"(1, 0) killed on its 2nd QUERY: "
              + ", ".join(f"{t * 1e3:.3f}" for t in lat_kill)
              + " ms, answers equal phase 2's")
        print(f"[chaos] healed in {heal_s:.3f} s: {n_resync} resyncs, "
              + (f"{each[0]:.3f} and {each[1]:.3f} s"
                 if each else f"{resync_sum:.3f} s in all")
              + f" (respawn {split['replica.respawn']:.3f} s, replay "
              f"{split['replica.replay']:.3f} s, the rest verify and "
              f"rejoin), {replayed} rows replayed "
              f"({rows['replayed_rows_per_s']:.0f} rows a replay second, "
              f"{rows['rows_per_resync_s']:.0f} a resync second); counters "
              f"{d}; respawned "
              + "; ".join(f"({ln['shard']},{ln['replica']}) on "
                          f"{ln['device']} holding {ln['device_bytes']} B"
                          for ln in mine))
        print("[chaos] healed batches "
              + ", ".join(f"{t * 1e3:.3f}" for t in lat_healed)
              + " ms; the resynced lanes alone "
              + ", ".join(f"{t * 1e3:.3f}" for t in lat_alone)
              + " ms; answers equal phase 2's")
        print(f"[chaos] launches: coordinator {coordinator}; survivors and "
              f"resynced lanes "
              + "; ".join(f"({ln['shard']},{ln['replica']}) "
                          f"{ln['launches']} for {ln['handled']}"
                          for ln in counted))
        require(sorted(respawned) == [(0, 1), (1, 0)],
                f"the killed lanes were respawned ({respawned})")
        require(d["replica.failovers"] >= 2
                and d["replica.recover_failures"] == 0,
                f"two resyncs and no failed recovery ({d})")
        require(sorted((ln["shard"], ln["replica"]) for ln in alone)
                == [(0, 1), (1, 0)],
                f"the resynced lanes carry their shards alone "
                f"({[(ln['shard'], ln['replica']) for ln in alone]})")
        require(all(ln["size"] == store._gid_len[ln["shard"]]
                    for ln in alone),
                "each resynced lane holds its shard's rows")
        require(sorted((ln["shard"], ln["replica"]) for ln in survivors)
                == [(0, 0), (1, 1)],
                f"the survivors' launches read before they stop "
                f"({[(ln['shard'], ln['replica']) for ln in survivors]})")
        check_lane_launches(counted, "chaos")
    finally:
        if sup is not None:
            sup.stop()
        if svc is not None:
            svc.close()
        for row in grid:
            for w in row:
                w.terminate()
        journal.close()


def stream_once(svc, qidx, want, seed: int, tag: str) -> dict:
    """1088 single queries with Poisson gaps at ``STREAM_QPS`` through
    ``svc.stream(max_batch=256, max_delay_ms=2.0, depth=2)``; every ticket
    held equal to phase 2's row.  Launches counted on the coordinator
    (set to 0 just before, read just after)."""
    from repro_torch.obs import metrics as obs_metrics
    ks = kernels()
    signed = obs_metrics.default().counter("engine.sign.rows")
    gaps = np.random.default_rng(seed).exponential(1.0 / STREAM_QPS,
                                                   len(qidx))
    torch.cuda.synchronize()
    s0 = signed.value
    zero_counts(ks)
    # --- the stream: single queries in -----------------------------------
    with svc.stream(max_batch=256, max_delay_ms=2.0, depth=2) as st:
        t0 = time.perf_counter()
        tickets = []
        for i, row in enumerate(qidx):
            target = t0 + gaps[: i + 1].sum()
            while (left := target - time.perf_counter()) > 0:
                time.sleep(min(left, 1e-3))
            tickets.append(st.submit_sparse(row, top_k=TOP_K))
        for t in tickets:
            t.result(timeout=120)
        wall = time.perf_counter() - t0
    launches = read_counts(ks)
    # -------------------------------------------------------------------
    for i, t in enumerate(tickets):
        ids, scores = t.result(0)
        require(np.array_equal(ids, want[0][i])
                and np.array_equal(scores, want[1][i]),
                f"{tag}: streamed ticket {i} answers as phase 2's row")
    lat = np.sort([t.latency_s for t in tickets])
    n = st.n_batches
    rows = {"queries": len(qidx), "qps_offered": STREAM_QPS,
            "qps_served": len(qidx) / wall, "batches": n,
            "mean_batch": len(qidx) / n,
            "docs_signed": signed.value - s0,
            "latency_s_p50": float(np.quantile(lat, 0.50)),
            "latency_s_p99": float(np.quantile(lat, 0.99)),
            "latency_s_max": float(lat[-1]), "launches": launches}
    print(f"[stream] {tag}: {len(qidx)} single queries at "
          f"{STREAM_QPS:.0f}/s offered, {len(qidx) / wall:.0f}/s served, "
          f"in {n} batches (mean {len(qidx) / n:.1f} rows), "
          f"{rows['docs_signed']} docs signed (pow2 padding included); "
          f"ticket latency p50 {rows['latency_s_p50'] * 1e3:.3f} ms, p99 "
          f"{rows['latency_s_p99'] * 1e3:.3f} ms; every ticket equals "
          f"phase 2's row; launches {launches}")
    require(launches["cminhash_sparse"] == n and launches["fold"] == n,
            f"{tag}: one sparse-kernel launch and one fold a batch "
            f"({launches['cminhash_sparse']} and {launches['fold']} for {n} "
            f"batches)")
    return rows


def stream_kernel_checks(svc, qidx, report: dict) -> list[dict]:
    """Phase 5e: the kernels at one stream-sized batch, against their plain
    versions, timed and bounded as in phase 3.  Seven single queries (the
    last three indexed rows and the first four fresh ones), padded to eight
    by repeating the first as the coalescer pads them, are signed and folded
    as the coordinator does, probed over phase 2's in-process shard; the
    rows the probe finds no candidate for are scored as its fallback."""
    from repro_torch.core.permutations import apply_permutation_sparse
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.kernels import query_fused as kq
    dev, cfg = svc.engine.device, svc.cfg
    store = svc.store.shards[0].store
    pi, k = svc.engine.pi, cfg.k
    rows = qidx[N_QUERY_INDEXED - 3: N_QUERY_INDEXED + 4]
    rows = np.concatenate([rows, rows[:1]])
    extra = {"stream_rows": 7, "padded_to": len(rows)}
    out = []
    sidx = apply_permutation_sparse(torch.tensor(rows, device=dev),
                                    svc.engine.sigma).to(torch.int32)
    sidx = sidx.contiguous()
    got = ks.cminhash_sparse_kernel(sidx, pi, k, pack_b=cfg.b)
    want = ks.cminhash_sparse_plain(sidx, pi, k, pack_b=cfg.b)
    require(torch.equal(got, svc.engine.sign(rows, layout="sparse",
                                             pack_b=cfg.b)),
            "stream batch: the kernel's words are the service's signing")
    ms, dev_ms = both_ms(lambda: ks.cminhash_sparse_kernel(
        sidx, pi, k, pack_b=cfg.b), 50)
    plain_ms = time_ms(lambda: ks.cminhash_sparse_plain(sidx, pi, k,
                                                        pack_b=cfg.b), 10)
    print(f"[stream] the kernels at one stream batch ({len(rows)} rows, 7 "
          f"queries), against their plain versions:")
    out.append(kernel_entry(
        "cminhash_sparse", "src/repro_torch/csrc/cminhash_sparse.cu",
        "src/repro/kernels/cminhash_sparse.py:186", got, want, ms, plain_ms,
        sidx.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
        int((sidx >= 0).sum().item()) * k, dev_ms,
        {"shape": list(sidx.shape), **extra}))
    qwords = got
    frows = kq.words_to_rows(qwords, cfg.n_bands).contiguous()
    folded = kq.fold_rows_kernel(frows)
    ms, dev_ms = both_ms(lambda: kq.fold_rows_kernel(frows), 50)
    plain_ms = time_ms(lambda: kq.fold_rows_plain(frows), 10)
    out.append(kernel_entry(
        "fold", "src/repro_torch/csrc/fold.cu",
        "src/repro/kernels/query_fused.py:164", folded,
        kq.fold_rows_plain(frows), ms, plain_ms,
        frows.numel() * 4 + folded.numel() * 8, frows.numel() * 5, dev_ms,
        {"shape": list(frows.shape), **extra}))
    table = store.table
    row, cands = probe_entry(table.device_records(), folded, table.n_slots,
                             table.max_probes, extra)
    out.append(row)
    has_any = (cands.view(len(rows), -1) >= 0).any(1).cpu().numpy()
    em = np.flatnonzero(~has_any)
    require(len(em) > 0, "stream batch: some rows take the fallback")
    out.append(collision_entry(qwords[torch.from_numpy(em).to(dev)],
                               len(em), store.buffer.device_words(), k,
                               cfg.b, {"fallback_rows": len(em),
                                       **extra})[0])
    report["kernels"] = out
    return out


def stream_path(main_svc, rsvc, qidx, seed: int, report: dict) -> None:
    """Phase 5e: the streaming front end over phase 2's in-process service,
    then over phase 5d's healthy replicated plane."""
    want = main_svc.query_sparse(qidx, top_k=TOP_K)
    inproc = stream_once(main_svc, qidx, want, seed, "in-process")
    n = inproc["batches"]
    require(inproc["launches"]["lsh_probe"] == n
            and 0 < inproc["launches"]["collision"] <= n,
            f"in-process: the shard launches the probe once a batch and "
            f"the collision kernel for the batches with fallback rows "
            f"({inproc['launches']})")
    before = {(ln["shard"], ln["replica"]): ln for ln in
              lane_stats(rsvc.store)}
    replicated = stream_once(rsvc, qidx, want, seed, "replicated")
    after = lane_stats(rsvc.store)
    delta = [{**ln, "launches": {k: v - before[(ln["shard"], ln["replica"])]
                                 ["launches"][k]
                                 for k, v in ln["launches"].items()},
              "handled": {k: v - before[(ln["shard"], ln["replica"])]
                          ["handled"][k] for k, v in ln["handled"].items()}}
             for ln in after]
    require(replicated["launches"]["lsh_probe"] == 0
            and replicated["launches"]["collision"] == 0,
            "replicated: the coordinator launches no probe or collision "
            "kernel")
    check_lane_launches(delta, "replicated stream")
    replicated["lanes"] = delta
    replicated["launches"] = plane_launches(replicated["launches"], delta)
    report["stream_path"] = {"in_process": inproc, "replicated": replicated,
                             "launches": {
                                 k: inproc["launches"][k]
                                 + replicated["launches"][k]
                                 for k in inproc["launches"]}}
    stream_kernel_checks(main_svc, qidx, report["stream_path"])


def dense_path(idx, fresh_idx, report: dict):
    """Phase 6: dense rows through the service a user calls, counted."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    ks = kernels()
    n = min(N_DENSE, len(idx))
    t0 = time.perf_counter()
    batches = [dense_rows(idx[lo: lo + BATCH]) for lo in range(0, n, BATCH)]
    qidx = np.concatenate([idx[:N_QUERY_INDEXED], fresh_idx])
    qv = dense_rows(qidx)
    build_s = time.perf_counter() - t0
    svc = SimilaritySearchService(SearchConfig(device="cuda"))
    zero_counts(ks)
    # --- the dense path: ingest + query batches ----------------------------
    t0 = time.perf_counter()
    with svc.pipeline(depth=2, layout="dense") as pipe:
        for v in batches:
            pipe.submit(v)
    t_ingest = time.perf_counter() - t0
    split = pipe.timings
    after_ingest = read_counts(ks)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        ids, scores = svc.query_dense(qv, top_k=TOP_K)
        lat.append(time.perf_counter() - t0)
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    store = svc.store.shards[0].store
    words = store.buffer.device_words()
    for lo in range(0, n, BATCH):
        sparse = svc.engine.sign(idx[lo: lo + BATCH], layout="sparse",
                                 pack_b=svc.cfg.b)
        require(torch.equal(words[lo: lo + BATCH], sparse),
                f"dense words of documents {lo}..{lo + BATCH} equal the "
                "sparse signing")
    sids, sscores = svc.query_sparse(qidx, top_k=TOP_K)
    require(np.array_equal(ids, sids) and np.array_equal(scores, sscores),
            "query_dense answers as query_sparse of the same documents")
    self_hit = float((ids[:N_QUERY_INDEXED, 0]
                      == np.arange(N_QUERY_INDEXED)).mean())
    n_fallback = svc.store.last_timings["n_fallback"]
    report["dense_path"] = {
        "docs": n, "batches": len(batches), "rows_bytes_per_batch":
        batches[0].nbytes, "host_rows_build_s": build_s,
        "ingest_s": t_ingest, "ingest_docs_per_s": n / t_ingest,
        "ingest_split_s": split, "query_rows": len(qv),
        "query_latency_s_first": lat[0],
        "query_latency_s_median_next4": statistics.median(lat[1:]),
        "query_latency_s_all": lat, "top1_self_hit": self_hit,
        "fallback_rows": n_fallback, "launches": launches,
        "launches_ingest": after_ingest, "words_equal_sparse": True,
        "answers_equal_sparse": True}
    print(f"[dense] ingest {n} docs as {len(batches)} batches of "
          f"{BATCH} x {batches[0].shape[1]} int8 rows in {t_ingest:.3f} s "
          f"({n / t_ingest:.0f} docs/s; rows built on the host in "
          f"{build_s:.2f} s beforehand); sign (copy in, permute, pack, "
          f"launch) {split['sign_s']:.3f} s, wait {split['wait_s']:.3f} s, "
          f"scatter {split['scatter_s']:.3f} s")
    print(f"[dense] query batch of {len(qv)} dense rows: first "
          f"{lat[0] * 1e3:.3f} ms, median of next 4 "
          f"{statistics.median(lat[1:]) * 1e3:.3f} ms; top-1 self-hit "
          f"{self_hit * 100:.2f}%; fallback rows {n_fallback}")
    print(f"[dense] launches {launches}; words of all {n} documents equal "
          "the sparse signing; query_dense == query_sparse")
    require(ids.shape == (len(qv), TOP_K), "dense answer shape")
    require(bool(np.isfinite(scores).all()), "finite dense scores")
    require(self_hit == 1.0, f"dense top-1 self-hit {self_hit}")
    trace_query(svc, qv, report, layout="dense")
    require(after_ingest["cminhash_packed"] == len(batches)
            and launches["cminhash_packed"] == len(batches) + len(lat),
            f"bit-packed kernel launched once per ingest and query batch "
            f"({launches['cminhash_packed']} for {len(batches)} + "
            f"{len(lat)})")
    require(launches["collision"] == len(lat) * len(svc.store.shards),
            f"collision kernel launched once per brute-force fallback call "
            f"({launches['collision']} for {len(lat)} query batches)")
    for name in ("cminhash_packed", "fold", "lsh_probe"):
        require(launches[name] > 0,
                f"kernel {name} launched on the dense path")
    return svc, batches[0]


def paper_path(report: dict) -> dict:
    """Phase 7: Fig. 7 on the card, counted.  Returns the corpora."""
    from repro_torch.core.estimators import true_jaccard_dense
    from repro_torch.core.minhash import make_k_permutations, minhash_dense
    from repro_torch.core.permutations import make_two_permutations
    from repro_torch.data.synthetic import (imagelike_binary_dataset,
                                            textlike_binary_dataset)
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False   # exact integer counts
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ks = kernels()
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    corpora = {
        "textA": textlike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                         mean_nnz=80),
        "textB": textlike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                         mean_nnz=250),
        "imageA": imagelike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                           block=16),
        "imageB": imagelike_binary_dataset(rng, PAPER_DOCS, PAPER_D,
                                           block=64, p_on=0.5)}
    data_s = time.perf_counter() - t0
    iu = torch.triu_indices(PAPER_DOCS, PAPER_DOCS, 1, device=dev)
    rows = []
    zero_counts(ks)
    # --- the paper path ----------------------------------------------------
    t0 = time.perf_counter()
    for name, data in corpora.items():
        v = torch.from_numpy(data).to(dev)
        vf = v.float()
        inter = vf @ vf.T                      # exact: counts < 2^24
        cnt = vf.sum(dim=1)
        union = cnt[:, None] + cnt[None, :] - inter
        truth = torch.where(union > 0, inter / union.clamp(min=1),
                            torch.zeros_like(union))
        for k in PAPER_KS:
            gen = torch.Generator().manual_seed(k)
            sigma, pi = make_two_permutations(gen, PAPER_D, device=dev)
            perms = make_k_permutations(gen, PAPER_D, k, device=dev)
            sigs = {"MH": minhash_dense(v, perms),
                    "C0pi": ops.cminhash_signatures(v, pi, k),
                    "Csigmapi": ops.cminhash_signatures(v, pi, k, sigma)}
            row = {"corpus": name, "k": k}
            for method, sig in sigs.items():
                est = ops.estimated_jaccard_matrix(sig, sig)
                err = (est - truth)[iu[0], iu[1]].abs().double()
                row[method] = float(err.mean())
                require(bool(torch.isfinite(est).all())
                        and 0.0 <= row[method] <= 1.0,
                        f"paper {name} K={k} {method} estimates")
            row["win_pct"] = (row["MH"] - row["Csigmapi"]) / row["MH"] * 100
            rows.append(row)
            print(f"[paper] fig7_mae_{name}_K{k}: MH={row['MH']:.4f} "
                  f"C0pi={row['C0pi']:.4f} Csigmapi={row['Csigmapi']:.4f} "
                  f"win={row['win_pct']:.1f}%")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(ks)
    # -----------------------------------------------------------------------
    n_sign = len(corpora) * len(PAPER_KS) * 2
    report["paper_path"] = {
        "d": PAPER_D, "docs": PAPER_DOCS, "ks": list(PAPER_KS),
        "data_s": data_s, "wall_s": wall, "rows": rows,
        "nnz_mean": {n: float(c.sum(1).mean()) for n, c in corpora.items()},
        "launches": launches}
    print(f"[paper] {len(rows)} (corpus, K) cells in {wall:.3f} s "
          f"(corpora built in {data_s:.1f} s); launches {launches}")
    require(launches["cminhash_dense"] == n_sign,
            f"int8 kernel launched for every C-MinHash set "
            f"({launches['cminhash_dense']} of {n_sign})")
    require(launches["collision"] == 3 * len(rows),
            "collision kernel launched for every method")
    return corpora


def dense_kernel_checks(svc, batch: np.ndarray, corpora: dict,
                        report: dict) -> tuple[list, list]:
    """Phase 8: the two dense kernels against their plain versions.
    Returns the kernels line's rows (the int8 kernel at the paper's shape,
    the bit-packed one at the service's) and the rows of the other two
    shapes."""
    from repro_torch.core.permutations import (apply_permutation_dense,
                                               make_two_permutations)
    from repro_torch.kernels import cminhash_kernel as kd
    from repro_torch.kernels import cminhash_packed as kpk
    from repro_torch.kernels import collision_kernel as kc
    dev = svc.engine.device
    out = []
    sources = {"cminhash_dense": ("src/repro_torch/csrc/cminhash_dense.cu",
                                  "src/repro/kernels/cminhash_kernel.py:77"),
               "cminhash_packed": ("src/repro_torch/csrc/cminhash_packed.cu",
                                   "src/repro/kernels/cminhash_packed.py:95")}

    def dense_int8(v, pi, k, pack_b, reps, plain_reps):
        got = kd.cminhash_dense_kernel(v, pi, k, pack_b=pack_b)
        want = kd.cminhash_dense_plain(v, pi, k, pack_b=pack_b)
        ms, dev_ms = both_ms(lambda: kd.cminhash_dense_kernel(
            v, pi, k, pack_b=pack_b), reps)
        plain_ms = time_ms(lambda: kd.cminhash_dense_plain(
            v, pi, k, pack_b=pack_b), plain_reps, warmup=1)
        b, d = v.shape
        nnz = int((v > 0).sum().item())
        # the function's work, as the bit-packed kernel is bounded: read
        # each byte once, one min per set bit per hash; the dense
        # algorithm's B*K*D masked mins are its own cost, kept beside it
        return kernel_entry(
            "cminhash_dense", *sources["cminhash_dense"], got, want, ms,
            plain_ms, b * d + d * 4 + got.numel() * 4, nnz * k + b * d,
            dev_ms, {"shape": [b, d, k], "pack_b": pack_b, "set_bits": nnz,
             "dense_algorithm_ops": b * k * d})

    def packed(v, pi, k, pack_b, reps, plain_reps):
        words = kpk.pack_bits(v)
        got = kpk.cminhash_packed_kernel(words, pi, k, pack_b=pack_b)
        want = kpk.cminhash_packed_plain(words, pi, k, pack_b=pack_b)
        ms, dev_ms = both_ms(lambda: kpk.cminhash_packed_kernel(
            words, pi, k, pack_b=pack_b), reps)
        plain_ms = time_ms(lambda: kpk.cminhash_packed_plain(
            words, pi, k, pack_b=pack_b), plain_reps, warmup=1)
        pack_ms = time_ms(lambda: kpk.pack_bits(v), reps)
        b, nw = words.shape
        nnz = int((v > 0).sum().item())
        return kernel_entry(
            "cminhash_packed", *sources["cminhash_packed"], got, want, ms,
            plain_ms, words.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
            nnz * k + b * nw, dev_ms,
            {"shape": [b, v.shape[1], k], "pack_b": pack_b,
             "set_bits": nnz, "pack_bits_ms": pack_ms})

    # the paper's shape: the image-like corpus with the permutations the
    # paper path drew for it, sigma applied as dispatch does
    kp = PAPER_KS[-1]
    sigma_p, pi_p = make_two_permutations(torch.Generator().manual_seed(kp),
                                          PAPER_D, device=dev)
    vp = apply_permutation_dense(torch.from_numpy(corpora["imageA"]).to(dev),
                                 sigma_p)
    out.append(dense_int8(vp, pi_p, kp, None, 20, 3))
    # the service's shape: the dense path's first batch, sigma-permuted
    cfg = svc.cfg
    vs = apply_permutation_dense(torch.from_numpy(batch).to(dev),
                                 svc.engine.sigma)
    out.append(packed(vs, svc.engine.pi, cfg.k, cfg.b, 20, 3))
    extra = [dense_int8(vs, svc.engine.pi, cfg.k, cfg.b, 5, 2),
             packed(vp, pi_p, kp, None, 20, 3)]
    # the int8 kernel at each of Fig. 7's K on imageA, with the permutations
    # phase 7 drew for that K: phase 7 launches it 8 times at each K (four
    # corpora x two C-MinHash variants), so the launch-weighted sum stands in
    # imageA's time for every corpus
    imagea = torch.from_numpy(corpora["imageA"]).to(dev)
    sweep, fig7_collision = [], []
    for k in PAPER_KS:
        sigma_k, pi_k = make_two_permutations(
            torch.Generator().manual_seed(k), PAPER_D, device=dev)
        vk = apply_permutation_dense(imagea, sigma_k)
        sig = kd.cminhash_dense_kernel(vk, pi_k, k)
        require(torch.equal(sig, kd.cminhash_dense_plain(vk, pi_k, k)),
                f"cminhash_dense imageA K={k}")
        ms, dev_ms = both_ms(lambda: kd.cminhash_dense_kernel(vk, pi_k, k), 20)
        sweep.append({"k": k, "launches_in_phase_7": 2 * len(corpora),
                      "ms": ms, "device_ms": dev_ms})
        # the collision kernel at Fig. 7's 4096 x 4096 x K, on these codes
        counts = kc.collision_counts_kernel(sig, sig)
        require(torch.equal(counts, kc.collision_counts_plain(sig, sig)),
                f"collision imageA 4096 x 4096 x {k}")
        sd = sig.double()
        require(torch.equal((k - torch.cdist(sd, sd, p=0)).to(torch.int32),
                            counts), f"collision K - cdist(p=0), K={k}")
        c_ms, c_dev_ms = both_ms(lambda: kc.collision_counts_kernel(sig, sig),
                                 10)
        n = sig.shape[0]
        fig7_collision.append({
            "k": k, "shape": [n, n, k],
            "launches_in_phase_7": 3 * len(corpora), "ms": c_ms,
            "device_ms": c_dev_ms,
            "plain_ms": time_ms(lambda: kc.collision_counts_plain(sig, sig),
                                1, warmup=1),
            "library_ms": time_ms(lambda: k - torch.cdist(sd, sd, p=0), 3,
                                  warmup=1),
            "bound_ms": bound_ms(2 * n * k * 4 + n * n * 4,
                                 collision_ops(n, n, k, 32))[0]})
    weighted = {key: sum(r[key] * r["launches_in_phase_7"] for r in sweep)
                for key in ("ms", "device_ms")}
    report["fig7_int8_sweep"] = {"rows": sweep,
                                 "launch_weighted_ms": weighted["ms"],
                                 "launch_weighted_device_ms":
                                 weighted["device_ms"]}
    print("[kernel] cminhash_dense on imageA at Fig. 7's K: "
          + ", ".join(f"K={r['k']} {r['ms']:.4f} ms (device "
                      f"{r['device_ms']:.4f})" for r in sweep)
          + f"; summed over phase 7's "
          f"{sum(r['launches_in_phase_7'] for r in sweep)} launches "
          f"{weighted['ms']:.4f} ms (device {weighted['device_ms']:.4f})")
    weighted = {key: sum(r[key] * r["launches_in_phase_7"]
                         for r in fig7_collision)
                for key in ("ms", "device_ms")}
    report["fig7_collision"] = {"rows": fig7_collision,
                                "launch_weighted_ms": weighted["ms"],
                                "launch_weighted_device_ms":
                                weighted["device_ms"]}
    print("[kernel] collision at Fig. 7's 4096 x 4096 x K: "
          + ", ".join(f"K={r['k']} {r['ms']:.4f} ms (device "
                      f"{r['device_ms']:.4f}, bound {r['bound_ms']:.4f}, "
                      f"plain {r['plain_ms']:.4f}, library "
                      f"{r['library_ms']:.4f})" for r in fig7_collision)
          + f"; summed over phase 7's "
          f"{sum(r['launches_in_phase_7'] for r in fig7_collision)} launches "
          f"{weighted['ms']:.4f} ms (device {weighted['device_ms']:.4f})")
    words = kpk.pack_bits(vs[:512])
    for pack_b in (None, 1, 2, 4, 8, 16):      # the other epilogues
        require(torch.equal(
            kd.cminhash_dense_kernel(vp[:512], pi_p, kp, pack_b=pack_b),
            kd.cminhash_dense_plain(vp[:512], pi_p, kp, pack_b=pack_b)),
            f"cminhash_dense pack_b={pack_b}")
        require(torch.equal(
            kpk.cminhash_packed_kernel(words, svc.engine.pi, cfg.k,
                                       pack_b=pack_b),
            kpk.cminhash_packed_plain(words, svc.engine.pi, cfg.k,
                                      pack_b=pack_b)),
            f"cminhash_packed pack_b={pack_b}")
    require(torch.equal(
        kd.cminhash_dense_kernel(vp[:256], pi_p, kp, shift_offset=0),
        kd.cminhash_dense_plain(vp[:256], pi_p, kp, shift_offset=0)),
        "cminhash_dense shift_offset=0")
    require(torch.equal(
        kpk.cminhash_packed_kernel(words, svc.engine.pi, cfg.k,
                                   shift_offset=0),
        kpk.cminhash_packed_plain(words, svc.engine.pi, cfg.k,
                                  shift_offset=0)),
        "cminhash_packed shift_offset=0")
    return out, extra


def dense_card_vs_cpu(idx, fresh_idx, report: dict) -> None:
    """Phase 9: a 512-document dense subset on the card and on the CPU."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    v = dense_rows(idx[:512])
    q = np.concatenate([v[:128], dense_rows(fresh_idx)])
    answers = []
    for device in ("cuda", "cpu"):
        svc = SimilaritySearchService(SearchConfig(device=device))
        with svc.pipeline(depth=2, layout="dense") as pipe:
            for lo in range(0, len(v), 128):
                pipe.submit(v[lo: lo + 128])
        answers.append(svc.query_dense(q, top_k=TOP_K))
    (ci, cs), (pi_, ps) = answers
    require(np.array_equal(ci, pi_) and np.array_equal(cs, ps),
            "card and CPU dense answers differ on the 512-document subset")
    report["dense_card_vs_cpu"] = {"docs": len(v), "query_rows": len(q),
                                   "identical": True}
    print(f"[dense-card-vs-cpu] {len(v)} docs, {len(q)} dense queries: ids "
          "and scores identical")


DEDUP_CHECK_DOCS = 16_384     # the card against the CPU
DEDUP_PLAIN_ROWS = 8_192      # the plain version's row chunk


def dedup_path(docs, labels, idx, report: dict) -> None:
    """Phase 10: ``dedup_corpus`` on the card over the main path's
    documents at ``DedupConfig``'s defaults, counted: one launch of the
    sparse signing kernel and no other.  Pair precision and recall against
    the planted clusters; the card against the CPU on the first
    ``DEDUP_CHECK_DOCS`` documents; the kernel's output at that launch
    against its plain version, timed and bounded as in phase 3."""
    from repro_torch.core.permutations import (apply_permutation_sparse,
                                               make_two_permutations)
    from repro_torch.data.dedup import (STAGES, DedupConfig, dedup_corpus,
                                        dedup_metrics)
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.obs import metrics as obs_metrics
    ks_all = kernels()
    cfg = DedupConfig()
    dev = torch.device("cuda")
    sigma, pi = make_two_permutations(torch.Generator().manual_seed(cfg.seed),
                                      cfg.d, device=dev)
    reg = obs_metrics.default()
    before = {s: reg.histogram(f"dedup.{s}").sum for s in STAGES}
    torch.cuda.synchronize()
    zero_counts(ks_all)
    # --- the dedup path ----------------------------------------------------
    t0 = time.perf_counter()
    res = dedup_corpus(docs, cfg, device="cuda", params=(sigma, pi))
    wall = time.perf_counter() - t0
    launches = read_counts(ks_all)
    # -----------------------------------------------------------------------
    stages = {s: reg.histogram(f"dedup.{s}").sum - before[s] for s in STAGES}
    m = dedup_metrics(res, labels)
    n = len(docs)
    print(f"[dedup] {n} docs (D = 2^{cfg.d.bit_length() - 1}, K = {cfg.k}, "
          f"{cfg.n_bands} x {cfg.rows_per_band} bands, threshold "
          f"{cfg.threshold}) in {wall:.3f} s ({n / wall:.0f} docs/s); "
          + ", ".join(f"{s} {v:.3f}" for s, v in stages.items()) + " s")
    print(f"[dedup] {res.n_candidates} candidate pairs, {res.n_verified} "
          f"verified; kept {m['kept']}/{m['total']}; pair precision "
          f"{m['precision']:.4f}, recall {m['recall']:.4f} (tp {m['tp']}, "
          f"fp {m['fp']}, fn {m['fn']}); launches {launches}")
    require(res.signatures.shape == (n, cfg.k)
            and res.cluster_of.shape == (n,), "dedup result shapes")
    require(launches["cminhash_sparse"] == 1
            and sum(launches.values()) == 1,
            f"dedup launched the sparse signing kernel once and no other "
            f"kernel ({launches})")
    require(m["precision"] > 0.95 and m["recall"] > 0.9,
            f"dedup precision {m['precision']} > 0.95, recall "
            f"{m['recall']} > 0.9")

    # the card against the CPU on the first documents
    t0 = time.perf_counter()
    sub = docs[:DEDUP_CHECK_DOCS]
    card = dedup_corpus(sub, cfg, device="cuda", params=(sigma, pi))
    cpu = dedup_corpus(sub, cfg, device="cpu",
                       params=(sigma.cpu(), pi.cpu()))
    for field in dataclasses.fields(card):
        a, b = getattr(card, field.name), getattr(cpu, field.name)
        require(type(a) is type(b) and np.array_equal(a, b),
                f"dedup on the card == on the CPU, first {len(sub)} "
                f"documents: {field.name}")
    check_s = time.perf_counter() - t0
    print(f"[dedup] card == CPU on the first {len(sub)} documents, every "
          f"field ({card.n_candidates} candidates, {card.n_verified} "
          f"verified; {check_s:.1f} s)")

    # kernel 1 at the dedup launch: its output is the result's signatures
    sidx = apply_permutation_sparse(torch.from_numpy(idx).to(dev),
                                    sigma).to(torch.int32).contiguous()
    got = ks.cminhash_sparse_kernel(sidx, pi, cfg.k)
    require(np.array_equal(got.cpu().numpy(), res.signatures),
            "the kernel's output is the dedup launch's signatures")

    def plain():
        return torch.cat([ks.cminhash_sparse_plain(
            sidx[lo: lo + DEDUP_PLAIN_ROWS], pi, cfg.k)
            for lo in range(0, len(sidx), DEDUP_PLAIN_ROWS)])
    want = plain()
    ms, dev_ms = both_ms(lambda: ks.cminhash_sparse_kernel(sidx, pi, cfg.k),
                         10)
    plain_ms = time_ms(plain, 3, warmup=1)
    n_valid = int((sidx >= 0).sum().item())
    row = kernel_entry(
        "cminhash_sparse", "src/repro_torch/csrc/cminhash_sparse.cu",
        "src/repro/kernels/cminhash_sparse.py:186", got, want, ms, plain_ms,
        sidx.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
        n_valid * cfg.k, dev_ms, {"shape": list(sidx.shape), "pack_b": None,
                                  "plain_rows_a_call": DEDUP_PLAIN_ROWS})
    del sidx, got, want
    torch.cuda.empty_cache()
    report["dedup_path"] = {
        "docs": n, "config": dataclasses.asdict(cfg), "wall_s": wall,
        "docs_per_s": n / wall, "stages_s": stages,
        "n_candidates": res.n_candidates, "n_verified": res.n_verified,
        "metrics": m, "launches": launches,
        "card_vs_cpu": {"docs": len(sub), "identical": True,
                        "n_candidates": card.n_candidates,
                        "n_verified": card.n_verified, "seconds": check_s},
        "kernels": [row]}


LINEAR_D = 1 << 14
LINEAR_K = 512
LINEAR_TRAIN = 32_768
LINEAR_TEST = 8_192
LINEAR_CHECK_ROWS = 1_024     # the card's fit against the CPU's


def linear_path(report: dict) -> None:
    """Phase 11: the hashed-feature trainer at the paper's learning width.
    The classifier example's data (two 5%-density templates, 2% flips) at
    D = 2^14: 32,768 training and 8,192 test rows made on the card in
    4096-row batches, each signed at K = 512 through ``SketchEngine.
    signatures_dense`` (the bit-packed kernel), only the signatures kept;
    then ``fit_logistic`` (300 steps) for b in {1, 2, 4, 8}, counted.  Test
    accuracy > 0.95 at each b; the card's fit on the first 1,024 training
    rows against the CPU's within the CPU tests' tolerances; the bit-packed
    kernel against its plain version at one batch, timed and bounded as in
    phase 8."""
    from repro_torch.core.engine import SketchConfig, SketchEngine
    from repro_torch.core.linear_model import (HashedLinearConfig, accuracy,
                                               fit_logistic,
                                               predict_logistic)
    from repro_torch.core.permutations import apply_permutation_dense
    from repro_torch.kernels import cminhash_packed as kpk
    ks_all = kernels()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    templates = torch.from_numpy(np.stack(
        [rng.random(LINEAR_D) < 0.05, rng.random(LINEAR_D) < 0.05])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def batch(n: int) -> tuple[torch.Tensor, torch.Tensor]:
        y = torch.randint(0, 2, (n,), generator=gen, device=dev)
        flips = torch.rand((n, LINEAR_D), generator=gen, device=dev) < 0.02
        return (templates[y] ^ flips).to(torch.int8), y.to(torch.int32)

    engine = SketchEngine(SketchConfig(d=LINEAR_D, k=LINEAR_K), device=dev)
    torch.cuda.synchronize()
    zero_counts(ks_all)
    # --- the linear path: sign the batches, then the fits -------------------
    t0 = time.perf_counter()
    sigs, ys, first = [], [], None
    for _ in range((LINEAR_TRAIN + LINEAR_TEST) // BATCH):
        x, y = batch(BATCH)
        first = x if first is None else first
        sigs.append(engine.signatures_dense(x))
        ys.append(y)
    torch.cuda.synchronize()
    sign_s = time.perf_counter() - t0
    n_batches = len(sigs)
    sigs, ys = torch.cat(sigs), torch.cat(ys)
    s_tr, y_tr = sigs[:LINEAR_TRAIN], ys[:LINEAR_TRAIN]
    s_te, y_te = sigs[LINEAR_TRAIN:], ys[LINEAR_TRAIN:]
    fits = {}
    for b in (1, 2, 4, 8):
        cfg = HashedLinearConfig(b=b)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wb = fit_logistic(s_tr, y_tr, cfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        acc = accuracy(wb, s_te, y_te, b)
        fits[b] = {"fit_s": fit_s, "s_per_step": fit_s / cfg.steps,
                   "peak_bytes_over_signatures": peak,
                   "one_hot_bytes": LINEAR_TRAIN * (LINEAR_K << b) * 4,
                   "test_accuracy": acc}
    launches = read_counts(ks_all)
    # -----------------------------------------------------------------------
    print(f"[linear] {LINEAR_TRAIN} + {LINEAR_TEST} rows at D = 2^14 signed "
          f"at K = {LINEAR_K} in {n_batches} batches in {sign_s:.3f} s; "
          f"launches {launches}")
    for b, f in fits.items():
        print(f"[linear] b = {b}: {f['fit_s']:.3f} s for 300 steps "
              f"({f['s_per_step'] * 1e3:.3f} ms a step), peak "
              f"{f['peak_bytes_over_signatures'] / 2**20:.1f} MiB over the "
              f"signatures (one-hot matrix {f['one_hot_bytes'] / 2**30:.2f} "
              f"GiB), test accuracy {f['test_accuracy']:.4f}")
        require(f["test_accuracy"] > 0.95,
                f"trainer test accuracy at b = {b}: {f['test_accuracy']}")
    require(fits[8]["peak_bytes_over_signatures"]
            < fits[8]["one_hot_bytes"] / 8,
            "no one-hot matrix materialised at b = 8")
    require(launches["cminhash_packed"] == n_batches
            and sum(launches.values()) == n_batches,
            f"the bit-packed kernel launched once per batch and no other "
            f"kernel ({launches} for {n_batches} batches)")

    # the card's fit against the CPU's on the first training rows
    t0 = time.perf_counter()
    sc, yc = s_tr[:LINEAR_CHECK_ROWS], y_tr[:LINEAR_CHECK_ROWS]
    check = {}
    for b in (1, 2, 4, 8):
        cfg = HashedLinearConfig(b=b)
        wc, bc = fit_logistic(sc, yc, cfg)
        w, bias = fit_logistic(sc.cpu(), yc.cpu(), cfg)
        pc = predict_logistic((wc, bc), s_te, b).cpu()
        p = predict_logistic((w, bias), s_te.cpu(), b)
        ac = accuracy((wc, bc), s_te, y_te, b)
        a = accuracy((w, bias), s_te.cpu(), y_te.cpu(), b)
        check[b] = {"w_max_abs_err": float((wc.cpu() - w).abs().max()),
                    "bias_abs_err": abs(float(bc) - float(bias)),
                    "p_max_abs_err": float((pc - p).abs().max()),
                    "accuracy_card": ac, "accuracy_cpu": a}
        c = check[b]
        require(c["w_max_abs_err"] <= 1e-3 and c["bias_abs_err"] <= 1e-3
                and c["p_max_abs_err"] <= 1e-3 and ac == a,
                f"the card's fit within the tests' tolerances of the CPU's "
                f"at b = {b}: {c}")
    check_s = time.perf_counter() - t0
    print(f"[linear] card vs CPU fit on the first {LINEAR_CHECK_ROWS} rows: "
          + "; ".join(f"b = {b}: |dw| {c['w_max_abs_err']:.2e}, |dp| "
                      f"{c['p_max_abs_err']:.2e}, accuracy "
                      f"{c['accuracy_card']:.4f} both"
                      for b, c in check.items()) + f" ({check_s:.1f} s)")

    # kernel 6 at one batch of the path, sigma applied as dispatch does
    vs = apply_permutation_dense(first, engine.sigma)
    words = kpk.pack_bits(vs)
    got = kpk.cminhash_packed_kernel(words, engine.pi, LINEAR_K)
    require(torch.equal(got, sigs[:BATCH]),
            "the kernel's output is the path's first batch of signatures")
    want = kpk.cminhash_packed_plain(words, engine.pi, LINEAR_K)
    ms, dev_ms = both_ms(lambda: kpk.cminhash_packed_kernel(
        words, engine.pi, LINEAR_K), 20)
    plain_ms = time_ms(lambda: kpk.cminhash_packed_plain(
        words, engine.pi, LINEAR_K), 3, warmup=1)
    nnz = int((vs > 0).sum().item())
    row = kernel_entry(
        "cminhash_packed", "src/repro_torch/csrc/cminhash_packed.cu",
        "src/repro/kernels/cminhash_packed.py:95", got, want, ms, plain_ms,
        words.numel() * 4 + engine.pi.numel() * 4 + got.numel() * 4,
        nnz * LINEAR_K + words.numel(), dev_ms,
        {"shape": [BATCH, LINEAR_D, LINEAR_K], "set_bits": nnz,
         "pack_bits_ms": time_ms(lambda: kpk.pack_bits(vs), 20)})
    report["linear_path"] = {
        "d": LINEAR_D, "k": LINEAR_K, "train": LINEAR_TRAIN,
        "test": LINEAR_TEST, "batches": n_batches, "sign_s": sign_s,
        "fits": fits, "card_vs_cpu": {"rows": LINEAR_CHECK_ROWS,
                                      "by_b": check, "seconds": check_s},
        "launches": launches, "kernels": [row]}


LM_ARCH = "llama3_2_1b"
LM_BATCH = 8                  # requests
LM_PROMPT = 32                # tokens a prompt
LM_NEW = 32                   # greedy tokens a request
LM_CPU_ROWS = 2               # requests whose prefill the CPU repeats
LM_FAMILIES = ("falcon_mamba_7b", "hymba_1_5b", "qwen3_moe_30b_a3b",
               "pixtral_12b", "seamless_m4t_medium")
LM_CUT_LAYERS = 2             # the families' depth (encdec: each side)
LM_FAMILY_STEPS = 8           # teacher-forced decode steps a family
LM_TRACE_NEW = 8              # greedy tokens of the traced generate
LM_TOL = 1e-3                 # float32 decode against forward, and card
                              # against CPU: sums in other orders (observed
                              # <= 2e-5 on an H100)


def lm_batch(cfg, tokens: np.ndarray, seed: int) -> dict:
    """A prompt batch of ``cfg``'s family: the tokens, and the stub
    frontend's embeddings (patches: one per 8 prompt tokens; frames: one a
    prompt token) drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(b, s // 8, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "frames":
        batch["frames"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return batch


def timed_generate(bundle, params, batch: dict, n_new: int):
    """``serve.decode.generate``'s greedy loop with a CUDA event after the
    prefill's token and after each decode step's: (tokens (B, n_new),
    prefill ms, [ms of each decode step]).  The host enqueues ahead of the
    card, so an event pair spans what the card waited for the host too."""
    from repro_torch.serve.decode import sample_token
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_new + 1)]
    with torch.no_grad():
        events[0].record()
        logits, cache = bundle.prefill(params, batch, max_len=batch[
            "tokens"].shape[1] + n_new)
        toks = [sample_token(logits, None, 0.0)]
        events[1].record()
        for i in range(n_new - 1):
            logits, cache = bundle.decode_step(params, cache, toks[-1])
            toks.append(sample_token(logits, None, 0.0))
            events[i + 2].record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return torch.stack(toks, 1).cpu().numpy(), ms[0], ms[1:]


def teacher_forced(bundle, params, batch: dict, prompt_len: int,
                   seq: np.ndarray) -> tuple[float, torch.Tensor]:
    """The prefill of ``seq``'s first ``prompt_len`` tokens, then one
    decode step a later token of ``seq``, against ``forward`` over all of
    ``seq``: (the largest |logit difference|, the prefill's logits)."""
    full = bundle.forward(params, dict(batch, tokens=seq))
    first, cache = bundle.prefill(
        params, dict(batch, tokens=seq[:, :prompt_len]),
        max_len=seq.shape[1])
    err = max_abs_err(first, full[:, prompt_len - 1])
    for t in range(prompt_len, seq.shape[1]):
        logits, cache = bundle.decode_step(params, cache, seq[:, t])
        err = max(err, max_abs_err(logits, full[:, t]))
    del full, cache
    return err, first


def lm_path(seed: int, report: dict) -> None:
    """Phase 12: the LM serving path.  (a) ``llama3_2_1b`` at its full
    published config through ``models.build`` and ``serve.decode.generate``;
    (b) one config of each other family at full width, cut to
    ``LM_CUT_LAYERS`` layers; (c) the scan kernel alone (``ssm_scan_entry``).
    Counted: the path reaches no kernel but the scan, once a Mamba layer of
    each prompt."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models import build
    from repro_torch.serve.decode import generate
    # float32 products in full float32, not TF32, in every comparison here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ks_all = kernels()
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts(ks_all)
    # --- the LM path ---------------------------------------------------------
    cfg = get_config(LM_ARCH)
    bundle = build(cfg, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    require(n_params == cfg.param_count(),
            f"{LM_ARCH}: {n_params} parameters, config {cfg.param_count()}")
    batch = next(token_batches(cfg.vocab_size_real, LM_BATCH, LM_PROMPT,
                               seed))
    walls, runs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(generate(bundle, params, batch, max_new_tokens=LM_NEW))
        walls.append(time.perf_counter() - t0)
    toks = runs[0]
    require(toks.shape == (LM_BATCH, LM_NEW) and toks.dtype == np.int32,
            f"generate's tokens: {toks.shape} {toks.dtype}")
    require(0 <= toks.min() and toks.max() < cfg.vocab_size,
            "every token in [0, vocab_size)")
    require(np.array_equal(runs[0], runs[1]),
            "a second generate gives the first's tokens")
    timed, prefill_ms, step_ms = timed_generate(bundle, params, batch, LM_NEW)
    require(np.array_equal(timed, toks),
            "the timed loop gives generate's tokens")
    peak = torch.cuda.max_memory_allocated()
    # the card's busy share: a shorter generate, untraced then traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(bundle, params, batch, max_new_tokens=LM_TRACE_NEW)
    trace_wall_ms = (time.perf_counter() - t0) * 1e3
    trace = profile_busy(lambda: generate(
        bundle, params, batch, max_new_tokens=LM_TRACE_NEW), "lm_trace")
    busy_ms = trace["device_busy_us"] / 1e3
    decode_ms = statistics.median(step_ms)
    n_tok = LM_BATCH * LM_NEW
    # a decode step reads every float32 parameter and writes its bf16 copy
    bound = n_params * (4 + 2) / HBM_BYTES_PER_S * 1e3
    print(f"[lm] {LM_ARCH} (full config: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype} compute, "
          f"{cfg.param_dtype} parameters): {n_params} parameters, "
          f"{param_bytes} B, drawn in {init_s:.2f} s")
    print(f"[lm] {LM_BATCH} requests x {LM_PROMPT}-token prompts, {LM_NEW} "
          f"greedy tokens each: generate {walls[0]:.3f} s, {walls[1]:.3f} s "
          f"({n_tok / walls[1]:.1f} tokens/s); prefill {prefill_ms:.3f} ms, "
          f"decode {decode_ms:.3f} ms a token (median of {len(step_ms)} "
          f"steps; min {min(step_ms):.3f}, max {max(step_ms):.3f}); the "
          f"step's bound {bound:.3f} ms (read {n_params} float32 "
          f"parameters, write their bf16 copies, at 3.35 TB/s); peak "
          f"memory {peak} B; sample {toks[0][:8].tolist()}; {card_line()}")
    print(f"[lm] generate of {LM_TRACE_NEW} tokens: {trace_wall_ms:.3f} ms, "
          f"the card busy {busy_ms:.3f} ms of it "
          f"({busy_ms / trace_wall_ms * 100:.1f}%; traced wall "
          f"{trace['wall_us'] / 1e3:.3f} ms, {trace['device_events']} "
          f"device events); top: " + ", ".join(
              f"{r['name'][:40]} {r['us'] / 1e3:.3f} ms"
              for r in trace["top_device_time_us"][:4]))

    # float32 on the same weights, TF32 off: decode against forward, and the
    # card's prefill against the CPU's
    t0 = time.perf_counter()
    b32 = build(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    seq = np.concatenate([batch["tokens"], toks[:, :-1]], axis=1)
    tf_err, logits32 = teacher_forced(b32, params, batch, LM_PROMPT, seq)
    require(tf_err < LM_TOL, f"{LM_ARCH} float32: teacher-forced decode "
            f"within {LM_TOL} of forward ({tf_err})")
    cpu_params = copy.deepcopy(params).cpu()
    del params
    torch.cuda.empty_cache()
    rows = {"tokens": batch["tokens"][:LM_CPU_ROWS]}
    cpu_logits, _ = build(b32.cfg, device="cpu").prefill(cpu_params, rows)
    cpu_err = max_abs_err(logits32[:LM_CPU_ROWS].cpu(), cpu_logits)
    require(cpu_err < LM_TOL, f"{LM_ARCH} float32: the card's prefill "
            f"logits within {LM_TOL} of the CPU's ({cpu_err})")
    del cpu_params, logits32
    check_s = time.perf_counter() - t0
    print(f"[lm] {LM_ARCH} float32 (TF32 off): teacher-forced decode of "
          f"{LM_NEW - 1} tokens vs forward {tf_err:.3e}; card vs CPU prefill "
          f"logits ({LM_CPU_ROWS} requests) {cpu_err:.3e}; tolerance "
          f"{LM_TOL} ({check_s:.1f} s)")
    out = {"arch": LM_ARCH, "params": n_params, "param_bytes": param_bytes,
           "init_s": init_s, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "new_tokens": LM_NEW, "generate_s": walls,
           "tokens_per_s": n_tok / walls[1], "prefill_ms": prefill_ms,
           "decode_ms": decode_ms, "step_ms": step_ms,
           "decode_bound_ms": bound, "peak_bytes": peak,
           "trace": dict(trace, new_tokens=LM_TRACE_NEW,
                         untraced_wall_ms=trace_wall_ms),
           "fp32_teacher_forced_err": tf_err, "card_vs_cpu_err": cpu_err,
           "tf32": False, "tolerance": LM_TOL, "check_s": check_s}

    # (b) each other family at full width, LM_CUT_LAYERS layers
    families = {}
    scans = 0
    for arch in LM_FAMILIES:
        t0 = time.perf_counter()
        full_cfg = get_config(arch)
        cut = {"n_layers": LM_CUT_LAYERS}
        if full_cfg.is_encdec:
            cut["n_enc_layers"] = LM_CUT_LAYERS
        fcfg = dataclasses.replace(full_cfg, **cut)
        # float32; MoE with room for every assignment, so forward over
        # B * S tokens and decode over B drop none (the reference's test)
        room = {"capacity_factor": 64.0} if fcfg.n_experts else {}
        b32 = build(dataclasses.replace(fcfg, dtype="float32", **room),
                    device="cuda")
        params = b32.init(seed)
        n = sum(p.numel() for p in params.parameters())
        require(n == fcfg.param_count(),
                f"{arch}: {n} parameters, config {fcfg.param_count()}")
        seq = next(token_batches(fcfg.vocab_size_real, LM_BATCH,
                                 LM_PROMPT + LM_FAMILY_STEPS, seed))["tokens"]
        batch = lm_batch(fcfg, seq[:, :LM_PROMPT], seed)
        tf_err, _ = teacher_forced(b32, params, batch, LM_PROMPT, seq)
        require(tf_err < LM_TOL, f"{arch} float32: teacher-forced decode "
                f"within {LM_TOL} of forward ({tf_err})")
        b16 = build(fcfg, device="cuda")
        logits, _ = b16.prefill(params, batch)
        require(bool(torch.isfinite(logits).all()),
                f"{arch} bf16: finite prefill logits")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = generate(b16, params, batch, max_new_tokens=LM_FAMILY_STEPS)
        gen_s = time.perf_counter() - t1
        # float32 forward and prefill, bf16 prefill, generate's prompt
        scans += 4 * sum("ssm" in fcfg.mixer(i) for i in range(fcfg.n_layers))
        require(toks.shape == (LM_BATCH, LM_FAMILY_STEPS)
                and 0 <= toks.min() and toks.max() < fcfg.vocab_size,
                f"{arch} bf16: tokens in [0, vocab_size)")
        families[arch] = {
            "family": fcfg.family, "params": n, "param_bytes": 4 * n,
            "reduced": {**cut, **{f"fp32_{k}": v for k, v in room.items()}},
            "fp32_teacher_forced_err": tf_err, "generate_s": gen_s,
            "seconds": time.perf_counter() - t0}
        print(f"[lm] {arch} ({fcfg.family}, full width, depth cut to "
              f"{LM_CUT_LAYERS}{' + ' + str(LM_CUT_LAYERS) + ' encoder' if fcfg.is_encdec else ''}"
              f" layers{', float32 capacity_factor 64' if room else ''}): "
              f"{n} parameters; float32 prefill + {LM_FAMILY_STEPS} "
              f"teacher-forced steps vs forward {tf_err:.3e}; bf16 generate "
              f"of {LM_FAMILY_STEPS} tokens {gen_s:.3f} s, tokens in range "
              f"({time.perf_counter() - t0:.1f} s)")
        del params, b32, b16, logits
        torch.cuda.empty_cache()
    launches_all = read_counts(ks_all)
    require(sum(launches_all.values()) == launches_all["ssm_scan"] == scans,
            f"the LM path reaches no kernel of the port but the scan, once a "
            f"Mamba layer of each prompt ({scans}: {launches_all})")
    # (c) the scan kernel alone at the LM cell's shape
    row = ssm_scan_entry(seed)
    report.setdefault("kernels", []).append(row)
    out.update(families=families, launches=launches_all, ssm_scan=row,
               wall_s=time.perf_counter() - t_phase)
    report["lm_path"] = out
    print(f"[lm] phase {out['wall_s']:.1f} s; kernel launches "
          f"{launches_all}")


SCAN_SHAPE = (16, 1024, 8192, 16)   # the LM cell's Mamba layer: B, S, Di, N
SCAN_TOL = 1e-5                     # of the largest |y| or |h|
SCAN_EXPS_PER_S = 132 * 16 * 1.98e9     # MUFU.EX2: 16 a clock an SM


def ssm_scan_entry(seed: int) -> dict:
    """Phase 12 (c): the scan kernel at ``SCAN_SHAPE`` against its plain
    version and the chunked scan, timed beside both and its bound."""
    from repro_torch.kernels import ssm_scan as kss
    from repro_torch.models.ssm import _ssm_inner
    b, s, di, n = SCAN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, di, generator=gen, device="cuda") * 0.5 - 4.6)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(di, n).contiguous()
    bm, cm, xs = (torch.randn(*shape, generator=gen, device="cuda")
                  .to(torch.bfloat16)
                  for shape in ((b, s, n), (b, s, n), (b, s, di)))
    ops = (dt, a, bm, cm, xs, torch.zeros(b, di, n, device="cuda"))
    got = kss.ssm_scan_kernel(*ops)
    wants = {"plain": kss.ssm_scan_plain(*ops),
             "chunked": _ssm_inner(*ops, 32, torch.float32)}
    diffs = {k: [max_abs_err(g, w) for g, w in zip(got, want)]
             for k, want in wants.items()}
    errs = {k: max(d / float(w.abs().max()) for d, w in zip(diffs[k], want))
            for k, want in wants.items()}
    for name, err in errs.items():
        require(err < SCAN_TOL, f"ssm_scan within {SCAN_TOL} of the {name} "
                f"scan ({err:.3e})")
    abs_err = max(diffs["plain"])
    del got, wants
    ms, dev_ms = both_ms(lambda: kss.ssm_scan_kernel(*ops), 20)
    plain_ms = time_ms(lambda: kss.ssm_scan_plain(*ops), 3, warmup=1)
    chunked_ms = time_ms(lambda: _ssm_inner(*ops, 32, torch.float32), 3,
                         warmup=1)
    nbytes = sum(t.numel() * t.element_size() for t in ops) \
        + (b * s * di + b * di * n) * 4
    exps = b * s * di * n
    by_bytes, by_exps = nbytes / HBM_BYTES_PER_S, exps / SCAN_EXPS_PER_S
    b_ms, b_by = max(by_bytes, by_exps) * 1e3, \
        "bytes" if by_bytes >= by_exps else "exps"
    print(f"[kernel] ssm_scan {list(SCAN_SHAPE)} (bf16 x, B, C): within "
          f"{errs['plain']:.3e} of the plain version, {errs['chunked']:.3e} "
          f"of the chunked scan; {ms:.4f} ms, device {fmt_ms(dev_ms)} ms "
          f"(plain {plain_ms:.4f} ms, chunked {chunked_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}: {by_bytes * 1e3:.4f} by {nbytes} bytes, "
          f"{by_exps * 1e3:.4f} by {exps} exps); {card_line()}")
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "none (src/repro/models/ssm.py:88 "
                        "jax.lax.associative_scan)",
            "launches": None, "max_abs_err": abs_err, "equal": False,
            "tolerance": SCAN_TOL, "rel_err": errs, "ms": ms,
            "kernel_ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "chunked_ms": chunked_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "bytes": nbytes, "operations": exps,
            "shape": list(SCAN_SHAPE)}


TRAIN_ARCH = "llama3_2_1b"
TRAIN_BATCH = 8               # the launcher's defaults: 8 x 128 tokens,
TRAIN_SEQ = 128               # --steps 50 (warmup 5)
TRAIN_STEPS = 50
TRAIN_WARMUP_STEPS = 3        # untimed steps first
TRAIN_TIMED = 10              # steps timed with CUDA events
TRAIN_MICRO_STEPS = 2         # microbatches=2, grad_compression="bf16"
TRAIN_CUT_LAYERS = 1          # phase 13 (b), (c), phase 14 (c): depth cut
                              # so the host runs it, a checkpoint is small
                              # and phase 14 keeps to its time
TRAIN_CPU_ROWS = 2            # (b): rows of the batch the CPU repeats
TRAIN_TOL = 1e-3              # (b): loss and grad norm, relative
TRAIN_PARAM_TOL = 1e-5        # (b): parameters after one update
TRAIN_LOOP_STEPS = 4          # (c): checkpoint every 2, SIGTERM while
TRAIN_STOP_BATCH = 2          # batch 2 is fetched
H100_BF16_FLOPS = 989e12      # dense bf16 peak, NVIDIA's data sheet (SXM)


def train_step_work(cfg, n_params: int, tokens: int) -> dict:
    """The work of one llama train step, for its bound: FLOPs of the
    products (2 a parameter a token forward, 4 backward, 2 more for each
    block's recompute under remat; the tied head is outside the blocks; the
    attention scores and values at full S x S a layer) and the bytes the
    update and the casts must move (AdamW reads the parameter, gradient and
    two moments and writes the parameter and moments, 28 B a parameter;
    each use of a block parameter casts float32 -> bf16, 6 B, in the
    forward and the recompute, and the gradient comes back bf16 -> float32,
    6 B; the head's cast and gradient once each).  Activations are not
    counted."""
    head = cfg.vocab_size * cfg.d_model
    blocks = n_params - head
    s = TRAIN_SEQ
    attn = (4 * TRAIN_BATCH * cfg.n_heads * s * s * cfg.head_dim
            * cfg.n_layers)                     # QK^T and PV, forward
    flops = tokens * (8 * blocks + 6 * head) + 4 * attn
    update = 28 * n_params
    casts = 18 * blocks + 12 * head
    return {"flops": flops, "update_bytes": update, "cast_bytes": casts,
            "bytes": update + casts}


def train_path(seed: int, report: dict) -> None:
    """Phase 13: LM training on one card.  (a) ``llama3_2_1b`` at its full
    published config through ``train.train_loop.make_train_step``; (b) the
    card's step against the CPU's, full width, ``TRAIN_CUT_LAYERS``
    layers, float32; (c) ``TrainLoop`` stopped by SIGTERM and restarted
    from its checkpoint; (d) ``launch/train.py --reduced --dedup`` in
    process.  Counted: kernel 1 once (the launcher's dedup), no other."""
    import contextlib
    import io
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (adamw_update, global_norm,
                                             init_opt_state, lr_schedule)
    from repro_torch.train.train_loop import (TrainLoop, loss_and_grads,
                                              make_train_step)
    ks_all = kernels()
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts(ks_all)
    # --- the training path ---------------------------------------------------
    # (a) full width at the launcher's defaults
    cfg = get_config(TRAIN_ARCH)
    bundle = build(cfg, device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init(seed)
    opt = init_opt_state(params)
    n_params = sum(p.numel() for p in params.parameters())
    require(n_params == cfg.param_count(),
            f"{TRAIN_ARCH}: {n_params} parameters, config "
            f"{cfg.param_count()}")
    tc = TrainConfig(total_steps=TRAIN_STEPS,
                     warmup_steps=max(TRAIN_STEPS // 10, 1))
    step = make_train_step(bundle, tc)
    data = token_batches(cfg.vocab_size_real, TRAIN_BATCH, TRAIN_SEQ, seed)
    losses, step_ms, lrs, norms = [], [], [], []
    for i in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED):
        batch = next(data)
        if i == TRAIN_WARMUP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        losses.append(m["loss"])
        lrs.append(m["lr"])
        norms.append(m["grad_norm"])
        if i >= TRAIN_WARMUP_STEPS:
            step_ms.append((start, end))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    step_ms = [a.elapsed_time(b) for a, b in step_ms]
    losses, lrs, norms = ([float(x) for x in xs]
                          for xs in (losses, lrs, norms))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    work = train_step_work(cfg, n_params, n_tok)
    t_flops = work["flops"] / H100_BF16_FLOPS * 1e3
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    bound, bound_by = max((t_flops, "operations"), (t_bytes, "bytes"))
    require(all(np.isfinite(losses)), f"finite losses ({losses})")
    require(losses[-1] < losses[TRAIN_WARMUP_STEPS],
            f"the last timed loss {losses[-1]} below the first timed "
            f"{losses[TRAIN_WARMUP_STEPS]}")
    print(f"[train] {TRAIN_ARCH} (full config: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} "
          f"compute, {cfg.param_dtype} parameters, remat {cfg.remat}, "
          f"fused_qkv {cfg.fused_qkv}): {n_params} parameters; batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, lr {tc.learning_rate} warmup "
          f"{tc.warmup_steps} of {tc.total_steps}; {card_line()}")
    print(f"[train] step {med:.3f} ms (median of {TRAIN_TIMED} after "
          f"{TRAIN_WARMUP_STEPS} warm-up; min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; host wall {wall_ms:.3f} ms a step), "
          f"{n_tok / med * 1e3:.1f} tokens/s; peak memory {peak} B; bound "
          f"{bound:.3f} ms by {bound_by} ({work['flops']:.4e} FLOPs at "
          f"989 TFLOP/s = {t_flops:.3f} ms; {work['update_bytes']} B of "
          f"update + {work['cast_bytes']} B of casts at 3.35 TB/s = "
          f"{t_bytes:.3f} ms)")
    print("[train] losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; lr " + ", ".join(f"{x:.3e}" for x in lrs)
          + "; grad_norm " + ", ".join(f"{x:.3f}" for x in norms))
    trace = profile_busy(lambda: step(params, opt, next(data)),
                         "train_trace")
    print(f"[train] one step traced: wall {trace['wall_us'] / 1e3:.3f} ms, "
          f"the card busy {trace['device_busy_us'] / 1e3:.3f} ms "
          f"({trace['device_busy_share'] * 100:.1f}%, "
          f"{trace['device_events']} device events); top: " + ", ".join(
              f"{r['name'][:40]} {r['us'] / 1e3:.3f} ms"
              for r in trace["top_device_time_us"][:5]))
    torch.cuda.reset_peak_memory_stats()
    micro = make_train_step(bundle, dataclasses.replace(
        tc, microbatches=2, grad_compression="bf16"))
    micro_losses, micro_s = [], []
    for _ in range(TRAIN_MICRO_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = micro(params, opt, next(data))
        micro_losses.append(float(m["loss"]))
        micro_s.append(time.perf_counter() - t1)
        require(np.isfinite(micro_losses[-1]) and np.isfinite(
            float(m["grad_norm"])), "microbatched bf16 step: finite")
    micro_peak = torch.cuda.max_memory_allocated()
    print(f"[train] microbatches=2, grad_compression=bf16: losses "
          + ", ".join(f"{x:.4f}" for x in micro_losses) + "; "
          + ", ".join(f"{s * 1e3:.1f}" for s in micro_s)
          + f" ms a step (host clock); peak memory {micro_peak} B")
    out = {"arch": TRAIN_ARCH, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "train_config": dataclasses.asdict(tc),
           "losses": losses, "lr": lrs, "grad_norm": norms,
           "step_ms": step_ms, "step_ms_median": med, "wall_ms": wall_ms,
           "tokens_per_s": n_tok / med * 1e3, "peak_bytes": peak,
           "bound_ms": bound, "bound_by": bound_by, "work": work,
           "trace": trace, "micro_bf16": {"losses": micro_losses,
                                           "seconds": micro_s,
                                           "peak_bytes": micro_peak}}
    del params, opt, step, micro, m
    torch.cuda.empty_cache()

    # (b) the card against the CPU: float32, TF32 off, TRAIN_CUT_LAYERS
    # layers.  The step's loss and gradients, then the update on the same
    # gradients (the CPU's on both sides), then the card's whole step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS,
                              dtype="float32")
    card, cpu = build(cut, device="cuda"), build(cut, device="cpu")
    start = card.init(seed)
    host = start.map(lambda _, p: p.to("cpu", copy=True))
    batch = next(token_batches(cut.vocab_size_real, TRAIN_CPU_ROWS,
                               TRAIN_SEQ, seed + 1))
    loss_c, _, g_card = loss_and_grads(card, start, batch)
    loss_h, _, g_host = loss_and_grads(cpu, host, batch)
    rel = {"loss": abs(float(loss_c) - float(loss_h)) / abs(float(loss_h)),
           "grad_norm": abs(float(global_norm(g_card))
                            - float(global_norm(g_host)))
           / float(global_norm(g_host))}
    g_err = max(max_abs_err(a.cpu(), b) for a, b in zip(g_card, g_host))
    whole = start.map(lambda _, p: p.clone())
    adamw_update(whole, g_card, init_opt_state(whole), tc)
    adamw_update(start, [g.cuda() for g in g_host], init_opt_state(start),
                 tc)
    adamw_update(host, g_host, init_opt_state(host), tc)
    p_err = max(max_abs_err(a.cpu(), b) for a, b in
                zip(start.parameters(), host.parameters()))
    step_err = max(max_abs_err(a.cpu(), b) for a, b in
                   zip(whole.parameters(), host.parameters()))
    lr1 = float(lr_schedule(torch.tensor(1), tc))
    check_s = time.perf_counter() - t0
    require(max(rel.values()) < TRAIN_TOL,
            f"card vs CPU loss and grad norm within {TRAIN_TOL} ({rel})")
    require(p_err < TRAIN_PARAM_TOL, f"card vs CPU parameters after one "
            f"adamw_update within {TRAIN_PARAM_TOL} ({p_err})")
    require(step_err <= 2 * lr1, f"the card's whole step within 2 x lr of "
            f"the CPU's ({step_err})")
    print(f"[train] card vs CPU ({TRAIN_CUT_LAYERS} layers, full width, "
          f"float32, TF32 off, {TRAIN_CPU_ROWS} x {TRAIN_SEQ}): loss "
          f"{float(loss_c):.6f} vs {float(loss_h):.6f} (rel "
          f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, "
          f"largest gradient difference {g_err:.2e}; parameters after one "
          f"adamw_update on the same gradients {p_err:.2e} (tolerances "
          f"{TRAIN_TOL}, {TRAIN_PARAM_TOL}); after each side's whole step "
          f"{step_err:.2e} (AdamW moves a parameter up to lr = {lr1:.1e} "
          f"whatever its gradient's size) ({check_s:.1f} s)")
    out["card_vs_cpu"] = {"layers": TRAIN_CUT_LAYERS, "rows": TRAIN_CPU_ROWS,
                          "rel": rel, "grad_err": g_err, "param_err": p_err,
                          "step_param_err": step_err, "seconds": check_s,
                          "tf32": False}
    del start, host, whole, card, cpu, g_card, g_host
    torch.cuda.empty_cache()

    # (c) TrainLoop: SIGTERM while a batch is fetched, then a restart
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    bundle = build(cut, device="cuda")
    ltc = TrainConfig(total_steps=TRAIN_LOOP_STEPS, warmup_steps=1,
                      checkpoint_every=2, keep_checkpoints=1, seed=seed)
    batches = list(itertools.islice(token_batches(
        cut.vocab_size_real, TRAIN_BATCH, TRAIN_SEQ, seed + 2),
        TRAIN_LOOP_STEPS))
    params = bundle.init(ltc.seed)
    opt = init_opt_state(params)
    step = make_train_step(bundle, ltc)
    whole = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        whole.append(float(m["loss"]))
    whole_params = params
    del opt, step
    wd = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def signalling():
            for i, b in enumerate(batches):
                if i == TRAIN_STOP_BATCH:
                    require(signal.getsignal(signal.SIGTERM) not in (
                        signal.SIG_DFL, signal.SIG_IGN, None),
                        "the loop's SIGTERM handler is installed")
                    signal.raise_signal(signal.SIGTERM)
                yield b
        logs: list[tuple[float, str]] = []

        def log(msg):
            logs.append((time.perf_counter(), msg))
        handler = signal.getsignal(signal.SIGTERM)
        first = TrainLoop(bundle, ltc, signalling(), wd, log=log).run()
        t_end = time.perf_counter()
        require(signal.getsignal(signal.SIGTERM) is handler,
                "the loop put the SIGTERM handler back")
        stops = [t for t, msg in logs if "preemption signal" in msg]
        require(len(stops) == 1, f"one preemption save ({logs})")
        save_s = t_end - stops[0]
        saved = ckpt.committed_steps(wd)
        require(saved == [TRAIN_STOP_BATCH + 1],
                f"the stop saved step {TRAIN_STOP_BATCH + 1} ({saved})")
        step_dir = os.path.join(wd, f"step_{saved[0]:08d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        second = TrainLoop(bundle, ltc, iter(batches[saved[0]:]), wd,
                           log=log).run()
        require(any(f"restored step {saved[0]}" in msg for _, msg in logs),
                "the restart restored the saved step")
        resumed = first["losses"] + second["losses"]
        require(resumed == whole, f"the stopped and restarted loop's losses "
                f"equal an uninterrupted run's ({resumed} vs {whole})")
        require(all(torch.equal(a, b) for a, b in zip(
            whole_params.parameters(), second["params"].parameters())),
            "the restarted loop ends with the uninterrupted run's "
            "parameters")
        t1 = time.perf_counter()
        step_r, restored = ckpt.restore_checkpoint(
            wd, {"params": second["params"], "opt": second["opt"]})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        require(step_r == TRAIN_LOOP_STEPS and all(torch.equal(a, b) for a, b
                in zip(restored["params"].parameters(),
                       second["params"].parameters())),
                "the final checkpoint restores the final parameters")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    print(f"[train] TrainLoop ({TRAIN_CUT_LAYERS} layers, full width, "
          f"{TRAIN_LOOP_STEPS} steps, checkpoint every "
          f"{ltc.checkpoint_every}, keep {ltc.keep_checkpoints}): SIGTERM "
          f"at batch {TRAIN_STOP_BATCH}, saved step {saved[0]} "
          f"({ckpt_bytes} B on disk, {save_s:.2f} s from the signal's save "
          f"to the loop's return), restarted: losses equal an "
          f"uninterrupted run's ({', '.join(f'{x:.4f}' for x in whole)}); "
          f"final checkpoint loaded in {load_s:.2f} s")
    out["train_loop"] = {"layers": TRAIN_CUT_LAYERS,
                         "steps": TRAIN_LOOP_STEPS, "saved_step": saved[0],
                         "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
                         "load_s": load_s, "losses": whole}
    del bundle, params, whole_params, first, second, restored
    torch.cuda.empty_cache()

    # (d) the launcher with --dedup, in process; its dedup and its training
    # counted apart
    from repro_torch.launch import train as launch_train
    wd = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    split: dict = {}
    real_loop = launch_train.TrainLoop

    class CountedLoop(real_loop):
        def run(self, *a, **kw):
            split["dedup"] = read_counts(ks_all)
            res = super().run(*a, **kw)
            split["train"] = {n: v - split["dedup"][n]
                              for n, v in read_counts(ks_all).items()}
            return res

    argv = ["--arch", TRAIN_ARCH, "--reduced", "--dedup", "--steps", "8",
            "--workdir", wd]
    buf = io.StringIO()
    launch_train.TrainLoop = CountedLoop
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = launch_train.main(argv)
    finally:
        launch_train.TrainLoop = real_loop
        shutil.rmtree(wd, ignore_errors=True)
    launch_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith("[launch]"):
            print(line)
    launches = read_counts(ks_all)
    # -------------------------------------------------------------------------
    require(any(line.startswith(f"[launch] {TRAIN_ARCH}: ") for line in lines)
            and any(line.startswith("[launch] dedup kept ") for line in lines)
            and any(line.startswith("[launch] final loss ")
                    for line in lines), f"the [launch] lines ({lines})")
    require(len(res["losses"]) == 8 and all(np.isfinite(res["losses"])),
            "the launcher trained 8 finite steps")
    require(split["dedup"]["cminhash_sparse"] == 1
            and sum(split["dedup"].values()) == 1
            and sum(split["train"].values()) == 0,
            f"the launcher's dedup launched kernel 1 once, its training no "
            f"kernel ({split})")
    print(f"[train] launch/train.py {' '.join(argv[:-1])} <tmp>: "
          f"{launch_s:.1f} s; launches: dedup {split['dedup']}, training "
          f"{split['train']}")

    # kernel 1 at the launcher's dedup launch against its plain version
    from repro_torch.configs import reduced
    from repro_torch.core.permutations import (apply_permutation_sparse,
                                               make_two_permutations)
    from repro_torch.data.dedup import DedupConfig
    from repro_torch.data.shingle import batch_shingles
    from repro_torch.data.synthetic import corpus_with_duplicates
    from repro_torch.kernels import cminhash_sparse as ks
    rcfg = reduced(cfg)
    dcfg = DedupConfig(d=1 << 14, k=256, n_bands=64, rows_per_band=4,
                       threshold=0.5)
    docs, _ = corpus_with_duplicates(400, vocab=rcfg.vocab_size_real,
                                     doc_len=128, dup_fraction=0.25, seed=0)
    dev = torch.device("cuda")
    sigma, pi = make_two_permutations(
        torch.Generator().manual_seed(dcfg.seed), dcfg.d, device=dev)
    idx = batch_shingles(docs, n=dcfg.shingle_n, d=dcfg.d)
    sidx = apply_permutation_sparse(torch.from_numpy(idx).to(dev),
                                    sigma).to(torch.int32).contiguous()
    got = ks.cminhash_sparse_kernel(sidx, pi, dcfg.k)
    require(np.array_equal(got.cpu().numpy(), res["dedup"].signatures),
            "the kernel's output is the launcher's dedup signatures")
    want = ks.cminhash_sparse_plain(sidx, pi, dcfg.k)
    ms, dev_ms = both_ms(lambda: ks.cminhash_sparse_kernel(sidx, pi, dcfg.k),
                         10)
    plain_ms = time_ms(lambda: ks.cminhash_sparse_plain(sidx, pi, dcfg.k), 5)
    n_valid = int((sidx >= 0).sum().item())
    row = kernel_entry(
        "cminhash_sparse", "src/repro_torch/csrc/cminhash_sparse.cu",
        "src/repro/kernels/cminhash_sparse.py:186", got, want, ms, plain_ms,
        sidx.numel() * 4 + pi.numel() * 4 + got.numel() * 4,
        n_valid * dcfg.k, dev_ms, {"shape": list(sidx.shape),
                                   "pack_b": None})
    out.update(launches=launches, launch_split=split, launch_s=launch_s,
               launch_lines=lines, kernels=[row],
               wall_s=time.perf_counter() - t_phase)
    report["train_path"] = out
    print(f"[train] phase {out['wall_s']:.1f} s; kernel launches "
          f"{launches}")


MESH_LR = 3e-4                # the launcher's lr; warmup 0, so step 1 runs
MESH_MOE_ARCH = "qwen3_moe_30b_a3b"
MESH_MOE_LAYERS = 2           # (b): published widths, depth cut
MESH_MOE_ROWS, MESH_MOE_SEQ = 8, 32
MESH_TOL = 1e-4               # loss and grad norm (relative), MoE logits
MESH_GRAD_TOL = 1e-5          # gradients, x the leaf's largest gradient
MESH_SPREAD_K = 2             # (f): or K x the leaf's own one-device
MESH_SPREAD_CAP = 1e-4        # spread, itself held below the cap
MESH_PSUM_STEPS = 20          # (e): error-feedback steps
MESH_TIMEOUT = 240.0          # seconds a rank may take for one call
MESH_HYBRID_ARCH = "hymba_1_5b"   # (f): at its full published config
MESH_HYBRID_PARAMS = 1_662_209_600
MESH_PROMPT = 32              # (f), (g): prefill 8 x 32, then teacher-
MESH_HYBRID_DECODE = 8        # forced decode steps
MESH_FAMILY_LAYERS = 1        # (g): published widths, depth cut (encdec:
MESH_FAMILY_DECODE = 4        # each side) to keep phase 14 in its time
MESH_FRAMES = 64              # (g): seamless's encoder frames a row
MESH_PATCHES = 16             # (g): pixtral's patch prefix a row
MESH_SERVE_DOCS = 65_536      # (h): documents the mesh service ingests
MESH_DEDUP_DOCS = 32_768      # (h): documents the mesh dedup reads
MESH_GEN_NEW = 8              # (h): greedy tokens of the mesh generate
MESH_GEN_GAP = 1e-3           # (h): rows held token for token: the one
                              # device's top-2 logit gap above this at
                              # every step
MESH_ENTRY_KERNELS = ("cminhash_sparse", "cminhash_dense", "cminhash_packed",
                      "fold", "lsh_probe", "collision")


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rank_counts(before: dict) -> dict:
    from repro_torch.distributed import collectives as col
    return {k: v - before.get(k, 0) for k, v in col.counters().items()
            if v - before.get(k, 0)}


def _mesh_rank(fn, *args) -> dict:
    """``fn(*args)`` on a rank of phase 14, the rank's kernel counts set to
    0 just before and read just after (``launches`` in the result)."""
    ks = kernels()
    zero_counts(ks)
    out = fn(*args)
    out["launches"] = read_counts(ks)
    return out


def _mesh_rank_step(cfg, tc, shape, batch, seed, want, timed):
    """A rank of phase 14 (a), (c), (f), (g): its slices of the parameters
    drawn from ``seed``; the gradients a step hands its update, held
    against the single device's (``want["grads"]``) relative to each
    leaf's largest; one step through ``jit_train_step``, held against the
    single device's parameters after the same step (``want["params"]``);
    with ``timed``, a second step timed with CUDA events.  ``want`` holds
    the parent's tensors on the card, shared through the pool's pipe."""
    from repro_torch.convert import reference_path
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import stacked_shapes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train.train_loop import (init_train_state,
                                              jit_train_step, mesh_gradients,
                                              train_state_shardings)
    _no_tf32()
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(*shape, device="cuda")
    full = bundle.init(seed)
    p_sh, _ = train_state_shardings(full, tc, mesh)
    shapes = stacked_shapes(full)
    params, opt = init_train_state(full, tc, mesh)
    del full
    secs: dict = {}
    t0 = time.perf_counter()
    grad_errs: dict = {}
    for name, sl, g in mesh_gradients(bundle, tc, mesh, params, batch):
        w = want["grads"][name]
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g - w[sl]).abs().max()) / scale
        grad_errs[name] = max(grad_errs.get(name, 0.0), err)
    del w, g
    secs["grads"] = time.perf_counter() - t0
    worst = max(grad_errs, key=grad_errs.get)
    torch.cuda.empty_cache()
    held = sum(t.numel() * t.element_size() for tree in (params, opt.mu,
                                                         opt.nu)
               for t in tree.parameters())
    torch.cuda.reset_peak_memory_stats()
    step = jit_train_step(bundle, tc, mesh)
    before = col.counters()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    secs["step"] = time.perf_counter() - t0
    counts = _rank_counts(before)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "lr": float(m["lr"]), "counts": counts, "state_bytes": held,
           "grad_errs": grad_errs, "grad_err": grad_errs[worst],
           "grad_worst": worst, "secs": secs}
    err = 0.0
    for name, p in params.named_parameters():
        rel, i = reference_path(name)
        sl = p_sh[rel].slices(shapes[rel])
        w = want["params"][name][sl if i is None else sl[1:]]
        err = max(err, float((p.detach() - w).abs().max()))
    out["param_err"] = err
    del want, w
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = col.counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        out.update(step_ms=start.elapsed_time(end),
                   wall_ms=(time.perf_counter() - t0) * 1e3,
                   timed_counts=_rank_counts(before))
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


class _CountDrops:
    """``with _CountDrops() as drops:`` counts in ``drops.n`` the MoE
    assignments that ``models.moe._places`` drops at capacity inside the
    block (to an expert held here, not kept)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.n, self._places = 0, moe._places

        def counted(idx, el, *args):
            lid, pos, keep = self._places(idx, el, *args)
            self.n += int(((lid < el) & ~keep).sum())
            return lid, pos, keep
        moe._places = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._places = self._places


def _mesh_rank_moe(cfg, mode, batch, seed, want_path):
    """Phase 14 (b) on a rank: the forward of its rows over (1, 2) in
    ``mode`` (``tp``: expert parallel; ``fsdp``: its half of the rows,
    the experts gathered), against one device's logits of those rows."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.parallel import Parallel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.train.train_loop import (batch_layout, rank_rows,
                                              train_state_shardings)
    _no_tf32()
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(1, 2, device="cuda")
    tc = TrainConfig(sharding_mode=mode)
    full = bundle.init(seed)
    local = shard_tree(full, train_state_shardings(full, tc, mesh)[0])
    del full
    torch.cuda.empty_cache()
    rows = batch_layout(tc, mesh)(batch, mesh)["tokens"].slices(
        batch["tokens"].shape)[0]
    before = col.counters()
    with _CountDrops() as drops:
        logits = bundle.forward(local, rank_rows(tc, mesh)(batch),
                                mesh=Parallel(mesh, cfg, mode))
        torch.cuda.synchronize()
    want = torch.from_numpy(np.load(want_path))[rows]
    return {"err": float((logits.cpu() - want).abs().max()),
            "dropped": drops.n, "counts": _rank_counts(before),
            "held": sum(p.numel() for p in local.parameters())}


def _mesh_rank_serve(cfg, shape, batch, feed, seed, want_path):
    """Phase 14 (f), (g) on a rank: its slices of ``seed``'s weights on
    ``shape``; the forward of its rows where ``want_path`` holds one
    device's, then prefill (tp = the model axis) and teacher-forced decode
    steps of ``feed``; each logit and each cache block held against one
    device's (its slices under ``cache_specs``)."""
    from repro_torch.data.loader import device_placer
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  cache_specs, local_slices,
                                                  param_shardings,
                                                  shard_tree)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    _no_tf32()
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(*shape, device="cuda")
    full = bundle.init(seed)
    local = shard_tree(full, param_shardings(full, mesh))
    del full
    torch.cuda.empty_cache()
    rows = device_placer(mesh, batch_shardings)(batch)
    sl = batch_shardings(batch, mesh)["tokens"].slices(
        batch["tokens"].shape)[0]
    want = torch.load(want_path, weights_only=True)
    out: dict = {}
    before = col.counters()
    if "forward" in want:
        got = bundle.forward(local, rows, mesh=mesh)
        out["forward_err"] = float((got.cpu() - want["forward"][sl])
                                   .abs().max())
        del got
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(local, rows, mesh=mesh, tp=shape[1],
                                   max_len=batch["tokens"].shape[1]
                                   + len(feed))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    errs = [float((logits.cpu() - want["logits"][0][sl]).abs().max())]
    t0 = time.perf_counter()
    for tok, w in zip(feed, want["logits"][1:]):
        logits, cache = bundle.decode_step(local, cache, tok[sl], mesh=mesh)
        errs.append(float((logits.cpu() - w[sl]).abs().max()))
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(len(feed), 1)
    counts = _rank_counts(before)
    specs = cache_specs(want["cache"], mesh)
    cache_err = {k: float((cache[k].cpu() - want["cache"][k][local_slices(
        specs[k], want["cache"][k].shape, mesh)]).abs().max())
        for k in want["cache"] if k != "t"}
    out.update(logit_err=max(errs), cache_err=cache_err,
               heads=(cache["k"].shape[-2] if "k" in cache else None),
               prefill_ms=prefill_ms, decode_ms=decode_ms, counts=counts,
               held=sum(p.numel() for p in local.parameters()))
    return out


def _entry_int8_rows(seed: int) -> np.ndarray:
    """(h): BATCH x PAPER_D int8 0/1 rows from ``seed``, below
    ``PACKED_MIN_D``, for the int8 dense kernel."""
    return (np.random.default_rng(seed).random((BATCH, PAPER_D)) < 0.05
            ).astype(np.int8)


def _entry_sign(engines: dict, idx, int8_rows) -> dict:
    """(h): the main sparse batch and BATCH dense rows of D = 2^16, packed
    at b = 32, and the int8 rows' raw signatures, on the host."""
    from repro_torch.device import u32_to_host
    return {"sparse": u32_to_host(engines["wide"].sign(
                idx[:BATCH], layout="sparse", pack_b=32)),
            "dense": u32_to_host(engines["wide"].sign(
                dense_rows(idx[:BATCH]), layout="dense", pack_b=32)),
            "int8": engines["narrow"].sign(int8_rows, layout="dense")
            .cpu().numpy()}


def _entry_engines(mesh) -> dict:
    """(h): the service's engine (``SearchConfig``'s D and K) and one at
    D = PAPER_D, on the card, over ``mesh`` or on one device."""
    from repro_torch.core.engine import SketchConfig, SketchEngine
    from repro_torch.serve.search import SearchConfig
    scfg = SearchConfig()
    return {"wide": SketchEngine(SketchConfig(d=scfg.d, k=scfg.k), mesh,
                                 device="cuda"),
            "narrow": SketchEngine(SketchConfig(d=PAPER_D, k=scfg.k), mesh,
                                   device="cuda")}


def _entry_serve(mesh, idx, qidx) -> tuple:
    """(h): the in-process service over ``mesh`` (or one device) ingesting
    ``idx`` in batches of BATCH, then ``qidx`` queried once."""
    from repro_torch.serve.search import SearchConfig, SimilaritySearchService
    svc = SimilaritySearchService(SearchConfig(device="cuda"), mesh)
    ingest(svc, idx, BATCH)
    ids, scores = svc.query_sparse(qidx, top_k=TOP_K)
    svc.close()
    return ids, scores


def _mesh_rank_entry(shape, idx, qidx, docs, int8_rows):
    """Phase 14 (h) on a rank of ``shape``: signing, the in-process service
    and ``dedup_corpus`` over the mesh, each a collective call with the
    parent's inputs (host tensors in shared memory: ``docs`` one row a
    document); the answers, the registry's ``kernel.*`` counters, the
    collectives and the seconds of each."""
    from repro_torch.data.dedup import DedupConfig, dedup_corpus
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.obs import metrics as obs_metrics
    t_rank = time.perf_counter()
    idx, int8_rows = idx.numpy(), int8_rows.numpy()
    docs = list(docs.numpy())
    mesh = make_host_mesh(*shape, device="cuda")
    reg = obs_metrics.default()
    k0 = {k: v for k, v in reg.snapshot()["counters"].items()
          if k.startswith("kernel.")}
    before = col.counters()
    secs: dict = {}
    engines = _entry_engines(mesh)
    secs["setup"] = time.perf_counter() - t_rank
    t0 = time.perf_counter()
    out = _entry_sign(engines, idx, int8_rows)
    secs["sign"] = time.perf_counter() - t0
    sign_counts = _rank_counts(before)
    t0 = time.perf_counter()
    out["ids"], out["scores"] = _entry_serve(mesh, idx, qidx)
    secs["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["keep"] = dedup_corpus(docs, DedupConfig(), mesh,
                               device="cuda").keep
    secs["dedup"] = time.perf_counter() - t0
    secs["rank"] = time.perf_counter() - t_rank
    out.update(secs=secs, sign_counts=sign_counts,
               counts=_rank_counts(before),
               kernel_counters={k: v - k0.get(k, 0) for k, v in
                                reg.snapshot()["counters"].items()
                                if k.startswith("kernel.")
                                and v - k0.get(k, 0)})
    return out


def _mesh_rank_generate(cfg, shape, prompts, seed, n_new):
    """Phase 14 (h) on a rank of ``shape``: greedy ``generate`` over the
    mesh from the rank's slices of ``seed``'s weights."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import param_shardings, shard_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.serve.decode import generate
    _no_tf32()
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(*shape, device="cuda")
    full = bundle.init(seed)
    local = shard_tree(full, param_shardings(full, mesh))
    del full
    torch.cuda.empty_cache()
    before = col.counters()
    t0 = time.perf_counter()
    toks = generate(bundle, local, {"tokens": prompts},
                    max_new_tokens=n_new, mesh=mesh)
    return {"tokens": toks, "seconds": time.perf_counter() - t0,
            "counts": _rank_counts(before)}


def _mesh_rank_save(cfg, tc, shape, batch, seed, d):
    """Phase 14 (d): a ZeRO-1 step on ``shape``, then a sharded save."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import (init_train_state,
                                              jit_train_step,
                                              train_state_shardings)
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(*shape, device="cuda")
    full = bundle.init(seed)
    p_sh, o_sh = train_state_shardings(full, tc, mesh)
    params, opt = init_train_state(full, tc, mesh)
    params, opt, _ = jit_train_step(bundle, tc, mesh)(params, opt, batch)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(d, 1, {"params": params, "opt": opt},
                         shardings={"params": p_sh, "opt": o_sh})
    return {"save_s": time.perf_counter() - t0,
            "moments_held": sum(t.numel() for t in opt.mu.parameters())}


def _mesh_rank_restore(cfg, tc, shape, src, dst, seed):
    """Phase 14 (d): restore ``src`` onto another mesh, save it again."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import (init_train_state,
                                              train_state_shardings)
    bundle = build(cfg, device="cuda")
    mesh = make_host_mesh(*shape, device="cuda")
    full = bundle.init(seed + 1)           # other values: all restored
    p_sh, o_sh = train_state_shardings(full, tc, mesh)
    params, opt = init_train_state(full, tc, mesh)
    shardings = {"params": p_sh, "opt": o_sh}
    t0 = time.perf_counter()
    step, state = ckpt.restore_checkpoint(
        src, {"params": params, "opt": opt}, shardings=shardings)
    restore_s = time.perf_counter() - t0
    ckpt.save_checkpoint(dst, step, state, shardings=shardings)
    return {"step": step, "restore_s": restore_s}


def _mesh_rank_psum(g_all, steps):
    """Phase 14 (e): ``compressed_psum`` bf16 and int8 (error feedback) on
    CUDA tensors over the two ranks' ``data`` axis."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import coordinate
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 1, device="cuda")
    r = coordinate(mesh)["data"]
    grads = {"w": torch.from_numpy(g_all[r]).cuda()}
    before = col.counters()
    bf16, _ = col.compressed_psum(grads, "bf16", ("data",), mesh=mesh)
    err = col.init_error_feedback(grads)
    int8 = []
    for _ in range(steps):
        out, err = col.compressed_psum(grads, "int8", ("data",), err,
                                       mesh=mesh)
        int8.append(out["w"].cpu().numpy())
    return {"bf16": bf16["w"].cpu().numpy(), "int8": int8,
            "device": str(grads["w"].device), "counts": _rank_counts(before)}


def _step_text(one: dict, r: dict) -> str:
    return (f"loss rel {abs(r['loss'] - one['loss']) / abs(one['loss']):.2e}"
            f", grad norm rel {abs(r['grad_norm'] - one['grad_norm']) / abs(one['grad_norm']):.2e}, "
            f"gradients {r['grad_err']:.2e} of each leaf's largest "
            f"({r['grad_worst']}), "
            f"parameters {r['param_err']:.2e}")


def _grad_bound(one: dict, name: str) -> float:
    """A leaf's gradient bound, relative to its largest gradient:
    MESH_GRAD_TOL, or MESH_SPREAD_K x the leaf's own one-device float32
    spread where ``one`` measured it (``grad_spread``) and that is
    larger."""
    return max(MESH_GRAD_TOL,
               MESH_SPREAD_K * one.get("grad_spread", {}).get(name, 0.0))


def _leaf_pairs(one: dict, ranks: list) -> str:
    """Each kind of leaf (its name without the layer index): the leaf
    nearest its bound over the ranks, as error / bound."""
    worst: dict = {}
    for r in ranks:
        for name, err in r["grad_errs"].items():
            kind = re.sub(r"\.\d+\.", ".", name)
            bound = _grad_bound(one, name)
            if kind not in worst or err / bound > worst[kind][0]:
                worst[kind] = (err / bound, err, bound, name)
    return "; ".join(f"{kind} {err:.2e} / {bound:.2e} ({name})"
                     for kind, (_, err, bound, name) in sorted(worst.items()))


def _check_step(tag: str, one: dict, ranks: list) -> None:
    """A mesh step against one device's: loss and grad norm within
    MESH_TOL relative, the grad norm the same on every rank, each leaf's
    gradients within ``_grad_bound`` of its largest (where ``one``
    measured its own spread, that spread below MESH_SPREAD_CAP),
    parameters within 2 x lr."""
    rel = max(abs(r[k] - one[k]) / abs(one[k]) for r in ranks
              for k in ("loss", "grad_norm"))
    require(rel < MESH_TOL, f"{tag}: loss and grad norm within {MESH_TOL} "
            f"of one device ({rel})")
    require(len({r["grad_norm"] for r in ranks}) == 1,
            f"{tag}: the grad norm the same on every rank "
            f"({[r['grad_norm'] for r in ranks]})")
    spread = max(one.get("grad_spread", {}).values(), default=0.0)
    require(spread < MESH_SPREAD_CAP, f"{tag}: the one device's own "
            f"float32 spread below {MESH_SPREAD_CAP} of each leaf's largest "
            f"gradient ({spread})")
    over = sorted((err / _grad_bound(one, n), n, err, _grad_bound(one, n))
                  for r in ranks for n, err in r["grad_errs"].items())[-3:]
    require(over[-1][0] <= 1.0, f"{tag}: each leaf's gradients within the "
            f"larger of {MESH_GRAD_TOL} and {MESH_SPREAD_K} x its own "
            f"one-device spread, of its largest (nearest: "
            + ", ".join(f"{n} {e:.2e} / {b:.2e}" for _, n, e, b in over)
            + ")")
    p_err = max(r["param_err"] for r in ranks)
    require(p_err <= 2 * one["lr"], f"{tag}: parameters within 2 x lr "
            f"of one device ({p_err})")


def _secs(secs: dict) -> str:
    return ", ".join(f"{k} {v:.1f}" for k, v in secs.items())


def _counts_line(counts: dict) -> str:
    kinds = sorted({k.split(".")[1] for k in counts
                    if k.endswith(".calls")})
    return "; ".join(f"{k} {counts[f'mesh.{k}.calls']} calls "
                     f"{counts.get(f'mesh.{k}.bytes', 0)} B" for k in kinds)


def entry_inputs(entry: dict | None) -> dict:
    """Phase 14 (h)'s inputs: the main path's index lists ``idx`` (at least
    MESH_SERVE_DOCS rows), its query batch ``qidx`` and the first
    MESH_DEDUP_DOCS of its documents; made anew from ``documents`` where
    the caller has none."""
    if entry is None:
        docs, _ = documents(MESH_SERVE_DOCS)
        idx, fresh_idx = corpus(MESH_SERVE_DOCS, docs)
        entry = {"idx": idx, "docs": docs,
                 "qidx": np.concatenate([idx[:N_QUERY_INDEXED], fresh_idx])}
    return {"idx": entry["idx"][:MESH_SERVE_DOCS], "qidx": entry["qidx"],
            "docs": entry["docs"][:MESH_DEDUP_DOCS]}


def mesh_path(seed: int, report: dict, entry: dict | None = None) -> None:
    """Phase 14: the mesh paths over two ranks sharing the card (gloo).
    (a) llama3_2_1b at full width, float32, TF32 off: one step on one
    device, then the same step tensor parallel on (1, 2); (b) qwen3_moe at
    published widths, 2 layers, its own capacity factor: the expert-
    parallel and the FSDP forward on (1, 2) against one device's, tokens
    dropped; (c) llama widths at 1 layer, data
    parallel on (2, 1): ZeRO-1 off and on, and FSDP; (d) an elastic
    checkpoint at reduced widths (d_model 512, vocab 8192, 2 layers): a
    ZeRO-1 state saved on (2, 1), restored on (1, 2) and saved again, the
    files byte-equal to the one device's; (e) ``compressed_psum`` bf16 and
    int8 on CUDA tensors; (f) hymba_1_5b at its full published config: a
    step on one device, then on (1, 2), then prefill and decode on (1, 2)
    with the replicated attention cache; (g) falcon_mamba_7b,
    pixtral_12b and seamless_m4t_medium at published widths, 1 layer:
    steps (not pixtral's: 30 GB of state) and prefill + decode on (1, 2).
    (h) the entry points over the mesh (``_mesh_entry``): signing, the
    service and dedup on (2, 1), ``generate`` on (1, 2), each against one
    device, from ``entry``'s inputs (``entry_inputs``).
    In (a), (c), (f) and (g) each rank's gradients are held against one
    device's, and its parameters after the step; the grad norm must be
    the same on every rank.  (a)-(g) reach no kernel of the port but the
    selective scan; (h)
    launches the signing and query kernels on each rank.  The parent's
    counts (to the end of (g)) and each rank's, each set to 0 just before
    its part, summed."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.ranks import RankPool
    from repro_torch.models import build
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import make_train_step
    ks_all = kernels()
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    zero_counts(ks_all)
    _no_tf32()
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out: dict = {"card": card}
    pool = None
    rank_launches: list = []

    parts: dict = {}
    t_part = [time.perf_counter()]

    def part(name: str) -> None:
        """The seconds since the last part ended, as ``name``'s."""
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def run(fn, *args) -> list:
        """``fn(*args)`` on both ranks, their kernel counts kept."""
        res = pool.run(_mesh_rank, fn, *args)
        rank_launches.extend(r["launches"] for r in res)
        return res

    try:
        # --- the mesh path ---------------------------------------------------
        # (a) one device, then (1, 2) tensor parallel, full width
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
        tc = TrainConfig(learning_rate=MESH_LR, warmup_steps=0,
                         total_steps=TRAIN_STEPS)
        batch = next(token_batches(cfg.vocab_size_real, TRAIN_BATCH,
                                   TRAIN_SEQ, seed + 4))
        single, want = _one_device_step(cfg, tc, batch, seed, timed=True)
        t0 = time.perf_counter()
        pool = RankPool(2, device="cuda", timeout=MESH_TIMEOUT)
        boot_s = time.perf_counter() - t0
        ranks = run(_mesh_rank_step, cfg, tc, (1, 2), batch, seed, want,
                    True)
        del want
        _release_shared()
        rel = {k: max(abs(r[k] - single[k]) / abs(single[k]) for r in ranks)
               for k in ("loss", "grad_norm")}
        p_err = max(r["param_err"] for r in ranks)
        g_err = max(r["grad_err"] for r in ranks)
        _check_step("(a) (1, 2) tp", single, ranks)
        require(all(r["peak"] < single["peak"] for r in ranks),
                "each rank's peak below the one device's")
        require(all("mesh.all_gather.calls" not in r["counts"]
                    for r in ranks), "tensor parallel gathers no weight")
        print(f"[mesh] (a) {TRAIN_ARCH} full width ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}), float32, "
              f"TF32 off, batch {TRAIN_BATCH} x {TRAIN_SEQ}, lr "
              f"{single['lr']:.3e}, two gloo ranks on one card (boot "
              f"{boot_s:.1f} s); {card}")
        print(f"[mesh] (a) one device: loss {single['loss']:.6f}, grad norm "
              f"{single['grad_norm']:.6f}, step {single['step_ms']:.3f} ms "
              f"(CUDA events, the second step), peak {single['peak']} B")
        for i, r in enumerate(ranks):
            print(f"[mesh] (a) (1, 2) rank {i}: loss rel {abs(r['loss'] - single['loss']) / abs(single['loss']):.2e}, "
                  f"grad norm rel {abs(r['grad_norm'] - single['grad_norm']) / abs(single['grad_norm']):.2e}, "
                  f"gradients {r['grad_err']:.2e} of each leaf's largest "
                  f"(bound {MESH_GRAD_TOL:.0e}), "
                  f"largest parameter difference {r['param_err']:.2e} "
                  f"(2 x lr = {2 * single['lr']:.1e}); step "
                  f"{r['step_ms']:.3f} ms (host wall {r['wall_ms']:.3f}); "
                  f"peak {r['peak']} B; parameters + moments held "
                  f"{r['state_bytes']} B; a step's collectives: "
                  + _counts_line(r["timed_counts"]))
        out["tp"] = {"single": single, "ranks": ranks, "rel": rel,
                     "grad_err": g_err, "param_err": p_err,
                     "boot_s": boot_s}
        part("a")

        # (b) MoE forward at the config's own capacity factor: tokens drop
        out["moe"] = _mesh_moe(run, tmp, seed)
        part("b")

        # (c) data parallel on (2, 1), TRAIN_CUT_LAYERS layers
        cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
        one, want = _one_device_step(cut, tc, batch, seed, timed=False)
        out["dp"] = {"single": one}
        for mode, zero1 in (("tp", False), ("tp", True), ("fsdp", False)):
            ctc = dataclasses.replace(tc, sharding_mode=mode, zero1=zero1)
            t0 = time.perf_counter()
            dp = run(_mesh_rank_step, cut, ctc, (2, 1), batch, seed, want,
                     False)
            secs = time.perf_counter() - t0
            rel = {k: max(abs(r[k] - one[k]) / abs(one[k]) for r in dp)
                   for k in ("loss", "grad_norm")}
            err = max(r["param_err"] for r in dp)
            g_err = max(r["grad_err"] for r in dp)
            tag = f"{mode}{', ZeRO-1' if zero1 else ''}"
            _check_step(f"(c) (2, 1) {tag}", one, dp)
            print(f"[mesh] (c) (2, 1) {tag}, {TRAIN_CUT_LAYERS} layers at "
                  f"full width: loss rel {rel['loss']:.2e}, grad norm rel "
                  f"{rel['grad_norm']:.2e}, gradients {g_err:.2e}, "
                  f"parameters {err:.2e}; "
                  f"parameters + moments held {dp[0]['state_bytes']} B a "
                  f"rank; {secs:.1f} s; "
                  + _counts_line(dp[0]["counts"]))
            out["dp"][tag] = {"ranks": dp, "rel": rel, "grad_err": g_err,
                              "param_err": err, "seconds": secs}
        del want
        _release_shared()
        part("c")

        # (d) elastic checkpoint: (2, 1) -> (1, 2), bytes against one device
        small = dataclasses.replace(reduced(get_config(TRAIN_ARCH),
                                            d_model=512, vocab=8192),
                                    dtype="float32")
        ztc = dataclasses.replace(tc, zero1=True)
        sbatch = next(token_batches(small.vocab_size_real, TRAIN_BATCH,
                                    TRAIN_SEQ, seed + 6))
        a, b, c = (os.path.join(tmp, n) for n in ("ck_a", "ck_b", "ck_c"))
        saved = run(_mesh_rank_save, small, ztc, (2, 1), sbatch, seed, a)
        restored = run(_mesh_rank_restore, small, ztc, (1, 2), a, b, seed)
        host = build(small, device="cpu").init(seed)
        _, state = ckpt.restore_checkpoint(a, {
            "params": host, "opt": init_opt_state(host)})
        ckpt.save_checkpoint(c, 1, state)
        files = sorted(os.listdir(os.path.join(c, "step_00000001")))
        same = all(open(os.path.join(d, "step_00000001", f), "rb").read()
                   == open(os.path.join(c, "step_00000001", f), "rb").read()
                   for d in (a, b) for f in files)
        require(same and all(r["step"] == 1 for r in restored),
                "the (2, 1) save and its (1, 2) restore-and-save write the "
                "one device's files byte for byte")
        n_bytes = sum(os.path.getsize(os.path.join(c, "step_00000001", f))
                      for f in files)
        print(f"[mesh] (d) ZeRO-1 state of {TRAIN_ARCH} reduced (d_model "
              f"512, vocab 8192, 2 layers) saved on (2, 1) (each rank held "
              f"{saved[0]['moments_held']} moment elements a tree), "
              f"restored on (1, 2) in {restored[0]['restore_s']:.2f} s and "
              f"saved again: {len(files)} files, {n_bytes} B, byte-equal to "
              f"the one device's save")
        out["elastic"] = {"saved": saved, "restored": restored,
                          "files": len(files), "bytes": n_bytes}
        part("d")

        # (e) compressed psum on CUDA tensors
        g_all = np.random.default_rng(seed + 7).normal(
            size=(2, 256, 1024)).astype(np.float32)
        exact = g_all.sum(0)
        ps = run(_mesh_rank_psum, g_all, MESH_PSUM_STEPS)
        scale = np.abs(exact).max()
        bf16 = max(np.abs(r["bf16"] - exact).max() / scale for r in ps)
        int8 = max(np.abs(r["int8"][0] - exact).max() / scale for r in ps)
        mean = max(np.abs(np.mean(r["int8"], 0) - exact).max() / scale
                   for r in ps)
        require(bf16 < 0.05 and int8 < 0.05 and mean < 0.02
                and all(r["device"].startswith("cuda") for r in ps),
                f"compressed psum within its bounds ({bf16}, {int8}, {mean})")
        print(f"[mesh] (e) compressed_psum over 2 ranks, 256 x 1024 float32 "
              f"on the card: bf16 {bf16:.2e} relative (bound 0.05), int8 "
              f"{int8:.2e} a step (0.05), mean of {MESH_PSUM_STEPS} "
              f"error-feedback steps {mean:.2e} (0.02); "
              + _counts_line(ps[0]["counts"]))
        out["psum"] = {"bf16": float(bf16), "int8": float(int8),
                       "int8_mean": float(mean), "counts": ps[0]["counts"]}
        part("e")

        # (f) hymba_1_5b at full width, (g) three families cut in depth
        out["hybrid"] = _mesh_hybrid(run, tmp, tc, seed, card)
        part("f")
        out["families"] = _mesh_families(run, tmp, tc, seed)
        part("g")
        # (a)-(g) reach no kernel but the scan; the parent's counts stop
        # here, so that (h)'s one-device references do not count as the
        # mesh's launches
        parent = read_counts(ks_all)
        quiet = {n: parent[n] + sum(r[n] for r in rank_launches)
                 for n in ks_all}
        require(sum(quiet.values()) == quiet["ssm_scan"], "(a)-(g) launch "
                f"no kernel of the port but the scan, the parent's and both "
                f"ranks' counts summed ({quiet})")
        # (h) signing, the service, dedup and generate over the mesh
        out["entry"] = _mesh_entry(run, seed, entry_inputs(entry))
        part("h")
        # ---------------------------------------------------------------------
    finally:
        if pool is not None:
            pool.close()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {n: parent[n] + sum(r[n] for r in rank_launches)
                for n in ks_all}
    require(all(launches[n] > 0 for n in MESH_ENTRY_KERNELS),
            f"(h) launches every kernel of the signing and query paths on "
            f"the ranks ({launches})")
    out.update(launches=launches, launches_parent=parent,
               launches_ranks=rank_launches, parts_s=parts,
               wall_s=time.perf_counter() - t_phase)
    report["mesh_path"] = out
    print(f"[mesh] phase {out['wall_s']:.1f} s (" + _secs(parts)
          + f"); kernel launches {launches}")


def _mesh_moe(run, tmp: str, seed: int) -> dict:
    """Phase 14 (b): qwen3_moe at published widths, ``MESH_MOE_LAYERS``
    layers, float32, at its own capacity factor: one device's forward
    (its logits to ``tmp``, its dropped assignments counted), then the
    (1, 2) forward in ``tp`` (expert parallel) and ``fsdp`` on the ranks
    (``run``), each held against it."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    mcfg = dataclasses.replace(get_config(MESH_MOE_ARCH),
                               n_layers=MESH_MOE_LAYERS, dtype="float32")
    rng = np.random.default_rng(seed + 5)
    mbatch = {"tokens": rng.integers(0, mcfg.vocab_size_real, (
        MESH_MOE_ROWS, MESH_MOE_SEQ)).astype(np.int32)}
    bundle = build(mcfg, device="cuda")
    params = bundle.init(seed)
    n_moe = sum(p.numel() for p in params.parameters())
    with _CountDrops() as drops:
        np.save(os.path.join(tmp, "moe.npy"),
                bundle.forward(params, mbatch).cpu().numpy())
    del bundle, params
    torch.cuda.empty_cache()
    require(drops.n > 0, f"assignments dropped at capacity factor "
            f"{mcfg.capacity_factor} ({drops.n})")
    out = {"params": n_moe, "dropped": drops.n,
           "capacity_factor": mcfg.capacity_factor}
    n_assign = MESH_MOE_ROWS * MESH_MOE_SEQ * mcfg.top_k * MESH_MOE_LAYERS
    for mode in ("tp", "fsdp"):
        moe = run(_mesh_rank_moe, mcfg, mode, mbatch, seed,
                  os.path.join(tmp, "moe.npy"))
        errs = [r["err"] for r in moe]
        dropped = sum(r["dropped"] for r in moe)
        require(max(errs) < MESH_TOL, f"the (1, 2) {mode} MoE forward "
                f"within {MESH_TOL} of one device's ({errs})")
        require(dropped == drops.n, f"the (1, 2) {mode} ranks drop "
                f"{dropped} assignments, one device {drops.n}")
        print(f"[mesh] (b) {MESH_MOE_ARCH} (d_model {mcfg.d_model}, "
              f"{mcfg.n_experts} experts top-{mcfg.top_k}, d_ff "
              f"{mcfg.d_ff}, vocab {mcfg.vocab_size}, {MESH_MOE_LAYERS} "
              f"layers, float32, capacity factor "
              f"{mcfg.capacity_factor}) forward of {MESH_MOE_ROWS} x "
              f"{MESH_MOE_SEQ} on (1, 2) {mode}: largest logit "
              f"difference {max(errs):.2e} from one device; "
              f"{dropped} of {n_assign} assignments dropped (one "
              f"device {drops.n}); each rank holds {moe[0]['held']} of "
              f"{n_moe} parameters; "
              + _counts_line(moe[0]["counts"]))
        out[mode] = {"ranks": moe, "dropped": dropped}
    return out


def _mesh_hybrid(run, tmp: str, tc, seed: int, card: str) -> dict:
    """Phase 14 (f): hymba_1_5b at its full published config, one step on
    one device, then on (1, 2) (``run`` calls a function on both ranks);
    then prefill and decode on (1, 2) with the replicated attention
    cache."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    t0 = time.perf_counter()
    hcfg = dataclasses.replace(get_config(MESH_HYBRID_ARCH),
                               dtype="float32")
    hbatch = next(token_batches(hcfg.vocab_size_real, TRAIN_BATCH,
                                TRAIN_SEQ, seed + 8))
    hone, want = _one_device_step(hcfg, tc, hbatch, seed, timed=True,
                                  spread=True)
    t1 = time.perf_counter()
    hranks = run(_mesh_rank_step, hcfg, tc, (1, 2), hbatch, seed, want,
                 True)
    del want
    _release_shared()
    t2 = time.perf_counter()
    print(f"[mesh] (f) {MESH_HYBRID_ARCH} full width ({hcfg.n_layers} "
          f"layers, d_model {hcfg.d_model}, {hcfg.n_heads} heads / "
          f"{hcfg.n_kv_heads} KV, d_inner {hcfg.d_inner}, d_ff "
          f"{hcfg.d_ff}, vocab {hcfg.vocab_size}), float32, TF32 off, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, lr {hone['lr']:.3e}; "
          f"one device: loss {hone['loss']:.6f}, grad norm "
          f"{hone['grad_norm']:.6f}, step {hone['step_ms']:.3f} ms "
          f"(CUDA events, the second step), peak {hone['peak']} B, its "
          f"own float32 spread up to "
          f"{max(hone['grad_spread'].values()):.2e} of a leaf's largest "
          f"gradient (cap {MESH_SPREAD_CAP}; the whole batch against two "
          f"halves); {card}")
    for i, r in enumerate(hranks):
        print(f"[mesh] (f) (1, 2) rank {i}: " + _step_text(hone, r)
              + f"; step {r['step_ms']:.3f} ms (host wall "
              f"{r['wall_ms']:.3f}); peak {r['peak']} B; parameters + "
              f"moments held {r['state_bytes']} B; a step's "
              "collectives: " + _counts_line(r["timed_counts"]))
    print(f"[mesh] (f) gradients, each leaf kind's leaf nearest its bound "
          f"(the larger of {MESH_GRAD_TOL} and {MESH_SPREAD_K} x the leaf's "
          f"own one-device spread), error / bound of its largest: "
          + _leaf_pairs(hone, hranks))
    print("[mesh] (f) seconds: one device " + _secs(hone["secs"])
          + "; rank 0 " + _secs(hranks[0]["secs"]))
    _check_step("(f) (1, 2) tp", hone, hranks)
    require(all(r["peak"] < hone["peak"] for r in hranks),
            "(f) each rank's peak below the one device's")
    rng = np.random.default_rng(seed + 9)
    dbatch = _mesh_family_batch(hcfg, TRAIN_BATCH, MESH_PROMPT, seed + 9)
    feed = rng.integers(0, hcfg.vocab_size_real, (
        MESH_HYBRID_DECODE, TRAIN_BATCH)).astype(np.int32)
    want = os.path.join(tmp, "f_serve.pt")
    n_h = _one_device_serve(hcfg, dbatch, feed, seed, 2, want, False)
    require(n_h == MESH_HYBRID_PARAMS, f"(f) {MESH_HYBRID_ARCH} has "
            f"{MESH_HYBRID_PARAMS} parameters ({n_h})")
    hserve = run(_mesh_rank_serve, hcfg, (1, 2), dbatch, feed, seed,
                 want)
    _check_serve("(f)", hserve)
    require(all(r["heads"] == hcfg.n_kv_heads for r in hserve),
            "(f) each rank holds the whole attention cache (5 KV heads "
            "do not split over 2)")
    print(_serve_line(f"(f) {MESH_HYBRID_ARCH} prefill {TRAIN_BATCH} x "
                      f"{MESH_PROMPT}", hserve, n_h, feed))
    print(f"[mesh] (f) seconds: one device {t1 - t0:.1f}, the ranks' steps "
          f"{t2 - t1:.1f}, decode {time.perf_counter() - t2:.1f}")
    return {"single": hone, "ranks": hranks, "serve": hserve, "params": n_h,
            "seconds": time.perf_counter() - t0}


def _mesh_families(run, tmp: str, tc, seed: int) -> dict:
    """Phase 14 (g): falcon_mamba_7b, pixtral_12b and seamless_m4t_medium
    at published widths, depth cut to MESH_FAMILY_LAYERS: their steps
    (not pixtral's) and prefill + decode on (1, 2)."""
    from repro_torch.configs import get_config
    out: dict = {}
    for arch, modes in (("falcon_mamba_7b", ("tp", "fsdp")),
                        ("pixtral_12b", ()),
                        ("seamless_m4t_medium", ("tp",))):
        t0 = time.perf_counter()
        gcfg = get_config(arch)
        gcfg = dataclasses.replace(
            gcfg, n_layers=MESH_FAMILY_LAYERS, dtype="float32",
            n_enc_layers=MESH_FAMILY_LAYERS if gcfg.is_encdec else 0)
        depth = f"{MESH_FAMILY_LAYERS} layer" + \
            ("s" if MESH_FAMILY_LAYERS > 1 else "")
        fam: dict = {}
        if modes:
            gbatch = _mesh_family_batch(gcfg, TRAIN_BATCH, TRAIN_SEQ,
                                        seed + 10)
            gone, want = _one_device_step(gcfg, tc, gbatch, seed,
                                          timed=False)
            for mode in modes:
                gtc = dataclasses.replace(tc, sharding_mode=mode)
                gr = run(_mesh_rank_step, gcfg, gtc, (1, 2), gbatch,
                         seed, want, False)
                _check_step(f"(g) {arch} (1, 2) {mode}", gone, gr)
                print(f"[mesh] (g) {arch} ({depth} at full width) (1, 2) "
                      f"{mode} step: "
                      + _step_text(gone, gr[0]) + "; parameters + "
                      f"moments held {gr[0]['state_bytes']} B a rank; "
                      + _counts_line(gr[0]["counts"]))
                fam[mode] = gr
            del want
            _release_shared()
        rng = np.random.default_rng(seed + 11)
        dbatch = _mesh_family_batch(gcfg, TRAIN_BATCH, MESH_PROMPT,
                                    seed + 11)
        feed = rng.integers(0, gcfg.vocab_size_real, (
            MESH_FAMILY_DECODE, TRAIN_BATCH)).astype(np.int32)
        want = os.path.join(tmp, "g_serve.pt")
        n_g = _one_device_serve(gcfg, dbatch, feed, seed, 2, want,
                                gcfg.frontend == "patches")
        gs = run(_mesh_rank_serve, gcfg, (1, 2), dbatch, feed, seed,
                 want)
        _check_serve(f"(g) {arch}", gs)
        os.remove(want)
        print(_serve_line(f"(g) {arch} ({depth}"
                          f"{' a side' if gcfg.is_encdec else ''}) "
                          f"prefill {TRAIN_BATCH} x {MESH_PROMPT}", gs,
                          n_g, feed)
              + f"; {time.perf_counter() - t0:.1f} s")
        fam.update(serve=gs, params=n_g,
                   seconds=time.perf_counter() - t0)
        out[arch] = fam
    return out


def _one_device_generate(cfg, prompts, seed, n_new) -> dict:
    """Phase 14 (h): greedy decoding of ``prompts`` on one device of the
    card from ``seed``'s weights, as ``generate`` decodes them, with each
    row's smallest top-2 logit gap over the steps; frees the card."""
    from repro_torch.models import build
    from repro_torch.serve.decode import sample_token
    bundle = build(cfg, device="cuda")
    params = bundle.init(seed)
    toks, gaps = [], []
    with torch.no_grad():
        logits, cache = bundle.prefill(
            params, {"tokens": prompts}, max_len=prompts.shape[1] + n_new)
        for step in range(n_new):
            top2 = logits.float().topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            toks.append(sample_token(logits, None, 0.0))
            if step < n_new - 1:
                logits, cache = bundle.decode_step(params, cache, toks[-1])
    out = {"tokens": torch.stack(toks, 1).cpu().numpy(),
           "gap": torch.stack(gaps, 1).min(1).values.cpu().numpy()}
    del bundle, params, cache, logits
    torch.cuda.empty_cache()
    return out


def _mesh_entry(run, seed: int, entry: dict) -> dict:
    """Phase 14 (h): the entry points over a mesh, against one device on
    the card.  On (2, 1): signing of the main sparse batch, BATCH dense
    rows of D = 2^16 and BATCH int8 rows of D = PAPER_D; the in-process
    service over MESH_SERVE_DOCS documents and the query batch;
    ``dedup_corpus`` of MESH_DEDUP_DOCS documents.  On (1, 2): greedy
    ``generate`` of llama3_2_1b at full width, float32.  ``run`` calls a
    function on both ranks (their kernel counts kept); each rank's kernel
    counts of the part are returned as ``launches``."""
    from repro_torch.configs import get_config
    from repro_torch.data.dedup import DedupConfig, dedup_corpus
    idx, qidx, docs = entry["idx"], entry["qidx"], entry["docs"]
    int8_rows = _entry_int8_rows(seed + 12)

    def one_device() -> tuple[dict, float]:
        t0 = time.perf_counter()
        want = _entry_sign(_entry_engines(None), idx, int8_rows)
        want["ids"], want["scores"] = _entry_serve(None, idx, qidx)
        want["keep"] = dedup_corpus(docs, DedupConfig(), device="cuda").keep
        return want, time.perf_counter() - t0

    # the one device's answers are computed in a thread while the ranks
    # compute theirs: the two share the card and the host's cores
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(one_device)
        ranks = run(_mesh_rank_entry, (2, 1), torch.from_numpy(idx), qidx,
                    torch.from_numpy(np.stack(docs)),
                    torch.from_numpy(int8_rows))
        want, one_s = fut.result()
    ranks_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for i, r in enumerate(ranks):
        for key in ("sparse", "dense", "int8", "ids", "scores", "keep"):
            require(np.array_equal(r[key], want[key]),
                    f"(h) rank {i}'s {key} equal one device's")
        kc = r["kernel_counters"]
        require(kc.get("kernel.sparse.cuda", 0) > 0
                and kc.get("kernel.dense.int8.cuda", 0) > 0
                and kc.get("kernel.dense.packed.cuda", 0) > 0,
                f"(h) rank {i} signs through the kernels on the card ({kc})")
        require(all(r["launches"][n] > 0 for n in MESH_ENTRY_KERNELS),
                f"(h) rank {i} launches every kernel of its path "
                f"({r['launches']})")
        require(r["sign_counts"] == {
            "mesh.all_gather.calls": 3,
            "mesh.all_gather.bytes": sum(want[k].nbytes for k in
                                         ("sparse", "dense", "int8")) // 2},
            f"(h) one all-gather of the rank's words a signing call "
            f"({r['sign_counts']})")
    print(f"[mesh] (h) signing over (2, 1): the main sparse batch "
          f"{idx[:BATCH].shape} and {BATCH} x {1 << 16} int8 dense rows "
          f"(b = 32 words), {BATCH} x {PAPER_D} int8 rows (raw): each "
          f"rank's words equal one device's; the service over "
          f"{len(idx)} documents, {len(qidx)} queries: "
          f"ids and scores equal; dedup of {len(docs)} documents: keep "
          f"({len(want['keep'])}) equal; rank 0 "
          + ", ".join(f"{k} {v:.2f} s" for k, v in ranks[0]["secs"].items())
          + f" (one device {one_s:.1f} s in all, beside the ranks' "
          f"{ranks_s:.1f} s); rank 0's launches "
          f"{ranks[0]['launches']}; registry "
          f"{ranks[0]['kernel_counters']}; "
          + _counts_line(ranks[0]["counts"]))
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype="float32")
    prompts = np.random.default_rng(seed + 13).integers(
        0, cfg.vocab_size_real, (TRAIN_BATCH, MESH_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    one = _one_device_generate(cfg, prompts, seed, MESH_GEN_NEW)
    gen = run(_mesh_rank_generate, cfg, (1, 2), prompts, seed, MESH_GEN_NEW)
    gen_s = time.perf_counter() - t0
    held = one["gap"] > MESH_GEN_GAP
    for i, r in enumerate(gen):
        require(r["tokens"].shape == one["tokens"].shape
                and np.array_equal(r["tokens"][held], one["tokens"][held]),
                f"(h) rank {i}'s generated tokens equal one device's on "
                f"the {int(held.sum())} rows whose top-2 gap exceeds "
                f"{MESH_GEN_GAP}")
        require("mesh.all_gather.calls" in r["counts"],
                "(h) generate gathers the vocab-split logits")
    same = [int((r["tokens"] == one["tokens"]).all(1).sum()) for r in gen]
    print(f"[mesh] (h) generate {TRAIN_ARCH} at full width, float32, "
          f"{TRAIN_BATCH} x {MESH_PROMPT} prompts, {MESH_GEN_NEW} greedy "
          f"tokens on (1, 2): {int(held.sum())} of {TRAIN_BATCH} rows with "
          f"every step's one-device top-2 gap above {MESH_GEN_GAP} (smallest "
          f"gap {float(one['gap'].min()):.3e}; {int((~held).sum())} rows "
          f"under it), held token for token; rows equal to one device's "
          f"on each rank: {same}; generate {gen[0]['seconds']:.2f} s on "
          f"rank 0 (host wall); " + _counts_line(gen[0]["counts"]))
    keep = ("secs", "sign_counts", "counts", "kernel_counters", "launches")
    return {"ranks": [{k: r[k] for k in keep} for r in ranks],
            "generate": [{k: g[k] for k in ("seconds", "counts", "launches")}
                         for g in gen],
            "rows_equal": same, "one_device_s": one_s,
            "ranks_s": ranks_s, "generate_s": gen_s,
            "held_rows": int(held.sum()), "min_gap": float(one["gap"].min()),
            "launches": [{n: r["launches"][n] + g["launches"][n]
                          for n in r["launches"]}
                         for r, g in zip(ranks, gen)]}


def _release_shared() -> None:
    """Free the card's memory of tensors the ranks were handed and have
    dropped (``_one_device_step``'s), and the cache."""
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def _one_device_step(cfg, tc, batch, seed, timed, spread: bool = False
                     ) -> tuple[dict, dict]:
    """One ``make_train_step`` step of ``cfg`` on one device of the card
    from ``seed``'s weights.  Returns its results and, kept on the card
    for the ranks (the caller passes them to ``_mesh_rank_step``, the
    pool's pipe shares them, then drops them), the loss's gradients at
    those weights (``"grads"``) and the parameters after the step
    (``"params"``); the peak leaves those out.  With ``timed``, a second
    step timed with CUDA events.  With ``spread``, the one device's own
    float32 spread of each leaf's gradients (``grad_spread``): relative
    to the leaf's largest gradient, the largest difference between the
    whole batch's gradients and the mean of two halves' (the same
    function summed in another order), over two splits of the rows
    (first and second half; even and odd).  Frees the rest of the card."""
    from repro_torch.models import build
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import loss_and_grads, make_train_step
    secs: dict = {}
    t0 = time.perf_counter()
    bundle = build(cfg, device="cuda")
    params = bundle.init(seed)
    opt = init_opt_state(params)
    _, _, grads = loss_and_grads(bundle, params, batch)
    names = [n for n, _ in params.named_parameters()]
    out: dict = {"secs": secs}
    torch.cuda.synchronize()
    secs["grads"] = time.perf_counter() - t0
    if spread:
        n = len(batch["tokens"])
        out["grad_spread"] = dict.fromkeys(names, 0.0)
        for split in ((slice(0, n // 2), slice(n // 2, n)),
                      (slice(0, n, 2), slice(1, n, 2))):
            parts = [loss_and_grads(bundle, params,
                                    {k: v[s] for k, v in batch.items()})[2]
                     for s in split]
            for name, g, a, b in zip(names, grads, *parts, strict=True):
                err = float(((a + b) / 2 - g).abs().max()) \
                    / max(float(g.abs().max()), 1e-30)
                out["grad_spread"][name] = max(out["grad_spread"][name], err)
            del parts
        torch.cuda.synchronize()
        secs["spread"] = time.perf_counter() - t0 - secs["grads"]
    t0 = time.perf_counter()
    want = {"grads": dict(zip(names, grads, strict=True))}
    held = sum(g.numel() * g.element_size() for g in grads)
    del grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(bundle, tc)
    params, opt, m = step(params, opt, batch)
    out.update({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    want["params"] = {n: p.detach().clone()
                      for n, p in params.named_parameters()}
    held += sum(p.numel() * p.element_size()
                for p in want["params"].values())
    secs["step"] = time.perf_counter() - t0
    if timed:
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        out["step_ms"] = start.elapsed_time(end)
        peak = max(peak, torch.cuda.max_memory_allocated() - held)
    out["peak"] = peak
    del bundle, params, opt, step, m
    torch.cuda.empty_cache()
    return out, want


def _one_device_serve(cfg, batch, feed, seed, tp, path, forward: bool
                      ) -> int:
    """Phase 14 (f), (g): ``seed``'s weights on one device of the card:
    the forward (``forward``), prefill with ``tp`` and teacher-forced
    decode steps of ``feed``, to ``path`` for the ranks to hold theirs
    against; frees the card.  Returns the parameter count."""
    from repro_torch.models import build
    bundle = build(cfg, device="cuda")
    params = bundle.init(seed)
    want: dict = {}
    if forward:
        want["forward"] = bundle.forward(params, batch).cpu()
    logits, cache = bundle.prefill(params, batch, tp=tp,
                                   max_len=batch["tokens"].shape[1]
                                   + len(feed))
    want["logits"] = [logits.cpu()]
    for tok in feed:
        logits, cache = bundle.decode_step(params, cache, tok)
        want["logits"].append(logits.cpu())
    want["cache"] = {k: v.cpu() for k, v in cache.items()}
    torch.save(want, path)
    n = sum(p.numel() for p in params.parameters())
    del bundle, params, cache, logits, want
    torch.cuda.empty_cache()
    return n


def _mesh_family_batch(cfg, rows, seq, seed) -> dict:
    """Tokens from ``seed``, with seamless's frames or pixtral's patch
    prefix."""
    from repro_torch.data.synthetic import token_batches
    rng = np.random.default_rng(seed)
    batch = next(token_batches(cfg.vocab_size_real, rows, seq, seed))
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(rows, MESH_FRAMES, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.normal(size=(rows, MESH_PATCHES, cfg.d_model)
                                      ).astype(np.float32)
    return batch


def _serve_line(tag: str, ranks: list, n_params: int, feed) -> str:
    heads = ranks[0]["heads"]
    cache = {k: max(r["cache_err"][k] for r in ranks)
             for k in ranks[0]["cache_err"]}
    fwd = [r["forward_err"] for r in ranks if "forward_err" in r]
    return (f"[mesh] {tag} on (1, 2): "
            + (f"forward {max(fwd):.2e}, " if fwd else "")
            + f"prefill + {len(feed)} teacher-forced decode logits "
            f"{max(r['logit_err'] for r in ranks):.2e} from one device; "
            "cache blocks " + ", ".join(f"{k} {v:.2e}" for k, v in
                                        sorted(cache.items()))
            + (f"; attention cache {heads} KV heads a rank" if heads
               else "")
            + f"; each rank holds {ranks[0]['held']} of {n_params} "
            f"parameters; prefill {ranks[0]['prefill_ms']:.1f} ms, decode "
            f"{ranks[0]['decode_ms']:.1f} ms a step (host wall); "
            + _counts_line(ranks[0]["counts"]))


def _check_serve(tag: str, ranks: list) -> None:
    errs = [r["logit_err"] for r in ranks] + [
        r.get("forward_err", 0.0) for r in ranks] + [
        v for r in ranks for v in r["cache_err"].values()]
    require(max(errs) < MESH_TOL, f"{tag}: forward, prefill and decode "
            f"logits and every cache block within {MESH_TOL} of one "
            f"device's ({ranks})")


# -- phase 15: the autotuner and the dry run ---------------------------------

TUNE_STREAM_ROWS = 8          # a stream batch: 7 queries padded to 8
TUNE_STREAM_FALLBACK = 4      # the stream's fallback rows
TUNE_REPS = 20                # device timings of the default and the winner
DRYRUN_CELL = ("llama3_2_1b", "decode_32k", "single")


def tune_shapes(report: dict) -> list[tuple]:
    """(label, kind, B, D, K, nnz) of each sweep, as the autotuner keys
    them: the main path's shapes (its 4096-document sparse batch, the
    1088-row query batch's fold and probe, the fallback's rows against the
    whole index), the stream's (8 documents, 8 queries, 4 fallback rows)
    and the dense path's 4096 x 2^16 rows."""
    from repro_torch.kernels.packfmt import pack_geometry
    from repro_torch.serve.search import SearchConfig
    cfg = SearchConfig()
    main = report["main_path"]
    nnz = next(r for r in report["kernels"]
               if r["name"] == "cminhash_sparse")["shape"][1]
    words = pack_geometry(cfg.k, cfg.b)[1]
    per_band = words // cfg.n_bands
    q_fb = 1 << (main["fallback_rows"] - 1).bit_length()
    ns, w, docs = main["n_slots"], main["bucket_width"], main["docs"]
    rows = main["query_rows"]
    return [
        ("main", "sparse", BATCH, cfg.d, cfg.k, nnz),
        ("stream", "sparse", TUNE_STREAM_ROWS, cfg.d, cfg.k, nnz),
        ("main", "fold", rows, cfg.n_bands, per_band, 0),
        ("stream", "fold", TUNE_STREAM_ROWS, cfg.n_bands, per_band, 0),
        ("main", "probe", rows * cfg.n_bands, ns, w, 0),
        ("stream", "probe", TUNE_STREAM_ROWS * cfg.n_bands, ns, w, 0),
        ("main", "collision", q_fb, docs, words, 0),
        ("stream", "collision", TUNE_STREAM_FALLBACK, docs, words, 0),
        ("dense", "dense_rows", BATCH, cfg.d, cfg.k, nnz),
        ("dense", "dense_bits", BATCH, cfg.d, cfg.k, nnz),
    ]


_POPCOUNT = [bin(i).count("1") for i in range(256)]


def tune_work(kind: str, runner, k: int) -> tuple[float, float]:
    """(bytes, operations) of one launch of ``kind`` on the runner's
    inputs, counted as phases 3 and 8 count them."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import lsh_probe as kp
    x = runner.inputs
    if kind == "sparse":
        idx, pi = x["idx"], x["pi"]
        n_valid = int((idx >= 0).sum().item())
        return (idx.numel() * 4 + pi.numel() * 4 + idx.shape[0] * k * 4,
                n_valid * k)
    if kind in ("dense_rows", "dense_bits"):
        if kind == "dense_rows":
            v = x["v"]
            b, d, set_bits = v.shape[0], v.shape[1], int((v > 0).sum().item())
        else:
            words = x["words"]
            pop = torch.tensor(_POPCOUNT, device=words.device)
            b, d = words.shape[0], x["pi"].numel()
            set_bits = int(pop[words.view(torch.uint8).long()].sum().item())
        r = roofline.cminhash_kernel_roofline(
            b, d, k, nnz=set_bits / b, packed=kind == "dense_bits")
        return r["bytes"], r["ops"]
    if kind == "fold":
        rows = x["rows"]
        return (rows.numel() * 4 + rows.shape[0] * rows.shape[1] * 8,
                rows.numel() * 5)
    if kind == "probe":
        records, hashes = x["records"], x["hashes"]
        w, e = records.shape[1] - 2, hashes.numel()
        ns = records.shape[0] // hashes.shape[1]
        walk = probe_walk(records, kp.hash_operands(hashes, ns), ns,
                          autotune.PROBE_DEPTH)
        return (e * 8 + walk["probe_steps"] * 8 + walk["hits"] * w * 4
                + e * w * 4, walk["probe_steps"] * 3)
    wq, wn = x["words_q"], x["words_n"]
    q, n, nw = wq.shape[0], wn.shape[0], wq.shape[1]
    return (q + n) * nw * 4 + q * n * 4, collision_ops(q, n, nw, 32)


def tune_path(report: dict) -> None:
    """Phase 15: the autotuner on the card, then the dry run.

    Phases 1-14 ran with no cache (``$REPRO_AUTOTUNE_CACHE`` unset, the
    in-process cache cleared at the start): every resolution returned the
    default, so they launched the geometry each kernel had before it took
    a knob.  Here, with the cache at a temporary file: ``measure`` (default
    sweeps, the default duelled) of each kind at ``tune_shapes``, counted
    as this path's launches; each winner launched again and held against
    its plain version on the same inputs (tolerance 0), timed on the
    device beside the default and the bound; ``recommend`` in a fresh
    process reads the winners back from the file; then the dry run of one
    cell in a subprocess (a fake 256-rank group on the CPU)."""
    from repro_torch.kernels import autotune
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.default()
    hits = reg.counter("autotune.hit").value
    resolved = reg.counter("autotune.heuristic").value
    print(f"[tune] phases 1-14: {resolved} launch geometries resolved to "
          f"the default, {hits} from a cache")
    require(hits == 0 and resolved > 0,
            "phases 1-14 launch the default geometry (no autotune cache)")
    ks = kernels()
    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    path = os.path.join(tmp, "autotune.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env[autotune.CACHE_ENV] = path
    os.environ[autotune.CACHE_ENV] = path
    rows = []
    try:
        shapes = tune_shapes(report)
        zero_counts(ks)
        # --- the tune path: default sweeps, the winners cached in the file
        t0 = time.perf_counter()
        winners = [autotune.measure(kind, b, d, k, backend="cuda", nnz=nnz)
                   for _, kind, b, d, k, nnz in shapes]
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = read_counts(ks)
        # --------------------------------------------------------------------
        for (label, kind, b, d, k, nnz), best in zip(shapes, winners):
            runner = autotune._make_runner(kind, b, d, k, nnz, 0, "cuda")
            got = runner(best)()
            want = runner.plain()
            err = max_abs_err(got, want)
            require(err == 0.0 and torch.equal(got, want),
                    f"tuned {kind} {best} at {label}: kernel != plain "
                    f"version (max abs err {err})")
            dflt = autotune.default(kind, b, d, k)
            win_ms = time_ms(runner(best), TUNE_REPS, spin=True)
            def_ms = win_ms if best == dflt else time_ms(
                runner(dflt), TUNE_REPS, spin=True)
            b_ms, b_by = bound_ms(*tune_work(kind, runner, k))
            rows.append({"label": label, "kind": kind, "shape": [b, d, k],
                         "nnz": nnz, "winner": best, "default": dflt,
                         "winner_device_ms": win_ms,
                         "default_device_ms": def_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "max_abs_err": err})
            print(f"[tune] {label} {kind} B={b} D={d} K={k}"
                  + (f" nnz={nnz}" if nnz else "") + f": winner {best} "
                  f"{fmt_ms(win_ms)} ms on the device, default {dflt} "
                  f"{fmt_ms(def_ms)} ms, bound {b_ms:.4f} ms by {b_by}; "
                  "equal to the plain version")
            del runner, got, want
            torch.cuda.empty_cache()
        code = ("import json, sys\n"
                "from repro_torch.kernels import autotune\n"
                "print(json.dumps([autotune.recommend(kind, b, d, k, "
                "backend='cuda', nnz=nnz) for _, kind, b, d, k, nnz in "
                "json.loads(sys.argv[1])]))")
        p = subprocess.run([sys.executable, "-c", code, json.dumps(shapes)],
                           env=env, capture_output=True, text=True,
                           timeout=120)
        require(p.returncode == 0, f"recommend in a fresh process:\n"
                f"{p.stdout}{p.stderr}")
        read_back = json.loads(p.stdout.splitlines()[-1])
        require(read_back == winners,
                f"recommend() in a fresh process returns the winners from "
                f"the cache file ({read_back} vs {winners})")
        with open(path) as f:
            n_entries = len(json.load(f))
        print(f"[tune] {len(shapes)} sweeps in {sweep_s:.2f} s, launches "
              f"{launches}; a fresh process's recommend() read the "
              f"{n_entries} winners back from the cache file")
        arch, shape, mesh = DRYRUN_CELL
        out = os.path.join(tmp, "dryrun")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", out],
            env=env, capture_output=True, text=True, timeout=300)
        dry_s = time.perf_counter() - t0
        require(p.returncode == 0, f"dry run:\n{p.stdout}{p.stderr}")
        with open(os.path.join(out, f"single_pod__{arch}__{shape}.json")) as f:
            rec = json.load(f)
        require(rec["status"] == "ok",
                f"dry run cell: {rec.get('traceback', rec.get('error'))}")
        hc = rec["hlo_cost"]
        print(f"[dryrun] single_pod {arch} {shape}: {hc['flops']:.6e} flops, "
              f"{hc['bytes']:.6e} bytes, {hc['collective_bytes']:.6e} "
              f"collective bytes a rank of {rec['n_chips']}; argument "
              f"bytes {rec['memory']['argument_bytes']}; status ok in "
              f"{dry_s:.1f} s")
    finally:
        os.environ.pop(autotune.CACHE_ENV, None)
        autotune.clear_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_all
    report["tune_path"] = {"launches": launches, "rows": rows,
                           "sweep_s": sweep_s, "seconds": secs,
                           "dryrun": {"cell": list(DRYRUN_CELL),
                                      "seconds": dry_s,
                                      "n_chips": rec["n_chips"],
                                      "hlo_cost": hc,
                                      "memory": rec["memory"]}}
    print(f"[tune] phase 15 {secs:.1f} s")


PLACEMENTS = {0: "uint16 shared", 1: "int32 global", 2: "uint16 pairs"}
SIGNING = ("cminhash_sparse", "cminhash_dense", "cminhash_packed")
# The earlier collision interface: unpacked int32 codes, (a, b, out, Q, N, K)
UNPACKED_COLLISION_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
# The earlier probe interface: (records, (E, 5) operand rows, out, E,
# n_slots, max_probes, W)
OPERAND_ROW_PROBE_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 3)
QUERY_SOURCES = ("fold", "lsh_probe")
# Each source's launch knobs (kernels/autotune.py), by the parameter that
# names the first of them in its C entry, and their count: a baseline
# source without it predates them.
KNOBS = {"cminhash_sparse": ("int placement", 1),
         "cminhash_dense": ("int placement", 1),
         "cminhash_packed": ("int placement", 1),
         "collision": ("int block_q", 1), "fold": ("int threads", 1),
         "lsh_probe": ("int group", 2)}


def has_knobs(baseline: str, name: str) -> bool:
    with open(os.path.join(baseline, "src", "repro_torch", "csrc",
                           f"{name}.cu")) as f:
        return KNOBS[name][0] in f.read()


class EarlierKernel:
    """A baseline library whose C entry takes no launch knobs, behind the
    current wrapper: bound with its own arguments, the wrapper's trailing
    knob arguments dropped."""

    def __init__(self, name: str, argtypes: list, library: str):
        from repro_torch.kernels import _build
        self.n = KNOBS[name][1]
        self.kernel = _build.CudaKernel(name, argtypes[:-self.n],
                                        library=library)

    def launch(self, device, *args) -> None:
        self.kernel.launch(device, *args[:-self.n])


def build_baseline(baseline: str, names) -> dict[str, str]:
    """Build ``names`` from DIR/src/repro_torch/csrc with the port's flags,
    one nvcc each, all started together -> {name: library path}."""
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "src", "repro_torch", "build", "baseline")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(baseline, "src", "repro_torch", "csrc")
    libs = {name: os.path.join(out_dir, f"lib{name}.so") for name in names}
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", libs[name],
         os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in names}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc baseline {name}:\n{log}")
    return libs


def collision_sass(report: dict) -> None:
    """The count loop of the b = 32 collision kernel (16-byte copies) in
    SASS: the instructions between the two barriers around one staged
    chunk, by opcode, and how many there are a compare (a pair of codes:
    an ``ISETP``).  A thread makes 512 compares a chunk (4 x 4 pairs of
    rows x 32 words); ptxas may schedule a few of them past the barrier.
    The whole listing goes to ``chiprun_out/collision.sass``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        "collision"))], capture_output=True, text=True, timeout=300,
        check=True).stdout
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "collision.sass"), "w") as f:
        f.write(sass)
    body = next(f for f in re.split(r"\n\s+Function : ", sass)
                if "CodeCountELi4ELi16E" in f.split("\n", 1)[0])
    ops = [m.group(2) for m in (re.match(
        r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        for line in body.splitlines()) if m]
    bars = [i for i, op in enumerate(ops) if op.startswith("BAR.SYNC")]
    seg = max((ops[i0 + 1: i1] for i0, i1 in zip(bars, bars[1:])),
              key=lambda x: sum(op == "FADD" for op in x))
    hist: dict = {}
    for op in seg:
        hist[op.split(".")[0]] = hist.get(op.split(".")[0], 0) + 1
    pairs = hist.get("ISETP", 0)
    report["collision_sass"] = {
        "compares_in_segment": pairs, "compares_per_chunk": 512,
        "instructions": len(seg), "per_compare": len(seg) / pairs,
        "opcodes": hist,
        "integer_pipe_per_compare": sum(v for k, v in hist.items() if k in (
            "ISETP", "IADD3", "LOP3", "SHF", "LEA", "SEL", "POPC", "VIADD",
            "IMNMX")) / pairs}
    print(f"[sass] collision count loop (b = 32, 16-byte copies): "
          f"{len(seg)} instructions for {pairs} of a chunk's 512 compares, "
          f"{len(seg) / pairs:.3f} a compare; "
          + ", ".join(f"{k} {v}" for k, v in sorted(
              hist.items(), key=lambda kv: -kv[1])[:8]))


def compare(baseline: str | None, report: dict) -> None:
    """``--compare``: the three signing kernels and the collision kernel
    through their wrappers.  Each signing kernel runs with the per-call
    placement and with each placement forced through the libraries' test
    entry point (``<name>_force_placement``); with ``--baseline DIR``, each
    of the four also runs bound to a build of DIR's source behind the same
    wrapper (a DIR collision.cu with the earlier unpacked interface is
    called as the earlier ``ops.packed_collision_counts`` called it: unpacked
    in blocks of 16,384 index rows, one launch each, then concatenated).
    Each variant is checked against the plain version, then timed in turns
    (forward, then reverse order; the median of each variant's per-round
    medians), with the host's launch work (``ms``) and without
    (``device_ms``).  Then the sparse kernel's time against the batch size
    (the slope is a document's work, the intercept what a launch costs),
    and the collision kernel's count loop in SASS."""
    import contextlib

    from repro_torch.core.permutations import (apply_permutation_dense,
                                               apply_permutation_sparse,
                                               make_two_permutations)
    from repro_torch.data.synthetic import imagelike_binary_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import cminhash_kernel as kd
    from repro_torch.kernels import cminhash_packed as kpk
    from repro_torch.kernels import cminhash_sparse as ks
    from repro_torch.kernels import collision_kernel as kc
    from repro_torch.kernels.packfmt import unpack_codes
    dev = torch.device("cuda")
    mods = {"cminhash_sparse": ks, "cminhash_dense": kd,
            "cminhash_packed": kpk, "collision": kc}
    base, unpacked_abi, query_libs = {}, False, {}
    if baseline:
        with open(os.path.join(baseline, "src", "repro_torch", "csrc",
                               "collision.cu")) as f:
            unpacked_abi = "int bits" not in f.read()
        libs = build_baseline(baseline, [*mods, *QUERY_SOURCES])
        query_libs = {n: libs.pop(n) for n in QUERY_SOURCES}
        for name, path in libs.items():
            if name == "collision" and unpacked_abi:
                base[name] = _build.CudaKernel(
                    name, UNPACKED_COLLISION_ARGS, library=path)
            elif not has_knobs(baseline, name):
                base[name] = EarlierKernel(name, mods[name].KERNEL.argtypes,
                                           path)
            else:
                base[name] = _build.CudaKernel(
                    name, mods[name].KERNEL.argtypes, library=path)

    @contextlib.contextmanager
    def variant(name, label):
        """The wrapper of ``name`` launching ``label``'s kernel."""
        mod = mods[name]
        current = mod.KERNEL
        force = (current.entry("force_placement", [ctypes.c_int])
                 if name in SIGNING else (lambda p: None))
        place = {v: k for k, v in PLACEMENTS.items()}.get(label, -1)
        if label == "baseline" and not (name == "collision" and unpacked_abi):
            mod.KERNEL = base[name]
        force(place)
        try:
            yield
        finally:
            force(-1)
            mod.KERNEL = current

    def unpacked_counts(a, b):
        """The earlier wrapper on the baseline's unpacked collision kernel."""
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                          device=dev)
        base["collision"].launch(dev, _build.ptr(a), _build.ptr(b),
                                 _build.ptr(out), a.shape[0], b.shape[0],
                                 a.shape[1])
        return out

    def collision_call(label, wq, wn, k, b):
        if label == "baseline" and unpacked_abi:
            uq = unpack_codes(wq, k, b).contiguous()
            return torch.cat([unpacked_counts(uq, unpack_codes(
                wn[lo: lo + 16384], k, b).contiguous())
                for lo in range(0, wn.shape[0], 16384)], dim=1)
        return kc.packed_collision_counts_kernel(wq, wn, k, b)

    # the serving batch: 4096 documents of the serving corpus, signed with
    # a seeded sigma/pi at D = 2^16, K = 256, b = 32; imageA at Fig. 7's D
    # and K, with the permutations phase 7 draws for each K; the serving
    # batch as dense int8 rows and as bit-packed words
    idx, _ = corpus(BATCH)
    sigma, pi = make_two_permutations(torch.Generator().manual_seed(0),
                                      1 << 16, device=dev)
    sidx = apply_permutation_sparse(torch.tensor(idx, device=dev),
                                    sigma).to(torch.int32).contiguous()
    vs = apply_permutation_dense(torch.from_numpy(dense_rows(idx)).to(dev),
                                 sigma).contiguous()
    imagea = torch.from_numpy(imagelike_binary_dataset(
        np.random.default_rng(0), PAPER_DOCS, PAPER_D, block=16)).to(dev)
    wrappers = {"cminhash_sparse": (ks.cminhash_sparse_kernel,
                                    ks.cminhash_sparse_plain),
                "cminhash_dense": (kd.cminhash_dense_kernel,
                                   kd.cminhash_dense_plain),
                "cminhash_packed": (kpk.cminhash_packed_kernel,
                                    kpk.cminhash_packed_plain)}
    cases = []                 # (name, shape, call(label) -> tensor, want)

    def signing(name, shape, x, p, k, pack_b):
        wrapper, plain = wrappers[name]
        cases.append((name, shape, lambda label: wrapper(x, p, k,
                                                         pack_b=pack_b),
                      plain(x, p, k, pack_b=pack_b)))

    signing("cminhash_sparse", "serving 4096 x 254, D 2^16, K 256, b 32",
            sidx, pi, 256, 32)
    for k in PAPER_KS:
        sigma_k, pi_k = make_two_permutations(
            torch.Generator().manual_seed(k), PAPER_D, device=dev)
        vk = apply_permutation_dense(imagea, sigma_k).contiguous()
        signing("cminhash_dense", f"imageA 4096 x 2048, K {k}", vk, pi_k, k,
                None)
        if k == PAPER_KS[-1]:
            signing("cminhash_packed", f"imageA 4096 x 2048, K {k}",
                    kpk.pack_bits(vk), pi_k, k, None)
    signing("cminhash_dense", "service 4096 x 2^16, K 256, b 32", vs, pi,
            256, 32)
    signing("cminhash_packed", "service 4096 x 2^16, K 256, b 32",
            kpk.pack_bits(vs), pi, 256, 32)

    # the collision kernel: the serving fallback (64 pow2-padded rows
    # against a 262,144-row index, K = 256, at b = 32 and b = 8), one
    # 16,384-row block, and Fig. 7's 4096 x 4096 x K; seeded codes (the
    # kernels' time does not depend on which codes match)
    gen = torch.Generator(device=dev).manual_seed(0)
    for b in (32, 8):
        codes = torch.randint(0, 1 << 16, (64 + 262_144, 256), generator=gen,
                              device=dev, dtype=torch.int32)
        codes[64::4096] = codes[0]
        w = pack_codes_dev(codes, b)
        wq, wn = w[:64].contiguous(), w[64:].contiguous()
        cases.append(("collision", f"fallback 64 x 262,144 x 256, b {b}",
                      lambda label, wq=wq, wn=wn, b=b: collision_call(
                          label, wq, wn, 256, b),
                      torch.cat([kc.packed_collision_counts_plain(
                          wq, wn[lo: lo + 16384], 256, b)
                          for lo in range(0, wn.shape[0], 16384)], dim=1)))
        if b == 32:
            blk = wn[:16384].contiguous()
            cases.append(("collision", "one block 64 x 16,384 x 256, b 32",
                          lambda label, wq=wq, blk=blk: collision_call(
                              label, wq, blk, 256, 32),
                          kc.collision_counts_plain(wq, blk)))
    for k in PAPER_KS:
        a = torch.randint(0, 1 << 11, (PAPER_DOCS, k), generator=gen,
                          device=dev, dtype=torch.int32)
        cases.append(("collision", f"Fig. 7 4096 x 4096 x {k}",
                      lambda label, a=a, k=k: collision_call(label, a, a, k,
                                                             32),
                      kc.collision_counts_plain(a, a)))

    rows = []
    for name, shape, call, want in cases:
        labels = (["per-call choice", *PLACEMENTS.values()]
                  if name in SIGNING else ["kernel"]) + (
            ["baseline"] if base else [])
        status = {}
        for label in labels:
            with variant(name, label):
                try:
                    got = call(label)
                except RuntimeError as e:
                    status[label] = f"refused ({e})"
                    continue
            require(torch.equal(got, want), f"{name} {label} at {shape}")
            status[label] = "equal"
        run = [lbl for lbl in labels if status[lbl] == "equal"]
        times: dict = {lbl: {"ms": [], "device_ms": []} for lbl in run}
        for order in (run, run[::-1]):
            for label in order:
                with variant(name, label):
                    ms, dev_ms = both_ms(lambda: call(label), 20)
                times[label]["ms"].append(ms)
                times[label]["device_ms"].append(dev_ms)
        row = {"kernel": name, "shape": shape, "status": status,
               "ms": {lbl: statistics.median(t["ms"])
                      for lbl, t in times.items()},
               "device_ms": {lbl: statistics.median(t["device_ms"])
                             for lbl, t in times.items()},
               "rounds": times}
        rows.append(row)
        print(f"[compare] {name} {shape}: " + "; ".join(
            f"{lbl} {row['ms'][lbl]:.4f} ms (device "
            f"{row['device_ms'][lbl]:.4f})" if lbl in row["ms"]
            else f"{lbl} refused" for lbl in labels))
    report["compare"] = rows
    big, _ = corpus(4 * BATCH)
    scaling = []
    for b in (BATCH // 4, BATCH // 2, BATCH, 2 * BATCH, 4 * BATCH):
        x = apply_permutation_sparse(torch.tensor(big[:b], device=dev),
                                     sigma).to(torch.int32).contiguous()
        ms, dev_ms = both_ms(
            lambda: ks.cminhash_sparse_kernel(x, pi, 256, pack_b=32), 20)
        scaling.append({"docs": b, "ms": ms, "device_ms": dev_ms})
    report["sparse_scaling"] = scaling
    print("[compare] cminhash_sparse by batch: " + ", ".join(
        f"{r['docs']} docs {r['ms']:.4f} ms (device {r['device_ms']:.4f})"
        for r in scaling))
    collision_sass(report)
    compare_query(baseline, query_libs, report)


def query_case(n_docs: int):
    """The full-size table and a serving query batch, built directly: the
    corpus signed on the card in serving batches, its band hashes inserted
    in one call into a table at the geometry the main path's ingest grows
    to at 262,144 documents (2^19 slots, bucket width 8, 16 probes).
    Returns (table, query words on the card, n_bands)."""
    from repro_torch.core.lsh import band_hashes_packed
    from repro_torch.core.permutations import make_two_permutations
    from repro_torch.device import u32_to_host
    from repro_torch.kernels import dispatch
    from repro_torch.serve.search import SearchConfig
    from repro_torch.store.table import BandedLSHTable
    dev = torch.device("cuda")
    cfg = SearchConfig()
    sigma, pi = make_two_permutations(torch.Generator().manual_seed(0),
                                      cfg.d, device=dev)
    idx, fresh = corpus(n_docs)

    def sign(rows):
        return dispatch.signatures_sparse(torch.tensor(rows, device=dev), pi,
                                          cfg.k, sigma, pack_b=cfg.b)
    words = torch.cat([sign(idx[lo: lo + BATCH])
                       for lo in range(0, len(idx), BATCH)])
    table = BandedLSHTable(cfg.n_bands, n_slots=1 << 19,
                           bucket_width=cfg.bucket_width, max_probes=16,
                           device=dev)
    table.insert(band_hashes_packed(u32_to_host(words), cfg.n_bands),
                 np.arange(len(idx)))
    qwords = sign(np.concatenate([idx[:N_QUERY_INDEXED], fresh]))
    return table, qwords, cfg.n_bands


def compare_query(baseline: str | None, libs: dict, report: dict) -> None:
    """``--compare``, the query side: the fold, the probe and the fold ->
    candidates leg ("service leg": every query leg, the service's shard
    and the single store alike) at the main path's full-size shapes (1088
    x 32 x 8 query codes, a 2^19-slot, 32-band table of 262,144
    documents).  With ``--baseline DIR``, beside each the previous
    ``fold.cu`` / ``lsh_probe.cu`` built from DIR, called as the earlier
    wrappers called them: a probe with the earlier operand-row interface
    gets its operands built as those wrappers built them, on the host
    (``probe_operands``, then an upload).  Each variant is checked against
    the plain version and timed in turns, with and without the host's
    launch work, and with L2 flushed."""
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import lsh_probe as kp
    from repro_torch.kernels import query_fused as kq
    dev = torch.device("cuda")
    table, qwords, nb = query_case(BATCH * 64)
    records = table.device_records()
    ns, mp = table.n_slots, table.max_probes
    w = records.shape[1] - 2
    rows = kq.words_to_rows(qwords, nb).contiguous()
    q, _, r = rows.shape
    hashes = kq.fold_rows_kernel(rows)
    meta = torch.tensor(kp.probe_operands(kq.hashes_to_host(hashes), ns),
                        device=dev)
    new = {"fold": lambda: kq.fold_rows_kernel(rows),
           "probe": lambda: kp.lsh_probe_hashes_kernel(
               records, hashes, n_slots=ns, max_probes=mp),
           "service leg": lambda: kp.lsh_probe_hashes_kernel(
               records, dispatch.fold_hashes(qwords, n_bands=nb),
               n_slots=ns, max_probes=mp)}
    old = {}
    if libs:
        with open(os.path.join(baseline, "src", "repro_torch", "csrc",
                               "lsh_probe.cu")) as f:
            meta_abi = "const int* meta" in f.read()
        fold_k = (_build.CudaKernel("fold", kq.KERNEL.argtypes,
                                    library=libs["fold"])
                  if has_knobs(baseline, "fold") else
                  EarlierKernel("fold", kq.KERNEL.argtypes, libs["fold"]))

        def old_fold():
            out = torch.empty((q, nb), dtype=torch.int64, device=dev)
            fold_k.launch(dev, _build.ptr(rows), _build.ptr(out), q, nb, r, 0,
                          256)
            return out
        if meta_abi:
            probe_k = _build.CudaKernel("lsh_probe", OPERAND_ROW_PROBE_ARGS,
                                        library=libs["lsh_probe"])

            def old_probe(m):
                out = torch.empty((m.shape[0], w), dtype=torch.int32,
                                  device=dev)
                probe_k.launch(dev, _build.ptr(records), _build.ptr(m),
                               _build.ptr(out), m.shape[0], ns, mp, w)
                return out
            old = {"fold": old_fold,
                   "probe": lambda: old_probe(meta),
                   "service leg": lambda: old_probe(torch.tensor(
                       kp.probe_operands(kq.hashes_to_host(old_fold()), ns),
                       device=dev))}
        else:
            probe_k = (_build.CudaKernel("lsh_probe", kp.KERNEL.argtypes,
                                         library=libs["lsh_probe"])
                       if has_knobs(baseline, "lsh_probe") else
                       EarlierKernel("lsh_probe", kp.KERNEL.argtypes,
                                     libs["lsh_probe"]))

            def old_probe(h):
                out = torch.empty((h.numel(), w), dtype=torch.int32,
                                  device=dev)
                probe_k.launch(dev, _build.ptr(records), _build.ptr(h),
                               _build.ptr(out), h.numel(), nb, ns, mp, w,
                               4, 4)
                return out
            old = {"fold": old_fold, "probe": lambda: old_probe(hashes),
                   "service leg": lambda: old_probe(old_fold())}
    want = {"fold": kq.fold_rows_plain(rows),
            "probe": kp.lsh_probe_hashes_plain(records, hashes, n_slots=ns,
                                               max_probes=mp)}
    want["service leg"] = want["probe"]
    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    cases = [(case, {"new": fn, **({"old": old[case]} if case in old
                                   else {})}, want[case])
             for case, fn in new.items()]
    rows_out = []
    for case, variants, expect in cases:
        for label, call in variants.items():
            require(torch.equal(call(), expect), f"{case} ({label}) == plain")
        times = {lbl: {"ms": [], "device_ms": [], "cold_device_ms": []}
                 for lbl in variants}
        for order in (list(variants), list(variants)[::-1]):
            for label in order:
                t = times[label]
                # the earlier legs wait for the card or enqueue longer
                # than the spin: they have an as-called time only
                ms, dev_ms = both_ms(variants[label], 50, host_bound_ok=True)
                t["ms"].append(ms)
                t["device_ms"].append(dev_ms)
                t["cold_device_ms"].append(time_ms(variants[label], 30,
                                                   spin=True, flush=flush))
        row = {"case": case, "rounds": times,
               **{key: {lbl: None if None in t[key]
                        else statistics.median(t[key])
                        for lbl, t in times.items()}
                  for key in ("ms", "device_ms", "cold_device_ms")}}
        rows_out.append(row)
        print(f"[compare] {case}: " + "; ".join(
            f"{lbl} {row['ms'][lbl]:.4f} ms (device "
            f"{fmt_ms(row['device_ms'][lbl])}, L2 flushed "
            f"{fmt_ms(row['cold_device_ms'][lbl])})" for lbl in variants))
    walk = probe_walk(records, meta, ns, mp)
    report["compare_query"] = {"rows": rows_out, "shape": list(rows.shape),
                               "records_shape": list(records.shape),
                               "n_spilled": table.n_spilled, **walk}
    print(f"[compare] probe walk: {walk['probe_steps']} steps, "
          f"{walk['hits']} hits, steps by entry {walk['steps_hist']}")


def index_form_fit(sigs: torch.Tensor, labels: torch.Tensor, cfg):
    """``fit_logistic`` in its first form, kept here as ``--compare``'s
    baseline: ``w[k * 2^b + code]`` picked by advanced indexing, whose
    gradient is an ``index_put`` with accumulate (it sorts the N * K
    indices); the port gathers ``w.view(K, 2^b)`` instead, whose gradient
    is a ``scatter_add``.  The same loss and Adam update."""
    from repro_torch.core.bbit import lowest_b_bits
    dev, k = sigs.device, sigs.shape[1]
    cols = ((torch.arange(k, device=dev, dtype=torch.int64) << cfg.b)
            + lowest_b_bits(sigs, cfg.b).long())
    y = labels.to(dev, torch.float32)
    w = torch.zeros(k << cfg.b, device=dev, requires_grad=True)
    bias = torch.zeros((), device=dev, requires_grad=True)
    params = (w, bias)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    t = torch.zeros((), device=dev)
    zero = torch.zeros((), device=dev)
    for _ in range(cfg.steps):
        logits = w[cols].sum(dim=1) + bias
        ce = torch.mean(torch.logaddexp(zero, logits) - y * logits)
        loss = ce + cfg.l2 * torch.sum(w * w)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            t += 1
            c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
            for p, mm, vv, g in zip(params, m, v, grads):
                mm.mul_(0.9).add_(0.1 * g)
                vv.mul_(0.999).add_(0.001 * g * g)
                p.sub_(cfg.lr * (mm / c1) / (torch.sqrt(vv / c2) + 1e-8))
    return w.detach(), bias.detach()


def compare_trainer(report: dict) -> None:
    """``--compare``: ``fit_logistic`` (the gather form) against
    ``index_form_fit`` at phase 11's N = 32,768 and K = 512, 300 steps,
    b in {1, 2, 4, 8}, in turns (index, gather, gather, index); seconds a
    step on the host clock around a synchronised fit, the peak device
    memory over the signatures, the largest weight the two forms put
    apart.  Random codes with a learnable signal, made on the card."""
    from repro_torch.core.linear_model import (HashedLinearConfig,
                                               fit_logistic)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randint(0, 2, (LINEAR_TRAIN,), generator=gen, device=dev,
                      dtype=torch.int32)
    sigs = torch.randint(0, 1 << 30, (LINEAR_TRAIN, LINEAR_K), generator=gen,
                         device=dev, dtype=torch.int32)
    sigs[y == 1, : LINEAR_K // 2] = 7
    forms = {"index": index_form_fit, "gather": fit_logistic}
    rows = []
    for b in (1, 2, 4, 8):
        cfg = HashedLinearConfig(b=b)
        for f in forms.values():                  # warm-up
            f(sigs[:1024], y[:1024], HashedLinearConfig(b=b, steps=5))
        wb = {}
        for name in ("index", "gather", "gather", "index"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            wb[name] = forms[name](sigs, y, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rows.append({"b": b, "form": name, "ms_per_step":
                         dt / cfg.steps * 1e3, "peak_bytes":
                         torch.cuda.max_memory_allocated() - base})
        apart = float((wb["index"][0] - wb["gather"][0]).abs().max())
        print(f"[trainer] b = {b}, ms a step, index / gather / gather / "
              "index: " + " / ".join(f"{r['ms_per_step']:.3f}"
                                     for r in rows[-4:])
              + "; peak MiB " + " / ".join(
                  f"{r['peak_bytes'] / 2**20:.1f}" for r in rows[-4:])
              + f"; weights apart at most {apart:.2e}")
        rows[-1]["w_max_apart"] = apart
    report["trainer_forms"] = rows


def pack_codes_dev(codes: torch.Tensor, b: int) -> torch.Tensor:
    """``packfmt.pack_codes`` in row chunks, so its int64 temporaries stay
    small at the index's size."""
    from repro_torch.kernels.packfmt import pack_codes
    return torch.cat([pack_codes(codes[lo: lo + 16384], b)
                      for lo in range(0, codes.shape[0], 16384)])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=262_144,
                    help="documents to ingest on the main path")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 5e's Poisson arrival gaps and of "
                         "phases 12-13's weights, prompts and batches")
    ap.add_argument("--compare", action="store_true",
                    help="only compare the signing kernels' table "
                         "placements, the collision kernel, the fold, the "
                         "probe (and --baseline's builds)")
    ap.add_argument("--baseline", default=None,
                    help="with --compare: a checkout whose signing, "
                         "collision, fold and probe sources are timed "
                         "behind the same wrappers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    adopt_descendants()
    from repro_torch.kernels import _build, autotune
    # phases 1-14 launch the default geometry: no autotune cache (phase 15)
    os.environ.pop(autotune.CACHE_ENV, None)
    autotune.clear_cache()
    t_all = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    report: dict = {"card": card, "torch": torch.__version__,
                    "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    report["build"] = built
    print(f"[build] {len(built)} kernels in {report['build_s']:.2f} s")
    for name, b in built.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    if args.compare:
        compare(args.baseline, report)
        compare_trainer(report)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "compare.json"),
                  "w") as f:
            json.dump(report, f, indent=1)
        print(card)
        return

    t0 = time.perf_counter()
    docs, labels = documents(args.docs)
    idx, fresh_idx = corpus(args.docs, docs)
    report["corpus_s"] = time.perf_counter() - t0
    print(f"[data] {len(idx)} docs x {idx.shape[1]} shingles + "
          f"{len(fresh_idx)} fresh in {report['corpus_s']:.1f} s")

    svc, qidx = main_path(idx, fresh_idx, report)
    mesh_entry = entry_inputs({"idx": idx, "qidx": qidx, "docs": docs})
    report["kernels"] = kernel_checks(svc, idx, qidx, report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    trace_query(svc, qidx, report)
    card_vs_cpu(idx, fresh_idx, report)

    raw_svc = raw_path(idx, fresh_idx, report)
    card_vs_cpu(idx, fresh_idx, report, b=2)
    snapshot_path({"main_path": svc, "raw_path": raw_svc}, qidx, report)
    del raw_svc
    torch.cuda.empty_cache()
    tcp_path(svc, idx, qidx, report)
    torch.cuda.empty_cache()
    jdir = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    try:
        rsvc = replica_path(svc, idx, qidx, jdir, report)
        try:
            chaos_path(svc, idx, qidx, os.path.join(jdir, "chaos"), report)
            stream_path(svc, rsvc, qidx, args.seed, report)
        finally:
            rsvc.close()
    finally:
        shutil.rmtree(jdir, ignore_errors=True)
    del svc, rsvc
    torch.cuda.empty_cache()

    svc, batch = dense_path(idx, fresh_idx, report)
    corpora = paper_path(report)
    rows, extra = dense_kernel_checks(svc, batch, corpora, report)
    report["kernels"] += rows
    report["kernel_extra"] = extra
    del svc, batch
    torch.cuda.empty_cache()
    dense_card_vs_cpu(idx, fresh_idx, report)
    torch.cuda.empty_cache()

    dedup_path(docs, labels, idx, report)
    del docs, labels
    torch.cuda.empty_cache()
    linear_path(report)
    torch.cuda.empty_cache()
    lm_path(args.seed, report)
    torch.cuda.empty_cache()
    train_path(args.seed, report)
    torch.cuda.empty_cache()
    mesh_path(args.seed, report, mesh_entry)
    del mesh_entry
    torch.cuda.empty_cache()
    tune_path(report)

    paths = ("main_path", "store_path", "raw_path", "snapshot_path",
             "tcp_path", "replica_path", "chaos_path", "stream_path",
             "dense_path", "paper_path", "dedup_path", "linear_path",
             "lm_path", "train_path", "mesh_path", "tune_path")
    for row in report["kernels"] + extra:
        row["launches"] = sum(report[p]["launches"][row["name"]]
                              for p in paths)
        row["launches_by_path"] = {p: report[p]["launches"][row["name"]]
                                   for p in paths}
    for row in report["kernels"]:
        require(row["launches"] > 0,
                f"kernel {row['name']} launched on a counted path")
    report["stopped_at_exit"] = stopped = stop_children()
    print(f"[exit] {len(stopped)} processes still running were stopped"
          + "".join(f"; {line}" for line in stopped))
    report["wall_s"] = time.perf_counter() - t_all
    print(f"[done] {report['wall_s']:.1f} s in all")
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "equal", "ms", "kernel_ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "launches_by_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report["kernels"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
